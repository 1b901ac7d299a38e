"""Unified model configuration covering every assigned architecture family.

One :class:`ModelConfig` describes dense / MoE / MLA / hybrid-SSM / xLSTM /
encoder-only / VLM-backbone models; ``models/transformer.py`` assembles the
right blocks from it.  ``profile()`` converts to the analytic
:class:`repro_torch.core.costmodel.ModelProfile` used by the Parallelizer,
Dispatcher and simulator, so the serving algorithms and the model are
always derived from the same source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.costmodel import ModelProfile


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # ---- attention flavour ------------------------------------------------
    attn_type: str = "gqa"         # gqa | mla | none
    causal: bool = True            # False: encoder-only (hubert)
    qkv_bias: bool = False         # qwen1.5
    qk_norm: bool = False          # qwen3
    rope_theta: float = 10000.0
    use_rope: bool = True
    sliding_window: int = 0        # 0 = full attention
    global_layers: Tuple[int, ...] = ()   # hymba: layers w/ full attention

    # ---- MLA (deepseek-v3) -------------------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0    # deepseek: first k layers use dense MLP
    capacity_factor: float = 1.25
    router_noise: float = 0.0

    # ---- SSM / hybrid (hymba) ----------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_dt_rank: int = 0           # 0 -> ceil(d_model / 16)

    # ---- xLSTM ---------------------------------------------------------------
    xlstm_pattern: Tuple[str, ...] = ()   # e.g. ("m", "s") repeated

    # ---- frontend -------------------------------------------------------------
    frontend: str = "text"         # text | audio_stub | vision_stub
    n_prefix_embeds: int = 0       # vlm: image patch embeddings prepended
    max_pos_embed: int = 0         # >0: learned absolute positions (hubert)

    # ---- misc -------------------------------------------------------------------
    act: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"        # weights/activations for lowering
    # training-time knobs (per-shape overridable)
    remat: bool = True
    # decode cache update strategy: "carry" = in-place scatter into the full
    # stacked cache carried through the layer scan (no per-step cache copy);
    # "stacked" = cache as scan xs/ys (baseline: copies every layer slice
    # once per decoded token — kept for the §Perf before/after record).
    decode_impl: str = "carry"
    # KV cache storage dtype ("" = activations dtype).  float8_e4m3fn halves
    # decode cache bandwidth + doubles KV capacity (§Perf phi3 decode;
    # beyond-paper optimization, upcast at the attention dots).
    kv_cache_dtype: str = ""

    @property
    def kv_dtype(self) -> str:
        return self.kv_cache_dtype or self.dtype
    scan_q_chunk: int = 1024       # chunked-attention query block
    loss_chunk: int = 512          # chunked loss over sequence
    ssm_chunk: int = 256           # chunk size for recurrent scans

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.ssm_dt_rank == 0 and self.ssm_state:
            object.__setattr__(self, "ssm_dt_rank",
                               max(1, (self.d_model + 15) // 16))

    # ------------------------------------------------------------------------
    @property
    def gqa_ratio(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.attn_type == "none"

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM / SWA-hybrid)"""
        if self.is_attention_free:
            return True
        return self.sliding_window > 0

    def kv_heads_shardable(self, tp: int) -> bool:
        """Paper-faithful head split possible on a tp-way axis?"""
        if self.attn_type == "mla":
            return False     # latent cache is shared across heads (DESIGN §4)
        return self.n_kv_heads % tp == 0

    def profile(self) -> ModelProfile:
        return ModelProfile(
            name=self.name,
            n_layers=self.n_layers,
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=max(1, self.n_kv_heads),
            d_ff=self.d_ff,
            vocab_size=self.vocab_size,
            head_dim=self.head_dim or 1,
            act=self.act,
            n_experts=self.n_experts,
            top_k=self.top_k,
            n_shared_experts=self.n_shared_experts,
            moe_d_ff=self.moe_d_ff,
            first_dense_layers=self.first_dense_layers,
            kv_lora_rank=self.kv_lora_rank,
            qk_rope_head_dim=self.qk_rope_head_dim,
            dtype=self.dtype,
        )

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized sibling of the same family."""
        small = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
        )
        if self.n_experts:
            small.update(n_experts=4, top_k=2, moe_d_ff=64,
                         n_shared_experts=min(1, self.n_shared_experts),
                         first_dense_layers=min(1, self.first_dense_layers))
        if self.q_lora_rank:
            small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                         qk_rope_head_dim=8, v_head_dim=16, head_dim=24)
        if self.ssm_state:
            small.update(ssm_state=8, ssm_dt_rank=4)
        if self.xlstm_pattern:
            small.update(xlstm_pattern=self.xlstm_pattern)
        if self.sliding_window:
            small.update(sliding_window=16)
        if self.global_layers:
            small.update(global_layers=(0,))
        if self.n_prefix_embeds:
            small.update(n_prefix_embeds=4)
        small.update(dtype="float32", scan_q_chunk=32, loss_chunk=64,
                     ssm_chunk=16, remat=False)
        small.update(overrides)
        small.setdefault("name", self.name + "-smoke")
        return dataclasses.replace(self, **small)
