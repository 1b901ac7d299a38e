"""HexGen-style analytic cost model: C = C_comp + C_comm (paper §4.1).

The Parallelizer scores candidate (DP, PP, TP) configurations with this
model; the discrete-event simulator uses it to advance time; the serving
engine reads its dense-FLOP count, roofline efficiencies and EWMA
calibration.

A copy of the framework-free ``repro.core.costmodel`` (the port imports
nothing of ``repro``): the :class:`ModelProfile` a ``ModelConfig``
converts to, the per-module FLOP and byte counts, the alpha-beta link
times, the per-class module times, stage and pipeline timing, and the
paper's model profiles.  Host arithmetic only; no tensor touches a device.

Per-module decomposition
------------------------
An LLM layer is split the way the paper splits it:

  * dense modules — QKV projection, attention output projection, MLP (or MoE
    experts), plus the final logits matmul.  These are matmul-bound and carry
    the model parameters.  Primary-worker parallelism governs them.
  * the Attention module proper — parameter-free ``softmax(qK^T)V``.  During
    decode it is *memory-bandwidth* bound (streams the KV cache once per
    token), which is exactly why low-end devices stay competitive (Fig 2b)
    and why Hetis dispatches it separately.

Each module cost is a roofline max(flops / dense_rate, bytes / hbm_rate) plus
a fixed launch overhead.  Communication uses the alpha-beta model [37]:
ring all-reduce costs ``2 (n-1)/n · V / BW`` and P2P costs ``V / BW + alpha``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence

from repro_torch.core.cluster import ClusterSpec, Device, DeviceClass

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """The minimal architectural facts the analytic model needs."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    act: str = "swiglu"            # swiglu -> 3 mats, gelu -> 2 mats
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    # MLA (deepseek): per-token latent cache instead of per-head K/V
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- sizes -----------------------------------------------------------
    @property
    def dtype_bytes(self) -> int:
        return BYTES[self.dtype]

    @property
    def gqa_ratio(self) -> int:
        """r = query heads per kv head group (paper §5.1)."""
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def mlp_mats(self) -> int:
        return 3 if self.act == "swiglu" else 2

    def layer_dense_params(self, layer_idx: int = -1) -> float:
        """Parameter count of the dense modules of one layer."""
        dh, d = self.head_dim, self.d_model
        qkv = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh)
        o = self.n_heads * dh * d
        if self.n_experts and (layer_idx < 0 or layer_idx >= self.first_dense_layers):
            ff = self.moe_d_ff or self.d_ff
            mlp = (self.n_experts + self.n_shared_experts) * self.mlp_mats() * d * ff
        else:
            mlp = self.mlp_mats() * d * self.d_ff
        return float(qkv + o + mlp)

    def layer_active_params(self, layer_idx: int = -1) -> float:
        """Params touched per token (MoE: only routed top-k + shared)."""
        dh, d = self.head_dim, self.d_model
        qkv = d * (self.n_heads * dh) + 2 * d * (self.n_kv_heads * dh)
        o = self.n_heads * dh * d
        if self.n_experts and (layer_idx < 0 or layer_idx >= self.first_dense_layers):
            ff = self.moe_d_ff or self.d_ff
            mlp = (self.top_k + self.n_shared_experts) * self.mlp_mats() * d * ff
        else:
            mlp = self.mlp_mats() * d * self.d_ff
        return float(qkv + o + mlp)

    def total_params(self) -> float:
        dense = sum(self.layer_dense_params(i) for i in range(self.n_layers))
        return dense + 2.0 * self.d_model * self.vocab_size

    def total_active_params(self) -> float:
        act = sum(self.layer_active_params(i) for i in range(self.n_layers))
        return act + 2.0 * self.d_model * self.vocab_size

    def kv_bytes_per_token_layer(self) -> float:
        """KV-cache bytes appended per token per layer."""
        if self.kv_lora_rank:  # MLA latent: c_kv + rope key, shared by heads
            return (self.kv_lora_rank + self.qk_rope_head_dim) * self.dtype_bytes
        return 2.0 * self.n_kv_heads * self.head_dim * self.dtype_bytes

    def kv_bytes_per_token(self) -> float:
        return self.kv_bytes_per_token_layer() * self.n_layers


# ---------------------------------------------------------------------------
# Per-module FLOPs / bytes (one layer unless stated)
# ---------------------------------------------------------------------------

def dense_flops_layer(p: ModelProfile, tokens: float, layer_idx: int = -1) -> float:
    """Matmul FLOPs of the dense modules of one layer for ``tokens`` tokens."""
    return 2.0 * tokens * p.layer_active_params(layer_idx)


def dense_weight_bytes_layer(p: ModelProfile, tokens: float,
                             layer_idx: int = -1) -> float:
    """Weight bytes streamed for one layer (decode: weight-bound).

    For MoE, small decode batches touch at most ``min(B*topk, E)`` experts.
    """
    d = p.d_model
    dh = p.head_dim
    qkv_o = (d * (p.n_heads * dh) + 2 * d * (p.n_kv_heads * dh)
             + p.n_heads * dh * d)
    if p.n_experts and (layer_idx < 0 or layer_idx >= p.first_dense_layers):
        ff = p.moe_d_ff or p.d_ff
        touched = min(tokens * p.top_k, float(p.n_experts)) + p.n_shared_experts
        mlp = touched * p.mlp_mats() * d * ff
    else:
        mlp = p.mlp_mats() * d * p.d_ff
    return (qkv_o + mlp) * p.dtype_bytes


def attn_flops_prefill_layer(p: ModelProfile, batch: float, seq: float) -> float:
    """Causal softmax attention flops for one layer of a full prefill."""
    # qK^T and AV, causal halves the work.
    return 2.0 * 2.0 * batch * p.n_heads * (seq * seq / 2.0) * p.head_dim


def attn_flops_decode_layer(p: ModelProfile, batch: float, ctx: float) -> float:
    """One decode step: each of ``batch`` tokens attends to ``ctx`` keys."""
    return 2.0 * 2.0 * batch * p.n_heads * ctx * p.head_dim


def attn_cache_bytes_decode_layer(p: ModelProfile, batch: float, ctx: float) -> float:
    """KV bytes streamed from HBM for one decode step of one layer."""
    return batch * ctx * p.kv_bytes_per_token_layer()


def activation_bytes(p: ModelProfile, tokens: float) -> float:
    """Hidden-state tensor size (for TP all-reduce / PP p2p volumes)."""
    return tokens * p.d_model * p.dtype_bytes


# ---------------------------------------------------------------------------
# Communication primitives (alpha-beta model [37])
# ---------------------------------------------------------------------------

ALPHA_INTRA_S = 10e-6    # per-op latency within a host
ALPHA_INTER_S = 30e-6    # per-op latency across hosts


def allreduce_time(devices: Sequence[Device], nbytes: float,
                   cluster: ClusterSpec) -> float:
    """Ring all-reduce across ``devices``: 2 (n-1)/n * V / min-link."""
    n = len(devices)
    if n <= 1 or nbytes == 0:
        return 0.0
    min_bw = min(cluster.link_gbps(devices[i], devices[(i + 1) % n])
                 for i in range(n)) * 1e9
    cross_host = len({d.host for d in devices}) > 1
    alpha = ALPHA_INTER_S if cross_host else ALPHA_INTRA_S
    return 2.0 * (n - 1) / n * nbytes / min_bw + 2.0 * alpha * math.log2(max(2, n))


def p2p_time(a: Device, b: Device, nbytes: float, cluster: ClusterSpec) -> float:
    if nbytes == 0 or a.device_id == b.device_id:
        return 0.0
    bw = cluster.link_gbps(a, b) * 1e9
    alpha = ALPHA_INTRA_S if cluster.same_host(a, b) else ALPHA_INTER_S
    return nbytes / bw + alpha


# ---------------------------------------------------------------------------
# Per-device module times
# ---------------------------------------------------------------------------

# Per-class roofline efficiencies, calibrated against Table 1 / Fig 2.
# P100 (no tensor cores, Pascal) achieves a tiny fraction of its nominal
# fp16 rate on *small-batch* dense GEMMs (decode), but recovers part of it
# on large prefill GEMMs — the only way to reconcile the paper's 24.5x
# prefill gap (Table 1) with its 40.4x decode-MLP gap (Fig 2a).
DENSE_EFF: Dict[str, float] = {
    "A100": 0.55, "3090": 0.42, "P100": 0.06, "H100": 0.5, "L4": 0.4,
    "v5e": 0.55, "v4": 0.55, "v3": 0.45,
}
# large-GEMM (>= 256 tokens) efficiency multiplier
DENSE_EFF_LARGE_BOOST: Dict[str, float] = {"P100": 5.0, "L4": 1.5}
HBM_EFF: Dict[str, float] = {
    "A100": 0.75, "3090": 0.65, "P100": 0.55, "H100": 0.75, "L4": 0.6,
    "v5e": 0.75, "v4": 0.75, "v3": 0.65,
}


def _dense_eff(cls: DeviceClass, tokens: float) -> float:
    eff = DENSE_EFF[cls.name]
    if tokens >= 256:
        eff = min(0.55, eff * DENSE_EFF_LARGE_BOOST.get(cls.name, 1.0))
    return eff


def calibrate_efficiency(prev_eff: float, analytic_s: float,
                         measured_s: float, alpha: float = 0.25,
                         lo: float = 0.02, hi: float = 1.0) -> float:
    """EWMA-update a roofline efficiency factor from a *measured* module
    time (telemetry span duration).

    ``analytic_s`` is the time the roofline predicts at efficiency 1.0;
    the instantaneous efficiency estimate is analytic/measured, clamped to
    [lo, hi] and folded with weight ``alpha`` so one slow step cannot
    swing the cost model (the same smoothing contract as the dispatcher's
    snapshot calibration).  Returns the updated efficiency."""
    if measured_s <= 0.0 or analytic_s <= 0.0:
        return prev_eff
    inst = min(max(analytic_s / measured_s, lo), hi)
    return (1.0 - alpha) * prev_eff + alpha * inst


def _roofline_s(cls: DeviceClass, flops: float, nbytes: float,
                tokens: float = 0.0) -> float:
    t_comp = flops / (cls.dense_tflops * 1e12 * _dense_eff(cls, tokens))
    t_mem = nbytes / (cls.hbm_gbps * 1e9 * HBM_EFF[cls.name])
    return max(t_comp, t_mem)


def dense_module_time(cls: DeviceClass, p: ModelProfile, tokens: float,
                      tp: int = 1, n_layers: Optional[int] = None,
                      phase: str = "decode") -> float:
    """Time for the dense modules of ``n_layers`` layers on one device class.

    ``tp``-way tensor parallel divides both flops and weight bytes.
    """
    L = p.n_layers if n_layers is None else n_layers
    fl = dense_flops_layer(p, tokens) / tp
    by = dense_weight_bytes_layer(p, tokens) / tp
    per_layer = _roofline_s(cls, fl, by, tokens) \
        + cls.launch_overhead_us * 1e-6
    return per_layer * L


# Attention runs on the vector/CUDA cores (no tensor-core GEMMs): its
# compute efficiency is class-agnostic-ish, which is exactly why the
# device gap "narrows in the Attention module" (Fig 2b / O2).
ATTN_VEC_EFF = 0.25


def attn_module_time(cls: DeviceClass, p: ModelProfile, batch: float,
                     ctx: float, tp: int = 1, n_layers: Optional[int] = None,
                     phase: str = "decode") -> float:
    """Attention-proper time (parameter-free part)."""
    L = p.n_layers if n_layers is None else n_layers
    if phase == "prefill":
        fl = attn_flops_prefill_layer(p, batch, ctx) / tp
        by = attn_cache_bytes_decode_layer(p, batch, ctx) / tp  # write K,V once
        t_comp = fl / (cls.dense_tflops * 1e12 * _dense_eff(cls, batch * ctx))
    else:
        fl = attn_flops_decode_layer(p, batch, ctx) / tp
        by = attn_cache_bytes_decode_layer(p, batch, ctx) / tp
        t_comp = fl / (cls.dense_tflops * 1e12 * ATTN_VEC_EFF)
    t_mem = by / (cls.hbm_gbps * 1e9 * HBM_EFF[cls.name])
    per_layer = max(t_comp, t_mem) + 0.5 * cls.launch_overhead_us * 1e-6
    return per_layer * L


def logits_time(cls: DeviceClass, p: ModelProfile, tokens: float,
                tp: int = 1) -> float:
    fl = 2.0 * tokens * p.d_model * p.vocab_size / tp
    by = p.d_model * p.vocab_size * p.dtype_bytes / tp
    return _roofline_s(cls, fl, by)


# ---------------------------------------------------------------------------
# Stage / iteration times for parallel configurations
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageConfig:
    """One pipeline stage: a set of same-class devices running TP."""

    devices: tuple            # tuple[Device]
    n_layers: int

    @property
    def tp(self) -> int:
        return len(self.devices)

    @property
    def cls(self) -> DeviceClass:
        return self.devices[0].cls


def stage_time(stage: StageConfig, p: ModelProfile, cluster: ClusterSpec,
               batch: float, tokens_per_req: float, ctx: float,
               phase: str) -> float:
    """Execution time of one stage for one iteration (micro-batch)."""
    tokens = batch * tokens_per_req
    cls = stage.cls
    t = dense_module_time(cls, p, tokens, tp=stage.tp, n_layers=stage.n_layers,
                          phase=phase)
    t += attn_module_time(cls, p, batch, ctx, tp=stage.tp,
                          n_layers=stage.n_layers, phase=phase)
    if stage.tp > 1:
        # 2 all-reduces per layer (post-attention, post-MLP) of the hidden.
        v = activation_bytes(p, tokens)
        t += 2.0 * stage.n_layers * allreduce_time(list(stage.devices), v, cluster)
    return t


def pipeline_iteration_time(stages: Sequence[StageConfig], p: ModelProfile,
                            cluster: ClusterSpec, batch: float,
                            tokens_per_req: float, ctx: float,
                            phase: str, include_logits: bool = True) -> float:
    """One iteration through a PP chain (single micro-batch: sum of stages +
    inter-stage P2P of the hidden states)."""
    total = 0.0
    for i, st in enumerate(stages):
        total += stage_time(st, p, cluster, batch, tokens_per_req, ctx, phase)
        if i + 1 < len(stages):
            v = activation_bytes(p, batch * tokens_per_req)
            total += p2p_time(st.devices[0], stages[i + 1].devices[0], v, cluster)
    if include_logits:
        last = stages[-1]
        total += logits_time(last.cls, p, batch * (1.0 if phase == "decode"
                                                   else tokens_per_req),
                             tp=last.tp)
    return total


# ---------------------------------------------------------------------------
# Paper model profiles (for benchmarks / simulator)
# ---------------------------------------------------------------------------

OPT_2_7B = ModelProfile("opt-2.7b", n_layers=32, d_model=2560, n_heads=32,
                        n_kv_heads=32, d_ff=10240, vocab_size=50272, act="gelu")
LLAMA_13B = ModelProfile("llama-13b", n_layers=40, d_model=5120, n_heads=40,
                         n_kv_heads=40, d_ff=13824, vocab_size=32000)
OPT_30B = ModelProfile("opt-30b", n_layers=48, d_model=7168, n_heads=56,
                       n_kv_heads=56, d_ff=28672, vocab_size=50272, act="gelu")
LLAMA_70B = ModelProfile("llama-70b", n_layers=80, d_model=8192, n_heads=64,
                         n_kv_heads=8, d_ff=28672, vocab_size=32000)

PAPER_MODELS = {m.name: m for m in [OPT_2_7B, LLAMA_13B, OPT_30B, LLAMA_70B]}
