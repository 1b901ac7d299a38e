"""The parts of the HexGen-style analytic cost model (paper §4.1) that the
serving engine reads: the :class:`ModelProfile` a ``ModelConfig`` converts
to, the dense-module FLOP count behind the engine's modeled step time, the
roofline efficiencies the profiler's analytic models use, and the EWMA
efficiency calibration.

A copy of the framework-free ``repro.core.costmodel`` subset, so the port
imports nothing of ``repro``.  The Parallelizer's stage/pipeline timing
model is not needed by the serving engine and waits for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


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

    @property
    def gqa_ratio(self) -> int:
        """r = query heads per kv head group (paper §5.1)."""
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def mlp_mats(self) -> int:
        return 3 if self.act == "swiglu" else 2

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


def dense_flops_layer(p: ModelProfile, tokens: float, layer_idx: int = -1) -> float:
    """Matmul FLOPs of the dense modules of one layer for ``tokens`` tokens."""
    return 2.0 * tokens * p.layer_active_params(layer_idx)


# alpha-beta model [37] per-op link latencies
ALPHA_INTRA_S = 10e-6    # per-op latency within a host
ALPHA_INTER_S = 30e-6    # per-op latency across hosts

# Per-class HBM roofline efficiencies, calibrated against Table 1 / Fig 2.
HBM_EFF: Dict[str, float] = {
    "A100": 0.75, "3090": 0.65, "P100": 0.55, "H100": 0.75, "L4": 0.6,
    "v5e": 0.75, "v4": 0.75, "v3": 0.65,
}


def calibrate_efficiency(prev_eff: float, analytic_s: float,
                         measured_s: float, alpha: float = 0.25,
                         lo: float = 0.02, hi: float = 1.0) -> float:
    """EWMA-update a roofline efficiency factor from a *measured* module
    time (telemetry span duration).

    ``analytic_s`` is the time the roofline predicts at efficiency 1.0;
    the instantaneous efficiency estimate is analytic/measured, clamped to
    [lo, hi] and folded with weight ``alpha`` so one slow step cannot
    swing the cost model.  Returns the updated efficiency."""
    if measured_s <= 0.0 or analytic_s <= 0.0:
        return prev_eff
    inst = min(max(analytic_s / measured_s, lo), hi)
    return (1.0 - alpha) * prev_eff + alpha * inst
