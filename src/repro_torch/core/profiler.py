"""Profiler: the linear models of paper §5.1 (Eqs 3-4).

Eq (3):  tau_i(t) = a_i * h_i(t) + b_i * g_i(t) + c_i
    h_i  — number of query heads resident on device i
    g_i  — total KV-cache bytes resident on device i

Eq (4):  rho_i(t) = gamma_i * d_i(t) + beta_i
    d_i  — transfer volume between the primary worker and attention worker i

The serving engine builds its dispatcher workers from the analytic
coefficients of each simulated device class.  A copy of the
framework-free part of ``repro.core.profiler``; measuring tau(h, g) on the
local GPU (the counterpart of ``profile_attention``) and the
least-squares fits wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.cluster import DeviceClass
from repro_torch.core.costmodel import (ALPHA_INTER_S, ALPHA_INTRA_S, HBM_EFF,
                                        ModelProfile)


@dataclasses.dataclass
class AttentionModel:
    """tau(h, g) = a * h + b * g + c   (seconds; g in bytes)."""

    a: float
    b: float
    c: float

    def time_s(self, heads: float, cache_bytes: float) -> float:
        return self.a * heads + self.b * cache_bytes + self.c


@dataclasses.dataclass
class TransferModel:
    """rho(d) = gamma * d + beta  (seconds; d in bytes)."""

    gamma: float
    beta: float

    def time_s(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.gamma * nbytes + self.beta


def analytic_attention_model(cls: DeviceClass, p: ModelProfile,
                             n_layers: Optional[int] = None) -> AttentionModel:
    """Decode attention is KV-bandwidth bound: b = 1/HBM rate (per byte,
    summed over layers is already in g since g counts total resident bytes).
    The per-head term models head-count contention (Fig 7c): each active
    query head adds a fixed cost (qK^T/AV vector work + softmax + scheduling).
    """
    hbm = cls.hbm_gbps * 1e9 * HBM_EFF[cls.name]
    L = n_layers if n_layers is not None else p.n_layers
    # bytes term: every resident cache byte is streamed once per step.
    b = 1.0 / hbm
    # head term: per-head fixed work — proportional to head_dim vector ops;
    # dominated by kernel scheduling on real devices.  Calibrated so Fig 7c
    # slopes are reproduced (~1-3 us per head per layer on A100-class).
    a = (cls.launch_overhead_us * 0.05e-6 + p.head_dim * 2.0 / (cls.dense_tflops * 1e12 * 0.05)) * L
    c = cls.launch_overhead_us * 1e-6 * 0.5 * L
    return AttentionModel(a=a, b=b, c=c)


def analytic_transfer_model(link_gbps: float, cross_host: bool = True
                            ) -> TransferModel:
    return TransferModel(gamma=1.0 / (link_gbps * 1e9),
                         beta=ALPHA_INTER_S if cross_host else ALPHA_INTRA_S)
