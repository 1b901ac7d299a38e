"""Profiler: the linear models of paper §5.1 (Eqs 3-4).

Eq (3):  tau_i(t) = a_i * h_i(t) + b_i * g_i(t) + c_i
    h_i  — number of query heads resident on device i
    g_i  — total KV-cache bytes resident on device i

Eq (4):  rho_i(t) = gamma_i * d_i(t) + beta_i
    d_i  — transfer volume between the primary worker and attention worker i

Two ways to obtain the coefficients, as in ``repro.core.profiler``:

  * ``analytic_attention_model`` — from a :class:`DeviceClass` roofline;
    the serving engine builds its dispatcher workers from these.
  * ``fit_attention_model`` — least squares over measured (h, g, tau)
    samples: from the engine's per-module probe spans
    (``fit_attention_model_from_tracer``), or from ``profile_attention``,
    which times plain decode attention on the local GPU over the paper's
    8x8 grid of (h, g).

A copy of ``repro.core.profiler`` (the port imports nothing of
``repro``); ``profile_attention`` is its torch counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cluster import DeviceClass
from repro_torch.core.costmodel import (ALPHA_INTER_S, ALPHA_INTRA_S, HBM_EFF,
                                        ModelProfile)
from repro_torch.device import resolve


@dataclasses.dataclass
class AttentionModel:
    """tau(h, g) = a * h + b * g + c   (seconds; g in bytes)."""

    a: float
    b: float
    c: float

    def time_s(self, heads: float, cache_bytes: float) -> float:
        return self.a * heads + self.b * cache_bytes + self.c

    def perturbed(self, rel: float, rng: Optional[np.random.Generator] = None
                  ) -> "AttentionModel":
        """Multiplicative perturbation of all coefficients by up to ±rel
        (Fig 16b robustness experiments)."""
        rng = rng or np.random.default_rng(0)
        f = lambda: 1.0 + rng.uniform(-rel, rel)
        return AttentionModel(self.a * f(), self.b * f(), self.c * f())


@dataclasses.dataclass
class TransferModel:
    """rho(d) = gamma * d + beta  (seconds; d in bytes)."""

    gamma: float
    beta: float

    def time_s(self, nbytes: float) -> float:
        if nbytes <= 0:
            return 0.0
        return self.gamma * nbytes + self.beta

    def perturbed(self, rel: float, rng: Optional[np.random.Generator] = None
                  ) -> "TransferModel":
        rng = rng or np.random.default_rng(1)
        f = lambda: 1.0 + rng.uniform(-rel, rel)
        return TransferModel(self.gamma * f(), self.beta * f())


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


# ---------------------------------------------------------------------------
# Least-squares fitting (paper: 8x8 grid of (h, g) combinations)
# ---------------------------------------------------------------------------

def fit_attention_model(samples: Sequence[Tuple[float, float, float]]
                        ) -> Tuple[AttentionModel, float]:
    """Fit tau = a h + b g + c.  Returns (model, R^2)."""
    arr = np.asarray(samples, dtype=np.float64)
    h, g, tau = arr[:, 0], arr[:, 1], arr[:, 2]
    A = np.stack([h, g, np.ones_like(h)], axis=1)
    coef, *_ = np.linalg.lstsq(A, tau, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((tau - pred) ** 2))
    ss_tot = float(np.sum((tau - tau.mean()) ** 2)) or 1.0
    r2 = 1.0 - ss_res / ss_tot
    a, b, c = (float(x) for x in coef)
    return AttentionModel(a, b, c), r2


def attention_samples_from_tracer(tracer, span_name: str = "attention"
                                  ) -> List[Tuple[float, float, float]]:
    """(heads, cache_bytes, seconds) samples from telemetry spans.

    The engine's per-module probe attaches ``{"heads": h, "cache_bytes":
    g}`` args to every device-synchronised attention span; those spans
    ARE the paper's (h, g, tau) measurement grid, collected from live
    traffic instead of an offline sweep."""
    samples: List[Tuple[float, float, float]] = []
    for sp in tracer.spans(span_name):
        if not sp.args or "heads" not in sp.args:
            continue
        samples.append((float(sp.args["heads"]),
                        float(sp.args.get("cache_bytes", 0.0)),
                        float(sp.dur)))
    return samples


def fit_attention_model_from_tracer(tracer, span_name: str = "attention"
                                    ) -> Optional[Tuple[AttentionModel,
                                                        float]]:
    """Least-squares tau(h, g) fit over live telemetry spans; None when
    the tracer holds fewer than 3 annotated attention spans."""
    samples = attention_samples_from_tracer(tracer, span_name)
    if len(samples) < 3:
        return None
    return fit_attention_model(samples)


def fit_transfer_model(samples: Sequence[Tuple[float, float]]
                       ) -> Tuple[TransferModel, float]:
    """Fit rho = gamma d + beta over (bytes, seconds) samples."""
    arr = np.asarray(samples, dtype=np.float64)
    d, rho = arr[:, 0], arr[:, 1]
    A = np.stack([d, np.ones_like(d)], axis=1)
    coef, *_ = np.linalg.lstsq(A, rho, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((rho - pred) ** 2))
    ss_tot = float(np.sum((rho - rho.mean()) ** 2)) or 1.0
    return TransferModel(float(coef[0]), float(coef[1])), 1.0 - ss_res / ss_tot


# ---------------------------------------------------------------------------
# Measurement on the local device
# ---------------------------------------------------------------------------

def decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
    """The decode attention ``profile_attention`` times, as the reference
    writes it: q (B, H, 1, dh), k/v (B, H, S, dh); einsum, softmax,
    einsum."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(q.shape[-1])
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def profile_attention(head_dim: int = 64,
                      head_grid: Sequence[int] = (1, 2, 4, 6, 8, 12, 16, 24),
                      ctx_grid: Sequence[int] = (64, 128, 256, 384, 512, 768,
                                                 1024, 1536),
                      batch: int = 4,
                      repeats: int = 3,
                      dtype: Optional[torch.dtype] = None,
                      device="cuda") -> List[Tuple[float, float, float]]:
    """Measure decode attention on ``device`` over an (h, ctx) grid.

    Returns (heads, cache_bytes, seconds) samples, one per grid point:
    ``batch * h`` query heads over ``batch`` rows of ``ctx`` keys, the
    mean wall time of ``repeats`` calls, each waited for, after two warm
    calls.  The paper measures one layer per configuration (<100 ms
    each); so does this.  What is timed is plain attention
    (``decode_attn``) as the reference times it, not a serving kernel.
    The reference jits it and compiles and runs it in its warm call; on
    the card the first warm call runs it and captures it as a CUDA graph
    (``serving.graphs.CapturedFn``), the second launches the graph once,
    and each timed call replays the graph.  On the CPU, and inside
    ``graphs.disable_capture()``, every call runs it eagerly.
    """
    # the serving package imports this module: import its graphs here
    from repro_torch.serving.graphs import CapturedFn, CudaGraphs
    from repro_torch.telemetry.metrics import Counter
    dev = resolve(device)
    dtype = dtype or torch.float32
    elem = 4 if dtype == torch.float32 else 2
    call = CapturedFn(decode_attn, Counter("profile/captures"),
                      CudaGraphs(dev))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    samples: List[Tuple[float, float, float]] = []
    for h in head_grid:
        for ctx in ctx_grid:
            g = torch.Generator(device=dev).manual_seed(h * 131 + ctx)
            q, k, v = (torch.randn(shape, generator=g, dtype=dtype,
                                   device=dev)
                       for shape in ((batch, h, 1, head_dim),
                                     (batch, h, ctx, head_dim),
                                     (batch, h, ctx, head_dim)))
            # warm: on the card a run and its capture, then the graph's
            # first launch (which uploads it: 0.1 ms more than a later one)
            for _ in range(2):
                call(q, k, v)
            sync()
            t0 = time.perf_counter()
            for _ in range(repeats):
                call(q, k, v)
                sync()
            dt = (time.perf_counter() - t0) / repeats
            cache_bytes = 2.0 * batch * h * ctx * head_dim * elem
            samples.append((float(batch * h), cache_bytes, dt))
    return samples
