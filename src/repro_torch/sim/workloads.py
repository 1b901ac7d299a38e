"""Workload generators matching the paper's three applications (§7.1).

Offline stand-ins for the real datasets, matching their published length
statistics (documented sources):

  ShareGPT (SG)  — chatbot: medium prompts, medium outputs.  vLLM's ShareGPT
                   stats: input ~ lognormal, mean ≈ 310 tok; output mean ≈
                   220 tok [vLLM paper, Fig 12 workloads].
  HumanEval (HE) — code completion: short prompts (mean ≈ 140), short
                   outputs (mean ≈ 60) [HumanEval dataset stats].
  LongBench (LB) — long-document summarisation: prompts ≈ 8k (1k-13k),
                   outputs ≈ 200 [LongBench paper, Table 2].

Arrivals are Poisson as in §7.2.

A copy of ``repro.sim.workloads``: the same seed gives the same trace.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    in_mean: float       # lognormal parameters chosen to hit these means
    in_sigma: float
    in_max: int
    out_mean: float
    out_sigma: float
    out_max: int


WORKLOADS: Dict[str, WorkloadSpec] = {
    "sharegpt": WorkloadSpec("sharegpt", in_mean=310, in_sigma=0.9,
                             in_max=2048, out_mean=220, out_sigma=0.8,
                             out_max=1024),
    "humaneval": WorkloadSpec("humaneval", in_mean=140, in_sigma=0.5,
                              in_max=512, out_mean=60, out_sigma=0.6,
                              out_max=256),
    "longbench": WorkloadSpec("longbench", in_mean=8000, in_sigma=0.6,
                              in_max=13000, out_mean=200, out_sigma=0.5,
                              out_max=512),
}


@dataclasses.dataclass
class TraceRequest:
    rid: int
    arrival: float
    prompt_len: int
    output_len: int


def _lognormal_with_mean(rng, mean: float, sigma: float, n: int) -> np.ndarray:
    mu = np.log(mean) - sigma ** 2 / 2.0
    return rng.lognormal(mu, sigma, n)


def make_trace(workload: str, rate: float, duration: float,
               seed: int = 0) -> List[TraceRequest]:
    """Poisson arrivals at ``rate`` req/s for ``duration`` seconds."""
    spec = WORKLOADS[workload]
    rng = np.random.default_rng(seed)
    n = max(1, rng.poisson(rate * duration))
    arrivals = np.sort(rng.uniform(0.0, duration, n))
    ins = np.clip(_lognormal_with_mean(rng, spec.in_mean, spec.in_sigma, n),
                  8, spec.in_max).astype(int)
    outs = np.clip(_lognormal_with_mean(rng, spec.out_mean, spec.out_sigma,
                                        n), 4, spec.out_max).astype(int)
    return [TraceRequest(i, float(arrivals[i]), int(ins[i]), int(outs[i]))
            for i in range(n)]
