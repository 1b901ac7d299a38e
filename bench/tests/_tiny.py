"""A tiny cell on the CPU for the benchmark's tests: the harness's whole
run (the program's fused engine with the kernels' plain versions, the
window, the reference), at sizes a test can hold.  Its four kv heads
put some of each request's heads on the pool shard, so the exchange is
live."""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import harness  # noqa: E402

CONFIG = {"name": "tiny", "family": "dense", "reference": "gqa",
          "n_layers": 2, "d_model": 128, "n_heads": 8, "n_kv_heads": 4,
          "head_dim": 16, "d_ff": 256, "vocab_size": 256, "qk_norm": True,
          "rope_theta": 10000.0, "norm_eps": 1e-6, "tie_embeddings": False,
          "dtype": "float32"}
MOE = dict(CONFIG, name="tiny-moe", family="moe", qk_norm=False,
           n_experts=4, top_k=2, moe_d_ff=64)
MIX = {"arrivals": "poisson", "base_seed": 0, "pool": 64,
       "lengths": {"in_mean": 20, "in_sigma": 0.9, "in_min": 4,
                   "in_max": 48, "out_mean": 8, "out_sigma": 0.8,
                   "out_min": 2, "out_max": 16}}
SPEC = {"cluster": [["A100", 1], ["3090", 1]], "primary": [0], "pool": [1],
        "engine": {"step_mode": "fused", "page_size": 8, "max_batch": 4,
                   "max_seq": 64, "prefill_chunk": 8, "token_budget": 0},
        "pool_gb": {"0": 0.001, "1": 0.001}, "rate_per_s": 20.0,
        "warmup": {"replays": 1, "min_s": 0.2, "settle_s": 0.1,
                   "max_s": 0.5},
        "trace": {"s": 0.3},
        # float32 on both sides: the gap is rounding of sums in another
        # order (about 1e-6 here).  Eight requests, as the served cell
        # samples: the two always picked are the oldest in their steps,
        # which sit in the first rows of every call, so a fault in the
        # later rows shows only in the requests drawn beside them
        "check": {"min_tokens": 16, "min_requests": 8, "gap_max": 1e-3}}


def cell(config=CONFIG, arrivals="poisson", e2e=(), per_layer=()):
    mix = dict(MIX, arrivals=arrivals)
    return harness.Cell("tiny.cell", config, mix, SPEC, 1,
                        [{"name": n, "unit": "x"} for n in e2e],
                        [{"name": n, "unit": "x"} for n in per_layer])


def run(c, seed=20261018, seconds=2.0, trace=False):
    """One run on the CPU, on one thread (test workers share the cores)."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run(c, seed, seconds, trace, "cpu",
                           time.perf_counter())
    finally:
        torch.set_num_threads(threads)
