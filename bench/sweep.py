#!/usr/bin/env python3
"""Find an open-loop cell's knee: the highest rate the engine sustains.

    python3 bench/sweep.py --workload <cell> --rates 1,1.5,2,3 \\
        --seconds 60 [--seed N] [--out build/sweep.json]

One engine, warmed on the cell's traffic once, takes each rate in turn
(ascending) for ``--seconds`` of the cell's open loop, and is drained
before the next.  Per rate: the time to first token (median, p90, in the
window's first and second halves), the gap between tokens (p50, p95),
tokens per second against those offered, the requests without a first
token (queued or prefilling) on average in each half and at the end, and
the batch.  A rate is sustained when that backlog does not grow: its
second half's mean is not above its first's, and the second half's TTFT
p90 not far above the first's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import harness, stats, traffic
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell.named(args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
    cell.spec["rate_per_s"] = rates[0]
    params, eng, drv = harness.setup(cell, args.seed, args.seconds, "cuda",
                                     False)
    vocab = cell.config["vocab_size"]
    rows = []
    for rate in rates:
        first_rid = drv.submitted
        jobs = traffic.open_loop(cell.mix, rate, args.seconds, args.seed,
                                 traffic.WINDOW, vocab)
        waiting = []     # (time, requests without a first token, batch)
        t0 = time.perf_counter()
        phase = harness.Phase(drv, cell, jobs, t0)
        phase.run(t0 + args.seconds, on_step=lambda: waiting.append((
            time.perf_counter(), len(eng.queue) + len(eng.prefilling),
            len(eng.running) + len(eng.prefilling))))
        close = time.perf_counter()
        half = t0 + args.seconds / 2
        due = [(s.due, s.first) for rid, s in drv.served.items()
               if rid >= first_rid and s.due is not None]
        ttft = lambda ds: [stats.censored(f, d, close) for d, f in ds]
        gaps = [g for e, g in drv.gaps if t0 <= e <= close]
        row = {"rate": rate, "requests": len(due),
               "ttft_p50_ms": 1e3 * stats.percentile(ttft(due), 50),
               "ttft_p90_ms": 1e3 * stats.percentile(ttft(due), 90),
               "ttft_p90_first_half_ms": 1e3 * (stats.percentile(
                   ttft([x for x in due if x[0] < half]), 90) or 0),
               "ttft_p90_second_half_ms": 1e3 * (stats.percentile(
                   ttft([x for x in due if x[0] >= half]), 90) or 0),
               "itl_p50_ms": 1e3 * (stats.percentile(gaps, 50) or 0),
               "itl_p95_ms": 1e3 * (stats.percentile(gaps, 95) or 0),
               "tok_s": harness._tokens_between(drv, t0, close)
               / (close - t0),
               "offered_tok_s": sum(j.max_new for j in jobs)
               / args.seconds,
               "waiting_mean_first_half": mean([w for t, w, _ in waiting
                                                if t < half]),
               "waiting_mean_second_half": mean([w for t, w, _ in waiting
                                                 if t >= half]),
               "waiting_end": len(eng.queue) + len(eng.prefilling),
               "batch_mean": mean([b for _, _, b in waiting]),
               "batch_max": max((b for _, _, b in waiting), default=0),
               "captures": harness._captures(eng)}
        rows.append(row)
        harness.log("sweep: " + json.dumps(row))
        t_drain = time.perf_counter()
        while drv.busy():
            drv.step()
        harness.log(f"sweep: drained in {time.perf_counter() - t_drain:.1f}"
                    f" s")
    harness.log(harness.card_line())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
