#!/usr/bin/env python3
"""The readings a cell's limit is set from: the program's widest gap on
many seeds, and the control's, in one process.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 15 [--out build/control.json]

One engine is built and warmed once.  For each seed: the weights of the
seed drawn in place (the captured graphs read the same tensors), the
cell's traffic of the seed for ``--seconds`` at the cell's load, the
engine drained, then the reference over the run's sample, as a run of
``bench/run.py`` draws it.  The program's reading is the widest gap of
its served tokens; on the control seeds, the control's is the widest gap
of the tokens that the reference computed in float8 puts first at the
same positions.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seeds, control_seeds, seconds, device):
    from bench import check, harness, traffic
    from bench.weights import make_params
    cfg = cell.config
    params, eng, drv = harness.setup(cell, seeds[0], seconds, device, False)
    while drv.busy():
        drv.step()
    ref = check.load_reference(cfg["reference"])
    out = []
    for seed in seeds:
        make_params(cfg, seed, device, into=params)
        first = drv.submitted
        if cell.mix["arrivals"] == "poisson":
            jobs = traffic.open_loop(cell.mix, cell.spec["rate_per_s"],
                                     seconds, seed, traffic.WINDOW,
                                     cfg["vocab_size"])
        else:
            jobs = traffic.backlog(cell.mix, seed, traffic.WINDOW,
                                   cfg["vocab_size"])
        t0 = time.perf_counter()
        harness.Phase(drv, cell, jobs, t0).run(t0 + seconds)
        while drv.busy():
            drv.step()
        served = [s.req for rid, s in drv.served.items()
                  if rid >= first and s.req.output]
        lim = cell.spec["check"]
        picked = check.sample(served, seed, lim["min_tokens"],
                              lim["min_requests"])
        t1 = time.perf_counter()
        gaps, ctrl = check.gaps(ref, cfg, params, picked, device,
                                control=seed in control_seeds)
        row = {"seed": seed, "requests": len(picked),
               "tokens": int(gaps.size), "program_gap_max": float(gaps.max()),
               "program_off_best": int((gaps > 0).sum()),
               "reference_s": time.perf_counter() - t1}
        if ctrl is not None:
            row.update(control_gap_max=float(ctrl.max()),
                       control_off_best=int((ctrl > 0).sum()))
        harness.log("control: " + json.dumps(row))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = readings(harness.Cell.named(args.workload), seeds, ctrl,
                    args.seconds, "cuda")
    harness.log(harness.card_line())
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
