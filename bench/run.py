#!/usr/bin/env python3
"""Run one cell of the benchmark on NVIDIA GPUs and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and ``checks``, each
compared number beside its limit); the last lines of standard error give
the same comparisons.  Without a card, or with fewer cards than the cell
needs, it exits 2 and prints no result.  Kernel libraries build into
``build/kernels/`` of the checkout on a first run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    # every cache of a run stays in the checkout, at fixed paths; a library
    # that would load JAX by itself is kept from it
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import harness
    age = harness.process_age()
    cell = harness.Cell.named(args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START - age)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or of the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    harness.log(harness.card_line())
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
