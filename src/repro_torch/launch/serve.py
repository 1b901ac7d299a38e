"""Serving launcher: run the Hetis engine end to end on the GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-14b \
      --requests 8 --rate 2.0

  # the per-module probe on the CPU, its Chrome trace checked after
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --trace-modules --trace-out trace.json
  PYTHONPATH=src python -m repro_torch.telemetry.export trace.json

Weights are the port's seeded random initialisation (``--seed``).  The
model is the full published config unless ``--smoke`` asks for its
reduced sibling.  Runs on ``--device cuda`` unless told otherwise; the
cluster's device classes are simulated and all pool shards live on that
one device.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_config, smoke_config
from repro_torch.core.cluster import ClusterSpec
from repro_torch.serving import EngineConfig, InferenceEngine, Request
from repro_torch.weights import init_params


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced same-family config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry and write a Chrome trace_event "
                         "JSON (chrome://tracing / ui.perfetto.dev)")
    ap.add_argument("--trace-modules", action="store_true",
                    help="also run the per-module probe (device-"
                         "synchronised attention/MLP spans feeding the "
                         "dispatcher/hauler/cost-model calibration)")
    args = ap.parse_args(argv)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, args.seed, device=args.device)

    cluster = ClusterSpec.build([("A100", 1), ("3090", 2), ("P100", 1)])
    telemetry = bool(args.trace_out) or args.trace_modules
    eng = InferenceEngine(cfg, params, cluster, primary_ids=[0],
                          pool_ids=[1, 2, 3],
                          engine_cfg=EngineConfig(
                              max_batch=16, max_seq=128,
                              telemetry=telemetry,
                              trace_modules=args.trace_modules),
                          device=args.device)

    rng = np.random.default_rng(args.seed)
    t = 0.0
    for i in range(args.requests):
        t += rng.exponential(1.0 / args.rate)
        prompt = [int(x) for x in
                  rng.integers(0, cfg.vocab_size, int(rng.integers(4, 24)))]
        eng.submit(Request(rid=i, prompt=prompt,
                           max_new_tokens=args.max_new_tokens, arrival=t))
    eng.run_until_drained()
    print(f"served {len(eng.finished)} requests, "
          f"sim clock {eng.clock*1e3:.2f} ms, metrics {eng.metrics}")
    for r in eng.finished[:4]:
        print(f"  rid={r.rid} ttft={r.ttft*1e3:.2f}ms "
              f"tokens={r.output[:8]}...")
    snap = eng.snapshot()
    print(f"snapshot: ttft_p95={snap['ttft_s/p95']*1e3:.3f}ms "
          f"kv_occupancy={snap['kv/occupancy']:.3f} "
          f"bucket_shapes={snap['jit/recompiles']:.0f}")
    if args.trace_out:
        n = eng.tracer.write_chrome(args.trace_out)
        print(f"wrote {n} trace events to {args.trace_out}")


if __name__ == "__main__":
    main()
