#!/usr/bin/env python3
"""The paged kernels (B1's chunked prefill, B2's decode) built from several
checkouts, timed in turns on one GPU.

    python3 scripts/b1_variants.py [--parent DIR] [--tree NAME=DIR]...
        [--cases NAME,...] [--out PATH]

A build is ``src/repro_torch/kernels/paged_attention/csrc/
paged_prefill_attention.cu`` and ``paged_attention.cu`` of a checkout
rooted at DIR, compiled with that checkout's headers, and called through
that checkout's own wrappers (``kernels/paged_attention/ops.py``: the C
signatures may differ between checkouts): ``tree`` is this one,
``--parent DIR`` adds ``parent``, and ``--tree NAME=DIR`` any other (a copy
of the repo with the kernels' constants edited, to time a variant of the
design).  Each build's TMA-fed instances are listed from ptxas's report
(registers, spills, serialised products).

``--cases`` names B1's cases (``chip_smoke.b1_cases()`` and
``extra_cases`` below) as they are and B2's (``chip_smoke.b2_cases()``
and ``extra_b2_cases``) as ``b2:NAME``.  Every build is first held
against the plain version on each case (bf16 2e-2, fp32 2e-5, padded rows
exactly 0).  Then the cases
are timed build by build in turns (b1 .. bn, then bn .. b1, so drift over
the run weighs on every build alike): the wrapper's host ms per call and
the CUDA-event ms first, then, with the profiler, the device ms of the
kernels alone; each launch follows chip_smoke's L2 flush.  Needs one
NVIDIA GPU and nvcc; prints one line a reading and writes them all as
JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

CSRC = Path("src/repro_torch/kernels/paged_attention/csrc")
OPS = Path("src/repro_torch/kernels/paged_attention/ops.py")
INCLUDE = Path("src/repro_torch/kernels/csrc")
LIBS = ("paged_prefill_attention", "paged_attention")


def build_variants(variants, out_dir):
    """Compile both libraries of every (name, root) at once; returns
    {name: ({library: so}, ptxas report)} of those that built (the
    others' errors are printed)."""
    from repro_torch.kernels import build
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name, root in variants:
        for lib in LIBS:
            so = out_dir / f"{name}-{lib}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I",
                   str(root / INCLUDE), "-o", str(so),
                   str(root / CSRC / f"{lib}.cu")]
            jobs.append((name, lib, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
    built, failed = {}, set()
    for name, lib, so, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for variant {name} ({lib}), left out:\n"
                  f"{err[-2000:]}", flush=True)
            failed.add(name)
            continue
        sos, log_text = built.get(name, ({}, ""))
        sos[lib] = so
        built[name] = (sos, log_text + out + err)
    return {k: v for k, v in built.items() if k not in failed}


def load_ops(name, root):
    """The wrappers of the checkout at ``root``: this tree's package, or
    that checkout's ops.py loaded as a module of its own."""
    if root == ROOT:
        from repro_torch.kernels.paged_attention import ops
        return ops
    spec = importlib.util.spec_from_file_location(f"variant_ops_{name}",
                                                  root / OPS)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# r = 1 (MHA) and small-bucket GQA batches of 64 folded rows or fewer,
# beside chip_smoke's mha_dh96 (phi3-mini's widths): qwen1.5-0.5b's dh 64
# (16 kv heads), dh 128 at 32 kv heads, and qwen3-14b's 8-token bucket
# (C 8, r 5: 40 rows); and the mixed batch at dh 96 (320 rows)
def extra_cases(cases):
    dtype, C, rows, widths = cases["mha_dh96"]
    decode = [row for row in rows if row[1] == 1]
    return {
        "mha_dh64": (dtype, C, rows, dict(widths, Hkv=16, dh=64)),
        "mha_dh128": (dtype, C, rows, dict(widths, dh=128)),
        "bucket8_dh128": (dtype, 8, decode + [(512, 8), (0, 5)]
                          + [(0, 0)] * 14),
        "mixed_dh96": (dtype, C, rows, dict(dh=96)),
    }


# B2's decode batch and its MHA batch at dh 64 with 64-key pages: one TMA
# box a tile and atom instead of four, the same keys
def extra_b2_cases(cases):
    return {name + "_page64": (dtype, dict(widths, page=64, max_pages=32),
                               lengths, bad)
            for name, (dtype, widths, lengths, bad) in cases.items()
            if name in ("decode", "mha_dh64")}


def use(sos):
    """Route the wrappers' library loads to the variant's libraries."""
    from repro_torch.kernels import build
    build._LIBS.update(sos)


def case_inputs(cs, dev, case):
    """(kernel id, inputs, plain output, bound, the call of a wrapper
    module on the inputs, the call that host ms times, the tile) of a case
    name.  B1's host ms takes q as the model's transposed view (what
    gqa_prefill_paged passes), as chip_smoke's B1 phase does."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        paged_attention_ref, paged_prefill_attention_ref)
    if case.startswith("b2:"):
        b2 = cs.b2_cases()
        b2.update(extra_b2_cases(b2))
        dtype, widths, lengths, bad = b2[case[3:]]
        a = cs.make_decode_rows(dev, dtype, lengths, bad_tables=bad,
                                **widths)
        clipped = (*a[:3], a[3].clamp(0, a[1].shape[0] - 1), a[4])
        call = lambda m, a=a: m.paged_attention(*a)
        return ("B2", a, paged_attention_ref(*clipped),
                cs.bound_decode(a, cs.dtype_name(dtype)), call, call,
                ops.decode_tile(dtype, a[1].shape[1], a[0].shape[2]))
    cases = cs.b1_cases()
    cases.update(extra_cases(cases))
    dtype, C, rows, *widths = cases[case]
    a = cs.make_rows(dev, dtype, rows, C, **(widths[0] if widths else {}))
    qv = a[0].transpose(1, 2).contiguous().transpose(1, 2)
    return ("B1", a, paged_prefill_attention_ref(*a),
            cs.bound(a, cs.dtype_name(dtype)),
            lambda m, a=a: m.paged_prefill_attention(*a),
            lambda m, a=(qv, *a[1:]): m.paged_prefill_attention(*a),
            ops.launch_tile(dtype, a[0].shape[2], a[0].shape[3],
                            a[1].shape[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="root of another checkout: adds build 'parent'")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR: adds build NAME from the checkout at DIR")
    ap.add_argument("--cases", default="mixed,prefill,mha_dh96",
                    help="comma-separated names of chip_smoke.b1_cases() "
                    "and extra_cases, and b2:NAME of chip_smoke.b2_cases() "
                    "and extra_b2_cases")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("b1_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cs.log(card)
    variants = [("tree", ROOT)]
    if args.parent:
        variants.insert(0, ("parent", Path(args.parent).resolve()))
    for spec in args.tree:
        name, _, root = spec.partition("=")
        variants.append((name, Path(root).resolve()))
    t0 = time.perf_counter()
    built = build_variants(variants, ROOT / "build" / "b1_variants")
    cs.log(f"built {len(built)} variants in "
           f"{time.perf_counter() - t0:.1f} s")
    if not built:
        return 1
    variants = [v for v in variants if v[0] in built]
    libs, mods = {}, {}
    result = {"card": card, "variants": {}, "cases": {}}
    for name, root in variants:
        sos, log_text = built[name]
        libs[name] = {lib: ctypes.CDLL(str(so)) for lib, so in sos.items()}
        mods[name] = load_ops(name, root)
        report = cs.wgmma_report(log_text)
        result["variants"][name] = dict(root=str(root), wgmma=report)
        for k, (regs, st, ld, serial) in sorted(report.items()):
            cs.log(f"variant {name}: {k}: {regs} registers, spill stores "
                   f"{st} B, loads {ld} B, wgmma "
                   f"{'serialised' if serial else 'pipelined'}")

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    names = [n for n in args.cases.split(",") if n]
    turns = [v[0] for v in variants] + [v[0] for v in reversed(variants)]
    calls = {}
    for case in names:
        kid, a, ref, (b_ms, b_by, nbytes, flops), call, host, tile = \
            case_inputs(cs, dev, case)
        calls[case] = {"host_ms": host, "ms": call, "device_ms": call}
        dname = cs.dtype_name(a[0].dtype)
        padded = a[4] == 0
        entry = dict(kernel=kid, shape=list(a[0].shape), dtype=dname,
                     bound_ms=b_ms, bound_by=b_by, tile=tile, max_abs_err={},
                     host_ms={}, ms={}, device_ms={})
        for name in libs:
            use(libs[name])
            got = call(mods[name])
            torch.cuda.synchronize()
            entry["max_abs_err"][name] = cs.check_kernel(
                f"{case}, variant {name}", got, ref, padded, dname)
        result["cases"][case] = entry
        cs.log(f"{case}: {kid}, {tile} tile in this tree, bound {b_ms:.4f} "
               f"ms ({b_by}); every variant within tolerance: "
               f"{entry['max_abs_err']}")
        del ref, a
    # host and event times first: once the profiler has run in a process,
    # later launches cost more host time
    for key, timer in (("host_ms", lambda f: cs.host_ms(f, 20)),
                       ("ms", lambda f: cs.time_ms(f, 20, flush)),
                       ("device_ms", lambda f: cs.device_ms(f, 20, flush))):
        for case in names:
            for name in turns:
                use(libs[name])
                ms = timer(lambda: calls[case][key](mods[name]))
                result["cases"][case][key].setdefault(name, []).append(ms)
                cs.log(f"{case} {key} variant {name}: {ms:.4f}")
    for case in names:
        e = result["cases"][case]
        cs.log(f"{case}: " + "; ".join(
            f"{name} device {'/'.join(f'{x:.4f}' for x in e['device_ms'][name])}"
            f" (share of bound {e['bound_ms'] / min(e['device_ms'][name]):.3f})"
            f" events {'/'.join(f'{x:.4f}' for x in e['ms'][name])}"
            f" host {'/'.join(f'{x:.4f}' for x in e['host_ms'][name])}"
            for name in libs))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
