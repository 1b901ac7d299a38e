"""One-card dry-run of every (arch x shape) cell: the reference's
``repro.launch.dryrun`` for the per-device share of its pod mesh.

For each cell, on the ``meta`` device (shapes only: no storage and no
card are needed):
  * the bundle of ``steps.build`` at the per-device share;
  * the argument bytes (parameters, optimizer state, batch or cache and
    tokens), whether they fit the card's 80 GB, and where they do not,
    the deepest cut (layers) whose arguments do;
  * model FLOPs by the reference's formula (6 N_active D to train, 2
    N_active D for a forward; per device of its 256-chip pod) and the
    card's share (its own rows);
  * counted FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one
    microbatch of the step (times ``n_micro``), as PyTorch runs it on
    ``meta``: there B3's plain version stands in for the kernel, so
    attention counts as the dense product over every (query, key) pair.
    Not counted (None) for the train and prefill cells of the
    subquadratic archs (hymba's SSM, xLSTM): their scans run a Python
    step per token and layer, minutes per cell on ``meta``;
  * ``hlo_analysis.roofline_terms`` of the counted FLOPs (else the model
    FLOPs) and the argument bytes read once (H100 peaks: a model of the
    card, not a measurement).

Results are JSON under results/dryrun_torch/.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ALIASES, SHAPES, cells, get_config,
                                 shape_applicable)
from repro_torch.launch import hlo_analysis
from repro_torch.launch.steps import (DATA_AXIS_SIZE, MODEL_AXIS_SIZE, build,
                                      input_specs)
from repro_torch.models import transformer as T
from repro_torch.training.train_loop import trainable
from repro_torch.training.tree import flatten

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" \
    / "dryrun_torch"
CARD_BYTES = 80e9          # one H100's HBM
POD_CHIPS = DATA_AXIS_SIZE * MODEL_AXIS_SIZE


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in flatten(tree)[0])


def arg_bytes(cfg, shape, batch: int) -> Dict[str, int]:
    """Bytes of each input of the cell's step for ``batch`` rows."""
    return {k: tree_bytes(v) for k, v in input_specs(cfg, shape,
                                                     batch).items()}


def deepest_fit(cfg, shape, batch: int) -> int:
    """The most layers whose step arguments fit the card (0: none)."""
    lo, hi = 0, cfg.n_layers
    while lo < hi:
        mid = (lo + hi + 1) // 2
        cut = dataclasses.replace(cfg, n_layers=mid)
        if sum(arg_bytes(cut, shape, batch).values()) <= CARD_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


def model_flops(cfg, shape, rows: int) -> float:
    """The reference's MODEL_FLOPS for ``rows`` rows (dryrun.py:88-100):
    6 N_active D (train) / 2 N_active D (inference)."""
    n_active = cfg.profile().total_active_params()
    if shape.step == "train":
        return 6.0 * n_active * rows * shape.seq_len
    if shape.step == "prefill":
        return 2.0 * n_active * rows * shape.seq_len
    return 2.0 * n_active * rows


def counted_flops(cfg, shape, bundle) -> Optional[float]:
    """FLOPs ``FlopCounterMode`` counts for one microbatch of the step on
    ``meta`` (a train step: the loss and its gradient); None for the
    token scans' train and prefill cells."""
    if cfg.subquadratic and shape.step != "decode":
        return None
    with FlopCounterMode(display=False) as counter:
        if shape.step == "train":
            params, _opt, batch = bundle.args
            params = trainable(params)
            mb = bundle.batch // bundle.n_micro
            loss, _ = T.loss_fn(cfg, params,
                                {k: v[:mb] for k, v in batch.items()})
            torch.autograd.grad(loss, flatten(params)[0],
                                materialize_grads=True)
        else:
            bundle.fn(*bundle.args)
    return float(counter.get_total_flops())


def run_cell(arch: str, shape_name: str, *, save: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "step": shape.step,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch}
    out_path = RESULTS / f"{arch}_{shape_name}.json"
    if not ok:
        rec.update(status="skipped", reason=why)
        if save:
            _save(out_path, rec)
        return rec
    try:
        t0 = time.perf_counter()
        bundle = build(cfg, shape, "meta")
        args = arg_bytes(cfg, shape, bundle.batch)
        total = sum(args.values())
        fits = total <= CARD_BYTES
        counted = counted_flops(cfg, shape, bundle)
        if counted is not None:
            counted *= bundle.n_micro
        card = model_flops(cfg, shape, bundle.batch)
        terms = hlo_analysis.roofline_terms(
            card if counted is None else counted, total)
        rec.update(
            status="ok", desc=bundle.static_desc, batch=bundle.batch,
            n_micro=bundle.n_micro, arg_bytes=args, arg_gb=total / 1e9,
            fits=fits,
            cut_layers=None if fits else deepest_fit(cfg, shape,
                                                     bundle.batch),
            model_flops_per_device=model_flops(
                cfg, shape, shape.global_batch) / POD_CHIPS,
            model_flops_card=card, counted_flops=counted,
            useful_flops_ratio=card / counted if counted else None,
            roofline_s=terms, dominant_term=max(terms, key=terms.get),
            host_s=time.perf_counter() - t0)
        cut = "" if fits else f" cut to {rec['cut_layers']} layers"
        count = ("not counted" if counted is None else
                 f"counted {counted:.3e} (ratio {card / counted:.2f})")
        print(f"[ok] {arch} {shape_name} ({bundle.static_desc}, "
              f"{bundle.batch} rows): args {total / 1e9:.2f} GB"
              f"{cut}; model FLOPs {card:.3e}, {count}; H100 model "
              f"compute {terms['compute_s'] * 1e3:.1f} ms, memory "
              f"{terms['memory_s'] * 1e3:.1f} ms", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures for iteration
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[ERR] {arch} {shape_name}: {e}", flush=True)
    if save:
        _save(out_path, rec)
    return rec


def _save(path: pathlib.Path, rec: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=str))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args(argv)
    if args.all:
        todo = [(arch, sname) for arch, sname, _ok, _ in
                cells(include_skipped=True)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(ALIASES.get(args.arch, args.arch), args.shape)]
    status = [run_cell(arch, sname)["status"] for arch, sname in todo]
    print(f"done: ok={status.count('ok')} err={status.count('error')} "
          f"skipped={status.count('skipped')}")
    return 1 if "error" in status else 0


if __name__ == "__main__":
    raise SystemExit(main())
