"""Sharded, atomic checkpointing: the reference's
``repro.training.checkpoint`` layout and behaviour.

Layout:  <dir>/step_<N>/
            manifest.json            (step, tree structure, shard count)
            shard_<host>.npz         (the leaves, ``leaf_<i>`` in
                                      ``jax.tree.flatten`` order)
            COMMITTED                (written last — partial dirs are ignored)

Writes go to a temp dir then rename — a crash mid-write never corrupts the
latest checkpoint.  ``restore_latest`` picks the newest COMMITTED step, the
trainer's restart path.  Leaves are stored in the reference's order, so an
fp32 checkpoint written by either package restores in the other.  A bf16
leaf is stored as the reference stores it, 2-byte ``V2`` records of the
bf16 bits, and read back as those bits when the template leaf is bf16
(the reference's ``restore`` cannot cast ``V2`` and raises; ROADMAP
Queue C).
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.tree import flatten, unflatten


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:            # the bits, as V2 records
        return x.view(torch.int16).numpy().view("V2")
    return x.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``like``'s dtype on its device."""
    if arr.dtype.kind == "V":                # bf16 bits
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise TypeError(f"a {arr.dtype} leaf restores only into a "
                            f"bfloat16 leaf, not {like.dtype}")
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr)).to(like.dtype)
    return t.to(like.device)


def save(ckpt_dir: str, step: int, tree, host_id: int = 0,
         keep_last: int = 3) -> str:
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    final = base / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=base, prefix=".tmp_"))
    try:
        leaves, spec = flatten(tree)
        np.savez(tmp / f"shard_{host_id}.npz",
                 **{f"leaf_{i}": _to_numpy(x) for i, x in
                    enumerate(leaves)})
        manifest = {"step": step, "n_leaves": len(leaves),
                    "treedef": repr(spec), "hosts": 1}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        (tmp / "COMMITTED").write_text("ok")
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(base, keep_last)
    return str(final)


def _gc(base: pathlib.Path, keep_last: int) -> None:
    steps = sorted(d for d in base.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and (d / "COMMITTED").exists())
    for d in steps[:-keep_last]:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in base.iterdir()
             if d.is_dir() and d.name.startswith("step_")
             and (d / "COMMITTED").exists()]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, tree_like, host_id: int = 0):
    """Restore into the structure of ``tree_like`` (shapes must match);
    each leaf takes its template leaf's dtype and device."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    assert (d / "COMMITTED").exists(), f"checkpoint {d} not committed"
    data = np.load(d / f"shard_{host_id}.npz")
    leaves, spec = flatten(tree_like)
    new_leaves = []
    for i, ref in enumerate(leaves):
        arr = data[f"leaf_{i}"]
        assert arr.shape == tuple(ref.shape), \
            f"leaf {i}: ckpt {arr.shape} vs model {tuple(ref.shape)}"
        new_leaves.append(_from_numpy(arr, ref))
    return unflatten(spec, new_leaves)


def restore_latest(ckpt_dir: str, tree_like, host_id: int = 0
                   ) -> Tuple[Optional[int], Any]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None, tree_like
    return step, restore(ckpt_dir, step, tree_like, host_id)
