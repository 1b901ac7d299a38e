"""Restart-safe training loop: the reference's
``repro.training.train_loop`` on the port.

Deterministic data (step-indexed batches), atomic checkpoints, and a
straggler/fault hook: if a step exceeds ``straggler_factor`` x the EWMA step
time, the event is logged (on a real cluster the Parallelizer would be
re-consulted — here the hook records the decision for tests).  A step
(``train_step``) is the reference's jitted ``step_fn``: the loss and its
gradient by autograd (every attention layer through the flash-attention
kernel and its backward on the card), then AdamW.  On the card ``train``
captures the step as one CUDA graph (``serving.graphs.CapturedFn``, the
counterpart of ``@jax.jit``): the first step runs for real and is then
captured, every later step copies its batch into the graph's static
inputs and replays it; the parameters and the optimizer state are
updated in place.  ``graphs.disable_capture()`` (and CPU tensors) run
every step eagerly.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.device import resolve
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.graphs import CapturedFn, CudaGraphs
from repro_torch.telemetry.metrics import Counter
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.training.tree import flatten, tree_map, unflatten
from repro_torch.weights import init_params


@dataclasses.dataclass
class TrainConfig:
    steps: int = 50
    lr: float = 3e-4
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    seed: int = 0
    straggler_factor: float = 3.0
    device: str = "cuda"


def trainable(params):
    """``params``' leaves as leaf tensors that require grad (the same
    storage)."""
    return tree_map(lambda p: p.detach().requires_grad_(), params)


def train_step(cfg: ModelConfig, params, opt, batch: Dict[str, torch.Tensor],
               lr: float):
    """One step: (loss, metrics) = ``loss_fn``, the gradient of every leaf
    (zeros for a leaf the loss does not reach, as JAX gives), then
    ``adamw_update`` in place.  ``params``' leaves require grad.  Returns
    (params, opt, loss (detached fp32 scalar), gnorm)."""
    loss, _met = T.loss_fn(cfg, params, batch)
    leaves, spec = flatten(params)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    params, opt, gnorm = adamw_update(params, unflatten(spec, list(grads)),
                                      opt, lr=lr)
    return params, opt, loss.detach(), gnorm


def train(cfg: ModelConfig, data_cfg: DataConfig, tcfg: TrainConfig,
          params=None) -> Dict:
    """Train ``tcfg.steps`` steps from the latest checkpoint in
    ``tcfg.ckpt_dir`` (if any) on ``tcfg.device``.  Starting weights:
    ``params`` (copied; the lockstep tests start from the reference's),
    else ``init_params(cfg, tcfg.seed)``.  Returns {"losses", "events"} as
    the reference does, plus each step's seconds ("times"), the final
    "params" and "opt", and "graphs": the captured step's graphs (one per
    batch shape; 0 when every step ran eagerly), replays and each
    capture's (warm-up s, capture s).  A restore hands the step new
    tensors, so each call captures its own graph after it."""
    dev = resolve(tcfg.device)
    if params is None:
        params = init_params(cfg, tcfg.seed, dev)
    else:
        params = tree_map(lambda p: p.detach().to(dev, copy=True), params)
    params = trainable(params)
    opt = adamw_init(params)
    start_step = 0
    if tcfg.ckpt_dir:
        step, state = ckpt.restore_latest(tcfg.ckpt_dir,
                                          {"params": params, "opt": opt})
        if step is not None:
            params, opt = trainable(state["params"]), state["opt"]
            start_step = step

    data = SyntheticLM(data_cfg)
    names: List[str] = []                # the batch's keys, in call order

    def run_step(params, opt, *arrays):
        # tokens as int64 for the embedding lookup and the label gather
        batch = {k: a.long() for k, a in zip(names, arrays)}
        return train_step(cfg, params, opt, batch, tcfg.lr)
    step_fn = CapturedFn(run_step, Counter("train/captures"),
                         CudaGraphs(dev), fixed=2)
    losses: List[float] = []
    times: List[float] = []
    events: List[str] = []
    ewma = None
    for step in range(start_step, tcfg.steps):
        host = data.batch_at(step)
        names[:] = sorted(host)
        t0 = time.perf_counter()
        params, opt, loss, gnorm = step_fn(params, opt,
                                           *(host[k] for k in names))
        loss = float(loss)                   # synchronises with the card
        dt = time.perf_counter() - t0
        if ewma is None:
            ewma = dt
        elif dt > tcfg.straggler_factor * ewma:
            events.append(f"straggler@step{step}:{dt:.3f}s vs {ewma:.3f}s")
        ewma = 0.9 * ewma + 0.1 * dt if ewma else dt
        losses.append(loss)
        times.append(dt)
        if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
            ckpt.save(tcfg.ckpt_dir, step + 1,
                      {"params": params, "opt": opt})
    if tcfg.ckpt_dir:
        ckpt.save(tcfg.ckpt_dir, tcfg.steps, {"params": params, "opt": opt})
    return {"losses": losses, "events": events, "times": times,
            "params": params, "opt": opt,
            "graphs": {"graphs": len(step_fn.entries),
                       "replays": step_fn.replays,
                       "capture_s": list(step_fn.capture_s)}}
