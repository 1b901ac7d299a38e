"""Step functions (train / prefill / decode) and their abstract inputs:
the reference's ``repro.launch.steps`` on one card.

``build(cfg, shape, device)`` returns what ``launch.dryrun`` and a
launcher need: the step function and stand-ins for every input, tensors
on the ``meta`` device (shapes and dtypes, no storage) in place of the
reference's ``ShapeDtypeStruct``s.  The step runs on ``device``: the
card for a real run, ``meta`` for the dry-run's FLOP count.

What the reference's bundle has and this one drops: ``in_shardings``,
``out_shardings`` and ``donate_argnums`` are arguments of ``jax.jit``
over its pod mesh.  One card holds every tensor whole, PyTorch runs the
step eagerly with no jit to hand them to, and the train step updates
parameters and moments in place, which is what donating them buys there.
The sharding rules are still entered (``distributed.sharding``; an
identity here), so the step functions read like the reference's.

The one-card cell is the per-device share of the reference's pod mesh,
(16, 16) over (data, model): the batch is split over ``data``, so one
device holds ``global_batch // 16`` rows (``per_device=True``, the
default).  For ``train_4k`` that is 16 rows of 4096, in ``n_micro``
microbatches by the reference's rule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs import ShapeSpec
from repro_torch.device import resolve
from repro_torch.distributed.sharding import axis_rules, make_rules
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.training.train_loop import trainable
from repro_torch.training.tree import flatten, tree_map, unflatten
from repro_torch.weights import init_params

# the reference's pod mesh: data axis 16 (repro/launch/mesh.py:13, the
# batch over it: repro/launch/partition.py:30), model axis 16
# (repro/launch/partition.py:27)
DATA_AXIS_SIZE = 16
MODEL_AXIS_SIZE = 16
META = torch.device("meta")


def moment_dtype(cfg: ModelConfig) -> torch.dtype:
    """bf16 Adam moments for >=100B-param models (DESIGN §5)."""
    big = cfg.profile().total_params() >= 1e11
    return torch.bfloat16 if big else torch.float32


def num_microbatches(cfg: ModelConfig, shape: ShapeSpec) -> int:
    if shape.step != "train":
        return 1
    if cfg.d_model >= 6144:
        return 16
    if cfg.d_model >= 3072:
        return 8
    return 2


def per_device_batch(shape: ShapeSpec) -> int:
    """Rows one device of the pod mesh holds: the global batch over the
    data axis where the axis divides it (the reference's ``dim_axis``),
    else all of it."""
    B = shape.global_batch
    return B // DATA_AXIS_SIZE if B % DATA_AXIS_SIZE == 0 else B


# ---------------------------------------------------------------------------
# Input specs (meta tensors)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_struct(cfg: ModelConfig, batch: int, seq: int) -> Dict:
    i32 = torch.int32
    if cfg.frontend == "audio_stub":
        return {"frames": _meta((batch, seq, cfg.d_model),
                                getattr(torch, cfg.dtype)),
                "labels": _meta((batch, seq), i32)}
    if cfg.frontend == "vision_stub":
        pe = cfg.n_prefix_embeds
        return {"tokens": _meta((batch, seq - pe), i32),
                "image_embeds": _meta((batch, pe, cfg.d_model),
                                      getattr(torch, cfg.dtype)),
                "labels": _meta((batch, seq - pe), i32)}
    return {"tokens": _meta((batch, seq), i32),
            "labels": _meta((batch, seq), i32)}


def shaped(tree):
    """``tree``'s leaves as meta tensors of their shapes and dtypes."""
    return tree_map(lambda x: _meta(x.shape, x.dtype), tree)


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                batch: Optional[int] = None) -> Dict[str, Any]:
    """All abstract inputs for the given (arch, shape) cell, for
    ``batch`` rows (default the global batch, as in the reference)."""
    B = shape.global_batch if batch is None else batch
    S = shape.seq_len
    params = init_params(cfg, device=META)
    out: Dict[str, Any] = {"params": params}
    if shape.step == "train":
        out["opt_state"] = adamw_init(params, moment_dtype(cfg))
        out["batch"] = batch_struct(cfg, B, S)
    elif shape.step == "prefill":
        b = batch_struct(cfg, B, S)
        b.pop("labels", None)
        out["batch"] = b
    else:  # decode
        out["cache"] = T.init_cache(cfg, B, S, META)
        out["tokens"] = _meta((B, 1), torch.int32)
    return out


# ---------------------------------------------------------------------------
# Step functions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepBundle:
    fn: Callable
    args: Tuple           # meta tensors, positional
    static_desc: str
    batch: int            # rows of the cell
    n_micro: int


def accumulate_grads(cfg: ModelConfig, params, batch: Dict[str, Any],
                     n_micro: int):
    """The reference's microbatch scan: the batch split as
    ``x.reshape(n_micro, b // n_micro, ...)`` (microbatch i is rows
    ``[i * mb, (i + 1) * mb)``), each microbatch's loss and gradient (the
    leaves of ``params`` require grad), the gradients summed in fp32 and
    divided by ``n_micro``.  Returns (fp32 gradient tree, mean loss)."""
    leaves, spec = flatten(params)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
             for k, v in batch.items()}
    for i in range(n_micro):
        loss, _ = T.loss_fn(cfg, params, {k: v[i] for k, v in micro.items()})
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                a.add_(g.to(torch.float32))
        loss_sum = loss_sum + loss.detach()
        del loss, grads
    return unflatten(spec, [a.div_(n_micro) for a in acc]), \
        loss_sum / n_micro


def _check_device(dev: torch.device, params) -> None:
    got = flatten(params)[0][0].device
    if got.type != dev.type:
        raise ValueError(f"the step was built for {dev}; its parameters "
                         f"are on {got}")


def build(cfg: ModelConfig, shape: ShapeSpec, device="cuda", *,
          per_device: bool = True) -> StepBundle:
    """The step of the (cfg, shape) cell, run on ``device`` (``meta`` for
    a dry-run; parameters elsewhere raise), for the per-device share of
    the batch or, with ``per_device=False``, the global batch."""
    dev = resolve(device)
    rules = make_rules(kv_head_split=cfg.kv_heads_shardable(MODEL_AXIS_SIZE),
                       multi_pod=False)
    B = per_device_batch(shape) if per_device else shape.global_batch
    specs = input_specs(cfg, shape, B)

    if shape.step == "train":
        n_micro = num_microbatches(cfg, shape)
        if B % n_micro:
            raise ValueError(f"{B} rows do not split into {n_micro} "
                             f"microbatches")

        def train_step(params, opt_state, batch):
            _check_device(dev, params)
            with axis_rules(rules):
                params = trainable(params)
                grads, loss = accumulate_grads(cfg, params, batch, n_micro)
                new_params, new_opt, gnorm = adamw_update(params, grads,
                                                          opt_state)
                del grads
                return new_params, new_opt, {"loss": loss,
                                             "grad_norm": gnorm}

        return StepBundle(
            fn=train_step,
            args=(specs["params"], specs["opt_state"], specs["batch"]),
            static_desc=f"train n_micro={n_micro}", batch=B,
            n_micro=n_micro)

    if shape.step == "prefill":
        max_seq = shape.seq_len  # cache sized to the prompt for the dry-run
        if cfg.is_encoder_only:
            @torch.no_grad()
            def prefill_step(params, batch):
                _check_device(dev, params)
                with axis_rules(rules):
                    h, _ = T.forward_hidden(cfg, params, batch, remat=False)
                    # the encoder emits the last frame's logits only (full
                    # logits are huge at 32k)
                    return (h[:, -1] @ params["lm_head"]).float()

            return StepBundle(fn=prefill_step,
                              args=(specs["params"], specs["batch"]),
                              static_desc="prefill(encoder)", batch=B,
                              n_micro=1)

        @torch.no_grad()
        def prefill_step(params, batch):
            _check_device(dev, params)
            with axis_rules(rules):
                return T.prefill(cfg, params, batch, max_seq=max_seq)

        return StepBundle(fn=prefill_step,
                          args=(specs["params"], specs["batch"]),
                          static_desc="prefill", batch=B, n_micro=1)

    # decode
    @torch.no_grad()
    def serve_step(params, cache, tokens):
        _check_device(dev, params)
        with axis_rules(rules):
            logits, new_cache = T.decode_step(cfg, params, cache, tokens)
            new_tokens = torch.argmax(logits, dim=-1).to(torch.int32)
            return new_tokens[:, None], new_cache

    return StepBundle(fn=serve_step,
                      args=(specs["params"], specs["cache"], specs["tokens"]),
                      static_desc="decode", batch=B, n_micro=1)
