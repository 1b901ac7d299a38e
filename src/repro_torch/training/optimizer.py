"""AdamW over parameter trees, with a configurable moment dtype: the
reference's ``repro.training.optimizer`` arithmetic.

Everything is computed in fp32 whatever the parameter and moment dtypes
(bf16 at full width): the global gradient norm accumulated leaf by leaf
in ``flatten`` order, clip scale ``min(1, clip / max(gnorm, 1e-9))``, bias
corrections ``1 - b ** step`` with the step as fp32, ``delta = mhat /
(sqrt(vhat) + eps) + wd * p`` with decay on every leaf, then casts back to
the parameter and moment dtypes.  ``torch.optim.AdamW`` is not this
function: it decays the weights before the moment update and, on bf16
parameters, keeps bf16 state and computes in bf16.  Parameters, moments
and the step counter are updated in place (the returned trees hold the
given tensors), so a step needs no second copy of the model, and a
captured step (a CUDA graph, which reads and writes the tensors it was
captured on) advances the counter on every replay.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.training.tree import flatten, tree_map

Params = Any
OptState = Dict[str, Any]


def adamw_init(params: Params, moment_dtype=torch.float32) -> OptState:
    """Zero moments ``m``, ``v`` of ``moment_dtype`` beside each leaf and
    ``step`` 0 (an int32 scalar on the parameters' device)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype,
                                  device=p.device)
    dev = flatten(params)[0][0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: OptState, *,
                 lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 grad_clip: float = 1.0
                 ) -> Tuple[Params, OptState, torch.Tensor]:
    """One AdamW step with global-norm clipping.  Returns (params, the
    state (``state``'s tensors, ``step`` advanced in place), the gradient's
    global norm (fp32 scalar) before clipping)."""
    step = state["step"].add_(1)
    flat_p = flatten(params)[0]
    flat_g = flatten(grads)[0]
    flat_m = flatten(state["m"])[0]
    flat_v = flatten(state["v"])[0]

    # global-norm clip (fp32 accumulation)
    gsq = torch.zeros((), dtype=torch.float32, device=step.device)
    for g in flat_g:
        gsq = gsq + torch.sum(torch.square(g.float()))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

    stepf = step.float()
    b1t = 1.0 - torch.pow(b1, stepf)
    b2t = 1.0 - torch.pow(b2, stepf)

    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        gf = g.float() * scale
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        mhat = m_new / b1t
        vhat = v_new / b2t
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm
