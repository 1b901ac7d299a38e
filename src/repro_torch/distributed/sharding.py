"""Logical-axis sharding rules: the reference's
``repro.distributed.sharding`` on one card.

Models annotate tensors with *logical* axis names ("batch", "heads",
"kv_seq", ...), and a :class:`ShardingRules` context maps those names to
mesh axes.  The reference turns an annotation into a
``with_sharding_constraint`` on its (16, 16) pod mesh.  The port runs on
one card, where every tensor is whole: the rules record the names and
the mapping (``spec`` gives the mesh axes per dimension, as the
reference's ``PartitionSpec`` does), and ``logical`` returns its tensor
unchanged, inside a context or not.  ``launch.steps`` enters the rules as
the reference's step functions do, so the two read alike.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import torch

MeshAxes = Union[str, Tuple[str, ...], None]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis name -> mesh axis (or tuple of mesh axes).
    ``mesh`` is None on one card."""

    rules: Dict[str, MeshAxes]
    mesh: Optional[Any] = None

    def spec(self, *names: Optional[str]) -> Tuple[MeshAxes, ...]:
        """The mesh axes of each dimension (None: whole)."""
        return tuple(self.rules.get(n) if n else None for n in names)


_active: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("sharding_rules", default=None)


@contextlib.contextmanager
def axis_rules(rules: ShardingRules):
    token = _active.set(rules)
    try:
        yield rules
    finally:
        _active.reset(token)


def current_rules() -> Optional[ShardingRules]:
    return _active.get()


def logical_spec(*names: Optional[str]) -> Optional[Tuple[MeshAxes, ...]]:
    r = current_rules()
    return r.spec(*names) if r is not None else None


def logical(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """``x`` itself: on one card there is nothing to constrain (the
    reference applies ``with_sharding_constraint`` when rules are
    active)."""
    return x


# ---------------------------------------------------------------------------
# Default rule sets (DESIGN §5)
# ---------------------------------------------------------------------------

def make_rules(mesh: Any = None, *, kv_head_split: bool, multi_pod: bool,
               expert_axes: MeshAxes = "model") -> ShardingRules:
    """Standard 2D/3D rules: batch/fsdp over (pod,)data, tensor over model.

    kv_head_split — paper-faithful head split of the decode KV cache when the
    arch's kv-head count divides the model axis; otherwise sequence split
    (DESIGN §4/§5).

    expert_axes — MoE expert placement: "model" (EP-16 + FSDP on the inner
    dims) or ("model", "data") (full EP-256).
    """
    batch_axes: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    rules: Dict[str, MeshAxes] = {
        "batch": batch_axes,
        "fsdp": batch_axes,
        "seq": None,
        "embed": None,
        "heads": "model",          # query heads / attention compute split
        "kv_heads": "model" if kv_head_split else None,
        "kv_seq": None if kv_head_split else "model",
        "head_dim": None,
        "mlp": "model",
        "experts": expert_axes,
        "expert_mlp": None,
        "vocab": "model",
        "q_lora": None,
        "kv_lora": None,
        "ssm_inner": "model",
        "ssm_state": None,
        "conv_dim": None,
    }
    return ShardingRules(rules, mesh)
