"""Parameter trees (nested dicts and lists of tensors) flattened in the
order ``jax.tree.flatten`` gives the reference's pytrees: dict keys
sorted, lists in order.  Checkpoints store leaves in this order, so
either package can restore the other's."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, spec): the leaves in ``jax.tree.flatten``'s order and the
    structure ``unflatten`` rebuilds from them."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [flatten(tree[k]) for k in keys]
        return ([x for leaves, _ in parts for x in leaves],
                ("dict", keys, [spec for _, spec in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [flatten(v) for v in tree]
        return ([x for leaves, _ in parts for x in leaves],
                (type(tree).__name__, None, [spec for _, spec in parts]))
    return [tree], None


def _count(spec) -> int:
    return 1 if spec is None else sum(_count(s) for s in spec[2])


def unflatten(spec, leaves: List[Any]):
    """The tree of ``spec`` with ``leaves`` in flatten order."""
    if spec is None:
        (leaf,) = leaves
        return leaf
    kind, keys, subs = spec
    out, i = [], 0
    for s in subs:
        n = _count(s)
        out.append(unflatten(s, leaves[i:i + n]))
        i += n
    if kind == "dict":
        return dict(zip(keys, out))
    return tuple(out) if kind == "tuple" else out


def tree_map(fn: Callable, tree):
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(x) for x in leaves])
