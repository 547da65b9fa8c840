"""Nested parameter trees: dicts, lists, tuples and NamedTuples of tensors.

The port keeps the reference's parameter layout (plain nested containers,
as ``jax.tree`` sees them), so these helpers walk a tree in
``jax.tree.leaves`` order: dict entries by sorted key, sequences by
position, NamedTuple fields in declaration order.  ``None`` and empty
containers hold no leaves.
"""
from __future__ import annotations

from typing import Any, Callable


def is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree: Any) -> list:
    """Every leaf of ``tree``, in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees in ``rest``
    (which share its structure); returns a tree of that structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(template: Any, values) -> Any:
    """A tree of ``template``'s structure whose leaves are ``values``, given
    in ``leaves`` order."""
    return _build(template, iter(values))


def _build(t: Any, it) -> Any:
    # A module-level function, not a closure: a recursive closure is a
    # reference cycle, which would hold ``values`` (gigabytes of gradients)
    # until the cycle collector runs.
    if t is None:
        return None
    if isinstance(t, dict):
        done = {k: _build(t[k], it) for k in sorted(t)}
        return {k: done[k] for k in t}
    if is_namedtuple(t):
        return type(t)(*(_build(x, it) for x in t))
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    return next(it)
