"""Nested containers of tensors walked in ``jax.tree``'s leaf order.

The port keeps params, optimizer moments and train states as the JAX
package does: nested dicts of tensors inside NamedTuples.  A checkpoint
stores one file per leaf in this order, so both packages read each other's:

- a dict's values in sorted key order, recursively;
- a tuple's (or NamedTuple's) fields in order;
- ``None`` is an empty subtree and contributes no leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["tree_leaves", "tree_map", "tree_unflatten"]


def tree_leaves(tree) -> list:
    """The leaves of ``tree``, in ``jax.tree.leaves`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def _rebuild(like, it: Iterator) -> Any:
    if like is None:
        return None
    if isinstance(like, dict):
        got = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: got[k] for k in like}     # keep the caller's key order
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(sub, it) for sub in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(sub, it) for sub in like)
    return next(it)


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure holding ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure; returns ``tree``'s structure."""
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    if any(len(ls) != len(leaves[0]) for ls in leaves):
        raise ValueError("trees of different structure")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])
