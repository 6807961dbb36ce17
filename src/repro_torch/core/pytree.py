"""Payload pytrees for ``SortEngine.sort_pairs``.

The containers and their leaf order are those of ``jax.tree_util`` for the
builtin nodes:

* ``None`` is a node with no children (it holds no leaf);
* ``tuple`` (namedtuples included) and ``list``: children in order;
* ``dict``: children in sorted key order;
* anything else — a numpy array, a tensor, a scalar, a subclass of
  ``dict`` or ``list`` — is a leaf.  (``jax.tree_util`` also walks
  ``OrderedDict`` and ``defaultdict``; no caller passes them, and as
  leaves they fail ``sort_pairs``' leading-dimension check.)
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["is_leaf", "tree_map"]


def _is_namedtuple(t: type) -> bool:
    return issubclass(t, tuple) and hasattr(t, "_fields")


def is_leaf(tree) -> bool:
    """Whether ``tree`` is a bare leaf rather than a container or None."""
    t = type(tree)
    return not (tree is None or t in (tuple, list, dict) or _is_namedtuple(t))


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, the leaves visited
    in ``jax.tree_util`` order."""
    if is_leaf(tree):
        return fn(tree)
    if tree is None:
        return None
    t = type(tree)
    if t is dict:
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    children = [tree_map(fn, c) for c in tree]
    return t(*children) if _is_namedtuple(t) else t(children)
