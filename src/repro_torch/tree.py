"""A small pytree map for the port's nested containers.

The JAX package walks gradient and residual pytrees with ``jax.tree.map``.
The port's trees are the same containers: dicts, lists and tuples, with
``None`` as an empty subtree (it holds no leaf and maps to ``None``, as in
``jax.tree.map``); everything else is a leaf. Dict keys are walked in
sorted order, as JAX flattens them.
"""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        for r in rest:
            if not isinstance(r, dict) or set(r) != set(tree):
                raise ValueError("tree_map: dict keys differ between the trees")
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        for r in rest:
            if not isinstance(r, (list, tuple)) or len(r) != len(tree):
                raise ValueError("tree_map: sequence lengths differ between the trees")
        out = [tree_map(fn, *parts) for parts in zip(tree, *rest)]
        return out if isinstance(tree, list) else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    leaves: List[Any] = []
    tree_map(leaves.append, tree)
    return leaves
