"""Minimal tree helpers over the parameter layouts the port uses.

A manifold element is either one tensor (Pose2 [..., 3], vectors) or a
NamedTuple of tensors (Pose3(R, t)). These helpers stand in for
`jax.tree_util.tree_map` / `tree_leaves` over those two layouts.
"""

from __future__ import annotations

from typing import Any, Callable, List


def _is_tuple(x) -> bool:
    return isinstance(x, tuple)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply fn leafwise over one or more trees of the same layout."""
    if _is_tuple(tree):
        parts = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if _is_tuple(tree):
        out: List[Any] = []
        for x in tree:
            out.extend(tree_leaves(x))
        return out
    return [tree]


def tree_stack(elements, stack_fn) -> Any:
    """Stack a list of same-layout trees leafwise with stack_fn(list)."""
    first = elements[0]
    if _is_tuple(first):
        parts = [tree_stack([e[i] for e in elements], stack_fn) for i in range(len(first))]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    return stack_fn(list(elements))
