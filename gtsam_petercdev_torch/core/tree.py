"""Minimal tree helpers over the parameter layouts the port uses.

A manifold element is either one tensor (Pose2 [..., 3], vectors) or a
NamedTuple of tensors (Pose3(R, t), SfmCamera(R, t, cal)); factor
parameters may also be a dict of tensors ({"uv": ...}). These helpers stand
in for `jax.tree_util.tree_map` / `tree_leaves` over those layouts.
"""

from __future__ import annotations

from typing import Any, Callable, List


def _is_tuple(x) -> bool:
    return isinstance(x, tuple)


def _rebuild(like, parts):
    return type(like)(*parts) if hasattr(like, "_fields") else tuple(parts)


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply fn leafwise over one or more trees of the same layout."""
    if _is_tuple(tree):
        return _rebuild(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if _is_tuple(tree) or isinstance(tree, dict):
        out: List[Any] = []
        for x in tree.values() if isinstance(tree, dict) else tree:
            out.extend(tree_leaves(x))
        return out
    return [tree]


def tree_stack(elements, stack_fn) -> Any:
    """Stack a list of same-layout trees leafwise with stack_fn(list)."""
    first = elements[0]
    if _is_tuple(first):
        return _rebuild(
            first, [tree_stack([e[i] for e in elements], stack_fn) for i in range(len(first))]
        )
    if isinstance(first, dict):
        return {k: tree_stack([e[k] for e in elements], stack_fn) for k in first}
    return stack_fn(list(elements))
