"""Flat views of nested parameter trees (dicts and lists of tensors) in the
JAX package's leaf order: dict keys sorted, lists in order, None skipped."""

from __future__ import annotations

from typing import Any, Iterator, List, Tuple


def _walk(tree: Any, path: Tuple[str, ...]) -> Iterator[Tuple[tuple, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in _walk(tree, ())]


def leaves_with_paths(tree: Any) -> List[Tuple[tuple, Any]]:
    return list(_walk(tree, ()))


def unflatten(template: Any, new_leaves: List[Any]) -> Any:
    """`template`'s containers (rebuilt) holding `new_leaves` in leaf order."""
    it = iter(new_leaves)

    def rec(node):
        if isinstance(node, dict):
            return {k: rec(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return None if node is None else next(it)

    out = rec(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
