"""Nested parameter and state trees (dicts, lists and tuples of tensors),
walked in the reference's pytree order: a dict's children in sorted-key
order, a sequence's in index order. Optimizer state that is a flat list
aligned with the leaves (Adafactor's) and checkpoint keys depend on that
order, so both packages must meet the leaves alike."""

from __future__ import annotations

from typing import Any, Callable


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(node, path, out) -> None:
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for key, child in kids:
        _walk(child, path + (key,), out)


def flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """``[(path, leaf), ...]`` in pytree order; a path is the tuple of
    dict keys and sequence indices from the root. (The walk is a module
    function: a recursive closure would hold the list, and so every leaf,
    in a reference cycle until the garbage collector ran.)"""
    out: list = []
    _walk(tree, (), out)
    return out


def path_key(path: tuple) -> str:
    """The reference checkpoint's key of a leaf: its path joined by ``/``."""
    return "/".join(str(p) for p in path)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def _build(node, it):
    if isinstance(node, dict):
        done = {k: _build(node[k], it) for k in sorted(node)}
        return {k: done[k] for k in node}  # the template's key order
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, it) for v in node)
    return next(it)


def unflatten_like(template, new_leaves) -> Any:
    """``template``'s structure holding ``new_leaves`` (in pytree order)."""
    it = iter(new_leaves)
    out = _build(template, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); the result keeps ``tree``'s structure."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    for o in others:
        if len(o) != len(mine):
            raise ValueError(f"tree_map: {len(mine)} leaves against {len(o)}")
    return unflatten_like(tree, [fn(*xs) for xs in zip(mine, *others)])
