"""Nested-dict helpers: the port's models and caches are plain dicts of
tensors (a language model's layered trees lists of per-layer dicts),
walked in sorted key order (the reference's tree order, which fixes the
packed layout)."""
from __future__ import annotations


def tree_map(fn, *trees):
    """Apply ``fn`` leaf by leaf over nested dicts (and lists, as a
    language model's per-layer ``blocks``) of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, list):
        return [tree_map(fn, *(t[i] for t in trees))
                for i in range(len(first))]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in sorted key order (a list, as the
    per-layer ``blocks``, in its own order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves):
    """Inverse of :func:`tree_leaves`: a nested dict shaped like ``like``
    holding ``leaves`` in sorted key order."""
    return _build(like, iter(leaves))


def _build(node, it):
    # a module-level recursion: a self-referencing closure would form a
    # reference cycle that keeps every leaf alive until the next garbage
    # collection (on the card, gigabytes of stale gradients)
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_build(t, it) for t in node]
    return next(it)
