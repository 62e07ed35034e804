"""Nested dict / list / tuple trees of tensors, walked in the reference's
order: jax flattens a dict by its sorted keys, so leaf order (the global
norm's sum, a checkpoint's manifest) follows sorted keys here too; a
rebuilt tree keeps its dicts' own key order."""
from __future__ import annotations


def items(tree, path: tuple = ()):
    """(path, leaf) pairs in jax's leaf order; a path is the tuple of
    dict keys and sequence indices down to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, path + (i,))
    else:
        yield path, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn, tree):
    """``fn`` over every leaf; returns a tree like ``tree``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def unflatten(like, values):
    """A tree shaped like ``like`` whose leaves are ``values``, given in
    jax's leaf order (``items``)."""
    by_path = dict(zip((p for p, _ in items(like)), values))

    def build(t, path=()):
        if isinstance(t, dict):
            return {k: build(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v, path + (i,)) for i, v in enumerate(t))
        return by_path[path]
    return build(like)
