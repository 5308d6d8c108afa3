"""Parameter and state trees: nested dicts, lists, tuples and dataclasses
of tensors.

The port's counterpart of the reference's pytree utilities, for the
trees the port builds (``models.params`` trees, ``optim.AdamWState``,
``train.TrainState``).  ``None`` is an empty subtree, as in JAX: it holds
no leaf and maps to itself.  A dataclass's children are its fields in
declaration order.
"""

from __future__ import annotations

import dataclasses


def _children(tree):
    """(kind, [(key, child), ...]) of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(k, v) for k, v in tree.items()]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(i, getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if isinstance(tree, tuple):
        return tuple(values)
    if isinstance(tree, list):
        return list(values)
    return dataclasses.replace(tree, **{
        f.name: v for f, v in zip(dataclasses.fields(tree), values)})


def leaves_with_path(tree, path=()):
    """Every leaf with its path of keys (dict keys, sequence indices,
    dataclass field indices), depth first in insertion order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for k, v in kids:
        out.extend(leaves_with_path(v, path + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_with_path(fn, tree, path=()):
    """The same structure with ``fn(path, leaf)`` at every leaf."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    return _rebuild(tree, [map_with_path(fn, v, path + (k,))
                           for k, v in kids])


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    flat_rest = [iter(leaves(r)) for r in rest]
    return map_with_path(lambda _, leaf: fn(leaf, *(next(r)
                                                      for r in flat_rest)),
                         tree)


def unflatten(template, values):
    """``template``'s structure with its leaves replaced, in order, by
    ``values``."""
    it = iter(values)
    return map_with_path(lambda _, __: next(it), template)
