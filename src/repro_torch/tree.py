"""The port's trees in JAX's flatten order.

The optimizer's moments, the compression residual and the checkpoint's
leaf files all follow the parameters' leaves, in the order
``jax.tree.flatten`` gives the reference's trees: a mapping's values by
sorted key, a tuple's (a NamedTuple's fields too) and a list's in order,
``None`` holding no leaf.  A :class:`~repro_torch.models.layers.Params`
is the mapping of its parameters and sub-trees by sorted name, a
``ModuleList`` the tuple of its sub-trees.  So the port writes and reads
a checkpoint leaf for leaf with the reference's ``CheckpointStore``.
"""
from __future__ import annotations

from typing import Any, List, Mapping

import torch
from torch import nn


def children(tree) -> list:
    """(key, child) pairs of a node, in flatten order; None for a leaf."""
    if isinstance(tree, nn.ModuleList):
        return list(enumerate(tree))
    if isinstance(tree, nn.Module):
        kids = {**tree._parameters, **tree._modules}
        return [(k, kids[k]) for k in sorted(kids)]
    if isinstance(tree, Mapping):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    kids = children(tree)
    if kids is None:
        return [tree]
    return [x for _, child in kids for x in leaves(child)]


def unflatten(like, new: List[torch.Tensor]) -> Any:
    """A tree shaped as ``like`` holding ``new`` (in :func:`leaves`'
    order).  A ``Params`` comes back as a new ``Params`` whose leaves take
    a gradient if ``like``'s do."""
    from repro_torch.models.layers import Params
    it = iter(new)

    def build(node):
        if node is None:
            return None
        kids = children(node)
        if kids is None:
            return next(it)
        if isinstance(node, Params):
            grad = any(p.requires_grad for p in node.parameters())
            return Params({k: plain(c) for k, c in kids}).requires_grad_(
                grad)
        return rebuild(node, kids)

    def plain(node):
        """A Params sub-tree as the mappings and tuples Params takes."""
        kids = children(node)
        if kids is None:
            return next(it)
        if isinstance(node, nn.ModuleList):
            return tuple(plain(c) for _, c in kids)
        return {k: plain(c) for k, c in kids}

    def rebuild(node, kids):
        vals = [build(c) for _, c in kids]
        if isinstance(node, Mapping):
            return dict(zip((k for k, _ in kids), vals))
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*vals)
        return type(node)(vals)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def paths(tree, prefix: tuple = ()) -> List[tuple]:
    """``(names, leaf)`` pairs in :func:`leaves`' order; ``names`` is the
    tuple of keys from the root as strings (a sequence index as its
    digits), as ``repro/launch/shardings.py`` ``_path_names`` reads a
    JAX key path."""
    if tree is None:
        return []
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [x for k, child in kids for x in paths(child, prefix + (str(k),))]


def map_with_path(fn, tree, prefix: tuple = ()) -> Any:
    """``fn(names, leaf)`` over every leaf, in a tree of plain dicts and
    tuples shaped as ``tree`` (a ``Params`` as the dict of its names)."""
    if tree is None:
        return None
    kids = children(tree)
    if kids is None:
        return fn(prefix, tree)
    vals = [map_with_path(fn, c, prefix + (str(k),)) for k, c in kids]
    if isinstance(tree, (Mapping, nn.Module)) and not isinstance(
            tree, nn.ModuleList):
        return dict(zip((k for k, _ in kids), vals))
    return tuple(vals)
