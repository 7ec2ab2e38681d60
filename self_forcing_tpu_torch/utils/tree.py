"""Nested-dict parameter trees: the leaves in a fixed order, and their
paths (the port keeps the JAX package's key layout)."""
from __future__ import annotations

from typing import Iterator

import torch


def items(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """(path, leaf) of every leaf, dict keys in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from items(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [t for _, t in items(tree)]


def map_tree(fn, tree):
    """The same tree with every tensor leaf replaced by ``fn(leaf)``."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree
