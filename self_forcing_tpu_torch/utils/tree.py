"""Nested-dict parameter trees: the leaves in a fixed order, and their
paths (the port keeps the JAX package's key layout); one layer of a
stacked block tree, and the stacking of per-layer trees."""
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


def detached(tree):
    """The same tree with every tensor leaf detached from autograd (views,
    no copies): parameters a loss reads but does not train.  A ZeRO-3
    view (``parallel/fsdp.py``) returns its detached view."""
    if hasattr(tree, "detached"):
        return tree.detached()
    return map_tree(lambda t: t.detach(), tree)


def index(tree, i: int):
    """The same tree with every tensor leaf replaced by ``leaf[i]`` (one
    layer of a stacked block tree: views, no copies)."""
    return map_tree(lambda t: t[i], tree)


def _sibling_views(node: dict) -> dict:
    """{key: sibling key} of the tensor leaves of ``node`` that are views
    of a contiguous sibling leaf (W8A8's ``w_qa``, the transposed view of
    ``w_qa_t``)."""
    owners = {id(v): k for k, v in node.items()
              if isinstance(v, torch.Tensor) and v._base is None
              and v.is_contiguous()}
    return {k: owners[id(v._base)] for k, v in node.items()
            if isinstance(v, torch.Tensor) and v._base is not None
            and id(v._base) in owners}


def _alloc(node, n: int):
    if not isinstance(node, dict):
        return node.new_empty((n, *node.shape))
    views = _sibling_views(node)
    out = {k: _alloc(v, n) for k, v in node.items() if k not in views}
    for k, owner in views.items():
        # the same view of the stacked owner, one layer a stride(0) apart
        v, base, dst = node[k], node[owner], out[owner]
        out[k] = dst.as_strided((n, *v.shape), (dst.stride(0), *v.stride()),
                                v.storage_offset() - base.storage_offset())
    return {k: out[k] for k in node}


def _put(dst: dict, node: dict, i: int) -> None:
    for k, v in dst.items():
        if isinstance(v, dict):
            _put(v, node[k], i)
        elif v._base is None:      # a view is filled through its owner
            v[i].copy_(node[k])


def stack(trees, n: int):
    """Stack ``n`` trees of one structure (any iterable, consumed one at
    a time) on a new axis 0.  The stacked leaves are allocated at the
    first tree, and each tree is copied in and dropped before the next is
    drawn, so a generator of trees never has two whole stacks alive.  A
    leaf that is a view of a sibling leaf stays that view of the stacked
    sibling."""
    out, count = None, 0
    for i, t in enumerate(trees):
        if out is None:
            out = _alloc(t, n)
        _put(out, t, i)
        count = i + 1
        del t
    if count != n:
        raise ValueError(f"stack: {count} trees, expected {n}")
    return out
