"""ZeRO-3 (fully sharded data parallelism) by hand over ``parallel/comm.py``:
the runtime half of what GSPMD does for the JAX package's sharded
trainers (``self_forcing_tpu/parallel/mesh.py``, ``train.py``).

A :class:`ShardedParams` holds this rank's slice of every leaf of a
parameter tree, laid out by a tree of ``mesh.Spec`` (the dimension a
leaf is split on and the mesh axes that split it; None: replicated):

- the forwards read it through :meth:`ShardedParams.view`, a read-only
  mapping with the tree's keys: the non-block leaves (patch / text /
  time embeddings, the head: ~2% of a Wan DiT) are all-gathered
  together, in one collective, where a function first reads one, and
  kept by the view (one step's: once with autograd, once without), and
  ``dit.split_layers`` of its ``blocks`` returns per-layer views that a
  block gathers whole as it starts (:meth:`_View.materialize`: one
  collective of the layer's flattened slices a dtype), inside the
  block, so a remat'd layer (``torch.utils.checkpoint``) frees its
  gathered weights and gathers them again in the backward;
- under autograd the gather's backward reduce-scatters: each rank's
  slice receives the sum over its shard group of the gradient of the
  whole leaf; :meth:`ShardedParams.reduce_grads` then sums it over the
  ranks that hold the same slice (the "dp" replicas: hybrid sharding)
  and divides by the ranks of the mesh, and all-reduces the replicated
  leaves' gradients the same way.  Each rank's loss is its share of the
  global loss (its batch rows' mean; a batch too small to split is
  computed whole on every rank), so the result is the rank's slice of
  the one-process gradient of the global loss;
- the optimizer's moments and the EMA are trees of the slices; the
  global norm sums each split leaf's squares over its shard group
  (:meth:`ShardedParams.global_norm`); :meth:`ShardedParams.full`
  gathers any tree of this layout (the weights, the EMA, the moments)
  for a checkpoint, and :meth:`ShardedParams.shard_like` cuts a full tree
  back to this rank's slices.

:class:`ShardedCache` is the training rollout's cache constraint
(``mesh.rollout_cache_constraint``).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from self_forcing_tpu_torch.parallel import comm
from self_forcing_tpu_torch.parallel import mesh as mesh_mod
from self_forcing_tpu_torch.utils import tree

AXES = mesh_mod.AXES


def _items(node, specs, path=()):
    """(path, leaf, spec) of every leaf, in ``tree.items`` order."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _items(v, specs[k], path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _items(v, specs[i], path + (i,))
    else:
        yield path, node, specs


def _build(node, specs, fn):
    if isinstance(node, dict):
        return {k: _build(v, specs[k], fn) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_build(v, sp, fn) for v, sp in zip(node, specs)]
    return fn(node, specs)


class ShardedParams:
    """This rank's slices of a parameter tree over ``mesh`` (see the
    module's docstring).  ``shards``: the tree of slices (the leaves an
    optimizer trains); ``specs``: the tree of ``mesh.Spec`` / None."""

    def __init__(self, shards: dict, specs: dict, mesh):
        self.shards, self.specs, self.mesh = shards, specs, mesh
        self.world = mesh_mod.axes_size(mesh, AXES)
        self._groups = {}
        for _, _, sp in _items(shards, specs):
            if sp is not None:
                self._group(sp.axes)

    # ---------------------------------------------------------- layout
    def _group(self, axes):
        """(group, index, count) over ``axes`` (made collectively the
        first time)."""
        if axes not in self._groups:
            count = mesh_mod.axes_size(self.mesh, axes)
            group = mesh_mod.axes_group(self.mesh, axes) if count > 1 \
                else None
            self._groups[axes] = (group, mesh_mod.axes_index(self.mesh, axes),
                                  count)
        return self._groups[axes]

    def _slice(self, t: torch.Tensor, sp) -> torch.Tensor:
        if sp is None:
            return t
        _, idx, count = self._group(sp.axes)
        return t.detach().chunk(count, sp.dim)[idx].clone()

    @classmethod
    def from_full(cls, params: dict, specs: dict, mesh) -> "ShardedParams":
        """The slices of a full tree (every rank holding the same values)
        by ``specs``; replicated leaves are kept as they are."""
        out = cls({}, specs, mesh)
        out.shards = _build(params, specs, out._slice)
        return out

    def shard_like(self, full: dict) -> dict:
        """A full tree of this layout (e.g. a restored checkpoint) cut to
        this rank's slices."""
        return _build(full, self.specs, self._slice)

    def leaves(self) -> list[torch.Tensor]:
        return tree.leaves(self.shards)

    def spec_list(self) -> list:
        return [sp for _, _, sp in _items(self.shards, self.specs)]

    def nbytes(self, shards=None) -> int:
        """Bytes of this rank's slices (of ``shards``, a tree of this
        layout, when given)."""
        return sum(t.numel() * t.element_size()
                   for t in tree.leaves(self.shards if shards is None
                                        else shards)
                   if isinstance(t, torch.Tensor))

    # --------------------------------------------------------- gathers
    def gather_leaf(self, t: torch.Tensor, sp) -> torch.Tensor:
        """The whole leaf of this rank's slice ``t`` (autograd-aware)."""
        if sp is None:
            return t
        group, _, _ = self._group(sp.axes)
        return comm.gather(t, group, sp.dim)

    @torch.no_grad()
    def full(self, shards=None) -> dict:
        """The whole tree of this rank's slices (or of ``shards``, a tree
        of the same layout: an EMA), gathered on every rank (a
        collective)."""
        src = self.shards if shards is None else shards
        return _build(src, self.specs,
                      lambda t, sp: self.gather_leaf(t.detach(), sp)
                      .clone() if sp is not None else t.detach().clone())

    def full_list(self, leaves: list) -> list:
        """:meth:`full` of a list of leaves in this tree's order (an
        optimizer's moments; None entries stay None)."""
        return [None if t is None else
                (self.gather_leaf(t.detach(), sp).clone()
                 if sp is not None else t.detach().clone())
                for t, sp in zip(leaves, self.spec_list())]

    def slice_list(self, leaves: list) -> list:
        """The inverse of :meth:`full_list`."""
        return [None if t is None else self._slice(t, sp)
                for t, sp in zip(leaves, self.spec_list())]

    def view(self, detached: bool = False) -> "_View":
        """The read-only mapping the forwards take (see the module's
        docstring); ``detached``: the gathered leaves carry no
        gradient.  Take a new view each step: it keeps the non-block
        leaves it gathered."""
        return _View(self, self.shards, self.specs, False, detached, {})

    def _gather_leaves(self, found: list, detached: bool) -> list:
        """The whole tensors of [(path, slice, spec)]: the split ones
        gathered in one collective for each (axes, dtype) they share."""
        values = [t.detach() if detached else t for _, t, _ in found]
        groups: dict = {}
        for i, (_, t, sp) in enumerate(found):
            if sp is not None:
                groups.setdefault((sp.axes, t.dtype), []).append(i)
        for (axes, _), idx in groups.items():
            group, _, _ = self._group(axes)
            whole = comm.gather_layer([values[i] for i in idx], group,
                                      [found[i][2].dim for i in idx])
            for i, w in zip(idx, whole):
                values[i] = w
        return values

    # ------------------------------------------------------- gradients
    @torch.no_grad()
    def reduce_grads(self, grads) -> list[torch.Tensor]:
        """The gradients of :meth:`leaves` (None: zero) made this rank's
        slice of the mesh-wide mean: split leaves (already summed over
        their shard group by the gather's backward) summed over the other
        axes, replicated ones over the whole mesh, then all divided by
        the mesh's ranks.  Each reduction is one all-reduce of the
        flattened gradients of the leaves that share it."""
        out = [torch.zeros_like(p) if g is None else g
               for p, g in zip(self.leaves(), grads)]
        buckets: dict = {}
        for i, sp in enumerate(self.spec_list()):
            rest = AXES if sp is None else tuple(a for a in AXES
                                                 if a not in sp.axes)
            buckets.setdefault(rest, []).append(i)
        for rest, idx in buckets.items():
            if mesh_mod.axes_size(self.mesh, rest) > 1:
                group = mesh_mod.axes_group(self.mesh, rest)
                flat = torch.cat([out[i].reshape(-1).float() for i in idx])
                comm.all_reduce(flat, group)
                for i, piece in zip(idx, flat.split(
                        [out[i].numel() for i in idx])):
                    out[i] = piece.view_as(out[i]).to(out[i].dtype)
        if self.world > 1:
            out = [g / self.world for g in out]
        return out

    @torch.no_grad()
    def global_norm(self, grads, index=None) -> torch.Tensor:
        """sqrt of the sum of squares of the whole tree's gradients
        (float32), from this rank's slices: each split leaf's squares
        summed over its shard group, a replicated leaf counted once.
        ``index``: the leaves to count (all by default)."""
        specs = self.spec_list()
        index = range(len(specs)) if index is None else index
        parts: dict = {}
        for i in index:
            sp = specs[i]
            key = None if sp is None else sp.axes
            sq = grads[i].float().pow(2).sum()
            parts[key] = parts.get(key, 0) + sq
        total = torch.zeros((), device=self.leaves()[0].device)
        for key, sq in parts.items():
            sq = torch.as_tensor(sq, device=total.device).clone()
            if key is not None:
                group, _, count = self._group(key)
                if count > 1:
                    comm.all_reduce(sq, group)
            total = total + sq
        return torch.sqrt(total)


class _View(Mapping):
    """A read-only, lazily gathering mapping over a :class:`ShardedParams`
    subtree; ``stacked``: a subtree of the stacked ``blocks``, which
    ``dit.split_layers`` takes apart with :meth:`layers`."""

    __slots__ = ("_owner", "_shards", "_specs", "_stacked", "_detached",
                 "_cache", "_path")

    def __init__(self, owner, shards, specs, stacked, detached,
                 cache=None, path=()):
        self._owner, self._shards, self._specs = owner, shards, specs
        self._stacked, self._detached = stacked, detached
        # the root view's non-block leaves, once gathered: {autograd: {path:
        # tensor}}, shared by its non-block subviews (None in a layer view)
        self._cache, self._path = cache, path

    def __getitem__(self, k):
        v, sp = self._shards[k], self._specs[k]
        if isinstance(v, (dict, list)):
            stacked = self._stacked or k == "blocks"
            return _View(self._owner, v, sp, stacked, self._detached,
                         None if stacked else self._cache,
                         self._path + (k,))
        if sp is None:
            return v.detach() if self._detached else v
        if self._cache is not None and not self._stacked:
            return self._non_block()[self._path + (k,)]
        if self._detached:
            v = v.detach()
        return self._owner.gather_leaf(v, sp)

    def _non_block(self) -> dict:
        """{path: whole tensor} of the tree's non-block leaves, gathered
        together the first time in this autograd mode."""
        mode = torch.is_grad_enabled() and not self._detached
        if mode not in self._cache:
            o = self._owner
            found = [(p, t, sp) for p, t, sp in _items(o.shards, o.specs)
                     if p[0] != "blocks"]
            self._cache[mode] = dict(zip(
                [p for p, _, _ in found],
                o._gather_leaves(found, not mode)))
        return self._cache[mode]

    def __iter__(self):
        return iter(self._shards)

    def __len__(self):
        return len(self._shards)

    def __contains__(self, k):
        return k in self._shards

    def detached(self) -> "_View":
        return _View(self._owner, self._shards, self._specs, self._stacked,
                     True, self._cache, self._path)

    def materialize(self) -> dict:
        """The whole subtree as a plain dict, its split leaves gathered in
        one collective for each (axes, dtype) they share (autograd-aware:
        the backward reduce-scatters the flattened gradients once)."""
        if self._stacked:
            raise TypeError("materialize() of a block stack: take its "
                            "layers()")
        found = list(_items(self._shards, self._specs))
        values = self._owner._gather_leaves(found, self._detached)
        out: dict = {}
        for (path, _, _), v in zip(found, values):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v
        return out

    def layers(self) -> list["_View"]:
        """One view a layer of a stacked subtree: each slice unbound once
        (so the stacked gradient is assembled once), a layer's leaf split
        on the dimension after the layer axis.  A leaf split on the layer
        axis itself is gathered whole here."""
        if not self._stacked:
            raise TypeError("layers() of a tree that is not a block stack")
        per_shards, per_specs, n = {}, {}, None

        def walk(node, specs, dst, dst_specs):
            nonlocal n
            for k, v in node.items():
                sp = specs[k]
                if isinstance(v, dict):
                    dst[k], dst_specs[k] = {}, {}
                    walk(v, sp, dst[k], dst_specs[k])
                    continue
                if self._detached:
                    v = v.detach()
                if sp is not None and sp.dim == 0:
                    v, sp = self._owner.gather_leaf(v, sp), None
                dst[k] = v.unbind(0)
                dst_specs[k] = None if sp is None \
                    else mesh_mod.Spec(sp.dim - 1, sp.axes)
                n = len(dst[k])

        walk(self._shards, self._specs, per_shards, per_specs)

        def pick(node, i):
            return {k: pick(v, i) if isinstance(v, dict) else v[i]
                    for k, v in node.items()}
        return [_View(self._owner, pick(per_shards, i), per_specs, False,
                      self._detached) for i in range(n)]


def view(params):
    """``params.view()`` for a :class:`ShardedParams`, the tree itself
    otherwise."""
    return params.view() if isinstance(params, ShardedParams) else params


def is_main() -> bool:
    """Rank 0 of the world, or no process group."""
    d = torch.distributed
    return not d.is_initialized() or d.get_rank() == 0


# ------------------------------------------------------------------
# the training rollout's cache constraint
# ------------------------------------------------------------------

class _LayerSlice:
    """One layer of a sharded cache's k or v, all-gathered on demand
    (``dit._block_decode_fresh`` calls :meth:`gathered` inside the block,
    so a remat'd layer gathers it again in its backward).  The k and v
    of a layer share one collective: the first call gathers both and
    hands the other its half."""

    def __init__(self, pair: "_LayerPair", which: int):
        self.pair, self.which = pair, which

    def gathered(self) -> torch.Tensor:
        return self.pair.take(self.which)


class _LayerPair:
    def __init__(self, layout, k: torch.Tensor, v: torch.Tensor):
        self.layout, self.kv, self.got = layout, (k, v), [None, None]

    def take(self, which: int) -> torch.Tensor:
        if self.got[which] is None:
            lay = self.layout
            t = torch.stack(self.kv)            # [2, BN_loc, S_loc, D]
            if lay.s_group is not None:
                t = comm.gather_cat(t.contiguous(), lay.s_group, 2)
            if lay.bn_group is not None:
                t = comm.gather_cat(t.contiguous(), lay.bn_group, 1)
            self.got = [t[0].unsqueeze(0), t[1].unsqueeze(0)]
        out, self.got[which] = self.got[which], None
        return out


@dataclasses.dataclass
class _CacheLayout:
    bn: tuple            # (lo, hi) of B*N on this rank
    s: tuple             # (lo, hi) of S on this rank
    bn_group: object
    s_group: object

    def layer(self, cache, li: int):
        pair = _LayerPair(self, cache.k[li], cache.v[li])
        return _LayerSlice(pair, 0), _LayerSlice(pair, 1)

    @torch.no_grad()
    def write(self, cache, li: int, write_at: int, k_new, v_new) -> None:
        """Rows [write_at, write_at + L) of layer ``li`` where they fall
        in this rank's slice."""
        L = k_new.shape[1]
        lo, hi = max(write_at, self.s[0]), min(write_at + L, self.s[1])
        if lo >= hi:
            return
        b0, b1 = self.bn
        s0 = self.s[0]
        cache.k[li, :, lo - s0:hi - s0] = \
            k_new[b0:b1, lo - write_at:hi - write_at]
        cache.v[li, :, lo - s0:hi - s0] = \
            v_new[b0:b1, lo - write_at:hi - write_at]


class ShardedCache:
    """The rollout's KV-cache constraint over ``mesh``: :meth:`constrain`
    turns a whole (zeroed) folded [L, B*N, S, D] cache into this rank's
    slice, B*N over ("dp", "sp") or "dp" and S over "fsdp" where the sizes
    divide (``mesh.cache_specs``); a cache that nothing splits comes back
    as it is.  ``batch_axes``: the axes that split the batch, which the
    cache is not sliced over (``mesh.cache_specs``)."""

    def __init__(self, mesh, batch_axes: tuple = ()):
        self.mesh, self.batch_axes = mesh, batch_axes

    def _split(self, axes, size):
        if axes is None or mesh_mod.axes_size(self.mesh, axes) == 1:
            return (0, size), None
        n = mesh_mod.axes_size(self.mesh, axes)
        i = mesh_mod.axes_index(self.mesh, axes)
        return (i * size // n, (i + 1) * size // n), \
            mesh_mod.axes_group(self.mesh, axes)

    def constrain(self, cache):
        if cache.shard is not None:
            return cache
        _, BN, S, _ = cache.k.shape
        bn_axes, s_axes = mesh_mod.cache_specs(self.mesh, cache.k.shape,
                                               self.batch_axes)
        bn, bn_group = self._split(bn_axes, BN)
        s, s_group = self._split(s_axes, S)
        if bn_group is None and s_group is None:
            return cache
        layout = _CacheLayout(bn, s, bn_group, s_group)
        cut = (slice(None), slice(*bn), slice(*s))
        return dataclasses.replace(cache, k=cache.k[cut].clone(),
                                   v=cache.v[cut].clone(), shard=layout)
