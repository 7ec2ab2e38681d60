"""The ``("dp", "fsdp", "sp")`` device mesh and the layouts of parameters,
batches and the training rollout's KV cache over it (port of
``self_forcing_tpu/parallel/mesh.py``).

One process a device; the world's ranks are laid out dp-major, sp
innermost, so that an sp group is a run of consecutive ranks and so is a
("fsdp", "sp") group.  Where the JAX package hands GSPMD a
``PartitionSpec``, the port keeps plain data: a leaf's :class:`Spec` is
the dimension it is split on and the mesh axes that split it, or None
(replicated); ``parallel/fsdp.py`` runs that layout (each rank holds its
slice, the all-gathers and reduce-scatters are made by hand).  A
"mesh" argument is a ``DeviceMesh`` from :func:`create_mesh`, or (for
the layout functions, which need only the axes' sizes) a mapping of axis
names to sizes.

Reference strategies, as in the JAX package: FULL_SHARD / ZeRO-3 =
parameters split over "fsdp"; HYBRID_SHARD ('hybrid_full') = split over
"fsdp", replicated over "dp"; the DistributedSampler = the batch split
over dp x fsdp (:func:`data_sharding`).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "sp")


def create_mesh(fsdp: int | None = None, dp: int = 1, sp: int = 1,
                device_type: str = "cuda"):
    """The ``("dp", "fsdp", "sp")`` ``DeviceMesh`` over the initialised
    world (``fsdp`` defaults to what dp and sp leave).  Every rank calls
    it."""
    from torch.distributed.device_mesh import DeviceMesh
    n = dist.get_world_size()
    if fsdp is None:
        fsdp = n // (dp * sp)
    if dp * fsdp * sp != n:
        raise ValueError(f"dp {dp} x fsdp {fsdp} x sp {sp} != world {n}")
    return DeviceMesh(device_type, torch.arange(n).reshape(dp, fsdp, sp),
                      mesh_dim_names=AXES)


@dataclasses.dataclass(frozen=True)
class Spec:
    """A leaf split into ``prod(sizes of axes)`` equal chunks along
    ``dim``; the chunk a rank holds is its index over ``axes`` (the first
    axis major), as a ``PartitionSpec`` entry of a tuple of axes means.
    (A tree leaf, not a tuple, so that ``utils/tree.py`` walks past it.)"""
    dim: int
    axes: tuple


def mesh_shape(mesh) -> dict:
    """{axis: size} of a ``DeviceMesh`` or a mapping of sizes."""
    if isinstance(mesh, Mapping):
        return {a: int(mesh.get(a, 1)) for a in AXES} | dict(mesh)
    return {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names)}


def axes_size(mesh, axes) -> int:
    shape = mesh_shape(mesh)
    return int(np.prod([shape[a] for a in _tuple(axes)]))


def axes_index(mesh, axes) -> int:
    """This rank's index over ``axes`` (the first axis major)."""
    shape, idx = mesh_shape(mesh), 0
    for a in _tuple(axes):
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def axes_group(mesh, axes):
    """The process group of this rank's peers over ``axes`` (the ranks
    that differ from it only there), in index order.  A single axis is
    the mesh's own group; a combination is made with ``new_group`` the
    first time (collectively: every rank of the world must ask for the
    same combinations in the same order) and kept on the mesh."""
    axes = _tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    groups = mesh.__dict__.setdefault("_axes_groups", {})
    if axes not in groups:
        names = list(mesh.mesh_dim_names)
        ranks = mesh.mesh.numpy() if hasattr(mesh.mesh, "numpy") \
            else np.asarray(mesh.mesh)
        order = [names.index(a) for a in names if a not in axes] \
            + [names.index(a) for a in axes]
        keep = int(np.prod([ranks.shape[names.index(a)] for a in axes]))
        mine = None
        for row in np.transpose(ranks, order).reshape(-1, keep):
            g = dist.new_group([int(r) for r in row])
            if dist.get_rank() in row:
                mine = g
        groups[axes] = mine
    return groups[axes]


def _tuple(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _leaf_spec(shape, axes, axis_size: int, min_size: int) -> Spec | None:
    """The largest dimension of ``shape`` that ``axis_size`` divides, split
    over ``axes``; None (replicated) for a leaf of fewer than ``min_size``
    elements or with no such dimension (FSDP's size-based auto-wrap
    policy)."""
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) < min_size:
        return None
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[i] % axis_size == 0 and shape[i] >= axis_size:
            return Spec(i, _tuple(axes))
    return None


def _specs(params, axes, size: int, min_size: int):
    """The layout rule of :func:`fsdp_shardings` over ``axes`` of
    ``size`` ranks: ``modulation`` leaves replicated whatever their size;
    a 2-D ``time_projection`` split on its input dimension (its output
    dimension would split the [B, F, 6, D] reshape of e0); every other
    leaf by :func:`_leaf_spec`."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        ps = _path_str(path)
        if "modulation" in ps:
            return None
        shape = tuple(node.shape)
        if ("time_projection" in ps and len(shape) == 2
                and int(np.prod(shape)) >= min_size
                and shape[0] % size == 0):
            return Spec(0, _tuple(axes))
        return _leaf_spec(shape, axes, size, min_size)
    return walk(params, ())


def fsdp_shardings(params, mesh, axis: str = "fsdp",
                   min_size: int = 2 ** 16):
    """Every leaf's :class:`Spec` (or None) for FSDP-style sharding over
    ``axis``: the tree of the JAX package's ``NamedSharding``s, as plain
    data.  ``params`` may hold tensors on the ``meta`` device."""
    return _specs(params, (axis,), axes_size(mesh, axis), min_size)


def combined_fsdp_specs(params, mesh, axes=("fsdp", "sp"),
                        min_size: int = 2 ** 16):
    """:func:`fsdp_shardings`' rule over the COMBINED axes: every large
    leaf's largest divisible dimension split over ``prod(axes)`` ranks
    (the student and optimizer state at 14B-teacher scale, and the
    ZeRO-3-over-sp teacher of ``sequence.forward_train_sp``)."""
    return _specs(params, _tuple(axes), axes_size(mesh, axes), min_size)


def spec_component(specs, axis: str):
    """A spec tree projected onto one mesh axis: a leaf split over
    ``axis`` (alone or among others) keeps ``Spec(dim, (axis,))``, any
    other becomes None."""
    def one(sp):
        if isinstance(sp, dict):
            return {k: one(v) for k, v in sp.items()}
        if isinstance(sp, list):
            return [one(v) for v in sp]
        if sp is None or axis not in sp.axes:
            return None
        return Spec(sp.dim, (axis,))
    return one(specs)


def shard_params(params, mesh, axis: str = "fsdp", min_size: int = 2 ** 16,
                 specs=None):
    """This rank's slice of every leaf under :func:`fsdp_shardings` (or
    the given ``specs``), as a ``fsdp.ShardedParams`` that the trainers,
    the optimizer and the forwards take."""
    from self_forcing_tpu_torch.parallel import fsdp
    if specs is None:
        specs = fsdp_shardings(params, mesh, axis, min_size)
    return fsdp.ShardedParams.from_full(params, specs, mesh)


def replicate(tree, mesh):
    """Every rank's tree made rank 0's (a broadcast of each tensor leaf
    over the mesh), in place; returns the tree."""
    from self_forcing_tpu_torch.parallel import comm
    from self_forcing_tpu_torch.utils import tree as tree_mod
    group = axes_group(mesh, AXES)
    for t in tree_mod.leaves(tree):
        if isinstance(t, torch.Tensor):
            with torch.no_grad():
                comm.broadcast(t, group)
    return tree


class DataSharding:
    """Which ranks split a batch's leading dimension: this rank holds
    rows ``[index * n, (index + 1) * n)`` of a batch of ``count * n``,
    its peers in ``group``.  ``count`` 1 is a batch every rank holds
    whole."""

    def __init__(self, axes: tuple, index: int, count: int, group):
        self.axes, self.index, self.count, self.group = axes, index, count, group

    def slice(self, t):
        """This rank's rows of a global batch tensor or array."""
        if self.count == 1:
            return t
        n = t.shape[0] // self.count
        return t[self.index * n:(self.index + 1) * n]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks that split the batch (a copy)."""
        from self_forcing_tpu_torch.parallel import comm
        t = t.detach().clone()
        return t if self.count == 1 else comm.all_reduce(t, self.group)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        return self.sum(t) / self.count

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' rows of ``t`` concatenated in batch order."""
        from self_forcing_tpu_torch.parallel import comm
        if self.count == 1:
            return t
        return torch.cat(comm.all_gather(t.detach().contiguous(),
                                         self.group))


def data_sharding(mesh, *batch_axes: str) -> DataSharding:
    """The split of a batch's leading dimension over ``batch_axes``
    (default dp x fsdp: the DistributedSampler's), the counterpart of the
    JAX package's ``NamedSharding(mesh, P(axes))``."""
    axes = tuple(batch_axes) or ("dp", "fsdp")
    if len(axes) == 1 and isinstance(axes[0], tuple):
        axes = axes[0]
    count = axes_size(mesh, axes)
    group = axes_group(mesh, axes) if count > 1 else None
    return DataSharding(axes, axes_index(mesh, axes), count, group)


def batch_sharding(mesh, batch: int) -> DataSharding:
    """The split the trainers give a batch of ``batch`` rows: over dp x
    fsdp where it divides, else over dp, else none (``train.shard_batch``'s
    rule)."""
    shape = mesh_shape(mesh)
    if batch % (shape["dp"] * shape["fsdp"]) == 0:
        return data_sharding(mesh, "dp", "fsdp")
    if batch % shape["dp"] == 0:
        return data_sharding(mesh, "dp")
    return DataSharding((), 0, 1, None)


def _axes_for(shape: dict, size: int, *cands):
    for axes in cands:
        if size % int(np.prod([shape[a] for a in axes])) == 0:
            return axes
    return None


def cache_specs(mesh, cache_shape, batch_axes=()) -> tuple:
    """The layout :func:`rollout_cache_constraint` gives a rank's folded
    [L, B*N, S, D] cache: (axes of B*N, axes of S), each None when no
    candidate divides: B*N over ("dp", "sp") or "dp", S over "fsdp" (the
    JAX package's rule), less the ``batch_axes`` that split the batch:
    ranks that differ there hold other batch rows, so only the ranks
    that repeat this rank's rows can share its cache."""
    shape = mesh_shape(mesh)
    _, BN, S, _ = cache_shape

    def cands(*options):
        out = []
        for axes in options:
            axes = tuple(a for a in axes if a not in batch_axes)
            if axes and axes not in out:
                out.append(axes)
        return out
    return (_axes_for(shape, BN, *cands(("dp", "sp"), ("dp",))),
            _axes_for(shape, S, *cands(("fsdp",))))


def rollout_cache_constraint(mesh, batch_axes=()):
    """The activation-sharding hook of the training rollout's KV cache
    (``pipelines/self_forcing_training.py``'s ``act_shard``): the cache the
    with-grad rollout keeps for the decode backward is held sharded, B*N
    over ("dp", "sp") and S over "fsdp" (per dimension falling back to
    fewer axes, or none, where a size does not divide), leaving out the
    ``batch_axes`` that split the step's batch (:func:`cache_specs`).
    Each layer's forward all-gathers its layer; the decode backward
    re-gathers it from the slices.  Values are unchanged.  Returns a
    callable KVCache -> KVCache (``fsdp.ShardedCache.constrain``)."""
    from self_forcing_tpu_torch.parallel import fsdp
    return fsdp.ShardedCache(mesh, tuple(batch_axes)).constrain
