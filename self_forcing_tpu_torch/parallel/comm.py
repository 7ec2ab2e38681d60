"""The collectives of tensor, sequence and data parallelism (ZeRO-3),
chosen by the group's backend.

NCCL takes CUDA tensors as they are.  A gloo group (the CPU, and several
ranks sharing one card, which NCCL refuses) reduces and sends host
tensors: a CUDA tensor is staged through a pinned host copy.  Which way a
call goes follows from the backend and the tensor's device alone; no
path falls back to another.

``CLOCK`` keeps the host-clock milliseconds and the count of the calls
made while it is on (off by default: then it costs one attribute test).
Timing synchronises the card first, so that a staged copy's wait for
the work queued before it is not counted as the collective's.

The autograd-aware collectives (:func:`gather`, :func:`reduce_from`,
:func:`copy_to`, :func:`all_reduce_both`) are ``torch.autograd.Function``s:
the ZeRO-3 parameter gather whose backward reduce-scatters, and the
tensor-parallel all-reduces with their Megatron backward rules.  A group
of one rank makes no call."""
from __future__ import annotations

import time

import torch
import torch.distributed as dist


class CommClock:
    """Host-clock ms and count of the collectives since ``reset``."""

    def __init__(self):
        self.on = False
        self.reset()

    def reset(self) -> None:
        self.ms, self.calls = 0.0, 0

    def start(self, t: torch.Tensor) -> float | None:
        if not self.on:
            return None
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        return time.perf_counter()

    def stop(self, t: torch.Tensor, t0: float | None) -> None:
        if t0 is None:
            return
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.ms += (time.perf_counter() - t0) * 1e3
        self.calls += 1


CLOCK = CommClock()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _alone(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through a host copy: a CUDA tensor on a group
    whose backend is not NCCL."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``group`` ('sum' or 'max'), in place; returns
    ``t``."""
    t0 = CLOCK.start(t)
    if _staged(t, group):
        buf = _host(t)
        dist.all_reduce(buf, op=_OPS[op], group=group)
        t.copy_(buf)
    else:
        dist.all_reduce(t, op=_OPS[op], group=group)
    CLOCK.stop(t, t0)
    return t


def ring_pass(tensors: list[torch.Tensor], group) -> list[torch.Tensor]:
    """Each tensor sent to the next rank of ``group`` (rank r to r + 1,
    the last to 0) while the previous rank's arrives: returns the
    received tensors, shaped as the sent ones."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    t0 = CLOCK.start(tensors[0])
    staged = _staged(tensors[0], group)
    send = [_host(t) if staged else t.contiguous() for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = []
    for s, rv in zip(send, recv):
        ops += [dist.P2POp(dist.isend, s, nxt, group),
                dist.P2POp(dist.irecv, rv, prv, group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        recv = [rv.to(t.device) for rv, t in zip(recv, tensors)]
    CLOCK.stop(tensors[0], t0)
    return recv


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (all shaped alike), in rank order, on ``t``'s
    device.  NCCL runs ``all_gather``; a gloo group broadcasts each
    rank's ``t`` in turn into one host buffer (pinned for a CUDA tensor,
    copied to the card once): gloo's ``all_gather`` moves the same bytes
    several times slower (``scripts/gloo_gather_ab.py``)."""
    t0 = CLOCK.start(t)
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        src = t.contiguous()
        out = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=group)
    else:
        staged = t.is_cuda
        buf = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          pin_memory=staged)
        buf[dist.get_rank(group)].copy_(t)
        for r in range(n):
            dist.broadcast(buf[r], dist.get_global_rank(group, r),
                           group=group)
        out = list((buf.to(t.device) if staged else buf).unbind(0))
    CLOCK.stop(t, t0)
    return out


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` made the value of the group's rank ``src``, in place."""
    if _alone(group):
        return t
    t0 = CLOCK.start(t)
    root = dist.get_global_rank(group, src)
    if _staged(t, group):
        buf = _host(t)
        dist.broadcast(buf, root, group=group)
        t.copy_(buf)
    else:
        dist.broadcast(t, root, group=group)
    CLOCK.stop(t, t0)
    return t


def gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    if _alone(group):
        return t
    return torch.cat(all_gather(t, group), dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int,
                   op: str = "sum") -> torch.Tensor:
    """``t`` (the same shape on every rank) summed over ``group`` ('mean':
    averaged), and this rank's chunk of the sum along ``dim`` (``t``'s
    size there divided by the group's).  NCCL runs
    ``reduce_scatter_tensor``; a gloo group runs an all-reduce of the
    whole tensor and keeps the chunk: chosen by the backend, as every
    route here, not as a fallback (a gloo reduce-scatter is missing from
    some PyTorch builds, and this sums in one fixed order on every
    rank)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"reduce_scatter op {op!r}")
    if _alone(group):
        return t.clone()
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: size {t.shape[dim]} of dim {dim} "
                         f"is not a multiple of the group's {n} ranks")
    t0 = CLOCK.start(t)
    if dist.get_backend(group) == "nccl":
        src = t.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // n,) + src.shape[1:],
                          dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, src, group=group)
        out = out.movedim(0, dim)
    else:
        full = _host(t) if t.is_cuda else t.detach().clone()
        dist.all_reduce(full, group=group)
        out = full.chunk(n, dim)[r].to(t.device).contiguous()
    CLOCK.stop(t, t0)
    return out / n if op == "mean" else out


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; the backward reduce-scatters (sums) the
    gradient back to each rank's chunk."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_cat(t, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g.contiguous(), ctx.group, ctx.dim), None, None


def gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ZeRO-3 parameter gather: every rank's chunk concatenated along
    ``dim``.  Under autograd its backward hands each rank the SUM over the
    group of the gradients of the whole tensor, cut to its chunk (the
    caller divides by the ranks that split or repeat the batch)."""
    if _alone(group):
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _Gather.apply(t, group, dim)
    return gather_cat(t, group, dim)


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def _needs_rule(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


def reduce_from(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of the rank's partial ``t`` (a row-sharded
    product: Megatron's g).  Its output is replicated, and so is the
    gradient each rank gets for it: the backward is the identity."""
    if _alone(group):
        return t
    if _needs_rule(t):
        return _ReduceFrom.apply(t, group)
    return all_reduce(t.clone(), group)


def copy_to(t: torch.Tensor, group) -> torch.Tensor:
    """A replicated ``t`` entering the rank's column-sharded products
    (Megatron's f): the identity, whose backward sums the ranks' partial
    gradients (an all-reduce)."""
    if _alone(group) or not _needs_rule(t):
        return t
    return _CopyTo.apply(t, group)


def all_reduce_both(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of a per-rank partial statistic that every
    rank then uses for its own shard (the q / k RMS norm's sum of squares
    over the heads of all ranks): the backward sums the ranks'
    gradients too."""
    if _alone(group):
        return t
    if _needs_rule(t):
        return _AllReduceBoth.apply(t, group)
    return all_reduce(t.clone(), group)


def gather_many(tensors: list, group, dims: list) -> list:
    """Every rank's chunks of several tensors (one dtype), each
    concatenated along its own dim in rank order, in ONE all-gather of
    their flattened concatenation (a ZeRO-3 layer's leaves)."""
    if _alone(group):
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    rows = torch.stack(all_gather(flat, group))          # [n, total]
    n, out, at = rows.shape[0], [], 0
    for t, d in zip(tensors, dims):
        k = t.numel()
        out.append(torch.cat([rows[r, at:at + k].view(t.shape)
                              for r in range(n)], dim=d))
        at += k
    return out


def reduce_scatter_many(tensors: list, group, dims: list) -> list:
    """Each whole tensor (one dtype) summed over ``group`` and cut to
    this rank's chunk along its dim, in ONE collective of the flattened
    chunks (:func:`reduce_scatter` over rows, as each backend runs it)."""
    if _alone(group):
        return [t.clone() for t in tensors]
    n = dist.get_world_size(group)
    flat = torch.stack([torch.cat([t.chunk(n, d)[r].reshape(-1)
                                   for t, d in zip(tensors, dims)])
                        for r in range(n)])              # [n, total]
    mine = reduce_scatter(flat, group, 0)[0]
    out, at = [], 0
    for t, d in zip(tensors, dims):
        shape = list(t.shape)
        shape[d] //= n
        k = int(torch.Size(shape).numel())
        out.append(mine[at:at + k].view(shape))
        at += k
    return out


class _GatherMany(torch.autograd.Function):
    """:func:`gather_many`; the backward :func:`reduce_scatter_many`s the
    gradients (a missing one counts as zero)."""

    @staticmethod
    def forward(ctx, group, dims, *tensors):
        ctx.group, ctx.dims = group, dims
        outs = gather_many(list(tensors), group, list(dims))
        ctx.like = [(o.shape, o.dtype, o.device) for o in outs]
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        whole = [torch.zeros(shape, dtype=dtype, device=dev) if g is None
                 else g.contiguous()
                 for g, (shape, dtype, dev) in zip(grads, ctx.like)]
        return (None, None, *reduce_scatter_many(whole, ctx.group,
                                                 list(ctx.dims)))


def gather_layer(tensors: list, group, dims: list) -> list:
    """The autograd-aware :func:`gather_many`: under autograd (any of the
    tensors requiring grad) the backward hands each rank the SUM over the
    group of every whole tensor's gradient, cut to its chunk."""
    if _alone(group) or not tensors:
        return list(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return list(_GatherMany.apply(group, tuple(dims), *tensors))
    return gather_many(list(tensors), group, list(dims))
