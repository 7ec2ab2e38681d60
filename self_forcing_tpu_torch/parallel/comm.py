"""The collectives of tensor and sequence parallelism, chosen by the
group's backend.

NCCL takes CUDA tensors as they are.  A gloo group (the CPU, and several
ranks sharing one card, which NCCL refuses) reduces and sends host
tensors: a CUDA tensor is staged through a pinned host copy.  Which way a
call goes follows from the backend and the tensor's device alone; no
path falls back to another.

``CLOCK`` keeps the host-clock milliseconds and the count of the calls
made while it is on (off by default: then it costs one attribute test).
Timing synchronises the card first, so that a staged copy's wait for
the work queued before it is not counted as the collective's."""
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
    device."""
    t0 = CLOCK.start(t)
    staged = _staged(t, group)
    src = _host(t) if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    if staged:
        out = [o.to(t.device) for o in out]
    CLOCK.stop(t, t0)
    return out
