"""Ranks started from one process: ``start`` runs a function in N fresh
processes joined into one ``torch.distributed`` group through a
``FileStore`` in a temporary directory (no port to pick); ``join`` waits
for all of them and fails if any of them failed.  ``torchrun`` is the
launcher of the CLI; this is for a program that starts its own ranks (a
smoke run, a test)."""
from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist


def _entry(rank: int, fn, world: int, backend: str, store: str,
           args: tuple) -> None:
    torch.set_num_threads(1)
    if torch.cuda.is_available():
        torch.cuda.set_device(0)   # the ranks share the process's card
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Processes started by :func:`start`."""

    def __init__(self, ctx, tmp: str):
        self._ctx, self._tmp = ctx, tmp

    def join(self) -> None:
        """Wait for every rank; raises if any of them raised or exited
        with another code than 0 (the others are then terminated)."""
        try:
            while not self._ctx.join():
                pass
        finally:
            shutil.rmtree(self._tmp, ignore_errors=True)


def start(fn, world: int, backend: str, *args) -> Ranks:
    """Start ``fn(rank, world, *args)`` in ``world`` spawned processes,
    each with one torch thread, on cuda:0 where there is a card, in a
    ``backend`` process group of ``world`` ranks.  ``fn`` must be
    importable by name (a module-level function)."""
    d = tempfile.mkdtemp(prefix="ranks_")
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(fn, world, backend, os.path.join(d, "store"), args),
        nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, d)


def spawn(fn, world: int, backend: str, *args) -> None:
    """:func:`start`, then :meth:`Ranks.join`."""
    start(fn, world, backend, *args).join()
