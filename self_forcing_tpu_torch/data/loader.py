"""Host-side data loading (port of ``self_forcing_tpu/data/loader.py``): a
per-process index shard and a background thread that collates batches
ahead of the trainer.

``DistributedSampler`` gives the JAX package's order for the same seed,
epoch and replica count: a numpy ``default_rng(seed + epoch)`` shuffle,
padded to a whole number of batches per replica by repeating the order
(as often as the pad needs), every ``num_replicas``-th index from
``rank``.  The replica count and rank come from ``torch.distributed``
when a process group exists, else 1 and 0.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch


class DistributedSampler:
    def __init__(self, dataset_len: int, num_replicas: int | None = None,
                 rank: int | None = None, shuffle: bool = True,
                 seed: int = 0):
        if num_replicas is None or rank is None:
            group = torch.distributed.is_available() \
                and torch.distributed.is_initialized()
            num_replicas = torch.distributed.get_world_size() if group else 1
            rank = torch.distributed.get_rank() if group else 0
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self.num_samples = -(-dataset_len // num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        idx = np.arange(self.dataset_len)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        pad = self.num_samples * self.num_replicas - len(idx)
        if pad:
            reps = np.tile(idx, -(-pad // max(len(idx), 1)))
            idx = np.concatenate([idx, reps[:pad]])
        return iter(idx[self.rank::self.num_replicas].tolist())

    def __len__(self) -> int:
        return self.num_samples


def default_collate(samples: list[dict]) -> dict:
    """Stack each key's values (numpy); strings and dicts stay lists."""
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if isinstance(vals[0], (str, dict)):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class DataLoader:
    """Iterates the sampler's indices and collates batches on a daemon
    thread, handing them over a bounded queue (``prefetch`` batches).  An
    exception in the thread is raised to the consumer; leaving the
    iteration early stops the thread."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[DistributedSampler] = None,
                 collate_fn: Callable = default_collate,
                 prefetch: int = 2, drop_last: bool = True,
                 infinite: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or DistributedSampler(
            len(dataset), num_replicas=1, rank=0)
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.infinite = infinite

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # wait for room, but give up once the consumer has left
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                epoch = self.sampler.epoch
                while not stop.is_set():
                    batch = []
                    for i in self.sampler:
                        batch.append(self.dataset[i])
                        if len(batch) == self.batch_size:
                            if not put(self.collate_fn(batch)):
                                return
                            batch = []
                    if batch and not self.drop_last:
                        if not put(self.collate_fn(batch)):
                            return
                    if not self.infinite:
                        break
                    epoch += 1
                    self.sampler.set_epoch(epoch)
                put(None)
            except Exception as e:  # noqa: BLE001 (handed to the consumer)
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join(timeout=5.0)
