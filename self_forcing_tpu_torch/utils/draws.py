"""The trainers' random draws, for one process or for a batch split over
ranks: a :class:`SplitGenerator` draws every number for the whole batch
from its ``torch.Generator`` (the same seed on every rank) and keeps this
rank's rows, so a sharded step sees the one-process step's numbers."""
from __future__ import annotations

import torch


class SplitGenerator:
    """``generator``'s draws for the global batch, cut to the rows of
    ``split`` (a ``parallel.mesh.DataSharding``); the batch is the leading
    dimension of every draw."""

    def __init__(self, generator: torch.Generator, split):
        self.generator, self.split = generator, split

    def _whole(self, shape) -> tuple:
        return (shape[0] * self.split.count,) + tuple(shape[1:])


def split_generator(generator: torch.Generator, split):
    """``generator`` itself when nothing splits the batch, else a
    :class:`SplitGenerator`."""
    if split is None or split.count == 1:
        return generator
    return SplitGenerator(generator, split)


def randn(shape, generator, device, dtype=torch.float32) -> torch.Tensor:
    """``torch.randn`` of ``shape`` (this rank's rows under a
    :class:`SplitGenerator`)."""
    if isinstance(generator, SplitGenerator):
        return generator.split.slice(torch.randn(
            generator._whole(shape), generator=generator.generator,
            device=device, dtype=dtype))
    return torch.randn(tuple(shape), generator=generator, device=device,
                       dtype=dtype)


def randint(low: int, high: int, shape, generator, device) -> torch.Tensor:
    """``torch.randint`` of ``shape`` (this rank's rows under a
    :class:`SplitGenerator`)."""
    if isinstance(generator, SplitGenerator):
        return generator.split.slice(torch.randint(
            low, high, generator._whole(shape),
            generator=generator.generator, device=device))
    return torch.randint(low, high, tuple(shape), generator=generator,
                         device=device)
