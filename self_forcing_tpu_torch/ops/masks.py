"""Attention masks of the causal Wan DiT as index intervals (port of
``self_forcing_tpu/ops/masks.py``).

Each mask family is two ``[start, end)`` key intervals per query
position:

    visible(q, j) = (start1[q] <= j < end1[q]) or (start2[q] <= j < end2[q])

The arrays are numpy int32 ``[S]``, built on the host from the static
geometry; the flash attention's plain versions and its CUDA kernels read
them (the kernels through the device copies and tile tables of
``ops/cuda_attention.py``).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class IntervalMask:
    """Per-query visibility as the union of two [start, end) intervals."""

    start1: np.ndarray  # [S] i32
    end1: np.ndarray    # [S] i32
    start2: np.ndarray  # [S] i32
    end2: np.ndarray    # [S] i32

    @property
    def seq_len(self) -> int:
        return self.start1.shape[0]

    def visible(self, q_idx: np.ndarray, kv_idx: np.ndarray) -> np.ndarray:
        """Boolean visibility for broadcastable index arrays."""
        s1, e1 = self.start1[q_idx], self.end1[q_idx]
        s2, e2 = self.start2[q_idx], self.end2[q_idx]
        return (((kv_idx >= s1) & (kv_idx < e1))
                | ((kv_idx >= s2) & (kv_idx < e2)))

    def materialize(self) -> np.ndarray:
        """Full [S, S] bool mask, for tests and tiny geometries only."""
        q = np.arange(self.seq_len)[:, None]
        j = np.arange(self.seq_len)[None, :]
        return self.visible(q, j)


def _from_numpy(s1, e1, s2=None, e2=None) -> IntervalMask:
    z = np.zeros_like(s1) if s2 is None else s2
    z2 = np.zeros_like(e1) if e2 is None else e2
    return IntervalMask(
        np.asarray(s1, np.int32), np.asarray(e1, np.int32),
        np.asarray(z, np.int32), np.asarray(z2, np.int32))


def _self_visibility(idx, starts, ends):
    """Every query sees itself: where interval 1 misses the diagonal (a
    local window shorter than the block), the second interval is
    [q, q + 1)."""
    covered = (starts <= idx) & (idx < ends)
    s2 = np.where(covered, 0, idx)
    e2 = np.where(covered, 0, idx + 1)
    return s2, e2


def block_causal_mask(num_frames: int, frame_seqlen: int,
                      num_frame_per_block: int = 1,
                      local_attn_size: int = -1) -> IntervalMask:
    """Block-wise causal mask: each query sees every token up to the end
    of its own ``num_frame_per_block``-frame block (with a local window,
    only the last ``local_attn_size`` frames of that range)."""
    total = num_frames * frame_seqlen
    block = frame_seqlen * num_frame_per_block
    idx = np.arange(total, dtype=np.int64)
    ends = np.minimum((idx // block + 1) * block, total)
    if local_attn_size == -1:
        starts = np.zeros_like(ends)
    else:
        starts = np.maximum(ends - local_attn_size * frame_seqlen, 0)
    return _from_numpy(starts, ends, *_self_visibility(idx, starts, ends))


def block_causal_mask_i2v(num_frames: int, frame_seqlen: int,
                          num_frame_per_block: int = 4,
                          local_attn_size: int = -1) -> IntervalMask:
    """[1 frame][N frames][N frames]... variant: an independent first
    frame, then blocks of ``num_frame_per_block``."""
    total = num_frames * frame_seqlen
    block = frame_seqlen * num_frame_per_block
    idx = np.arange(total, dtype=np.int64)
    first = idx < frame_seqlen
    rest = idx - frame_seqlen
    ends = np.where(first, frame_seqlen,
                    frame_seqlen + (rest // block + 1) * block)
    ends = np.minimum(ends, total)
    if local_attn_size == -1:
        starts = np.zeros_like(ends)
    else:
        starts = np.maximum(ends - local_attn_size * frame_seqlen, 0)
    return _from_numpy(starts, ends, *_self_visibility(idx, starts, ends))


def teacher_forcing_mask(num_frames: int, frame_seqlen: int,
                         num_frame_per_block: int = 1) -> IntervalMask:
    """Mask over a doubled [clean | noisy] sequence: clean queries are
    block-causal over the clean half; a noisy query sees the clean tokens
    of strictly earlier blocks and its own noisy block."""
    S = num_frames * frame_seqlen
    block = frame_seqlen * num_frame_per_block
    idx = np.arange(2 * S, dtype=np.int64)
    clean_ends = np.minimum((idx // block + 1) * block, S)
    noisy_rel = idx - S
    block_index = noisy_rel // block
    noise_ctx_end = block_index * block
    noise_self_start = S + block_index * block
    noise_self_end = S + (block_index + 1) * block
    is_noisy = idx >= S
    start1 = np.zeros_like(idx)
    end1 = np.where(is_noisy, noise_ctx_end, clean_ends)
    start2 = np.where(is_noisy, noise_self_start, 0)
    end2 = np.where(is_noisy, np.minimum(noise_self_end, 2 * S), 0)
    return _from_numpy(start1, end1, start2, end2)
