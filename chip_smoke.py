"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--blocks 3] [--seed 0] [--kernels-only]

Phases, each printing one line or more (any failure exits non-zero):
1. the card's name and power limit, then the build of every CUDA kernel
   of ``self_forcing_tpu_torch/csrc`` (nvcc, all sources at once);
2. each kernel against its plain PyTorch version at the Wan-1.3B shapes
   of its paths: the bf16 decode and cross attention of the streaming
   sampler, the int8-QK decode attention (pre-pass and attention) at the
   global demo window and at the windowed steady state (beside the bf16
   decode kernel on the same keys) and its pre-pass at the Wan-14B global
   window (40 heads; the pre-pass bit-equal), the decode and cross attention
   backward (SDPA's on the gathered visible keys) against their fp32
   plain versions at the training rollout's shapes, the W8A8 linears
   (M = 4680 tokens, dim 1536, ffn 8960; each GEMM bit-equal to its
   plain version), the training path's flash
   attention forward and its one dq / dk / dv backward kernel (L = 32760
   tokens, 12 heads, no mask and the 7-block block-causal mask); the decode
   kernel's 'bounded', online and 'free_noclamp' modes, the full-int8
   decode attention ('tile', 'global', online; the V pre-pass, bit-equal,
   and the attention, with the products the kernel runs and its share of
   their bound) at
   the global demo window, int8 online also at the windowed steady
   state, and the flash forward's online and bounded modes; timed with
   CUDA events (median of 7) beside its bound and one PyTorch library
   call;
3. one full-width DiT forward (block 2, so the cache is read) with the
   kernels and with their plain versions, same weights and inputs;
4. the streaming sampler at full Wan-1.3B width (random weights from the
   seed): ``CausalInferencePipeline.stream`` over ``--blocks`` blocks of 3
   latent frames at 60x104 (480x832 pixels), steps [1000, 750, 500, 250]
   warped, each block decoded by the streaming Wan VAE; the kernels'
   launch counts are reset just before and read just after;
5. where the time goes: one denoise forward at the last block's window
   and the decode of that block under torch.profiler (device busy and
   idle share).
Phases 3-5 run for the parity configuration; then phases 3-4 under
``attn_softmax`` 'bounded' and 'online' (the forward kernels vs plain and
against the free forward; a 3-block stream, denoise and refresh each
block, with the cache's per-layer kmax after each); then for the demo
configuration as ``bench.py`` runs it: the same weights quantized and the
attention quantized as ``ops/chip.py`` picks for the card (W8A8 linears,
int8-QK attention; phase 3 also gives its distance to the bf16 forward;
phase 4 decodes each block with the stateful TAEHV streamer), phases 4-5
of the demo with the bf16 decode attention (the A/B of the registry's
``demo_attn_quant``), and phases 3-5 of the demo with the full-int8
attention (``attn_quant='int8'``, the tile-bounded kernel on the global
path; its DiT ms per block).
6. The windowed configurations of ``bench.py`` (1-frame sink, 12-frame
   window, 24-frame buffer, W8A8 + int8-QK, 12 blocks with TAEHV): a warm
   run, then a timed run with steady-state DiT and TAEHV ms per block
   and the frame rates with and without the decode, the compactions, one
   forward kernels vs plain at the compacted state, and phase 5; then the
   same with ``attn_quant='int8'`` (the online int8 kernel: the windowed
   cache keeps no kmax) and its phase 5.
7. The training path: ``ScoreDistillationTrainer`` with
   ``configs/self_forcing_dmd.yaml`` (Self-Forcing DMD: 21 latent frames
   of 60x104 in 7 blocks, steps [1000, 750, 500, 250] warped, guidance
   3.0, LoRA rank 128, bf16) at full Wan-1.3B width and depth, random
   weights, pseudo text context: two
   ``train_step``s (generator + critic, then critic only) with per-phase
   ms, peak memory, losses and grad norms, the parameters that moved and
   the launch counts of the flash kernels and of the decode / cross
   backward; one critic-only step under
   ``attn_softmax='bounded'``; then the critic-loss gradient at full
   width and 2 layers with the kernels and with their plain versions,
   under 'free', 'bounded' and 'online'.
8. The Wan VAE at full width (random weights from the seed) under its
   three conv backends (None: cuDNN convs; 'pallas': every 3x3x3 causal
   conv through the conv kernel; 'fused': the fused norm + SiLU + conv
   residual blocks after ``pad_decoder_channels``): the streaming decode
   of 3 blocks of seeded latents (60x104), with the conv kernels' launch
   and decline counts against the JAX package's routes and the pixels
   against the None decode; the encode of a seeded 1 + 4-frame 480x832
   clip; the i2v path under 'pallas' (a seeded image encoded into
   ``initial_latent``, ``CausalInferencePipeline.inference`` with an
   independent first frame and 2 blocks of 3 frames on random 1.3B
   weights, decoded by the VAE); one encode under torch.profiler under
   'pallas' and 'fused' with the RGB input conv's share of its busy time,
   and one decode block under each backend, with the conv kernels' share.
9. The Wan-14B demo stream (last, every earlier tensor freed, the peak
   memory counter reset): ``WAN_14B`` at full width and depth, random
   W8A8 weights drawn and quantized block by block on the card, int8-QK
   attention and stateful TAEHV; one block-2 forward kernels vs plain on
   a 4-layer cut, then ``--blocks`` blocks at 40 layers (per-block DiT /
   TAEHV ms, pixel frames/s, TTFF, peak memory, launches: fc1 from
   pre-quantized x, ``w8a8_ffn1_xq``, must launch), and a profile.
10. The text-to-video main path through the modules a user calls:
   umT5-XXL at full width (random bf16 weights from the seed) encodes
   seeded ids with a padding mask at L = 512 (``encode_for_dit``: ms busy
   and wall beside its bound, padded rows exactly zero); the encoder, the
   1.3B DiT and a float32 Wan VAE exported to the reference's state
   dicts, saved with ``torch.save`` into a model directory and read back
   by one ``load_wan_models`` call with ``t5_on_host`` (every leaf
   equal); ``encode_text`` streaming that encoder (bit-equal, with its
   peak memory); then the CLI's per-prompt function
   ``inference.generate`` on that context with the loaded DiT and float32
   VAE: ``--blocks`` blocks of 3 latent frames at 60x104 (t2v) and an
   i2v run from a seeded 720x1280 image, uint8 frames [F, 480, 832, 3],
   TTFF and ms a block, the decode / cross kernels' launches; the video
   writer the machine has, if any.
11. The pose-conditioned 50-step causal path through the CLI's functions
   (random pose-CNN weights through a UniAnimate ``torch.save`` file and
   ``load_pose_weights``, a seeded 480x832 pose video and reference pose
   through an ``.npz`` and ``load_pose_npz``): the DWPose embedding's ms
   and its distance to TF32 off; one CFG UniPC step of block 1 at full
   width with pose tokens, each branch's flow kernels vs plain; then
   ``inference.generate`` with ``CausalDiffusionInferencePipeline`` on
   ``configs/causal_diffusion.yaml`` (50 steps, guidance 5, shift 5), 2
   blocks of 3 latent frames and a float32 VAE: ms a block and a step,
   the prompt's wall, peak memory, and exactly 2 x 102 x 30 decode and
   cross launches; then the bidirectional samplers over 21 latent frames
   (few-step at 4 steps, CFG cut to 4 DPM-Solver++ steps) with their
   ``flash_fwd`` launches, forwards x 30.
12. The streaming demo server built by ``python -m
   self_forcing_tpu_torch.demo``'s own ``demo.build_app`` (with
   ``--warmup``) on phase 10's model files plus a random TAEHV checkpoint
   in ``taew2_1.pth``'s key layout and a stand-in tokenizer, serving on
   127.0.0.1 in a thread: through a WebSocket client, (a) a parity
   request (3 blocks, Wan VAE), (b) a demo request (``quantize``:
   W8A8 + int8-QK, ``taehv``), (c) a second connection refused ``busy``
   during (b), (d) a 7-block request stopped after its first block, (e)
   (a) again (within 1 uint8 level of (a)), the demo request under
   torch.profiler (device idle share, the host's synchronize waits), (f)
   ``/api/status`` (``hbm_in_use_gb`` the allocator's live bytes); each
   request's ms to ``generation_started``, to the first ``block_ready``
   and ``frame_ready``, ``block_s``, frames and pushed frames/s, with
   exact launch counts.
13. The image-to-video path at Wan-I2V-14B's full width (last, every
   earlier tensor freed, the peak counter reset): (a) CLIP ViT-H/14 in
   float32 through the reference's ``visual.*`` file and
   ``runtime.load_clip_vision``, ``encode_image`` of a 480x832 image
   against the CPU (1e-4); (b) ``WanI2V.generate`` at 40 layers, 81
   frames at 832x480, 2 of 40 UniPC steps (cut for time): ms of CLIP,
   the y encode, each CFG step and forward, the decode, peak memory, and
   exactly 160 ``flash_fwd`` and 320 ``cross_attention`` launches; (c)
   one 4-layer i2v forward kernels vs plain (2e-2); (e) one full-depth
   forward under torch.profiler; (d) the causal 50-step pipeline's
   ``input_image`` with pose at 20 of 40 layers, 2 blocks, 4 steps (cut
   for time): ms a block and a step, peak memory, exact decode and cross
   launches.
14. The other trainers at full Wan-1.3B width and depth (random float32
   weights, TF32 products, as ``python -m self_forcing_tpu_torch.train``
   runs them), through the CLI's functions (``train.build_models``,
   ``data_batches``, ``make_batch``, ``make_trainer``) on seeded stand-in
   data that the port's ``RecordWriter`` writes (an ODE shard of 5-snapshot
   trajectories [5, 21, 16, 60, 104] fp16, a directory of latent shards)
   and its datasets and ``DataLoader`` read back: (a) ODE regression
   (``ode_init.yaml``) and (b) causal diffusion with teacher forcing
   (``causal_diffusion.yaml``), two steps each; (c) GAN
   (``self_forcing_gan.yaml``, update ratio 2: step 0 the generator and
   the critic, step 1 the critic); (d) SiD (``self_forcing_sid.yaml``, a
   generator + critic step); each step's ms, losses (finite), exact
   launches of the flash, decode and cross kernels and the decode / cross
   backward (derived from the code, the exits from a copy of the
   trainer's host RNG), the leaves that moved and the peak memory; (f)
   at 2 layers the GAN critic-loss and the causal-diffusion loss
   gradients (teacher-forcing mask) with the kernels and with their
   plain versions (1e-2); (e) a 2-layer GAN trainer's ``save_state`` ->
   ``load_state`` round trip and a ``save_reference_checkpoint`` read
   back through the converter, every leaf equal.
15. Pose-conditioned Self-Forcing distillation and the data-prep chain
   (every earlier tensor freed, the peak counter reset, cuDNN in TF32
   as ``train.py`` leaves it): (a) the port's
   ``generate_ode_pairs`` on phase 10's model directory (2 prompts,
   latents [1, 21, 16, 60, 104], guidance 6, 4 of its 48 steps) with
   exact launches, then ``create_sharded_dataset`` and
   ``create_shards_iterative``, whose rows the datasets read back equal
   to the snapshots; (b) ``self_forcing_dmd.yaml`` with
   ``use_pose_conditioning`` (bf16, LoRA rank 128 from a random
   ``lora_path`` file, random UniAnimate pose weights, dropout 0.1) on
   pose shards ``create_pose_shards`` wrote, the DiT, VAE and CLIP from a
   model directory, through ``train``'s functions: step 0 (generator and
   critic) and step 1 (critic) with the ms split (the conditioning's
   parts too), losses, exact launches, the LoRA and ``pose_proj`` leaves
   moved, the peak; (c) a 24-frame rollout (the first block a no-grad
   prefix, the 37440-key window, the VAE trim) with its backward: ms,
   the trim's ms, the 21 frames and mask, exact launches; (d) the 2-layer
   pose critic-loss gradient with the kernels and with their plain
   versions (1e-2).
16. Tensor and sequence parallelism (last, every earlier tensor freed;
   the ranks are processes that ``parallel/launch.py`` spawns and
   ``parallel/card_checks.py`` runs): (a) an NCCL group of one rank:
   block 2 at full Wan-1.3B width through ``forward_inference_tp``
   beside ``dit.forward_inference`` (1e-3, the same launches); (b) two
   ranks on cuda:0 over gloo (NCCL refuses two ranks on one device;
   every collective is staged through pinned host memory, so no time
   here is an NCCL or NVLink time) at Wan-14B's full width: block 2 on a
   4-layer cut against the single-process forward, the rank caches
   against the dense cache (2e-2), then the tensor-parallel
   ``CausalInferencePipeline.stream`` over 2 blocks at 40 layers with a
   21-frame cache, each rank drawing the model layer by layer and
   keeping its shard (ms a block, the host-staged all-reduces' ms, each
   rank's peak beside ``parallel/fit.py``'s estimate, exactly 9 x 40
   decode and cross launches a rank); (c) ``forward_train_sp`` at
   Wan-I2V-14B's width, 20 of 40 layers, 21 latent frames (padded to
   22) at 60x104 with seeded ``y`` and ``clip_fea`` against the
   single-process ``forward_train`` (2e-2), exactly 40
   ``cross_attention`` launches a rank.
17. Parallel training (``parallel/fsdp.py``: ZeRO-3 by hand; the
   trainers' ``mesh=``; bf16 as ``self_forcing_dmd.yaml`` runs, random
   weights, latents [1, 21, 16, 60, 104]): (a) in this process, an NCCL
   group of one rank: phase 7's full-depth Wan-1.3B DMD step 0
   (generator and critic, LoRA rank 128) again, through the sharded
   trainer on a mesh of one, against phase 7's one-process step
   (``card_checks.dmd_distances``: losses and updated trees 1e-5, both
   models' first moments GRAD_TOL, their updates UPDATE_TOL: two runs
   of a step differ there, the flash backward's dq sums in a
   run-dependent order; the same launches), its peak beside
   ``fit.sp_dmd_fit``'s estimate; two ranks on cuda:0 over gloo
   (staged through pinned host memory: no time here is an NCCL or
   NVLink time), started before (a), run (d) and (e) beside it and the
   rest after it: (b) on an fsdp-2 mesh a DMD step at TRAIN_LAYERS of 30
   layers (batch 1, whole on both ranks; as (a)) and two
   causal-diffusion steps with batch 2 split over the ranks (1e-3),
   each against one process on rank 0, each rank's parameter +
   optimizer bytes beside one process's (the trainer's rollout cache
   constraint set aside in (b) and (c): on one card gloo moves each
   layer's cache through host memory at every forward; (e) runs it);
   (c) on an sp-2 mesh a DMD step whose teacher is Wan-14B wide at
   TEACHER_LAYERS of 40 layers, its weights sliced over ("fsdp", "sp")
   (``teacher_zero3_sp``) and gathered a layer at a time in the ring
   forward, against one process with the whole teacher (3e-3: the ring
   runs float32 attention, the flash kernel bf16; updates UPDATE_TOL),
   each rank's teacher bytes; (d) ``forward_train_tp``'s gradients at tp
   2, Wan-14B width, 2 layers, float32, against the single-process
   gradients (TP_GRAD_TOL over all leaves, TP_LEAF_TOL for the worst
   leaf, which is named); (e) the 21-frame rollout with gradient at
   CACHE_LAYERS layers with and without the rollout cache constraint:
   the same loss, gradients within 1e-3, and the cache bytes a rank
   holds halved; then ``train.main`` (``causal_diffusion.yaml``) for 2
   steps on both ranks (CLI_LAYERS layers) against one process: rank 0
   alone writes metrics.jsonl and the checkpoint, equal to one
   process's.  Every step's ms (host clock, synchronised), collective ms
   and launches; the launches equal one process's.
Phase 2 also holds ``decode_fresh`` and its backward on the last block
of a 24-frame rollout (37440 keys), and each conv kernel (the 27-tap conv, its RGB input's
route at 4 frames and 1, the split route, v2 and the fused norm + SiLU +
conv, and the 27-tap conv at float32)
against its plain version at the VAE's full-width shapes, beside cuDNN's
conv; the W8A8 kernels at the Wan-14B shapes (fc1 from int8 x, fc2 at
768-column groups, the K = 5120 qkv and o GEMMs) and the GEMM from raw
bf16 x (every GEMM bit-equal to its plain version);
and the cache-window attention (``decode_attention``) at the 1.3B global
window in bf16 and float32, beside SDPA; and the image-to-video path's
two kernels at Wan-I2V-14B's shapes: the unmasked flash forward at
32760 tokens and 40 heads, the cross attention of 32760 queries onto
257 image keys and onto 512 text keys; and the flash forward and
backward at the other trainers' shapes: the teacher-forcing mask over
the doubled 65520-token sequence, and the GAN discriminator's unmasked
fake|real batch (B = 2, L = 32760); and the decode and cross attention
at 20 heads, one rank of Wan-14B at tp 2 (phase 16).
Then the kernel table as one JSON line, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

# published H100 SXM peaks: dense bf16 and int8 tensor-core rates, the
# float32 rate outside the tensor cores, HBM3 rate; a float32 product in
# 3xTF32 is three TF32 tensor-core products (495 TFLOP/s dense)
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
GB = 1e9

LQ = 3 * 1560          # tokens of one 3-frame block at 60x104 latents
SEQ_TRAIN = 21 * 1560  # tokens of the 21-frame training sequence
N_HEADS, HEAD_DIM, N_LAYERS = 12, 128, 30
S_CACHE = 32768        # 21 frames * 1560 tokens rounded up to 2048
LAST_KV_END = 18 * 1560  # cache tokens before the 7th block
DIM, FFN, N_CTX = 1536, 8960, 512
DIM_14B, FFN_14B = 5120, 13824   # Wan-14B width (40 heads of 128)
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's 1.98 GHz boost clock
LOG2E = 1.4426950408889634
S_WIN = 24 * 1560      # the windowed configuration's 24-frame buffer
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


# the kernels each path launches
PARITY_KERNELS = ("decode_fresh_free", "cross_attention")
DEMO_KERNELS = ("int8qk_quantize", "decode_fresh_int8qk", "cross_attention",
                "quantize_rows", "w8a8_matmul", "w8a8_ffn1", "w8a8_ffn2")
# the demo's W8A8 linears with the bf16 decode attention (its A/B)
DEMO_BF16_ATTN_KERNELS = ("decode_fresh_free", "cross_attention",
                          "quantize_rows", "w8a8_matmul", "w8a8_ffn1",
                          "w8a8_ffn2")
# attn_quant='int8': the global demo runs the tile-bounded int8 attention,
# the windowed configuration (no kmax) the online one
INT8_DEMO_KERNELS = ("int8qk_quantize", "int8_quantize_v",
                     "decode_fresh_int8_tile", "cross_attention",
                     "quantize_rows", "w8a8_matmul", "w8a8_ffn1", "w8a8_ffn2")
INT8_WIN_KERNELS = ("int8qk_quantize", "int8_quantize_v",
                    "decode_fresh_int8_online", "cross_attention",
                    "quantize_rows", "w8a8_matmul", "w8a8_ffn1", "w8a8_ffn2")
# Wan-14B: every linear has K = 5120 > 4096 (no quantize_rows, and fc1
# runs from int8 x)
WAN14B_KERNELS = ("int8qk_quantize", "decode_fresh_int8qk", "cross_attention",
                  "w8a8_matmul", "w8a8_ffn1_xq", "w8a8_ffn2")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check_launches(tag: str, launches: dict, names) -> None:
    for name in names:
        if launches[name] == 0:
            fail(f"{tag}: kernel {name} was never launched on the path")


def time_ms(fn, reps: int = 7) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after one
    warm-up call.  Before each timed call a spin kernel (~10 ms) holds the
    stream, so the call's launches queue up behind it and the events time
    the device's work, not the host's enqueue (a small kernel's Python
    wrapper takes longer to launch it than the card to run it)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class GcClock:
    """Milliseconds spent in Python's garbage collector since install():
    read before and after a timed span, the difference is collector time
    that the span's host clock counts."""

    def __init__(self):
        self.ms, self._t0 = 0.0, None

    def install(self):
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None


GC_CLOCK = GcClock()


def device_segments() -> int:
    """Device segments the caching allocator has created (each one
    cudaMalloc)."""
    return torch.cuda.memory_stats().get("segment.all.allocated", 0)


class HostStalls:
    """Host-side stalls over a span: the caching allocator's new device
    segments and the time spent in Python's garbage collector."""

    def __enter__(self):
        self._gc, self._segs = GC_CLOCK.ms, device_segments()
        return self

    def __exit__(self, *exc):
        self.gc_ms = GC_CLOCK.ms - self._gc
        self.mallocs = device_segments() - self._segs

    def __str__(self):
        return f"device_mallocs={self.mallocs} gc_ms={self.gc_ms:.1f}"


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def bound(flops: float, nbytes: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_kernel(name, out, ref, tol=1e-2):
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail(f"{name}: non-finite output")
    err = rel_l2(out, ref)
    mae = float((out.float() - ref.float()).abs().max())
    if err > tol:
        fail(f"{name}: relative L2 {err:.3e} > {tol}")
    return err, mae


def check_gemm(name, out, ref):
    """A W8A8 GEMM against its plain version: both round the exact int32
    sums and the f32 epilogue step by step, so the bf16 outputs must be
    equal bit for bit.  Returns (relative L2, max abs error)."""
    err, mae = check_kernel(name, out, ref, tol=1e-3)
    if not torch.equal(out, ref):
        fail(f"{name}: not bit-equal to its plain version (relative L2 "
             f"{err:.3e}, max abs {mae:.3e})")
    return err, mae


def phase_kernels(ca, g) -> dict:
    """Each kernel against its plain version at the 1.3B shapes."""
    dev = "cuda"
    D, N = HEAD_DIM, N_HEADS
    bf = torch.bfloat16
    # q carries the folded head_dim**-0.5 * log2(e) gain, as on the path
    q = (torch.randn(1, LQ, N * D, generator=g, device=dev)
         * (D ** -0.5 * 1.4426950408889634)).to(bf)
    kc = torch.randn(N_LAYERS, N, S_CACHE, D, generator=g, device=dev,
                     dtype=bf)
    vc = torch.randn(N_LAYERS, N, S_CACHE, D, generator=g, device=dev,
                     dtype=bf)
    kn = torch.randn(1, LQ, N * D, generator=g, device=dev, dtype=bf)
    vn = torch.randn(1, LQ, N * D, generator=g, device=dev, dtype=bf)
    table = {}

    maes = []
    # the last block of a 24-frame training rollout reads 21 cached frames
    # and its own 3: a 37440-key window
    for label, kv_end in (("block 1", 0), ("block 7", LAST_KV_END),
                          ("block 8 of 24 frames", 21 * 1560)):
        args = dict(layer_idx=7, kv_start=0, kv_end=kv_end, sink_end=0,
                    static_hi=kv_end, num_heads=N)
        out = ca.decode_fresh_free(q, kc, vc, kn, vn, **args)
        ref = ca.decode_fresh_free_ref(q, kc, vc, kn, vn, **args)
        err, mae = check_kernel("decode_fresh_free", out, ref)
        maes.append(mae)
        ms = time_ms(lambda: ca.decode_fresh_free(q, kc, vc, kn, vn, **args))
        plain_ms = time_ms(
            lambda: ca.decode_fresh_free_ref(q, kc, vc, kn, vn, **args),
            reps=5)
        # library yardstick: SDPA over the concatenated visible K/V at
        # scale ln 2 (base-2 softmax of the folded scores)
        heads = lambda t: t.reshape(1, -1, N, D).transpose(1, 2)
        kv_k = torch.cat([kc[7, :, :kv_end][None], heads(kn)], dim=2)
        kv_v = torch.cat([vc[7, :, :kv_end][None], heads(vn)], dim=2)
        qh = heads(q)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kv_k, kv_v, scale=math.log(2.0)))
        del kv_k, kv_v
        n_keys = kv_end + LQ
        flops = 4.0 * LQ * n_keys * D * N
        nbytes = 2.0 * (2 * LQ * N * D + 2 * n_keys * N * D)
        b_ms, b_by = bound(flops, nbytes)
        print(f"kernel decode_fresh_free {label} (kv_end={kv_end}, "
              f"layer 7): rel_l2={err:.3e} max_abs={mae:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"tflops={flops / ms / 1e9:.1f} "
              f"bound_share={b_ms / ms:.3f}", flush=True)
        if label == "block 7":
            table["decode_fresh_free"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by)
    table["decode_fresh_free"]["max_abs_err"] = max(maes)
    table.update(phase_int8qk_kernels(ca, q, kc, vc, kn, vn, g))
    table.update(phase_mode_kernels(ca, q, kc, vc, kn, vn, g))
    phase_attention_backward(ca, q, kc, vc, kn, vn, g)
    del kc, vc, kn, vn

    Lk = 512
    qx = torch.randn(1, LQ, N * D, generator=g, device=dev, dtype=bf)
    k = torch.randn(1, Lk, N, D, generator=g, device=dev, dtype=bf)
    v = torch.randn(1, Lk, N, D, generator=g, device=dev, dtype=bf)
    out = ca.cross_attention(qx, k, v, num_heads=N)
    ref = ca.cross_attention_ref(qx, k, v, num_heads=N)
    err, mae = check_kernel("cross_attention", out, ref)
    ms = time_ms(lambda: ca.cross_attention(qx, k, v, num_heads=N))
    plain_ms = time_ms(lambda: ca.cross_attention_ref(qx, k, v, num_heads=N),
                       reps=5)
    qh, kh, vh = (qx.reshape(1, LQ, N, D).transpose(1, 2), k.transpose(1, 2),
                  v.transpose(1, 2))
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    flops = 4.0 * LQ * Lk * D * N
    nbytes = 2.0 * (2 * LQ * N * D + 2 * Lk * N * D)
    b_ms, b_by = bound(flops, nbytes)
    print(f"kernel cross_attention (Lk={Lk}): rel_l2={err:.3e} "
          f"max_abs={mae:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"sdpa_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
          f"tflops={flops / ms / 1e9:.1f} bound_share={b_ms / ms:.3f}",
          flush=True)
    table["cross_attention"] = dict(ms=ms, plain_ms=plain_ms,
                                    library_ms=lib_ms, bound_ms=b_ms,
                                    bound_by=b_by, max_abs_err=mae)
    return table


def phase_attention_backward(ca, q, kc, vc, kn, vn, g) -> None:
    """The backward of the decode and cross attention (no TPU kernel: the
    JAX package's is an XLA replay) at the training rollout's shapes: a
    block's 4680 queries onto the fresh K/V alone (block 1) and onto 28080
    cached keys as well (block 7), as the gradient of the free softmax at
    ln 2; the cross attention onto 512 text tokens for 4680 (the rollout)
    and 32760 (the score models) queries.  The card path (SDPA's backward
    on the gathered visible keys, bf16) is held against the fp32 plain
    version at 2e-2 relative L2 per gradient and timed beside it; the
    bound counts SDPA's backward as 5 bf16 products (the forward
    recomputed, then dV, dP, dQ, dK) and its bytes as q, k, v, do read
    once and dq, dk, dv written once."""
    D, N = HEAD_DIM, N_HEADS
    go = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)

    def check(name, got, want):
        errs = [rel_l2(a, b) for a, b in zip(got, want)]
        if not all(math.isfinite(e) and e <= 2e-2 for e in errs):
            fail(f"{name}: relative L2 {errs} > 2e-2 against the fp32 "
                 f"plain version")
        return max(errs)

    # the last block of a 24-frame training rollout reads 21 cached frames
    # and its own 3: a 37440-key window
    for label, kv_end in (("block 1", 0), ("block 7", LAST_KV_END),
                          ("block 8 of 24 frames", 21 * 1560)):
        kw = dict(layer_idx=7, kv_start=0, kv_end=kv_end, num_heads=N,
                  scale=math.log(2.0))
        err = check(f"decode_fresh_bwd {label}",
                    ca.decode_fresh_bwd(q, kc, vc, kn, vn, go, **kw),
                    ca.decode_fresh_bwd_ref(q, kc, vc, kn, vn, go, **kw))
        ms = time_ms(lambda: ca.decode_fresh_bwd(q, kc, vc, kn, vn, go,
                                                 **kw))
        plain_ms = time_ms(lambda: ca.decode_fresh_bwd_ref(
            q, kc, vc, kn, vn, go, **kw), reps=3)
        keys = kv_end + LQ
        b_ms, b_by = bound(5 * 2.0 * LQ * keys * D * N,
                           2.0 * N * D * (4 * LQ + 4 * keys))
        print(f"backward decode_fresh_bwd {label} (keys {keys}): "
              f"rel_l2={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f}",
              flush=True)
    k = torch.randn(1, N_CTX, N, D, generator=g, device="cuda").to(q.dtype)
    v = torch.randn(1, N_CTX, N, D, generator=g, device="cuda").to(q.dtype)
    for Lq in (LQ, SEQ_TRAIN):
        qx = torch.randn(1, Lq, N * D, generator=g, device="cuda").to(
            q.dtype)
        gx = torch.randn(1, Lq, N * D, generator=g, device="cuda").to(
            q.dtype)
        err = check(f"cross_attention_bwd Lq={Lq}",
                    ca.cross_attention_bwd(qx, k, v, gx, num_heads=N),
                    ca.cross_attention_bwd_ref(qx, k, v, gx, num_heads=N))
        ms = time_ms(lambda: ca.cross_attention_bwd(qx, k, v, gx,
                                                    num_heads=N))
        plain_ms = time_ms(lambda: ca.cross_attention_bwd_ref(
            qx, k, v, gx, num_heads=N), reps=3)
        b_ms, b_by = bound(5 * 2.0 * Lq * N_CTX * D * N,
                           2.0 * N * D * (4 * Lq + 4 * N_CTX))
        print(f"backward cross_attention_bwd (Lq={Lq}, Lk={N_CTX}): "
              f"rel_l2={err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f}",
              flush=True)


def phase_int8qk_kernels(ca, q, kc, vc, kn, vn, g) -> dict:
    """The int8-QK decode attention (pre-pass and attention) against its
    plain versions at the two shapes of its paths: the global demo path
    at block 7 (28080 cached tokens of the 32768-token cache) and the
    windowed steady state (a 37440-token buffer whose 1560-token sink and
    12480-token recent window are visible, 14040 cached tokens).  The
    library yardstick is SDPA on the same bf16 inputs: the bf16 function
    (no PyTorch call does int8 QK^T); beside it the port's bf16
    ``decode_fresh_free`` on the same keys."""
    from self_forcing_tpu_torch.ops.attention import decode_tiles
    D, N = HEAD_DIM, N_HEADS
    S_W = 24 * 1560
    kc_w = torch.randn(N, S_W, D, generator=g, device="cuda",
                       dtype=torch.bfloat16)
    vc_w = torch.randn(N, S_W, D, generator=g, device="cuda",
                       dtype=torch.bfloat16)
    shapes = (
        ("global block 7", kc, vc, dict(layer_idx=7, kv_start=0,
                                        kv_end=LAST_KV_END, sink_end=0,
                                        static_hi=LAST_KV_END), None),
        ("windowed steady state", kc_w, vc_w,
         dict(layer_idx=0, kv_start=S_W - LQ - 8 * 1560, kv_end=S_W - LQ,
              sink_end=1560, static_hi=None), 1560))
    table = {}
    heads = lambda t: t.reshape(1, -1, N, D).transpose(1, 2)
    for label, k_c, v_c, win, align in shapes:
        tq, tk, tf = decode_tiles(LQ, k_c.shape[-2], LQ, "int8qk", "free",
                                  align)
        win.update(num_heads=N, tq=tq, tk=tk, tf=tf)
        lo, hi, sk = win["kv_start"], win["kv_end"], win["sink_end"]
        qq, pre = prepass_row(ca, label, q, k_c, kn, win)

        # the attention
        out = ca.decode_fresh_int8qk(q, k_c, v_c, kn, vn, **win)
        ref = ca.decode_fresh_int8qk_ref(q, k_c, v_c, kn, vn, **win)
        err, mae = check_kernel("decode_fresh_int8qk", out, ref)
        del out, ref
        ms = time_ms(lambda: ca.int8qk_attend(qq, q, v_c, vn, **win))
        plain_ms = time_ms(lambda: ca.int8qk_attend_ref(qq, q, v_c, vn,
                                                        **win), reps=5)
        lay = k_c[win["layer_idx"]] if k_c.dim() == 4 else k_c
        lav = v_c[win["layer_idx"]] if v_c.dim() == 4 else v_c
        vis = torch.cat([torch.arange(sk), torch.arange(lo, hi)]).cuda()
        kv_k = torch.cat([lay[:, vis][None], heads(kn)], dim=2)
        kv_v = torch.cat([lav[:, vis][None], heads(vn)], dim=2)
        qh = heads(q)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kv_k, kv_v, scale=math.log(2.0)))
        del kv_k, kv_v
        # the bf16 kernel on the same keys: what the int8-QK toggle must
        # beat to save time
        bf_args = {k: win[k] for k in ("layer_idx", "kv_start", "kv_end",
                                       "sink_end", "static_hi",
                                       "num_heads")}
        bf16_ms = time_ms(lambda: ca.decode_fresh_free(q, k_c, v_c, kn, vn,
                                                       **bf_args))
        n_keys = sk + (hi - lo) + LQ
        ops = 2.0 * LQ * n_keys * D * N     # each of QK^T and P.V
        nbytes = 2.0 * (2 * LQ * N * D + 2 * n_keys * N * D)
        t_ops = ops / PEAK_INT8_OPS + ops / PEAK_BF16_FLOPS
        b_ms = max(t_ops, nbytes / PEAK_BYTES) * 1e3
        b_by = "operations" if t_ops >= nbytes / PEAK_BYTES else "bytes"
        print(f"kernel decode_fresh_int8qk {label} (keys {n_keys}, tiles "
              f"{tq}/{tk}/{tf}): rel_l2={err:.3e} max_abs={mae:.3e} "
              f"attend_ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"sdpa_bf16_ms={lib_ms:.4f} decode_fresh_bf16_ms={bf16_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
              f"tops={2 * ops / ms / 1e9:.1f}", flush=True)
        if "decode_fresh_int8qk" not in table:   # the table row: global
            table["decode_fresh_int8qk"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=mae)
            table["int8qk_quantize"] = pre
        del qq
    del kc_w, vc_w
    # the pre-pass at the Wan-14B shape: 40 heads, the global window
    N14 = DIM_14B // D
    q14, kn14 = (torch.randn(1, LQ, N14 * D, generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
    q14 = (q14.float() * (D ** -0.5 * LOG2E)).to(torch.bfloat16)
    kc14 = torch.randn(N14, S_CACHE, D, generator=g, device="cuda",
                       dtype=torch.bfloat16)
    tq, tk, tf = decode_tiles(LQ, S_CACHE, LQ, "int8qk", "free", None)
    prepass_row(ca, "14B global block 7", q14, kc14, kn14, dict(
        layer_idx=0, kv_start=0, kv_end=LAST_KV_END, sink_end=0,
        static_hi=LAST_KV_END, num_heads=N14, tq=tq, tk=tk, tf=tf))
    del q14, kn14, kc14
    return table


def prepass_row(ca, label, q, k_c, kn, win):
    """The int8-QK pre-pass against its plain version: the int8 values
    and scales bit-equal (both divide truly and round half to even; dead
    cache tiles are not written and not compared), its time and bound.
    Returns (the kernel's Int8QK, the table row)."""
    N, D = win["num_heads"], HEAD_DIM
    tq, tk, tf = win["tq"], win["tk"], win["tf"]
    qq = ca.int8qk_quantize(q, k_c, kn, **win)
    qq_ref = ca.int8qk_quantize_ref(q, k_c, kn, **win)
    live = torch.tensor(ca.live_cache_tiles(
        qq.ksc.shape[1], tk, win["kv_start"], win["kv_end"],
        win["sink_end"]), device="cuda")
    rows = live.repeat_interleave(tk)
    worst = max(check_int8("int8qk_quantize", a, b) for a, b in (
        (qq.q8, qq_ref.q8), (qq.kc8[:, rows], qq_ref.kc8[:, rows]),
        (qq.kn8, qq_ref.kn8)))
    s_err = max(rel_l2(a, b) for a, b in ((qq.qs, qq_ref.qs),
                                          (qq.ksc, qq_ref.ksc),
                                          (qq.ksf, qq_ref.ksf)))
    pairs = ((qq.q8, qq_ref.q8), (qq.kc8[:, rows], qq_ref.kc8[:, rows]),
             (qq.kn8, qq_ref.kn8), (qq.qs, qq_ref.qs), (qq.ksc, qq_ref.ksc),
             (qq.ksf, qq_ref.ksf))
    if not all(torch.equal(a, b) for a, b in pairs):
        fail(f"int8qk_quantize {label}: not bit-equal to its plain version "
             f"(largest int8 step {worst}, scales relative L2 {s_err:.3e})")
    del qq_ref, pairs
    Lq = q.shape[1]
    n_live = int(live.sum()) * tk
    # each of q, the live cache rows and k_new: a bf16 read and an int8
    # write (3 bytes an element), then the f32 scales
    elems = (Lq + n_live + kn.shape[1]) * N * D
    pre_bytes = 3.0 * elems + 4.0 * N * (qq.qs.shape[1] + qq.ksc.shape[1]
                                          + qq.ksf.shape[1])
    pre_ms = time_ms(lambda: ca.int8qk_quantize(q, k_c, kn, **win))
    pre_plain = time_ms(lambda: ca.int8qk_quantize_ref(q, k_c, kn, **win),
                        reps=5)
    pb_ms, pb_by = bound(3.0 * elems, pre_bytes, PEAK_F32_FLOPS)
    print(f"kernel int8qk_quantize {label} ({N} heads, tiles {tq}/{tk}/{tf}, "
          f"{n_live} live cache rows): bit_equal=True "
          f"ms={pre_ms:.4f} "
          f"plain_ms={pre_plain:.4f} bound_ms={pb_ms:.4f} ({pb_by}) "
          f"bound_share={pb_ms / pre_ms:.3f}", flush=True)
    return qq, dict(ms=pre_ms, plain_ms=pre_plain, library_ms=None,
                    bound_ms=pb_ms, bound_by=pb_by, max_abs_err=float(worst))


def _heads(t: torch.Tensor) -> torch.Tensor:
    """Heads-packed [1, L, N*D] -> [1, N, L, D]."""
    return t.reshape(1, -1, N_HEADS, HEAD_DIM).transpose(1, 2)


def _window(k_c, v_c, kn, vn, li, win):
    """The visible keys and values [1, N, keys, D] of a decode window
    (sinks, the cached window, the fresh block)."""
    lay_k = k_c[li] if k_c.dim() == 4 else k_c
    lay_v = v_c[li] if v_c.dim() == 4 else v_c
    lo, hi, sk = win["kv_start"], win["kv_end"], win["sink_end"]
    vis = torch.cat([torch.arange(sk), torch.arange(lo, hi)]).cuda()
    return (torch.cat([lay_k[:, vis][None], _heads(kn)], dim=2),
            torch.cat([lay_v[:, vis][None], _heads(vn)], dim=2))


def _max_score(qh, keys) -> torch.Tensor:
    """max over heads of q.k^T * head_dim**-0.5, on the card."""
    return torch.stack([(qh[0, n].float() @ keys[0, n].float().T).amax()
                        for n in range(qh.shape[1])]).amax() \
        * HEAD_DIM ** -0.5


def phase_mode_kernels(ca, q, kc, vc, kn, vn, g) -> dict:
    """The decode kernel's other softmax modes and the full-int8 decode
    attention against their plain versions, at the global demo window
    (block 7: 28080 cached keys of layer 7 plus 4680 fresh): 'bounded'
    (the DiT's Cauchy-Schwarz bound, on the card), online and
    'free_noclamp' (q carrying head_dim**-0.5 * log2(e)); int8 'tile'
    (the same bound), 'global' (the max score + 0.5) and online, each
    the V pre-pass (its int8 and scales equal to the plain version's)
    and the attention; int8 online also at the windowed steady state (a
    37440-token buffer with the 1560-token sink and 12480 recent keys
    visible), its path.  Tolerance 1e-2 relative L2 (p rounded to bf16,
    or to int8 at an exp2 that may differ by an ulp).  Library yardstick:
    SDPA on the same bf16 inputs at head_dim**-0.5 (for the int8 rows,
    the bf16 function)."""
    from self_forcing_tpu_torch.ops.attention import decode_tiles
    D, N = HEAD_DIM, N_HEADS
    qu = (q.float() / (D ** -0.5 * LOG2E)).to(q.dtype)   # unfolded
    glob = dict(layer_idx=7, kv_start=0, kv_end=LAST_KV_END, sink_end=0,
                static_hi=LAST_KV_END, num_heads=N)
    kv_k, kv_v = _window(kc, vc, kn, vn, 7, glob)
    qh = _heads(qu)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kv_k,
                                                             kv_v))
    m0 = (D ** -0.5 * qh.float().norm(dim=-1).amax()
          * kv_k.float().norm(dim=-1).amax()).reshape(1)
    smax = _max_score(qh, kv_k)
    del kv_k, kv_v
    n_keys = LAST_KV_END + LQ
    b_ms, b_by = bound(4.0 * LQ * n_keys * D * N,
                       2.0 * (2 * LQ * N * D + 2 * n_keys * N * D))
    print(f"decode modes at the global window: m0={float(m0):.4f} "
          f"max_score={float(smax):.4f} (Cauchy-Schwarz bound, its slack "
          f"{float(m0 - smax):.3f} nats)", flush=True)
    table = {}
    for name, kw in (("decode_fresh_bounded", dict(mode="bounded", m0=m0,
                                                   scale=D ** -0.5)),
                     ("decode_fresh_online", dict(mode="online",
                                                  scale=D ** -0.5)),
                     ("decode_fresh_free_noclamp",
                      dict(mode="free_noclamp"))):
        qm = q if kw["mode"] == "free_noclamp" else qu
        run = lambda: ca.decode_fresh(qm, kc, vc, kn, vn, **kw, **glob)
        ref = ca.decode_fresh_ref(qm, kc, vc, kn, vn, **kw, **glob)
        err, mae = check_kernel(name, run(), ref)
        del ref
        ms = time_ms(run)
        plain_ms = time_ms(lambda: ca.decode_fresh_ref(qm, kc, vc, kn, vn,
                                                       **kw, **glob), reps=3)
        print(f"kernel {name} global block 7 (keys {n_keys}, layer 7): "
              f"rel_l2={err:.3e} max_abs={mae:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms={sdpa_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"tflops={4.0 * LQ * n_keys * D * N / ms / 1e9:.1f} "
              f"bound_share={b_ms / ms:.3f}", flush=True)
        table[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_ms,
                           bound_ms=b_ms, bound_by=b_by, max_abs_err=mae)

    kc_w = torch.randn(N, S_WIN, D, generator=g, device="cuda",
                       dtype=torch.bfloat16)
    vc_w = torch.randn(N, S_WIN, D, generator=g, device="cuda",
                       dtype=torch.bfloat16)
    wwin = dict(layer_idx=0, kv_start=S_WIN - LQ - 8 * 1560,
                kv_end=S_WIN - LQ, sink_end=1560, static_hi=None,
                num_heads=N)
    cases = [("tile", "global block 7", kc, vc, glob, None, m0),
             ("global", "global block 7", kc, vc, glob, None, smax + 0.5),
             ("online", "global block 7", kc, vc, glob, None, None),
             ("online", "windowed steady state", kc_w, vc_w, wwin, 1560,
              None)]
    for mode, label, k_c, v_c, win, align, bnd in cases:
        tq, tk, tf = decode_tiles(LQ, k_c.shape[-2], LQ, "int8", None,
                                  align)
        tiles = dict(tk=tk, tf=tf, **win)
        qq = ca.int8qk_quantize(qu, k_c, kn, tq=tq, **tiles)
        vv = ca.int8_quantize_v(v_c, vn, **tiles)
        vv_ref = ca.int8_quantize_v_ref(v_c, vn, **tiles)
        live = torch.tensor(ca.live_cache_tiles(
            vv.vsc.shape[1], tk, win["kv_start"], win["kv_end"],
            win["sink_end"]), device="cuda")
        torch.cuda.synchronize()
        worst = max(int((a.int() - b.int()).abs().max()) for a, b in (
            (vv.vc8[:, live], vv_ref.vc8[:, live]), (vv.vn8, vv_ref.vn8)))
        s_err = max(rel_l2(a, b) for a, b in ((vv.vsc, vv_ref.vsc),
                                              (vv.vsf, vv_ref.vsf)))
        if worst or not (torch.equal(vv.vsc, vv_ref.vsc)
                         and torch.equal(vv.vsf, vv_ref.vsf)):
            fail(f"int8_quantize_v {label}: not bit-equal to its plain "
                 f"version (int8 {worst} steps apart, scales relative L2 "
                 f"{s_err:.3e})")
        del vv_ref
        att = dict(mode=mode, m0=bnd, scale=D ** -0.5, tq=tq,
                   cache_len=k_c.shape[-2], fresh_len=LQ, **tiles)
        name = f"decode_fresh_int8_{mode}"
        out = ca.int8_attend(qq, vv, qu, **att)
        ref = ca.decode_fresh_int8_ref(qu, k_c, v_c, kn, vn, mode=mode,
                                       m0=bnd, scale=D ** -0.5, tq=tq,
                                       **tiles)
        err, mae = check_kernel(name, out, ref)
        del out, ref
        ms = time_ms(lambda: ca.int8_attend(qq, vv, qu, **att))
        plain_ms = time_ms(lambda: ca.int8_attend_ref(qq, vv, qu, **att),
                           reps=3)
        pre_ms = time_ms(lambda: ca.int8_quantize_v(v_c, vn, **tiles))
        pre_plain = time_ms(lambda: ca.int8_quantize_v_ref(v_c, vn,
                                                           **tiles), reps=3)
        kk, kv = _window(k_c, v_c, kn, vn, win["layer_idx"], win)
        lib = (sdpa_ms if label.startswith("global") else
               time_ms(lambda: F.scaled_dot_product_attention(qh, kk, kv)))
        nk = kk.shape[2]
        del kk, kv
        ops = 2.0 * LQ * nk * D * N           # each of QK^T and P.V
        ab_ms, ab_by = bound(2 * ops, (LQ + 2 * nk) * N * D
                             + 2.0 * LQ * N * D, PEAK_INT8_OPS)
        # the kernel runs QK^T twice where it needs the row max
        products = 2 if mode == "global" else 3
        design_ms, _ = bound(products * ops, (LQ + 2 * nk) * N * D
                             + 2.0 * LQ * N * D, PEAK_INT8_OPS)
        n_v = int(live.sum()) * tk + LQ
        pb_ms, pb_by = bound(3.0 * n_v * N * D, 3.0 * n_v * N * D,
                             PEAK_F32_FLOPS)
        print(f"kernel {name} {label} (keys {nk}, tiles {tq}/{tk}/{tf}, "
              f"m0={'none' if bnd is None else f'{float(bnd):.4f}'}): "
              f"rel_l2={err:.3e} max_abs={mae:.3e} attend_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_bf16_ms={lib:.4f} "
              f"bound_ms={ab_ms:.4f} ({ab_by}) bound_share={ab_ms / ms:.3f} "
              f"products={products} design_bound_ms={design_ms:.4f} "
              f"design_bound_share={design_ms / ms:.3f} "
              f"tops={2 * ops / ms / 1e9:.1f};"
              f" int8_quantize_v ({n_v} rows) max_int8_step={worst} "
              f"scales_rel_l2={s_err:.3e} ms={pre_ms:.4f} "
              f"plain_ms={pre_plain:.4f} bound_ms={pb_ms:.4f} ({pb_by})",
              flush=True)
        # the table's rows: each mode at its path's shape (online: the
        # windowed configuration's; the V pre-pass: the demo's, global)
        if name not in table or not label.startswith("global"):
            table[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                               bound_ms=ab_ms, bound_by=ab_by,
                               max_abs_err=mae)
        if mode == "tile":
            table["int8_quantize_v"] = dict(
                ms=pre_ms, plain_ms=pre_plain, library_ms=None,
                bound_ms=pb_ms, bound_by=pb_by, max_abs_err=float(worst))
        del qq, vv
    del kc_w, vc_w
    return table


def check_int8(name, out, ref) -> int:
    """int8 outputs: at most one step apart on at most 0.1% of them (a
    value within an ulp of a .5 tie may round either way).  Returns the
    largest step."""
    torch.cuda.synchronize()
    step = (out.int() - ref.int()).abs()
    worst, share = int(step.max()), float((step > 0).float().mean())
    if worst > 1 or share > 1e-3:
        fail(f"{name}: int8 outputs {worst} steps apart on {share:.2e} of "
             f"them")
    return worst


def library_ms(fn) -> float | None:
    """Time of a library yardstick, or None where this PyTorch build does
    not take the call (the yardstick is not part of the port)."""
    try:
        return time_ms(fn)
    except RuntimeError as e:
        print(f"library call refused: {str(e).splitlines()[0]}", flush=True)
        return None


def phase_w8a8_kernels(cm, quant, g) -> dict:
    """The W8A8 kernels against their plain versions at the demo
    configuration's Wan-1.3B shapes.  Library yardstick: ``torch._int_mm``
    on the same int8 operands (the int32 product alone, no epilogue); the
    bf16 ``torch.matmul`` of the same shape is printed beside it (the
    parity configuration's cost)."""
    dev, bf = "cuda", torch.bfloat16
    M = LQ

    def acts(rows):
        x = torch.randn(rows, DIM, generator=g, device=dev)
        x[3] = 0.0                    # a zero row: the scale floor
        return x.to(bf)

    def weight(d_in, d_out):
        w = torch.randn(d_in, d_out, generator=g, device=dev) * d_in ** -0.5
        b = torch.randn(d_out, generator=g, device=dev) * 0.02
        p = quant.quantize_linear_params({"w": w.to(bf), "b": b.to(bf)},
                                         "w8a8")
        return p, w.to(bf)

    def report(name, label, err, mae, ms, plain_ms, lib_ms, ops, nbytes,
               peak=PEAK_INT8_OPS, bf16_ms=None, gemm=False):
        b_ms, b_by = bound(ops, nbytes, peak)
        extra = "" if bf16_ms is None else f" bf16_matmul_ms={bf16_ms:.4f}"
        lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
        equal = " bit_equal=True" if gemm else ""   # check_gemm failed else
        print(f"kernel {name} ({label}): rel_l2={err:.3e} max_abs={mae:.3e}"
              f"{equal} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib}{extra} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
              f"tops={ops / ms / 1e9:.1f}", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=mae)

    table = {}
    x = acts(M)
    q, s = cm.quantize_rows(x)
    q_ref, s_ref = cm.quantize_rows_ref(x)
    worst = check_int8("quantize_rows", q, q_ref)
    s_err = rel_l2(s, s_ref)
    if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
        fail(f"quantize_rows: not bit-equal to the plain version (scales "
             f"relative L2 {s_err:.3e})")
    # no single PyTorch call computes a per-row int8 quantization
    table["quantize_rows"] = report(
        "quantize_rows", f"[{M}, {DIM}] bf16", s_err, float(worst),
        time_ms(lambda: cm.quantize_rows(x)),
        time_ms(lambda: cm.quantize_rows_ref(x), reps=5), None,
        3.0 * M * DIM, M * DIM * 3.0 + M * 4.0, peak=PEAK_F32_FLOPS,
        gemm=True)

    # the three GEMM shapes of a layer: fused qkv; o, cross q and cross o;
    # cross k and v, once per prompt (the row of the table is the qkv's)
    for label, rows, n_out in (("qkv", M, 3 * DIM), ("o/cross q/cross o", M,
                                                     DIM),
                               ("cross k/v", N_CTX, DIM)):
        xx = x if rows == M else acts(rows)
        xq, xs = (q, s) if rows == M else cm.quantize_rows_ref(xx)
        p, wb = weight(DIM, n_out)
        args = (xq, xs, p["w_qa_t"], p["w_scale"], p["b"])
        err, mae = check_gemm("w8a8_matmul", cm.w8a8_matmul(*args),
                              cm.w8a8_matmul_ref(*args))
        row = report(
            "w8a8_matmul", f"{label} {rows}x{DIM}x{n_out}", err, mae,
            time_ms(lambda: cm.w8a8_matmul(*args)),
            time_ms(lambda: cm.w8a8_matmul_ref(*args), reps=5),
            library_ms(lambda: torch._int_mm(xq, p["w_qa_t"].t())),
            2.0 * rows * DIM * n_out,
            rows * DIM + rows * 4.0 + n_out * DIM + n_out * 8.0
            + rows * n_out * 2.0,
            bf16_ms=time_ms(lambda: xx @ wb), gemm=True)
        table.setdefault("w8a8_matmul", row)
        del p, wb

    (p1, w1b), (p2, w2b) = weight(DIM, FFN), weight(FFN, DIM)
    tg = cm.ffn_group(M, DIM, FFN, DIM, raw_x=True)
    a1 = (p1["w_qa_t"], p1["w_scale"], p1["b"], tg)
    hq, hs = cm.w8a8_ffn1(x, *a1)
    hq_ref, hs_ref = cm.w8a8_ffn1_ref(x, None, *a1)
    worst = check_int8("w8a8_ffn1", hq, hq_ref)
    hs_err = rel_l2(hs, hs_ref)
    if hs_err > 1e-5:
        fail(f"w8a8_ffn1: group scales relative L2 {hs_err:.3e} > 1e-5")
    ng = FFN // tg
    table["w8a8_ffn1"] = report(
        "w8a8_ffn1", f"{M}x{DIM}x{FFN} from raw bf16 x (the quantize_rows "
        f"pre-pass included), groups of {tg}", hs_err,
        float(worst), time_ms(lambda: cm.w8a8_ffn1(x, *a1)),
        time_ms(lambda: cm.w8a8_ffn1_ref(x, None, *a1), reps=5),
        library_ms(lambda: torch._int_mm(q, p1["w_qa_t"].t())),
        2.0 * M * DIM * FFN,
        M * DIM * 2.0 + FFN * DIM + FFN * 8.0 + M * FFN + M * ng * 4.0,
        bf16_ms=time_ms(lambda: x @ w1b))

    a2 = (p2["w_qa_t"], p2["w_scale"], p2["b"], tg)
    err, mae = check_gemm("w8a8_ffn2", cm.w8a8_ffn2(hq_ref, hs_ref, *a2),
                          cm.w8a8_ffn2_ref(hq_ref, hs_ref, *a2))
    hb = torch.randn(M, FFN, generator=g, device=dev).to(bf)
    table["w8a8_ffn2"] = report(
        "w8a8_ffn2", f"{M}x{FFN}x{DIM}, groups of {tg}", err, mae,
        time_ms(lambda: cm.w8a8_ffn2(hq_ref, hs_ref, *a2)),
        time_ms(lambda: cm.w8a8_ffn2_ref(hq_ref, hs_ref, *a2), reps=5),
        library_ms(lambda: torch._int_mm(hq_ref, p2["w_qa_t"].t())),
        2.0 * M * FFN * DIM,
        M * FFN + M * ng * 4.0 + DIM * FFN + DIM * 8.0 + M * DIM * 2.0,
        bf16_ms=time_ms(lambda: hb @ w2b), gemm=True)

    args = (p1["w_qa_t"], p1["w_scale"], p1["b"], p2["w_qa_t"],
            p2["w_scale"], p2["b"])
    err, _ = check_kernel("w8a8_ffn", cm.w8a8_ffn(x, None, *args),
                          cm.w8a8_ffn_ref(x, None, *args), tol=1e-2)
    print(f"kernel w8a8_ffn (fc1 then fc2, {M}x{DIM}x{FFN}x{DIM}): "
          f"rel_l2={err:.3e}", flush=True)
    return table


def phase_wide_w8a8_kernels(cm, quant, g) -> dict:
    """The W8A8 kernels of the Wan-14B demo path (dim 5120, 40 heads, ffn
    13824, M = 4680 tokens) against their plain versions: fc1 from int8 x
    quantized by ``quantize_activations`` (K = 5120 in 128-byte steps,
    768-column groups), fc2 at groups of 768 onto N = 5120, the fused qkv
    GEMM at K = 5120, N = 15360; and the GEMM from raw bf16 x
    (``w8a8_matmul_bf16x``: the ``quantize_rows`` pre-pass, then the
    int8-x linear, timed together) at the 1.3B qkv shape.  Tolerances as
    phase 2's W8A8 rows: int8 outputs equal but for one-step flips on
    <= 0.1%, group scales 1e-5, GEMMs bit-equal.  Library
    yardsticks: ``torch._int_mm`` on the same int8 operands, cuBLAS bf16
    beside it."""
    dev, bf = "cuda", torch.bfloat16
    M, K, Hh = LQ, DIM_14B, FFN_14B
    table = {}

    def weight(d_in, d_out):
        w = torch.randn(d_in, d_out, generator=g, device=dev) * d_in ** -0.5
        b = torch.randn(d_out, generator=g, device=dev) * 0.02
        p = quant.quantize_linear_params({"w": w.to(bf), "b": b.to(bf)},
                                         "w8a8")
        return p, w.to(bf)

    def report(name, label, err, mae, ms, plain_ms, lib_ms, bf16_ms, ops,
               nbytes, gemm=True):
        b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
        lib = "none" if lib_ms is None else f"{lib_ms:.4f}"
        equal = " bit_equal=True" if gemm else ""   # check_gemm failed else
        print(f"kernel {name} ({label}): rel_l2={err:.3e} max_abs={mae:.3e}"
              f"{equal} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib} "
              f"bf16_matmul_ms={bf16_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
              f"share_of_bound={b_ms / ms:.3f} tops={ops / ms / 1e9:.1f}",
              flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by, max_abs_err=mae)

    x = torch.randn(M, K, generator=g, device=dev).to(bf)
    x[3] = 0.0
    if cm.quantize_rows(x) is not None or cm.ffn_group(M, K, Hh, K, True):
        fail("14B shapes: quantize_rows / raw-x fc1 took K = 5120")
    xq, sx = quant.quantize_activations(x)
    (p1, w1b), (p2, w2b) = weight(K, Hh), weight(Hh, K)
    tg = cm.ffn_group(M, K, Hh, K, raw_x=False)
    a1 = (p1["w_qa_t"], p1["w_scale"], p1["b"], tg, sx)
    hq, hs = cm.w8a8_ffn1(xq, *a1)
    hq_ref, hs_ref = cm.w8a8_ffn1_ref(xq, sx, *a1[:4])
    worst = check_int8("w8a8_ffn1_xq", hq, hq_ref)
    hs_err = rel_l2(hs, hs_ref)
    if hs_err > 1e-5:
        fail(f"w8a8_ffn1_xq: group scales relative L2 {hs_err:.3e} > 1e-5")
    ng = Hh // tg
    table["w8a8_ffn1_xq"] = report(
        "w8a8_ffn1_xq", f"14B {M}x{K}x{Hh}, int8 x, groups of {tg}", hs_err,
        float(worst), time_ms(lambda: cm.w8a8_ffn1(xq, *a1)),
        time_ms(lambda: cm.w8a8_ffn1_ref(xq, sx, *a1[:4]), reps=3),
        library_ms(lambda: torch._int_mm(xq, p1["w_qa_t"].t())),
        time_ms(lambda: x @ w1b), 2.0 * M * K * Hh,
        M * K + M * 4.0 + Hh * K + Hh * 8.0 + M * Hh + M * ng * 4.0,
        gemm=False)
    del hq, hs, w1b

    a2 = (p2["w_qa_t"], p2["w_scale"], p2["b"], tg)
    err, mae = check_gemm("w8a8_ffn2", cm.w8a8_ffn2(hq_ref, hs_ref, *a2),
                          cm.w8a8_ffn2_ref(hq_ref, hs_ref, *a2))
    hb = torch.randn(M, Hh, generator=g, device=dev).to(bf)
    report("w8a8_ffn2", f"14B {M}x{Hh}x{K}, groups of {tg}", err, mae,
           time_ms(lambda: cm.w8a8_ffn2(hq_ref, hs_ref, *a2)),
           time_ms(lambda: cm.w8a8_ffn2_ref(hq_ref, hs_ref, *a2), reps=3),
           library_ms(lambda: torch._int_mm(hq_ref, p2["w_qa_t"].t())),
           time_ms(lambda: hb @ w2b), 2.0 * M * Hh * K,
           M * Hh + M * ng * 4.0 + K * Hh + K * 8.0 + M * K * 2.0)
    args = (p1["w_qa_t"], p1["w_scale"], p1["b"], p2["w_qa_t"],
            p2["w_scale"], p2["b"])
    err, _ = check_kernel("w8a8_ffn", cm.w8a8_ffn(xq, sx, *args),
                          cm.w8a8_ffn_ref(xq, sx, *args), tol=1e-2)
    print(f"kernel w8a8_ffn (14B, from int8 x: fc1_xq then fc2): "
          f"rel_l2={err:.3e}", flush=True)
    del hb, w2b, hq_ref, hs_ref, p1, p2, args, a1, a2
    torch.cuda.empty_cache()

    # the 14B linears: fused qkv; o, cross q and cross o
    for label, n_out in (("qkv", 3 * K), ("o/cross q/cross o", K)):
        p, wb = weight(K, n_out)
        args = (xq, sx, p["w_qa_t"], p["w_scale"], p["b"])
        err, mae = check_gemm("w8a8_matmul", cm.w8a8_matmul(*args),
                              cm.w8a8_matmul_ref(*args))
        report("w8a8_matmul", f"14B {label} {M}x{K}x{n_out}, 40 K steps",
               err, mae, time_ms(lambda: cm.w8a8_matmul(*args)),
               time_ms(lambda: cm.w8a8_matmul_ref(*args), reps=3),
               library_ms(lambda: torch._int_mm(xq, p["w_qa_t"].t())),
               time_ms(lambda: x @ wb), 2.0 * M * K * n_out,
               M * K + M * 4.0 + n_out * K + n_out * 8.0 + M * n_out * 2.0)
        del p, wb, args
    del x, xq, sx
    torch.cuda.empty_cache()

    # the raw-x GEMM at the 1.3B fused qkv shape (K = 1536 in one tile)
    x = torch.randn(M, DIM, generator=g, device=dev).to(bf)
    x[3] = 0.0
    p, wb = weight(DIM, 3 * DIM)
    args = (x, p["w_qa_t"], p["w_scale"], p["b"])
    err, mae = check_gemm("w8a8_matmul_bf16x", cm.w8a8_matmul_bf16x(*args),
                          cm.w8a8_matmul_bf16x_ref(*args))
    xq, _ = cm.quantize_rows_ref(x)
    table["w8a8_matmul_bf16x"] = report(
        "w8a8_matmul_bf16x", f"1.3B qkv {M}x{DIM}x{3 * DIM}, raw bf16 x",
        err, mae, time_ms(lambda: cm.w8a8_matmul_bf16x(*args)),
        time_ms(lambda: cm.w8a8_matmul_bf16x_ref(*args), reps=3),
        library_ms(lambda: torch._int_mm(xq, p["w_qa_t"].t())),
        time_ms(lambda: x @ wb), 2.0 * M * DIM * 3 * DIM,
        M * DIM * 2.0 + 3 * DIM * DIM + 3 * DIM * 8.0 + M * 3 * DIM * 2.0)
    return table


def phase_window_kernels(ca, g) -> dict:
    """The cache-window attention (``decode_attention``; the TPU's
    ``_decode_kernel``) at the 1.3B global window: 4680 queries onto keys
    [0, 28080) of a 32760-token folded cache, 12 heads of 128, in bf16
    (1e-2 relative L2: p rounded to bf16 for P.V) and float32 (3xTF32
    products on tf32 wgmma, after the pre-pass that splits the window's K
    and V^T, timed together: 1e-4), against the port of
    ``decode_attention_xla`` in
    float32 (TF32 off).  Library yardstick: SDPA on the window slice (the
    same dtype).  The float32 bound counts the three TF32 tensor-core
    products that form each 3xTF32 product (495 / 3 TFLOP/s)."""
    dev, D, N = "cuda", HEAD_DIM, N_HEADS
    S, hi = SEQ_TRAIN, LAST_KV_END
    table = {}
    for dt, name, tol, peak in ((torch.bfloat16, "decode_window", 1e-2,
                                 PEAK_BF16_FLOPS),
                                (torch.float32, "decode_window_f32", 1e-4,
                                 PEAK_3XTF32_FLOPS)):
        q = torch.randn(1, LQ, N, D, generator=g, device=dev).to(dt)
        kc = torch.randn(N, S, D, generator=g, device=dev).to(dt)
        vc = torch.randn(N, S, D, generator=g, device=dev).to(dt)
        lo_t = torch.zeros((), dtype=torch.int32, device=dev)
        hi_t = torch.full((), hi, dtype=torch.int32, device=dev)
        out = ca.decode_window(q, kc, vc, lo_t, hi_t)
        ref = ca.decode_window_ref(q.float(), kc.float(), vc.float(), 0, hi)
        err, mae = check_kernel(name, out, ref, tol=tol)
        del out, ref
        ms = time_ms(lambda: ca.decode_window(q, kc, vc, lo_t, hi_t))
        plain_ms = time_ms(lambda: ca.decode_window_ref(q, kc, vc, 0, hi),
                           reps=3)
        qh = q.transpose(1, 2)
        kh, vh = kc[None, :, :hi], vc[None, :, :hi]
        lib = library_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4.0 * LQ * hi * D * N
        nbytes = q.element_size() * (2.0 * LQ * N * D + 2.0 * hi * N * D)
        b_ms, b_by = bound(flops, nbytes, peak)
        print(f"kernel {name} (Lq={LQ}, window [0, {hi}) of {S}, {N} heads, "
              f"{dt}): rel_l2={err:.3e} max_abs={mae:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} sdpa_ms="
              f"{'none' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by}) "
              f"tflops={flops / ms / 1e9:.1f} "
              f"bound_share={b_ms / ms:.3f}", flush=True)
        table[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                           bound_ms=b_ms, bound_by=b_by, max_abs_err=mae)
        del q, kc, vc, qh, kh, vh
        torch.cuda.empty_cache()
    return table


def mask_visible(mask, Lq: int, Lk: int) -> float:
    """The share of the Lq x Lk (query, key) pairs an IntervalMask (or
    None: all) leaves visible."""
    if mask is None:
        return 1.0
    return float((mask.end1 - mask.start1).astype("int64").sum()
                 + (mask.end2 - mask.start2).astype("int64").sum()) / Lq / Lk


def once_ms(fn):
    """(fn's result, the ms of that one call by CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def flash_pair_rows(ca, q, k, v, do, mask, label) -> dict:
    """``flash_fwd`` and ``flash_bwd`` on q, k, v [B, L, 12, 128] bf16 (q
    carrying the folded head_dim**-0.5 * log2(e)) under ``mask``: each
    against its plain version (out 1e-2 relative L2, lse 1e-3 absolute,
    dq / dk / dv 2e-2), timed with CUDA events beside the bound and
    SDPA's forward and backward on the same inputs; one line each.  The
    plain versions (seconds a call) are timed by their one call of the
    check.  Returns the two rows."""
    B, L, N, D = q.shape
    frac = mask_visible(mask, L, L)
    out, lse = ca.flash_fwd(q, k, v, mask)
    (ref, ref_lse), fwd_once = once_ms(lambda: ca.flash_fwd_ref(q, k, v,
                                                                mask))
    err, mae = check_kernel("flash_fwd", out, ref)
    lse_err = float((lse - ref_lse).abs().max())
    if lse_err > 1e-3:
        fail(f"flash_fwd ({label}): lse max abs error {lse_err:.3e} > 1e-3")
    delta = ca.flash_delta(ref, do)
    args = (q, k, v, do, ref_lse, delta, mask)
    grads = ca.flash_bwd(*args)
    plain_grads, bwd_once = once_ms(lambda: (
        ca.flash_bwd_dq_ref(*args), *ca.flash_bwd_dkv_ref(*args)))
    bwd_errs = [check_kernel(f"flash_bwd {name} ({label})", a, b, tol=2e-2)
                for name, a, b in zip(("dq", "dk", "dv"), grads,
                                      plain_grads)]
    del out, ref, grads, plain_grads

    prod = 2.0 * B * L * L * D * N * frac    # one product over the pairs
    row_bytes = 2.0 * B * L * N * D          # one [B, L, 12, 128] bf16
    fwd_ms = time_ms(lambda: ca.flash_fwd(q, k, v, mask))
    bwd_ms = time_ms(lambda: ca.flash_bwd(*args))
    lib_fwd, lib_bwd, backend = sdpa_yardsticks(q, k, v, do, mask)
    # bound: operations at the bf16 peak (2 products forward; 5
    # backward: s, dp, p^T.do, ds^T.q, ds.k) against each input read
    # once and each output written once (backward: q, k, v, do, lse,
    # delta in; dq, dk, dv out)
    rows = [("flash_fwd", fwd_ms, fwd_once, lib_fwd, 2 * prod,
             4 * row_bytes + 4.0 * B * L * N, err, mae),
            ("flash_bwd", bwd_ms, bwd_once, lib_bwd, 5 * prod,
             7 * row_bytes + 8.0 * B * L * N,
             max(e for e, _ in bwd_errs), max(m for _, m in bwd_errs))]
    table = {}
    for name, ms, pms, lms, ops, nbytes, e, m in rows:
        b_ms, b_by = bound(ops, nbytes)
        lib = "none" if lms is None else f"{lms:.4f}"
        print(f"kernel {name} ({label}, B={B}, L={L}, visible {frac:.4f}): "
              f"rel_l2={e:.3e} max_abs={m:.3e} ms={ms:.4f} "
              f"plain_ms={pms:.4f} sdpa_ms={lib} ({backend}) "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share="
              f"{b_ms / ms:.3f} tflops={ops / ms / 1e9:.1f}", flush=True)
        table[name] = dict(ms=ms, plain_ms=pms, library_ms=lms,
                           bound_ms=b_ms, bound_by=b_by, max_abs_err=m)
    (dq_err, _), (dk_err, _), (dv_err, _) = bwd_errs
    print(f"flash {label}: lse max_abs={lse_err:.3e} flash_bwd rel_l2 "
          f"dq={dq_err:.3e} dk={dk_err:.3e} dv={dv_err:.3e}", flush=True)
    return table


def flash_operands(B: int, L: int, N: int, g):
    """Seeded bf16 q (with the folded head_dim**-0.5 * log2(e)), k, v and
    an output gradient, [B, L, N, 128] on the card."""
    D = HEAD_DIM
    q = (torch.randn(B, L, N, D, generator=g, device="cuda")
         * (D ** -0.5 * LOG2E)).to(torch.bfloat16)
    k, v, do = (torch.randn(B, L, N, D, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(3))
    return q, k, v, do


def phase_flash_kernels(ca, masks, g) -> dict:
    """The training path's flash kernels against their plain versions at
    B 1, L 32760, 12 heads of 128 in bf16 (q carrying the folded
    head_dim**-0.5 * log2(e)), with no mask (the DMD path's score models)
    and with the 7-block block-causal mask of 3-frame blocks
    (:func:`flash_pair_rows`: tolerance 1e-2 relative L2 for out (both
    round p to bf16), 2e-2 for each of dq, dk, dv of the one backward
    kernel (both round p and ds to bf16 for the products; ds is a
    difference of near-equal terms, so its rounding may differ by an
    ulp), 1e-3 absolute for lse (fp32 sums)).  Library yardsticks: SDPA
    forward on the same inputs at scale ln 2 (base-2 scores), and SDPA's
    backward (one autograd call computing dq, dk and dv, its backend
    named); under the mask SDPA takes it as a dense boolean [L, L]
    mask."""
    L = SEQ_TRAIN
    q, k, v, do = flash_operands(1, L, N_HEADS, g)
    table = {}
    for label, mask in (("no mask", None),
                        ("block-causal 7x3 frames",
                         masks.block_causal_mask(21, 1560, 3))):
        rows = flash_pair_rows(ca, q, k, v, do, mask, label)
        if mask is None:   # the DMD path's shape is the table's row
            table.update(rows)
        table.update(flash_mode_rows(ca, q, k, v, mask, label,
                                     mask_visible(mask, L, L)))
    return table


def phase_trainer_flash_kernels(ca, masks, g) -> dict:
    """The flash kernels at the shapes the other trainers give them (12
    heads of 128): the causal-diffusion trainer's teacher-forcing mask
    over the doubled [clean | noisy] sequence of 2 x 21 frames (L =
    65520, 3-frame blocks) and the GAN discriminator's unmasked fake|real
    pass (B = 2, L = 32760); as :func:`flash_pair_rows`, the plain
    versions (seconds a call at these sizes) timed by their one call of
    the check.  Returns the rows by shape."""
    out = {}
    for label, B, L, mask in (
            ("teacher forcing 2x21 frames", 1, 2 * SEQ_TRAIN,
             masks.teacher_forcing_mask(21, 1560, 3)),
            ("no mask, fake|real batch", 2, SEQ_TRAIN, None)):
        q, k, v, do = flash_operands(B, L, N_HEADS, g)
        out[label] = flash_pair_rows(ca, q, k, v, do, mask, label)
        del q, k, v, do
        torch.cuda.empty_cache()
    return out


def phase_i2v_kernels(ca, g) -> None:
    """The two kernels of the image-to-video path at the Wan-I2V-14B shapes
    no earlier row holds: the unmasked flash forward at L 32760 and 40
    heads of 128 (q carrying the folded head_dim**-0.5 * log2(e)), and the
    cross attention of 32760 heads-packed queries [1, L, 5120] onto the 257
    image keys and onto the 512 text keys.  Each against its plain version
    (1e-2 relative L2; lse 1e-3 absolute), timed with CUDA events beside
    its bound and SDPA on the same inputs."""
    dev, bf = "cuda", torch.bfloat16
    D, N, L = HEAD_DIM, 40, SEQ_TRAIN
    q = (torch.randn(1, L, N, D, generator=g, device=dev)
         * (D ** -0.5 * LOG2E)).to(bf)
    k, v = (torch.randn(1, L, N, D, generator=g, device=dev, dtype=bf)
            for _ in range(2))
    out, lse = ca.flash_fwd(q, k, v, None)
    (ref, ref_lse), pms = once_ms(lambda: ca.flash_fwd_ref(q, k, v, None))
    err, mae = check_kernel("flash_fwd (40 heads)", out, ref)
    lse_err = float((lse - ref_lse).abs().max())
    if lse_err > 1e-3:
        fail(f"flash_fwd (40 heads): lse max abs error {lse_err:.3e} > 1e-3")
    del out, ref, lse, ref_lse
    ms = time_ms(lambda: ca.flash_fwd(q, k, v, None))
    lib, _, _ = sdpa_yardsticks(q, k, v, None, None)
    ops = 4.0 * L * L * D * N
    b_ms, b_by = bound(ops, 4 * 2.0 * L * N * D + 4.0 * L * N)
    print(f"kernel flash_fwd (i2v: no mask, L={L}, {N} heads): "
          f"rel_l2={err:.3e} max_abs={mae:.3e} lse_max_abs={lse_err:.3e} "
          f"ms={ms:.4f} plain_ms={pms:.4f} "
          f"sdpa_ms={'none' if lib is None else f'{lib:.4f}'} "
          f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
          f"tflops={ops / ms / 1e9:.1f}", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    qx = torch.randn(1, L, N * D, generator=g, device=dev, dtype=bf)
    for Lk, what in ((257, "image"), (512, "text")):
        k = torch.randn(1, Lk, N, D, generator=g, device=dev, dtype=bf)
        v = torch.randn(1, Lk, N, D, generator=g, device=dev, dtype=bf)
        out = ca.cross_attention(qx, k, v, num_heads=N)
        ref = ca.cross_attention_ref(qx, k, v, num_heads=N)
        err, mae = check_kernel(f"cross_attention (Lk={Lk})", out, ref)
        del out, ref
        ms = time_ms(lambda: ca.cross_attention(qx, k, v, num_heads=N))
        pms = time_ms(lambda: ca.cross_attention_ref(qx, k, v, num_heads=N),
                      reps=3)
        qh, kh, vh = (qx.reshape(1, L, N, D).transpose(1, 2),
                      k.transpose(1, 2), v.transpose(1, 2))
        lib = library_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4.0 * L * Lk * D * N
        b_ms, b_by = bound(flops, 2.0 * (2 * L * N * D + 2 * Lk * N * D))
        print(f"kernel cross_attention (i2v: Lq={L}, {N} heads, Lk={Lk} "
              f"{what} keys): rel_l2={err:.3e} max_abs={mae:.3e} "
              f"ms={ms:.4f} plain_ms={pms:.4f} "
              f"sdpa_ms={'none' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
              f"tflops={flops / ms / 1e9:.1f}", flush=True)
        del k, v, qh, kh, vh
    del qx
    torch.cuda.empty_cache()


def phase_tp_kernels(ca, g) -> dict:
    """The decode and cross attention kernels at the head count one rank
    of Wan-14B runs under tensor parallelism over 2 ranks (phase 16): 20
    heads of 128, heads-packed queries [1, 4680, 2560].  The decode at
    block 7's window (28080 cached keys + the 4680 fresh, one layer of
    the cache), the cross onto 512 text keys; each against its plain
    version (1e-2 relative L2), timed with CUDA events beside its bound
    and SDPA on the same inputs.  Returns their rows of the kernel
    table."""
    dev, bf = "cuda", torch.bfloat16
    D, N = HEAD_DIM, 40 // TP_RANKS
    q = (torch.randn(1, LQ, N * D, generator=g, device=dev)
         * (D ** -0.5 * LOG2E)).to(bf)
    kc, vc = (torch.randn(1, N, S_CACHE, D, generator=g, device=dev,
                          dtype=bf) for _ in range(2))
    kn, vn = (torch.randn(1, LQ, N * D, generator=g, device=dev, dtype=bf)
              for _ in range(2))
    args = dict(layer_idx=0, kv_start=0, kv_end=LAST_KV_END, sink_end=0,
                static_hi=LAST_KV_END, num_heads=N)
    err, mae = check_kernel("decode_fresh_free (20 heads)",
                            ca.decode_fresh_free(q, kc, vc, kn, vn, **args),
                            ca.decode_fresh_free_ref(q, kc, vc, kn, vn,
                                                     **args))
    ms = time_ms(lambda: ca.decode_fresh_free(q, kc, vc, kn, vn, **args))
    pms = time_ms(lambda: ca.decode_fresh_free_ref(q, kc, vc, kn, vn,
                                                   **args), reps=3)
    heads = lambda t: t.reshape(1, -1, N, D).transpose(1, 2)  # noqa: E731
    kv_k = torch.cat([kc[0, :, :LAST_KV_END][None], heads(kn)], dim=2)
    kv_v = torch.cat([vc[0, :, :LAST_KV_END][None], heads(vn)], dim=2)
    qh = heads(q)
    lib = library_ms(lambda: F.scaled_dot_product_attention(
        qh, kv_k, kv_v, scale=math.log(2.0)))
    n_keys = LAST_KV_END + LQ
    flops = 4.0 * LQ * n_keys * D * N
    b_ms, b_by = bound(flops, 2.0 * (2 * LQ * N * D + 2 * n_keys * N * D))
    print(f"kernel decode_fresh_free (14B tp 2: {N} heads, kv_end="
          f"{LAST_KV_END} + {LQ} fresh): rel_l2={err:.3e} max_abs={mae:.3e} "
          f"ms={ms:.4f} plain_ms={pms:.4f} "
          f"sdpa_ms={'none' if lib is None else f'{lib:.4f}'} "
          f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
          f"tflops={flops / ms / 1e9:.1f}", flush=True)
    table = {"decode_fresh_free_tp2": dict(
        ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=mae)}
    del kc, vc, kn, vn, kv_k, kv_v, qh

    Lk = 512
    k, v = (torch.randn(1, Lk, N, D, generator=g, device=dev, dtype=bf)
            for _ in range(2))
    err, mae = check_kernel("cross_attention (20 heads)",
                            ca.cross_attention(q, k, v, num_heads=N),
                            ca.cross_attention_ref(q, k, v, num_heads=N))
    ms = time_ms(lambda: ca.cross_attention(q, k, v, num_heads=N))
    pms = time_ms(lambda: ca.cross_attention_ref(q, k, v, num_heads=N),
                  reps=3)
    qh, kh, vh = heads(q), k.transpose(1, 2), v.transpose(1, 2)
    lib = library_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh))
    flops = 4.0 * LQ * Lk * D * N
    b_ms, b_by = bound(flops, 2.0 * (2 * LQ * N * D + 2 * Lk * N * D))
    print(f"kernel cross_attention (14B tp 2: {N} heads, Lk={Lk}): "
          f"rel_l2={err:.3e} max_abs={mae:.3e} ms={ms:.4f} "
          f"plain_ms={pms:.4f} "
          f"sdpa_ms={'none' if lib is None else f'{lib:.4f}'} "
          f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
          f"tflops={flops / ms / 1e9:.1f}", flush=True)
    table["cross_attention_tp2"] = dict(
        ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=b_by,
        max_abs_err=mae)
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return table


def sdpa_yardsticks(q, k, v, do, mask, scale=math.log(2.0)):
    """SDPA's forward and, with ``do`` given, its backward (one autograd
    call for dq, dk, dv) at ``scale`` on [1, L, N, D] operands: with no
    mask, or with the IntervalMask as a dense boolean [L, L] mask through
    the memory-efficient backend (the math backend's [N, L, L] float32
    scores would not fit); None where PyTorch refuses the call.  Also the
    name of the backend SDPA picks for the backward's inputs (its
    backward is that backend's)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    dense = None
    if mask is not None:
        from torch.nn.attention import SDPBackend, sdpa_kernel
        L = q.shape[1]
        j = torch.arange(L, device=q.device)
        s1, e1, s2, e2 = (torch.from_numpy(a[:L].astype("int64")).to(
            q.device)[:, None] for a in (mask.start1, mask.end1,
                                         mask.start2, mask.end2))
        dense = ((j >= s1) & (j < e1)) | ((j >= s2) & (j < e2))
        del s1, e1, s2, e2

    def sdpa(a, b, c):
        if dense is None:
            return F.scaled_dot_product_attention(a, b, c, scale=scale)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(a, b, c, attn_mask=dense,
                                                  scale=scale)

    lib_fwd = library_ms(lambda: sdpa(qh, kh, vh))
    lib_bwd, backend = None, "none"
    if lib_fwd is not None and do is not None:
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (qh, kh, vh))
        backend = sdpa_backend(qg, kg, vg, dense, scale)
        o = sdpa(qg, kg, vg)
        dh = do.transpose(1, 2)
        lib_bwd = library_ms(lambda: torch.autograd.grad(
            o, (qg, kg, vg), dh, retain_graph=True))
        del o, qg, kg, vg
    del dense
    torch.cuda.empty_cache()
    return lib_fwd, lib_bwd, backend


def sdpa_backend(q, k, v, dense, scale) -> str:
    """The SDPA backend for these [B, N, L, D] inputs: the memory-efficient
    one under a dense mask (forced there), else what
    ``torch._fused_sdp_choice`` picks; 'unknown' where this PyTorch build
    does not say."""
    from torch.nn.attention import SDPBackend
    if dense is not None:
        return SDPBackend.EFFICIENT_ATTENTION.name
    try:
        return SDPBackend(torch._fused_sdp_choice(q, k, v,
                                                  scale=scale)).name
    except (AttributeError, RuntimeError, TypeError, ValueError):
        return "unknown"


def flash_mode_rows(ca, q, k, v, mask, label, frac) -> dict:
    """The flash forward's online and bounded modes (the DiT's bound
    head_dim**-0.5 * max|q_row| * max|k_row|, on the card) against their
    plain versions on unfolded q at head_dim**-0.5: 1e-2 relative L2 on
    out, 1e-3 absolute on lse.  SDPA at the same scale is the library
    yardstick (under the mask as a dense boolean mask).  Returns the
    no-mask rows."""
    D, N, L = HEAD_DIM, N_HEADS, SEQ_TRAIN
    qu = (q.float() / (D ** -0.5 * LOG2E)).to(q.dtype)
    m0 = (D ** -0.5 * qu.float().norm(dim=-1).amax()
          * k.float().norm(dim=-1).amax()).reshape(1)
    lib, _, _ = sdpa_yardsticks(qu, k, v, None, mask, scale=D ** -0.5)
    prod = 2.0 * L * L * D * N * frac
    b_ms, b_by = bound(2 * prod, 4 * 2.0 * L * N * D + 4.0 * L * N)
    rows = {}
    for mode in ("online", "bounded"):
        kw = dict(mode=mode, scale=D ** -0.5,
                  m0=m0 if mode == "bounded" else None)
        name = f"flash_fwd_{mode}"
        out, lse = ca.flash_fwd(qu, k, v, mask, **kw)
        (ref, ref_lse), pms = once_ms(
            lambda: ca.flash_fwd_ref(qu, k, v, mask, **kw))
        err, mae = check_kernel(name, out, ref)
        lse_err = float((lse - ref_lse).abs().max())
        if lse_err > 1e-3:
            fail(f"{name}: lse max abs error {lse_err:.3e} > 1e-3")
        del out, ref, lse, ref_lse
        ms = time_ms(lambda: ca.flash_fwd(qu, k, v, mask, **kw))
        print(f"kernel {name} ({label}, L={L}, visible {frac:.4f}"
              f"{', m0=%.4f' % float(m0) if mode == 'bounded' else ''}): "
              f"rel_l2={err:.3e} max_abs={mae:.3e} lse_max_abs={lse_err:.3e} "
              f"ms={ms:.4f} plain_ms={pms:.4f} "
              f"sdpa_ms={'none' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
              f"tflops={2 * prod / ms / 1e9:.1f}", flush=True)
        if mask is None:
            rows[name] = dict(ms=ms, plain_ms=pms, library_ms=lib,
                              bound_ms=b_ms, bound_by=b_by, max_abs_err=mae)
    return rows


def make_params(dit, cfg, seed, block_fn=None):
    """Random weights at ``cfg``'s width (``block_fn`` as ``init_params``
    takes it); the zero-initialised output layer gets random values too,
    so the flow depends on every layer."""
    params = dit.init_params(cfg, seed=seed, dtype=torch.bfloat16,
                             device="cuda", block_fn=block_fn)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    w = params["head"]["head"]["w"]
    params["head"]["head"]["w"] = (torch.randn(
        w.shape, generator=g, device="cuda") * w.shape[0] ** -0.5).to(w.dtype)
    return params


def forward_inputs(cfg, g) -> dict:
    """Text context and two latent blocks for the block-2 forwards."""
    B, nb, C, H, W = 1, 3, 16, 60, 104
    return {"context": torch.randn(B, N_CTX, cfg.text_dim, generator=g,
                                   device="cuda").to(torch.bfloat16),
            "x0": torch.randn(B, nb, C, H, W, generator=g, device="cuda"
                              ).to(torch.bfloat16),
            "x1": torch.randn(B, nb, C, H, W, generator=g, device="cuda"
                              ).to(torch.bfloat16)}


def block2_forward(dit, cfg, params, rope, inp, kernels_list) -> dict:
    """Block 1 written to a fresh cache with the kernels, then block 2 run
    once for each ``kernels`` flag without writing (it reads block 1).
    Returns {kernels: (flow, host ms of that forward)}."""
    B, nb, _, H, W = inp["x0"].shape
    fs = (H // 2) * (W // 2)
    ctx_kv = dit.precompute_context(params, cfg, inp["context"])
    cache = dit.init_kv_cache(cfg, B, fs, 21, torch.bfloat16, "cuda")
    t0 = torch.zeros(B, nb, device="cuda")
    _, cache = dit.forward_inference(params, cfg, inp["x0"], t0, ctx_kv,
                                     cache, 0, rope, static_kv_hi=0)
    t1 = torch.full((B, nb), 750.0, device="cuda")
    outs = {}
    for kernels in kernels_list:
        torch.cuda.synchronize()
        t = time.perf_counter()
        flow, _ = dit.forward_inference(params, cfg, inp["x1"], t1, ctx_kv,
                                        cache, nb, rope, static_kv_hi=nb * fs,
                                        write_cache=False, kernels=kernels)
        torch.cuda.synchronize()
        outs[kernels] = (flow, (time.perf_counter() - t) * 1e3)
    return outs


def phase_forward(dit, cfg, params, rope, inp) -> torch.Tensor:
    """One full-width forward of block 2 with the kernels and with their
    plain versions.  Returns the kernel path's flow."""
    outs = block2_forward(dit, cfg, params, rope, inp, (True, False))
    (flow_k, ms_k), (flow_p, ms_p) = outs[True], outs[False]
    if not torch.isfinite(flow_k.float()).all():
        fail("forward: non-finite flow")
    err = rel_l2(flow_k, flow_p)
    print(f"forward 1.3B block 2 (cache window {LQ} tokens): "
          f"kernels vs plain rel_l2={err:.3e} kernel_path_ms={ms_k:.1f} "
          f"plain_path_ms={ms_p:.1f} (host clock, first calls)", flush=True)
    if err > 2e-2:
        fail(f"forward: kernels vs plain relative L2 {err:.3e} > 2e-2")
    return flow_k


def phase_demo_forward(dit, cfg, qparams, rope, inp, flow_bf16) -> None:
    """The same forward with the demo configuration's W8A8 weights: the
    kernels (attention and W8A8) against their plain versions, and, for
    information, against the bf16 forward on the weights they quantize."""
    outs = block2_forward(dit, cfg, qparams, rope, inp, (True, False))
    (flow_k, ms_k), (flow_p, ms_p) = outs[True], outs[False]
    if not torch.isfinite(flow_k.float()).all():
        fail("demo forward: non-finite flow")
    err = rel_l2(flow_k, flow_p)
    print(f"demo forward 1.3B W8A8 + {cfg.attn_quant} attention block 2 "
          f"(cache window {LQ} tokens): "
          f"kernels vs plain rel_l2={err:.3e} vs bf16 forward "
          f"rel_l2={rel_l2(flow_k, flow_bf16):.3e} kernel_path_ms={ms_k:.1f} "
          f"plain_path_ms={ms_p:.1f} (host clock, first calls)", flush=True)
    # 1.18e-2 measured: the attention kernels' rounding (the bf16 forward
    # shows 7.3e-3) also flips activations near .5 ties of the int8 grid
    if err > 2e-2:
        fail(f"demo forward: kernels vs plain relative L2 {err:.3e} > 2e-2")


def phase_stream(ca, dit, vae, pipe_mod, cfg, params, blocks, seed):
    """The slice: the streaming sampler with per-block VAE decode."""
    from self_forcing_tpu_torch.config import Config
    B, C, H, W = 1, 16, 60, 104
    F_lat = 3 * blocks
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    vae_params = vae.init_params(vae.WAN_VAE, seed=seed + 2,
                                 dtype=torch.bfloat16, device="cuda")
    args = Config({"denoising_step_list": [1000, 750, 500, 250],
                   "warp_denoising_step": True, "timestep_shift": 8.0,
                   "num_frame_per_block": 3, "context_noise": 0})
    pipe = pipe_mod.CausalInferencePipeline(args, params, cfg,
                                            device="cuda",
                                            dtype=torch.bfloat16)
    context = torch.randn(B, 512, cfg.text_dim, generator=g, device="cuda"
                          ).to(torch.bfloat16)
    noise = torch.randn(B, F_lat, C, H, W, generator=g, device="cuda"
                        ).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ca.reset_launch_counts()
    t0 = time.perf_counter()
    block_ms, dit_ms, vae_ms, pixels = [], [], [], []
    ttff = None
    dec_cache = None
    t_blk = t0
    with HostStalls() as stalls:
        for blk in pipe.stream(noise, context, generator=g):
            torch.cuda.synchronize()
            t_got = time.perf_counter()
            dit_ms.append((t_got - t_blk) * 1e3)
            lat = blk.permute(0, 1, 3, 4, 2)
            if dec_cache is None:
                dec_cache = vae.init_decoder_cache(
                    vae_params, vae.WAN_VAE, B, H, W, torch.bfloat16, "cuda")
                px0, dec_cache = vae.decode_frame(vae_params, vae.WAN_VAE,
                                                  lat[:, :1], dec_cache,
                                                  first=True)
                torch.cuda.synchronize()
                ttff = time.perf_counter() - t0
                rest, dec_cache = vae.decode_block(vae_params, vae.WAN_VAE,
                                                   lat[:, 1:], dec_cache,
                                                   first=False)
                pixels += [px0, rest]
            else:
                px, dec_cache = vae.decode_block(
                    vae_params, vae.WAN_VAE, lat, dec_cache, first=False)
                pixels.append(px)
            torch.cuda.synchronize()
            now = time.perf_counter()
            vae_ms.append((now - t_got) * 1e3)
            block_ms.append((now - t_blk) * 1e3)
            t_blk = now
    total = time.perf_counter() - t0
    launches = dict(ca.launch_counts)
    video = torch.cat(pixels, dim=1)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30

    frames = 1 + 4 * (F_lat - 1)
    want = (B, frames, 480, 832, 3)
    if tuple(video.shape) != want:
        fail(f"stream: pixels {tuple(video.shape)}, expected {want}")
    if not torch.isfinite(video.float()).all():
        fail("stream: non-finite pixels")
    check_launches("stream", launches, PARITY_KERNELS)
    print(f"stream 1.3B {blocks} blocks ({F_lat} latent frames, {frames} "
          f"pixel frames 480x832): per_block_ms="
          f"{[round(x, 1) for x in block_ms]} dit_ms={[round(x, 1) for x in dit_ms]} "
          f"vae_ms={[round(x, 1) for x in vae_ms]} ttff_ms={ttff * 1e3:.1f} "
          f"total_ms={total * 1e3:.1f} pixel_fps={frames / total:.3f} "
          f"peak_mem_gb={peak_gb:.2f} {stalls} launches={launches} "
          f"pixel_range=[{float(video.min()):.3f}, "
          f"{float(video.max()):.3f}] (host clock, one run incl. first "
          f"calls; dit_ms = the previous block's refresh + 4 denoise "
          f"forwards)", flush=True)
    last_lat, last_cache = blk.permute(0, 1, 3, 4, 2), list(dec_cache)
    last = dict(pipe=pipe, context=context, x=blk, start=3 * (blocks - 1),
                decode=("vae_block", lambda: vae.decode_block(
                    vae_params, vae.WAN_VAE, last_lat, list(last_cache),
                    first=False)))
    return launches, last


def phase_softmax_modes(ca, dit, pipe_mod, cfg, params, rope, inp,
                        flow_free, blocks, seed) -> dict:
    """Phases 3-4 under ``attn_softmax`` 'bounded' and 'online' on the
    parity weights: the block-2 forward with the kernels and with their
    plain versions (<= 2e-2 relative L2), and its distance to the 'free'
    forward (<= 2e-2: all three are the exact softmax up to bf16
    rounding); then a stream of ``blocks`` 3-frame blocks, each denoised
    (4 forwards) and refreshed into the cache (``denoise_block``,
    ``refresh_block``, as ``inference`` runs them), with the cache's
    per-layer kmax after each refresh (bounded: raised by every refresh;
    online: untouched).  Returns each mode's decode launches of its
    stream."""
    from self_forcing_tpu_torch.config import Config
    B, C, H, W = 1, 16, 60, 104
    fs = (H // 2) * (W // 2)
    launches = {}
    for mode in ("bounded", "online"):
        cfg_m = dataclasses.replace(cfg, attn_softmax=mode)
        outs = block2_forward(dit, cfg_m, params, rope, inp, (True, False))
        (flow_k, ms_k), (flow_p, ms_p) = outs[True], outs[False]
        if not torch.isfinite(flow_k.float()).all():
            fail(f"{mode} forward: non-finite flow")
        err, err_free = rel_l2(flow_k, flow_p), rel_l2(flow_k, flow_free)
        print(f"forward 1.3B block 2 attn_softmax={mode}: kernels vs plain "
              f"rel_l2={err:.3e} vs the free forward rel_l2={err_free:.3e} "
              f"kernel_path_ms={ms_k:.1f} plain_path_ms={ms_p:.1f} (host "
              f"clock, first calls)", flush=True)
        if err > 2e-2 or err_free > 2e-2:
            fail(f"{mode} forward: relative L2 {err:.3e} (kernels vs "
                 f"plain) / {err_free:.3e} (vs free) > 2e-2")
        del outs, flow_k, flow_p

        g = torch.Generator(device="cuda").manual_seed(seed + 11)
        args = Config({"denoising_step_list": [1000, 750, 500, 250],
                       "warp_denoising_step": True, "timestep_shift": 8.0,
                       "num_frame_per_block": 3, "context_noise": 0})
        pipe = pipe_mod.CausalInferencePipeline(args, params, cfg_m,
                                                device="cuda",
                                                dtype=torch.bfloat16)
        context = torch.randn(B, N_CTX, cfg.text_dim, generator=g,
                              device="cuda").to(torch.bfloat16)
        noise = torch.randn(B, 3 * blocks, C, H, W, generator=g,
                            device="cuda").to(torch.bfloat16)
        ctx_kv = dit.precompute_context(params, cfg_m, context)
        cache = dit.init_kv_cache(cfg_m, B, fs, 21, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        block_ms, kmax = [], []
        for b in range(blocks):
            lo = 3 * b
            t0 = time.perf_counter()
            x0, cache = pipe_mod.denoise_block(
                params, cfg_m, pipe.scheduler, pipe.rope, ctx_kv, cache,
                noise[:, lo:lo + 3], pipe.denoising_step_list, lo,
                static_kv_hi=lo * fs, generator=g)
            cache = pipe_mod.refresh_block(params, cfg_m, pipe.rope, ctx_kv,
                                           cache, x0, pipe.context_noise, lo,
                                           static_kv_hi=lo * fs)
            torch.cuda.synchronize()
            block_ms.append((time.perf_counter() - t0) * 1e3)
            if not torch.isfinite(x0.float()).all():
                fail(f"{mode} stream: non-finite block {b}")
            kmax.append(cache.kmax.float().cpu())
        name = f"decode_fresh_{mode}"
        got = dict(ca.launch_counts)
        if got[name] == 0:
            fail(f"{mode} stream: kernel {name} was never launched")
        km = torch.stack(kmax)
        if mode == "bounded" and not (
                (km[0] > 0).all() and (km[1:] >= km[:-1]).all()
                and torch.isfinite(km).all()):
            fail(f"bounded stream: kmax not positive and non-decreasing")
        if mode == "online" and km.any():
            fail("online stream: kmax moved")
        print(f"stream 1.3B attn_softmax={mode} {blocks} blocks (denoise + "
              f"refresh each): block_ms={[round(x, 1) for x in block_ms]} "
              f"kmax per block (layers 0, 1, 15, 29) "
              f"{[[round(float(k[i]), 3) for i in (0, 1, 15, 29)] for k in km]}"
              f" kmax range over layers "
              f"{[(round(float(k.min()), 3), round(float(k.max()), 3)) for k in km]}"
              f" launches={ {k: v for k, v in got.items() if v} }", flush=True)
        launches[name] = got[name]
        del pipe, cache, ctx_kv
        torch.cuda.empty_cache()
    return launches


def phase_demo_stream(ca, cm, dit, taehv, pipe_mod, cfg, qparams, blocks,
                      seed, kernels=DEMO_KERNELS, model="1.3B"):
    """The demo configuration (bench.py's run_demo): the streaming sampler
    on the W8A8 weights with the card's demo attention (int8-QK), each
    block decoded by the stateful TAEHV streamer (random decoder weights
    from the seed); ``model`` names the width in the printed line."""
    from self_forcing_tpu_torch.config import Config
    B, C, H, W = 1, 16, 60, 104
    F_lat = 3 * blocks
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    tae = taehv.init_decoder_params(seed=seed + 4, dtype=torch.bfloat16,
                                    device="cuda")
    args = Config({"denoising_step_list": [1000, 750, 500, 250],
                   "warp_denoising_step": True, "timestep_shift": 8.0,
                   "num_frame_per_block": 3, "context_noise": 0})
    pipe = pipe_mod.CausalInferencePipeline(args, qparams, cfg,
                                            device="cuda",
                                            dtype=torch.bfloat16)
    streamer = taehv.TAEHVStreamer(tae)
    context = torch.randn(B, N_CTX, cfg.text_dim, generator=g, device="cuda"
                          ).to(torch.bfloat16)
    noise = torch.randn(B, F_lat, C, H, W, generator=g, device="cuda"
                        ).to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reserved = torch.cuda.memory_reserved() / 1e9
    ca.reset_launch_counts()
    cm.reset_launch_counts()
    t0 = time.perf_counter()
    block_ms, dit_ms, tae_ms, pixels, lats = [], [], [], [], []
    ttff = None
    t_blk = t0
    with HostStalls() as stalls:
        for blk in pipe.stream(noise, context, generator=g):
            torch.cuda.synchronize()
            t_got = time.perf_counter()
            dit_ms.append((t_got - t_blk) * 1e3)
            state = streamer._state
            lats.append(blk[:, :, :16].to(torch.bfloat16))
            pixels.append(streamer.decode_chunk(lats[-1]))
            torch.cuda.synchronize()
            now = time.perf_counter()
            if ttff is None:
                ttff = now - t0
            tae_ms.append((now - t_got) * 1e3)
            block_ms.append((now - t_blk) * 1e3)
            t_blk = now
    total = time.perf_counter() - t0
    launches = {**ca.launch_counts, **cm.launch_counts}
    video = torch.cat(pixels, dim=1)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    peak_from_start_gb = torch.cuda.max_memory_allocated() / 1e9

    frames = 9 + 12 * (blocks - 1)
    want = (B, frames, 3, 480, 832)
    if tuple(video.shape) != want:
        fail(f"demo stream: pixels {tuple(video.shape)}, expected {want}")
    if not torch.isfinite(video.float()).all():
        fail("demo stream: non-finite pixels")
    check_launches(f"demo stream {model}", launches, kernels)
    # the stateful stream carries each MemBlock's last frame, so it equals
    # one decode of the whole video up to bf16 rounding in other cuDNN
    # algorithms; a lost or misplaced carry moves whole frames
    whole = taehv.decode_video(tae, torch.cat(lats, dim=1))
    err_whole = rel_l2(video, whole)
    if err_whole > 5e-2:
        fail(f"demo stream: streamed pixels vs one whole-video decode "
             f"relative L2 {err_whole:.3e} > 5e-2")
    print(f"demo stream {model} W8A8 + {cfg.attn_quant} attention + TAEHV "
          f"{blocks} blocks ({F_lat} latent "
          f"frames, {frames} pixel frames 480x832): per_block_ms="
          f"{[round(x, 1) for x in block_ms]} dit_ms="
          f"{[round(x, 1) for x in dit_ms]} dit_ms_per_block_after_first="
          f"{sum(dit_ms[1:]) / max(len(dit_ms) - 1, 1):.1f} taehv_ms="
          f"{[round(x, 1) for x in tae_ms]} ttff_ms={ttff * 1e3:.1f} "
          f"total_ms={total * 1e3:.1f} pixel_fps={frames / total:.3f} "
          f"peak_mem_gb={peak_gb:.2f} (GiB; {peak_from_start_gb:.2f} GB) "
          f"reserved_gb_before={reserved:.2f} {stalls} "
          f"launches={launches} "
          f"pixel_range=[{float(video.min()):.3f}, "
          f"{float(video.max()):.3f}] stream_vs_whole_rel_l2="
          f"{err_whole:.3e} (host clock, one run incl. first calls; "
          f"dit_ms = the previous block's refresh + 4 denoise forwards)",
          flush=True)
    lat = lats[-1]
    last = dict(pipe=pipe, context=context, x=blk, start=3 * (blocks - 1),
                decode=("taehv_block", lambda: taehv.decode_video_stateful(
                    tae, lat, state, trim=False)))
    return launches, last


def phase_wan14b(ca, cm, dit, taehv, pipe_mod, quant, chip, blocks,
                 seed) -> dict:
    """The Wan-14B demo stream on one card (BASELINE.json's "Wan 14B
    chunk-wise AR"): ``WAN_14B`` at full width and depth (dim 5120, 40
    heads, 40 layers, ffn 13824), random weights from the seed drawn block
    by block on the card and quantized W8A8 as each block is drawn
    (``init_params(block_fn=quantize_block)``: the bf16 stack never
    exists), the card's demo attention (int8-QK) and stateful TAEHV.  Every
    linear has K = 5120 > 4096, so activations go through
    ``quantize_activations`` into the multi-K-step GEMM and the FFN's fc1
    runs from int8 x (``w8a8_ffn1_xq``).  One block-2 forward kernels vs
    plain on a 4-layer cut of the tree (<= 2e-2), then ``--blocks`` blocks
    streamed at 40 layers with the launch counts reset just before.
    Peak memory from a reset counter (every earlier phase freed)."""
    import functools
    from self_forcing_tpu_torch.models.wan.configs import WAN_14B
    from self_forcing_tpu_torch.models.wan.rope import RopeTables
    from self_forcing_tpu_torch.utils.tree import map_tree
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(WAN_14B, num_frame_per_block=3,
                              attn_quant=chip["demo_attn_quant"])
    t = time.perf_counter()
    qparams = make_params(dit, cfg, seed, block_fn=functools.partial(
        quant.quantize_block, num_layers=cfg.num_layers,
        mode=chip["matmul_quant"]))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    weights_gb = sum(t.numel() * t.element_size() for t in
                     _unique_leaves(qparams)) / 1e9
    print(f"wan14b params: {cfg.num_layers} layers W8A8 drawn block by "
          f"block in {init_s:.1f} s; weights {weights_gb:.2f} GB; held "
          f"before the phase {held:.2f} GB; peak while drawing "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    # one block-2 forward, kernels vs plain, on a 4-layer cut
    g = torch.Generator(device="cuda").manual_seed(seed + 20)
    cut = dict(qparams)
    cut["blocks"] = map_tree(lambda a: a[:4], qparams["blocks"])
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    rope = RopeTables.create(cfg.head_dim, device="cuda")
    inp = forward_inputs(cfg, g)
    outs = block2_forward(dit, cfg4, cut, rope, inp, (True, False))
    (flow_k, ms_k), (flow_p, ms_p) = outs[True], outs[False]
    if not torch.isfinite(flow_k.float()).all():
        fail("wan14b forward: non-finite flow")
    err = rel_l2(flow_k, flow_p)
    print(f"wan14b forward W8A8 + {cfg.attn_quant} attention, 4 of 40 "
          f"layers, block 2 (cache window {LQ} tokens): kernels vs plain "
          f"rel_l2={err:.3e} kernel_path_ms={ms_k:.1f} plain_path_ms="
          f"{ms_p:.1f} (host clock, first calls)", flush=True)
    if err > 2e-2:
        fail(f"wan14b forward: kernels vs plain relative L2 {err:.3e} > "
             f"2e-2")
    del cut, inp, outs, flow_k, flow_p
    torch.cuda.empty_cache()

    launches, last = phase_demo_stream(ca, cm, dit, taehv, pipe_mod, cfg,
                                       qparams, blocks, seed,
                                       kernels=WAN14B_KERNELS, model="14B")
    phase_profile(dit, cfg, qparams, last, "wan14b")
    del last, qparams
    torch.cuda.empty_cache()
    return launches


def t5_bound(cfg, L: int) -> tuple[float, str]:
    """The umT5 encode's bound at L tokens: its bf16 products (the linears
    and the two attention products) at the bf16 rate against the weights
    read once (the embedding rows gathered, not the table) and the
    context written."""
    per_layer = 4 * cfg.dim * cfg.dim_attn + 3 * cfg.dim * cfg.dim_ffn
    flops = cfg.num_layers * (2 * L * per_layer
                              + 2 * 2 * L * L * cfg.dim_attn)
    nbytes = 2 * (cfg.num_layers * per_layer + 2 * L * cfg.dim)
    return bound(flops, nbytes)


def export_model_dir(model_dir: str, t5p, params, cfg, vae_params) -> dict:
    """The T5, the DiT and the VAE exported to the reference's state dicts
    and saved with ``torch.save`` under the file names
    ``runtime.load_wan_models`` looks for; returns the GB of each file."""
    from self_forcing_tpu_torch.utils import checkpoints as ckpt
    exports = {
        "models_t5_umt5-xxl-enc-bf16.pth":
            lambda: ckpt.export_t5_state_dict(t5p),
        os.path.join("Wan2.1-T2V-1.3B", "model.pt"):
            lambda: ckpt.export_dit_state_dict(params, cfg),
        "Wan2.1_VAE.pth": lambda: ckpt.export_vae_state_dict(vae_params)}
    sizes = {}
    for name, export in exports.items():
        path = os.path.join(model_dir, name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(export(), path)
        sizes[name] = round(os.path.getsize(path) / 1e9, 3)
    return sizes


def model_dir_params(dit, vae, seed):
    """Phase 10's random umT5-XXL, 1.3B DiT (and its config) and float32
    VAE, drawn from the seed."""
    from self_forcing_tpu_torch.models.wan import t5 as t5_mod
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    t5p = t5_mod.init_params(t5_mod.UMT5_XXL, seed=seed + 31,
                             dtype=torch.bfloat16, device="cuda")
    cfg = dataclasses.replace(WAN_1_3B, num_frame_per_block=3)
    return (t5p, make_params(dit, cfg, seed + 32), cfg,
            vae.init_params(vae.WAN_VAE, seed=seed + 33,
                            dtype=torch.float32, device="cuda"))


def phase_text_to_video(ca, dit, vae, blocks, seed, model_dir) -> dict:
    """10. The text-to-video main path at full width through the modules a
    user calls.  umT5-XXL (random bf16 weights from the seed) encodes
    seeded ids with a padding mask at L = 512 (``encode_for_dit``, on the
    card).  The encoder, the 1.3B DiT and a float32 Wan VAE are then
    exported to the reference's state dicts, saved with ``torch.save``
    into a model directory and read back by one ``load_wan_models`` call,
    as the CLI reads them (the T5 kept in pinned host memory,
    ``t5_on_host``), each leaf equal to what was saved.  ``encode_text``
    streams that encoder to the card a layer at a time (a stand-in for
    the tokenizer, whose files are not in the repository, gives the
    seeded ids) and must equal the resident context.  Then the CLI's
    per-prompt function (``inference.generate``) turns the context into
    uint8 frames with the loaded DiT and VAE, as the CLI's ``main`` does:
    ``--blocks`` blocks of 3 latent frames at 60x104, t2v, and one i2v run
    from a seeded 720x1280 image (resized, encoded by the float32 VAE, an
    independent first frame and 2 blocks); bf16 latents reach the float32
    VAE promoted, its convs on the default torch route under PyTorch's
    default cuDNN TF32, as the CLI leaves it.  The model directory
    ``model_dir`` stays for phase 12."""
    import importlib.util
    import tempfile
    from self_forcing_tpu_torch import inference as cli
    from self_forcing_tpu_torch import runtime
    from self_forcing_tpu_torch.config import Config
    from self_forcing_tpu_torch.models.wan import t5 as t5_mod
    from self_forcing_tpu_torch.pipelines.causal_inference import (
        CausalInferencePipeline)
    from self_forcing_tpu_torch.utils import tree
    from self_forcing_tpu_torch.utils.video_io import save_video
    bf = torch.bfloat16
    # the CLI's settings: the default conv route, PyTorch's default TF32
    # for cuDNN's float32 convs (the float32 VAE) and none for matmuls
    vae.set_conv_backend(None)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the T5 encoder, resident (with the DiT and the VAE that phase 12
    # draws from the same seeds when it runs alone)
    cfg5, L, n_valid = t5_mod.UMT5_XXL, 512, 120
    g = torch.Generator(device="cuda").manual_seed(seed + 30)
    t = time.perf_counter()
    t5p, params, cfg, vae_src = model_dir_params(dit, vae, seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t   # the T5, the DiT and the VAE
    ids = torch.randint(1, cfg5.vocab_size, (1, L), generator=g,
                        device="cuda")
    mask = torch.zeros(1, L, dtype=torch.int64, device="cuda")
    mask[:, :n_valid] = 1
    ids = ids * mask
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ctx = t5_mod.encode_for_dit(t5p, cfg5, ids, mask)
    torch.cuda.synchronize()
    act_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    if tuple(ctx.shape) != (1, L, cfg5.dim) or ctx.dtype != bf:
        fail(f"t5: context {tuple(ctx.shape)} {ctx.dtype}")
    if not torch.isfinite(ctx.float()).all():
        fail("t5: non-finite context")
    if not bool((ctx[:, n_valid:] == 0).all()) or \
            not bool((ctx[:, :n_valid] != 0).any()):
        fail("t5: the padded rows are not exactly zero (or all rows are)")
    # device busy = the kernels' time under torch.profiler: the encode's
    # host enqueue outlasts time_ms's spin, so events would count its gaps
    _, rows, _, _ = profile_ms(
        lambda: t5_mod.encode_for_dit(t5p, cfg5, ids, mask))
    busy = sum(ms for _, ms in rows)
    top = "; ".join(f"{name[:40]}={ms:.2f}" for name, ms in rows[:5])
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        t5_mod.encode_for_dit(t5p, cfg5, ids, mask)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    b_ms, b_by = t5_bound(cfg5, L)
    weights_gb = sum(x.numel() * x.element_size()
                     for x in tree.leaves(t5p)) / 1e9
    print(f"t5 umt5-xxl encode_for_dit L={L} ({n_valid} tokens, the rest "
          f"padding), bf16: device_busy_ms={busy:.4f} wall_ms="
          f"{statistics.median(walls):.3f} (median of 5; walls "
          f"{[round(w, 2) for w in walls]}) bound_ms={b_ms:.4f} "
          f"({b_by}; {b_ms / max(busy, 1e-9):.3f} of it) weights_gb="
          f"{weights_gb:.2f} "
          f"activations_peak_gb={act_gb:.3f} init_s={init_s:.1f} (the T5, "
          f"DiT and VAE drawn) top "
          f"kernels (ms): {top}", flush=True)

    # the models through the reference's files, read back by one
    # load_wan_models call as the CLI reads them
    t = time.perf_counter()
    sizes = export_model_dir(model_dir, t5p, params, cfg, vae_src)
    save_s = time.perf_counter() - t
    t = time.perf_counter()
    models = runtime.load_wan_models(model_dir, model_cfg=cfg, dtype=bf,
                                     t5_on_host=True, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    for label, got, want in (("dit", models.generator, params),
                             ("vae", models.vae_params, vae_src),
                             ("t5", models.t5_params, t5p)):
        mine, theirs = dict(tree.items(want)), dict(tree.items(got))
        if mine.keys() != theirs.keys() or not all(
                theirs[k].dtype == v.dtype
                and torch.equal(theirs[k].to(v.device), v)
                for k, v in mine.items()):
            fail(f"{label} checkpoint: the loaded params differ from the "
                 "saved ones")
    if not all(x.device.type == "cpu" and x.is_pinned()
               for x in tree.leaves(models.t5_params)):
        fail("t5_on_host: the encoder is not in pinned host memory")
    print(f"checkpoints: export + torch.save {save_s:.1f} s (GB: {sizes}), "
          f"load_wan_models(t5_on_host=True) {load_s:.1f} s; the DiT "
          f"({len(tree.leaves(params))} leaves, bf16), the VAE (float32) "
          f"and the T5 (pinned host memory) equal to what was saved",
          flush=True)
    del params, vae_src, t5p
    torch.cuda.empty_cache()

    # encode_text streams the host-resident encoder, one layer on the card
    # at a time
    models.tokenizer = lambda prompts: (ids.cpu(), mask.cpu())
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    streamed_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = models.encode_text(["a prompt"])
        torch.cuda.synchronize()
        streamed_ms.append((time.perf_counter() - t) * 1e3)
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    equal = torch.equal(out, ctx)
    print(f"t5 encode_text -> encode_streamed (pinned host weights, one "
          f"layer on the card at a time): wall_ms="
          f"{[round(x, 1) for x in streamed_ms]} (first, second) "
          f"peak_gb_above_held={peak_gb:.3f} bit_equal={equal} "
          f"rel_l2={rel_l2(out, ctx):.3e}", flush=True)
    if not equal:
        fail("t5: encode_text (streamed) differs from encode_for_dit")
    del out
    models.t5_params = None
    torch.cuda.empty_cache()

    # the CLI's per-prompt function, t2v then i2v
    common = {"denoising_step_list": [1000, 750, 500, 250],
              "warp_denoising_step": True, "timestep_shift": 8.0,
              "num_frame_per_block": 3, "context_noise": 0}
    image = torch.rand(720, 1280, 3, generator=g, device="cuda") * 2 - 1
    launches = {}
    runs = {"t2v": (False, 3 * blocks, None), "i2v": (True, 7, image)}
    for name, (iff, frames, img) in runs.items():
        pipe = CausalInferencePipeline(
            Config({**common, "independent_first_frame": iff}),
            models.generator, cfg, vae_params=models.vae_params,
            vae_cfg=models.vae_cfg, device="cuda", dtype=bf)
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        t = time.perf_counter()
        with HostStalls() as stalls:
            px = cli.generate(pipe, ctx, frames, (60, 104), seed + 34,
                              image=img, profile=True)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        launches[name] = dict(ca.launch_counts)
        check_launches(f"cli {name}", launches[name], PARITY_KERNELS)
        want = (1 + 4 * (frames - 1), 480, 832, 3)
        if tuple(px.shape) != want or px.dtype != torch.uint8:
            fail(f"cli {name}: frames {tuple(px.shape)} {px.dtype}, "
                 f"expected {want} uint8")
        if float(px.float().std()) < 1:
            fail(f"cli {name}: the frames are (nearly) constant")
        gen_blocks = (frames - iff) // 3
        prof = pipe.profile_ms
        print(f"cli {name} (inference.generate, the 1.3B DiT and the "
              f"float32 VAE from load_wan_models, umT5 context, {frames} "
              f"latent frames, {want[0]} pixel frames 480x832): ttff_ms="
              f"{wall:.1f} (the CLI holds no frame before the decode ends) "
              f"ms_per_block={prof['diffusion_ms'] / gen_blocks:.1f} "
              f"({gen_blocks} blocks of 3; the first of them after "
              f"init) init_ms={prof['init_ms']:.1f} vae_ms="
              f"{prof['vae_ms']:.1f} {stalls} launches="
              f"{{'decode_fresh_free': "
              f"{launches[name]['decode_fresh_free']}, 'cross_attention': "
              f"{launches[name]['cross_attention']}}} (host clock, "
              f"synchronised per phase)", flush=True)
        del pipe
        torch.cuda.empty_cache()

    # the video writer the machine has, if any, and the CLI's other
    # optional packages
    found = {m: importlib.util.find_spec(m) is not None for m in (
        "cv2", "imageio", "PIL", "transformers", "safetensors")}
    print(f"optional packages here: {found}", flush=True)
    writers = [m for m in ("cv2", "imageio") if found[m]]
    if writers:
        with tempfile.TemporaryDirectory() as out_dir:
            path = save_video(px.cpu().numpy(),
                              os.path.join(out_dir, "i2v.mp4"), fps=16)
            print(f"video writer: {writers[0]} wrote "
                  f"{os.path.getsize(path)} bytes", flush=True)
    else:
        print("video writer: neither cv2 nor imageio is installed here; "
              "no mp4 written (the frames above are the CLI's output)",
              flush=True)
    del models, ctx, px
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    return launches


def print_profile(tag: str, fn) -> None:
    """One call of ``fn`` (warmed) under torch.profiler: wall, device busy,
    idle share, the shares of busy time of the attention kernel
    (``decode_fresh_kernel``: decode, cross and flash forward), the GEMMs
    (cuBLAS / CUTLASS) and the rest (elementwise, norms, copies), and the
    top kernels by device time."""
    fn()
    wall, rows, stalls, _ = profile_ms(fn)
    busy = sum(ms for _, ms in rows)
    if busy <= 0:
        fail(f"profile {tag}: no device time recorded")
    attn = sum(ms for n, ms in rows if "decode_fresh_kernel" in n)
    gemm = sum(ms for n, ms in rows if "decode_fresh_kernel" not in n and any(
        w in n.lower() for w in ("gemm", "xmma", "cutlass", "nvjet",
                                 "sm90_")))
    top = "; ".join(f"{name[:48]}={ms:.2f}ms({ms / busy:.0%})"
                    for name, ms in rows[:8])
    print(f"profile {tag}: wall_ms={wall:.1f} device_busy_ms={busy:.1f} "
          f"idle_share={1 - busy / wall:.3f} attention_share="
          f"{attn / busy:.3f} gemm_share={gemm / busy:.3f} other_share="
          f"{(busy - attn - gemm) / busy:.3f} {stalls} top: {top}",
          flush=True)


def phase_pose_diffusion(ca, dit, vae, seed) -> dict:
    """11. The pose-conditioned 50-step causal path and the bidirectional
    samplers at full Wan-1.3B width (random weights from the seed), with
    PyTorch's default cuDNN TF32 for the float32 convs, as the CLI runs.

    The pose weights (random, seeded) are saved with ``torch.save`` under
    the UniAnimate key names and read back by the CLI's
    ``load_pose_weights``; a seeded uint8 pose video [3, 4F - 3, 480, 832]
    and reference pose [480, 832, 3] go through an ``.npz`` and the CLI's
    ``load_pose_npz``.  The DWPose embedding is timed and held against the
    same embedding with TF32 off, whole and on the part that depends on
    the pose video (a black video's embedding subtracted: the random
    layers shrink that part layer by layer while each bias adds a
    constant, so the whole is mostly bias).  11a: one CFG solver step of
    block 1 (the caches hold block 0) with the block's pose tokens through
    ``pose_proj``, seeded context and negative context [1, 512, 4096]:
    the positive and the negative flow with the kernels against their
    plain versions (<= 2e-2 relative L2), the guided flow's distance, and
    the step's time.  11b: ``inference.generate`` with the
    ``CausalDiffusionInferencePipeline`` on ``configs/causal_diffusion.yaml``
    (50 UniPC steps, guidance 5.0, shift 5.0), 2 blocks of 3 latent
    frames, the pose video and reference pose, a float32 Wan VAE:
    uint8 frames, ms a block and a step, VAE ms, the prompt's wall, peak
    memory, and the decode / cross launches, which must be blocks x (2 x
    50 + 2) x 30 each (2 blocks of a video's 7, cut for time).  11c: 21
    latent frames (32760 tokens): ``BidirectionalInferencePipeline`` at 4
    steps and ``BidirectionalDiffusionInferencePipeline`` cut to 4
    DPM-Solver++ steps (50 in use; cut for time), ms a forward and
    ``flash_fwd`` launches, which must be forwards x 30."""
    import tempfile
    import numpy as np
    from self_forcing_tpu_torch import conditioning as cond
    from self_forcing_tpu_torch import inference as cli
    from self_forcing_tpu_torch.config import Config, load_config
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    from self_forcing_tpu_torch.models.wan.rope import RopeTables
    from self_forcing_tpu_torch.pipelines import (
        bidirectional_diffusion_inference as bd, bidirectional_inference as bi,
        causal_diffusion_inference as cd)
    from self_forcing_tpu_torch.solvers import init_solver_state, make_solver
    bf, dev = torch.bfloat16, torch.device("cuda")
    vae.set_conv_backend(None)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.empty_cache()
    config = load_config(os.path.join(CONFIGS, "causal_diffusion.yaml"),
                         os.path.join(CONFIGS, "default_config.yaml"))
    nb = int(config.num_frame_per_block)
    cfg = dataclasses.replace(WAN_1_3B, num_frame_per_block=nb)
    blocks, H, W = 2, 60, 104
    fs = (H // 2) * (W // 2)
    F = blocks * nb
    g = torch.Generator(device="cuda").manual_seed(seed + 50)
    params = make_params(dit, cfg, seed + 51)
    if "pose_proj" not in params:
        fail("pose: the causal DiT has no pose_proj")

    # the pose weights through a UniAnimate file and the CLI's loader; the
    # pose video through an .npz and the CLI's reader
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(cond.export_pose_state_dict(
            cond.init_dwpose_params(seed + 52, device=dev),
            cond.init_randomref_params(seed + 53, device=dev)),
            os.path.join(tmp, "unianimate_pose.pt"))
        config.pose_weights_path = os.path.join(tmp, "unianimate_pose.pt")
        dw_params, rr_params = cli.load_pose_weights(config, "1.3b", dev)
        gcpu = torch.Generator().manual_seed(seed + 54)
        np.savez(os.path.join(tmp, "pose.npz"),
                 dwpose_data=torch.randint(
                     0, 256, (3, 4 * F - 3, 8 * H, 8 * W), generator=gcpu,
                     dtype=torch.uint8).numpy(),
                 random_ref_dwpose=torch.randint(
                     0, 256, (8 * H, 8 * W, 3), generator=gcpu,
                     dtype=torch.uint8).numpy())
        dwpose, ref = cli.load_pose_npz(os.path.join(tmp, "pose.npz"), dev)
    if len(dw_params["layers"]) != 7 or len(rr_params["layers"]) != 6:
        fail("pose: the CLI's loader did not read every pose conv")

    # the DWPose embedding: its time, its distance to TF32 off, whole and
    # on the part that depends on the pose video (x0: a black video)
    x_in = cond.prepare_dwpose_input(dwpose)
    x0 = torch.zeros_like(x_in)
    emb, emb0 = (cond.dwpose_embedding(dw_params, v) for v in (x_in, x0))
    torch.backends.cudnn.allow_tf32 = False
    emb_f32, emb0_f32 = (cond.dwpose_embedding(dw_params, v)
                         for v in (x_in, x0))
    torch.backends.cudnn.allow_tf32 = True
    want = (1, cond.POSE_CHANNELS, F, H // 2, W // 2)
    if tuple(emb.shape) != want or not torch.isfinite(emb).all():
        fail(f"pose: dwpose embedding {tuple(emb.shape)}, expected {want} "
             "finite")
    share = float((emb - emb0).norm() / emb.norm())
    if not share > 0:
        fail("pose: the dwpose embedding does not depend on the pose video")
    emb_ms = time_ms(lambda: cond.dwpose_embedding(dw_params, x_in), reps=3)
    print(f"pose dwpose_embedding [1, 3, {4 * F}, {8 * H}, {8 * W}] -> "
          f"{list(emb.shape)} float32 (cuDNN, TF32 on as the CLI runs): "
          f"ms={emb_ms:.3f} (CUDA events, median of 3) rel_l2 vs TF32 "
          f"off={rel_l2(emb, emb_f32):.3e}; the pose video's own part "
          f"(minus a black video's embedding) is {share:.3e} of the "
          f"embedding's norm, its rel_l2 vs TF32 off="
          f"{rel_l2(emb - emb0, emb_f32 - emb0_f32):.3e}", flush=True)
    del x_in, x0, emb_f32, emb0_f32

    # 11a: one CFG step of block 1, kernels vs plain
    ctx = torch.randn(1, N_CTX, cfg.text_dim, generator=g,
                      device="cuda").to(bf)
    neg = torch.randn(1, N_CTX, cfg.text_dim, generator=g,
                      device="cuda").to(bf)
    rope = RopeTables.create(cfg.head_dim, device=dev)
    ctx_pos = dit.precompute_context(params, cfg, ctx)
    ctx_neg = dit.precompute_context(params, cfg, neg)
    caches = [dit.init_kv_cache(cfg, 1, fs, 21, bf, dev) for _ in range(2)]
    x_prev = torch.randn(1, nb, 16, H, W, generator=g, device="cuda")
    caches = cd.prime_block_cfg(params, cfg, rope, ctx_pos, ctx_neg, *caches,
                                x_prev.to(bf), 0, 0, static_kv_hi=0)
    x = torch.randn(1, nb, 16, H, W, generator=g, device="cuda")
    pose_tok = cond.pose_tokens_for_block(emb, nb, nb).to(bf)
    solver = make_solver("unipc", 50, float(config.timestep_shift),
                         device=dev)
    t = torch.full((1, nb), float(solver.timesteps[0]), device="cuda")
    flows = {}
    for kernels in (True, False):
        flows[kernels] = cd._forward_pair(
            params, cfg, rope, x.to(bf), t, ctx_pos, ctx_neg, *caches, nb,
            cache_start_frame=nb, static_kv_hi=nb * fs, write_cache=False,
            kernels=kernels, add_condition=pose_tok)[:2]
    errs = [rel_l2(flows[True][i], flows[False][i]) for i in range(2)]
    guided = [cd.guided_flow(*flows[k], 5.0) for k in (True, False)]
    bare, black = (dit.forward_inference(
        params, cfg, x.to(bf), t, ctx_pos, caches[0], nb, rope,
        cache_start_frame=nb, static_kv_hi=nb * fs, write_cache=False,
        add_condition=pose)[0] for pose in (
            None, cond.pose_tokens_for_block(emb0, nb, nb).to(bf)))
    for flow in flows[True]:
        if not torch.isfinite(flow.float()).all():
            fail("pose step: non-finite flow")

    def cfg_step():
        state = init_solver_state(x.shape, dev)
        fc, fu, _, _ = cd._forward_pair(
            params, cfg, rope, x.to(bf), t, ctx_pos, ctx_neg, *caches, nb,
            cache_start_frame=nb, static_kv_hi=nb * fs,
            add_condition=pose_tok)
        solver.step(0, state, cd.guided_flow(fc, fu, 5.0), x)

    step_ms = time_ms(cfg_step, reps=5)
    print(f"pose 11a: one CFG step of block 1 (1.3B, 30 layers, pose tokens "
          f"through pose_proj, caches hold block 0): kernels vs plain "
          f"rel_l2 positive={errs[0]:.3e} negative={errs[1]:.3e} guided "
          f"(g 5.0, float32)={rel_l2(guided[0], guided[1]):.3e}; pose "
          f"tokens move the positive flow by rel_l2="
          f"{rel_l2(bare, flows[True][0]):.3e}, those of a black video "
          f"instead by {rel_l2(black, flows[True][0]):.3e}; step_ms="
          f"{step_ms:.1f} (2 "
          f"forwards + combine + UniPC step, CUDA events around the "
          f"enqueue, median of 5)", flush=True)
    print_profile("pose 11a CFG step", cfg_step)
    for name, err in zip(("positive", "negative"), errs):
        if err > 2e-2:
            fail(f"pose step: {name} flow kernels vs plain relative L2 "
                 f"{err:.3e} > 2e-2")
    del flows, guided, bare, black, caches, ctx_pos, ctx_neg, emb, emb0, \
        pose_tok
    torch.cuda.empty_cache()

    # 11b: the CLI's per-prompt function on the 50-step pose path
    vae_params = vae.init_params(vae.WAN_VAE, seed=seed + 55,
                                 dtype=torch.float32, device="cuda")
    pipe = cd.CausalDiffusionInferencePipeline(
        config, params, cfg, vae_params=vae_params, vae_cfg=vae.WAN_VAE,
        dwpose_params=dw_params, randomref_params=rr_params, device=dev,
        dtype=bf)
    finite, latents = [], []
    inner = pipe.inference

    def spy(*a, **k):
        video, lat = inner(*a, return_latents=True, **k)
        finite.append(bool(torch.isfinite(video).all()))
        latents.append(lat)
        return video

    pipe.inference = spy
    steps = pipe.solver.num_steps
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    with HostStalls() as stalls:
        px = cli.generate(pipe, ctx, F, (H, W), seed + 56, neg_context=neg,
                          dwpose_data=dwpose, random_ref_dwpose=ref,
                          profile=True)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(ca.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want_px = (1 + 4 * (F - 1), 8 * H, 8 * W, 3)
    if tuple(px.shape) != want_px or px.dtype != torch.uint8:
        fail(f"pose cli: frames {tuple(px.shape)} {px.dtype}, expected "
             f"{want_px} uint8")
    if finite != [True]:
        fail("pose cli: the decoded video is not finite")
    if float(px.float().std()) < 1:
        fail("pose cli: the frames are (nearly) constant")
    want_n = blocks * (2 * steps + 2) * cfg.num_layers
    for name in PARITY_KERNELS:
        if launches[name] != want_n:
            fail(f"pose cli: {name} launched {launches[name]} times, "
                 f"expected {blocks} x (2 x {steps} + 2) x "
                 f"{cfg.num_layers} = {want_n}")
    # the VAE decode's own peak: the same latents decoded again
    torch.cuda.synchronize()
    vae_held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vae.decode(vae_params, vae.WAN_VAE, latents[0].permute(0, 1, 3, 4, 2))
    torch.cuda.synchronize()
    vae_peak = (torch.cuda.max_memory_allocated() - vae_held) / 1e9
    prof = pipe.profile_ms
    blk = [prof[f"block{b}_ms"] for b in range(blocks)]
    print(f"pose 11b (inference.generate, CausalDiffusionInferencePipeline, "
          f"causal_diffusion.yaml: {steps} UniPC steps, guidance "
          f"{pipe.guidance_scale}, shift {pipe.shift}; {blocks} blocks of "
          f"{nb} latent frames at {H}x{W}, {want_px[0]} pixel frames "
          f"{8 * H}x{8 * W}, pose + reference pose, float32 VAE): "
          f"prompt_wall_ms={wall:.1f} init_ms={prof['init_ms']:.1f} (context "
          f"K/V, two caches, DWPose embedding) block_ms="
          f"{[round(b_, 1) for b_ in blk]} ms_per_step="
          f"{[round(b_ / (steps + 1), 2) for b_ in blk]} (a block over its "
          f"{steps} steps + the refresh) vae_ms={prof['vae_ms']:.1f} "
          f"peak_gb={peak_gb:.2f} (held before {held / 1e9:.2f}; the "
          f"decode alone {vae_peak:.2f} above what it found) {stalls} "
          f"launches={{'decode_fresh_free': "
          f"{launches['decode_fresh_free']}, 'cross_attention': "
          f"{launches['cross_attention']}}} = {blocks} x (2 x {steps} + 2) "
          f"x {cfg.num_layers} (host clock, synchronised per block)",
          flush=True)
    del pipe, inner, px, vae_params, dwpose, ref, latents
    torch.cuda.empty_cache()

    # 11c: the bidirectional samplers over 21 latent frames
    noise = torch.randn(1, 21, 16, H, W, generator=g, device="cuda")
    few = bi.BidirectionalInferencePipeline(Config(
        {"denoising_step_list": [1000, 750, 500, 250],
         "warp_denoising_step": True,
         "timestep_shift": float(config.timestep_shift)}),
        params, cfg, device=dev, dtype=bf)
    many = bd.BidirectionalDiffusionInferencePipeline(Config(
        {"sampling_steps": 4, "sample_solver": "dpm++", "shift": 8.0,
         "guidance_scale": 5.0}), params, cfg, device=dev, dtype=bf)
    runs = {"few-step": (lambda: few.inference(noise, ctx, generator=g), 4),
            "dpm++ CFG": (lambda: many.inference(
                noise, context=ctx, neg_context=neg,
                return_latents=True)[1], 2 * many.sampling_steps)}
    bi_launches = {}
    for name, (run, forwards) in runs.items():
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        lat = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n = ca.launch_counts["flash_fwd"]
        bi_launches[name] = n
        if tuple(lat.shape) != tuple(noise.shape) or \
                not torch.isfinite(lat).all():
            fail(f"bidirectional {name}: latents {tuple(lat.shape)} not "
                 "finite or misshapen")
        if n != forwards * cfg.num_layers:
            fail(f"bidirectional {name}: flash_fwd launched {n} times, "
                 f"expected {forwards} x {cfg.num_layers}")
        print(f"bidirectional {name} (21 latent frames, {21 * fs} tokens, "
              f"1.3B, no mask): {forwards} forwards wall_ms={wall:.1f} "
              f"ms_per_forward={wall / forwards:.1f} flash_fwd launches={n} "
              f"= {forwards} x {cfg.num_layers} cross_attention="
              f"{ca.launch_counts['cross_attention']} (host clock, "
              f"synchronised)", flush=True)
    t = torch.full((1, 21), 500.0, device="cuda")
    print_profile("bidirectional forward", lambda: dit.forward_train(
        params, cfg, noise.to(bf), t, ctx, None, few.rope, remat=False))
    del runs, few, many, noise, lat, params
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    return {"pose": launches, "bidirectional": bi_launches}


def _unique_leaves(tree):
    """Tensor leaves of a parameter tree, each storage once (``w_qa`` is a
    view of ``w_qa_t``)."""
    from self_forcing_tpu_torch.utils.tree import leaves
    seen, out = set(), []
    for t in leaves(tree):
        key = t.untyped_storage().data_ptr()
        if key not in seen:
            seen.add(key)
            out.append(t)
    return out


def phase_windowed(ca, cm, dit, taehv, pipe_mod, cfg, qparams, seed,
                   n_blocks: int = 12, steady_from: int = 4,
                   kernels=DEMO_KERNELS) -> dict:
    """bench.py's windowed configurations (``bench.py:309-381``): a 1-frame
    attention sink, a 12-frame window, a 24-frame append buffer compacted
    by the host-side fill tracker of ``stream``, W8A8 linears and int8-QK
    attention, ``n_blocks`` blocks of 3 frames, each decoded by the
    stateful TAEHV streamer.  One warm run, then one timed run (launch
    counts reset just before it); DiT and TAEHV are synchronised
    separately per block and their steady-state means from block
    ``steady_from`` give the frame rates without the decode
    (fps_windowed_streaming) and with it (fps_windowed_e2e)."""
    from self_forcing_tpu_torch.config import Config
    B, C, H, W = 1, 16, 60, 104
    g = torch.Generator(device="cuda").manual_seed(seed + 5)
    tae = taehv.init_decoder_params(seed=seed + 4, dtype=torch.bfloat16,
                                    device="cuda")
    args = Config({"denoising_step_list": [1000, 750, 500, 250],
                   "warp_denoising_step": True, "timestep_shift": 8.0,
                   "num_frame_per_block": 3, "context_noise": 0})
    pipe = pipe_mod.CausalInferencePipeline(args, qparams, cfg,
                                            device="cuda",
                                            dtype=torch.bfloat16)
    context = torch.randn(B, N_CTX, cfg.text_dim, generator=g, device="cuda"
                          ).to(torch.bfloat16)
    noise = torch.randn(B, 3 * n_blocks, C, H, W, generator=g,
                        device="cuda").to(torch.bfloat16)

    def run():
        streamer = taehv.TAEHVStreamer(tae)
        dit_ms, tae_ms, gc_ms, pixels = [], [], [], []
        torch.cuda.synchronize()
        t_blk, gc0 = time.perf_counter(), GC_CLOCK.ms
        for blk in pipe.stream(noise, context, generator=g):
            torch.cuda.synchronize()
            t_got = time.perf_counter()
            dit_ms.append((t_got - t_blk) * 1e3)
            state = streamer._state
            lat = blk[:, :, :16].to(torch.bfloat16)
            pixels.append(streamer.decode_chunk(lat))
            torch.cuda.synchronize()
            t_blk = time.perf_counter()
            tae_ms.append((t_blk - t_got) * 1e3)
            gc_ms.append(GC_CLOCK.ms - gc0)
            gc0 = GC_CLOCK.ms
        return (dit_ms, tae_ms, gc_ms, torch.cat(pixels, dim=1), blk, lat,
                state)

    run()  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    cm.reset_launch_counts()
    with HostStalls() as stalls:
        dit_ms, tae_ms, gc_ms, video, blk, lat, state = run()
    launches = {**ca.launch_counts, **cm.launch_counts}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    check_launches("windowed stream", launches, kernels)
    frames = 9 + 12 * (n_blocks - 1)
    if tuple(video.shape) != (B, frames, 3, 480, 832):
        fail(f"windowed stream: pixels {tuple(video.shape)}, expected "
             f"{(B, frames, 3, 480, 832)}")
    if not torch.isfinite(video.float()).all():
        fail("windowed stream: non-finite pixels")
    buf_tok, post = dit.windowed_compaction_schedule(cfg, 1560, LQ)
    if pipe.compactions < 1:
        fail("windowed stream: the buffer was never compacted")
    steady = n_blocks - steady_from
    dit_blk = sum(dit_ms[steady_from:]) / steady
    tae_blk = sum(tae_ms[steady_from:]) / steady
    print(f"windowed stream 1.3B W8A8 + {cfg.attn_quant} attention + TAEHV "
          f"(sink {cfg.sink_size}, window {cfg.local_attn_size}, buffer "
          f"{cfg.buffer_frames} frames = {buf_tok} tokens, {post} after a "
          f"compaction) {n_blocks} blocks: compactions={pipe.compactions} "
          f"steady_dit_ms_per_block={dit_blk:.1f} "
          f"steady_taehv_ms_per_block={tae_blk:.1f} "
          f"fps_windowed_streaming={12 / dit_blk * 1e3:.3f} "
          f"fps_windowed_e2e={12 / (dit_blk + tae_blk) * 1e3:.3f} "
          f"dit_ms={[round(x, 1) for x in dit_ms]} "
          f"taehv_ms={[round(x, 1) for x in tae_ms]} "
          f"gc_ms_per_block={[round(x, 1) for x in gc_ms]} "
          f"device_mallocs={stalls.mallocs} "
          f"peak_mem_gb={peak_gb:.2f} launches={launches} (host clock, "
          f"second run; steady state = blocks {steady_from}..{n_blocks - 1};"
          f" dit_ms = the previous block's refresh + 4 denoise forwards)",
          flush=True)

    # one forward of the last block at the compacted state, kernels vs
    # plain (the sink frame and the 8-frame recent window are visible)
    ctx_kv = dit.precompute_context(qparams, cfg, context)
    t = torch.full(blk.shape[:2], 500.0, device="cuda")
    start = 3 * (n_blocks - 1)
    flows = [dit.forward_inference(
        qparams, cfg, blk, t, ctx_kv, pipe._cache, start, pipe.rope,
        write_cache=False, assume_compacted=True, kernels=k)[0]
        for k in (True, False)]
    if not torch.isfinite(flows[0].float()).all():
        fail("windowed forward: non-finite flow")
    err = rel_l2(*flows)
    print(f"windowed forward 1.3B (local_end {pipe._cache.local_end} of "
          f"{buf_tok}): kernels vs plain rel_l2={err:.3e}", flush=True)
    if err > 2e-2:
        fail(f"windowed forward: kernels vs plain relative L2 {err:.3e} "
             f"> 2e-2")
    del flows
    return dict(pipe=pipe, context=context, x=blk, start=start,
                launches=launches,
                decode=("taehv_block", lambda: taehv.decode_video_stateful(
                    tae, lat, state, trim=False)))


# per decoded latent frame / per encoded chunk at full width, as the JAX
# package routes them (tests/test_torch_conv.py's route survey): 'pallas'
# sends every 3x3x3 conv to the kernel; 'fused' runs 5 of the decoder's 14
# residual blocks (2 launches each) and 4 of the encoder's 10
PALLAS_DECODE, PALLAS_ENCODE = 30, 22
FUSED_DECODE, FUSED_ENCODE = (5, 9), (4, 6)   # (fused, declined) blocks


def conv_bytes(B, T, H, W, C, Cout, residual=False) -> float:
    """Bytes the conv must move: x and its 2 cache frames read once, the
    weights and bias once, the output (and residual) written / read once."""
    return 2.0 * (B * (T + 2) * H * W * C + 27 * C * Cout + Cout
                  + B * T * H * W * Cout * (2 if residual else 1))


def phase_conv_kernels(tconv, g) -> dict:
    """The conv kernels against their plain versions (float32 convs over
    the upcast timeline) at the full-width Wan VAE shapes; relative L2
    <= 1e-2 (both sum the bf16 products in float32 and round once; the
    nsc prologue rounds its activation to bf16 in both, from an rsqrt and
    exp of other precision).  Library yardstick: cuDNN's bf16 F.conv3d,
    channels-last 3D, on the [cache | x] timeline concatenated beforehand
    (for nsc none: no PyTorch call normalizes inside a conv; cuDNN's conv
    of the activated timeline is printed beside it)."""
    dev, bf = "cuda", torch.bfloat16
    table = {}

    def operands(B, T, H, W, C, Cout):
        x = torch.randn(B, T, H, W, C, generator=g, device=dev).to(bf)
        cache = torch.randn(B, 2, H, W, C, generator=g, device=dev).to(bf)
        w = (torch.randn(Cout, C, 3, 3, 3, generator=g, device=dev)
             * (27 * C) ** -0.5).to(bf)
        b = (torch.randn(Cout, generator=g, device=dev) * 0.1).to(bf)
        return x, cache, w, b

    def cudnn(x, cache, w, b):
        xin = torch.cat([cache, x], dim=1).permute(0, 4, 1, 2, 3)
        wc = w.contiguous(memory_format=torch.channels_last_3d)
        return lambda: F.conv3d(xin, wc, b, padding=(0, 1, 1))

    def row(name, label, fn, ref_fn, lib_fn, flops, nbytes, launches):
        out, ref = fn(), ref_fn()
        err, mae = check_kernel(name, out, ref)
        del out, ref
        ms = time_ms(fn)
        plain_ms = time_ms(ref_fn, reps=3)
        lib = None if lib_fn is None else time_ms(lib_fn)
        b_ms, b_by = bound(flops, nbytes)
        libs = "none" if lib is None else f"{lib:.4f}"
        print(f"kernel {name} ({label}, {launches} launch(es)): "
              f"rel_l2={err:.3e} max_abs={mae:.3e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} cudnn_ms={libs} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
              f"tflops={flops / ms / 1e9:.1f}", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib, bound_ms=b_ms,
                    bound_by=b_by, max_abs_err=mae)

    # every 3x3x3 conv shape of a decode step (T = 1 at 60x104, 2 at
    # 120x208, 4 above) and an encode chunk of 4 frames, and the decoder's
    # first frame at 120x208 (T = 1); the wide route but for the RGB
    # input (ops/cuda_conv.py::conv_plan: its rows are conv3d_rgb, an
    # encode chunk of 4 frames, then the first frame)
    fused_shapes = [((1, 4, 480, 832, 96), 96, "decoder 480x832x96"),
                    ((1, 4, 240, 416, 192), 192, "decoder 240x416x192"),
                    ((1, 2, 120, 208, 384), 384, "decoder 120x208x384"),
                    ((1, 1, 60, 104, 384), 384, "decoder 60x104x384"),
                    ((1, 1, 60, 104, 16), 384, "decoder conv1 16->384"),
                    ((1, 2, 120, 208, 192), 384, "decoder 120x208 192->384"),
                    ((1, 1, 120, 208, 384), 384, "first frame 120x208x384"),
                    ((1, 4, 240, 416, 96), 192, "encoder 240x416 96->192"),
                    ((1, 4, 480, 832, 3), 96, "encoder conv1 RGB->96"),
                    ((1, 1, 480, 832, 3), 96, "encoder conv1 RGB->96, "
                     "first frame / i2v"),
                    ((1, 4, 480, 832, 96), 3, "decoder head 96->RGB"),
                    ((1, 1, 60, 104, 384), 32, "encoder head 384->32")]
    for shape, Cout, label in fused_shapes:
        x, cache, w, b = operands(*shape, Cout)
        B, T, H, W, C = shape
        route = tconv.cuda_conv.conv_plan(B, T, H, W, C, Cout, 3,
                                          tconv.cuda_conv._sm_count(x.device))
        # the RGB input's narrow route is a kernel of its own
        name = "conv3d_rgb" if route["route"] == "narrow" else "conv3d_fused"
        r = row(name, f"{label} {list(shape)}->{Cout}, route "
                f"{route['route']}, splits {route['splits']}",
                lambda: tconv.conv3d_fused(x, cache, w, b),
                lambda: tconv.conv3d_ref(x, cache, w, b),
                cudnn(x, cache, w, b), 2.0 * 27 * C * Cout * B * T * H * W,
                conv_bytes(B, T, H, W, C, Cout), 1)
        table.setdefault(name, r)   # the first shape of each is its row
        del x, cache
        torch.cuda.empty_cache()

    # the split route (fused route declined): 3 launches + 2 bf16 adds
    x, cache, w, b = operands(1, 1, 60, 104, 384, 384)
    table["conv2d_9tap"] = row(
        "conv2d_9tap", "split route [1, 1, 60, 104, 384]->384",
        lambda: tconv.conv3d_split(x, cache, w, b),
        lambda: tconv.split_ref(x, cache, w, b), cudnn(x, cache, w, b),
        2.0 * 27 * 384 * 384 * 60 * 104, conv_bytes(1, 1, 60, 104, 384, 384),
        3)

    x, cache, w, b = operands(1, 4, 480, 832, 128, 128)
    table["conv3d_v2"] = row(
        "conv3d_v2", "[1, 4, 480, 832, 128]->128",
        lambda: tconv.causal_conv3d_pallas_v2(x, cache, w, b),
        lambda: tconv.conv3d_ref(x, cache, w, b), cudnn(x, cache, w, b),
        2.0 * 27 * 128 * 128 * 4 * 480 * 832,
        conv_bytes(1, 4, 480, 832, 128, 128), 1)
    del x, cache
    torch.cuda.empty_cache()

    # the float32 mode (3xTF32 products on tf32 wgmma) at the decoder's
    # 96-channel full-resolution shape, on float32 operands with all 24
    # mantissa bits (bf16 values would leave the small tf32 parts zero),
    # against the plain float32 conv (TF32 off): 1e-4; library yardstick
    # cuDNN's float32 conv with TF32 off; the bound counts the three TF32
    # products of each 3xTF32 product
    x = torch.randn(1, 4, 480, 832, 96, generator=g, device=dev)
    cache = torch.randn(1, 2, 480, 832, 96, generator=g, device=dev)
    w = (torch.randn(96, 96, 3, 3, 3, generator=g, device=dev)
         * (27 * 96) ** -0.5)
    b = torch.randn(96, generator=g, device=dev) * 0.1
    out = tconv.conv3d_fused(x, cache, w, b)
    ref = tconv.conv3d_ref(x, cache, w, b)
    err, mae = check_kernel("conv3d_f32", out, ref, tol=1e-4)
    del out, ref
    ms = time_ms(lambda: tconv.conv3d_fused(x, cache, w, b))
    plain_ms = time_ms(lambda: tconv.conv3d_ref(x, cache, w, b), reps=3)
    lib = time_ms(cudnn(x, cache, w, b))
    flops = 2.0 * 27 * 96 * 96 * 4 * 480 * 832
    b_ms, b_by = bound(flops, 2.0 * conv_bytes(1, 4, 480, 832, 96, 96),
                       PEAK_3XTF32_FLOPS)
    print(f"kernel conv3d_f32 (float32 [1, 4, 480, 832, 96]->96, 1 "
          f"launch): rel_l2={err:.3e} max_abs={mae:.3e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} cudnn_f32_ms={lib:.4f} "
          f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
          f"tflops={flops / ms / 1e9:.1f}", flush=True)
    table["conv3d_f32"] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib,
                               bound_ms=b_ms, bound_by=b_by, max_abs_err=mae)
    del x, cache, w, b
    torch.cuda.empty_cache()

    # nsc at T = 1, as the path runs it (one latent frame a decode step,
    # the encoder's 60x104 stage), and at T = 3
    gamma = (1 + 0.2 * torch.randn(384, generator=g, device=dev)).to(bf)
    for T in (1, 3):
        x, cache, w, b = operands(1, T, 60, 104, 384, 384)
        res = torch.randn(T, 60, 104, 384, generator=g, device=dev).to(bf)
        act = tconv.norm_silu_ref(torch.cat([cache[0], x[0]]), gamma)
        act_ms = time_ms(cudnn(act[2:][None], act[:2][None], w, b))
        print(f"cudnn conv3d of the activated timeline [{T}, 60, 104, 384]"
              f"->384 (no norm, no residual): ms={act_ms:.4f}", flush=True)
        for r in (None, res):
            label = f"[{T}, 60, 104, 384]->384 " + (
                "with" if r is not None else "without") + " residual"
            out = row("norm_silu_conv3d", label,
                      lambda: tconv.norm_silu_conv3d(x[0], cache[0], gamma,
                                                     w, b, r),
                      lambda: tconv.nsc_ref(x[0], cache[0], gamma, w, b, r),
                      None, 2.0 * 27 * 384 * 384 * T * 60 * 104,
                      conv_bytes(1, T, 60, 104, 384, 384, r is not None), 1)
            if T == 1 and r is not None:   # the decoder's conv2: the row
                table["norm_silu_conv3d"] = out
        del x, cache, res, act
    return table


def phase_vae(cc, tconv, vae, dit, pipe_mod, seed) -> dict:
    """The Wan VAE at full width under each conv backend; returns the
    conv kernels' launches on the path (the 'fused' decode for
    norm_silu_conv3d, the i2v path for the other three)."""
    from self_forcing_tpu_torch.config import Config
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    bf, cfg = torch.bfloat16, vae.WAN_VAE
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    params = vae.init_params(cfg, seed=seed + 12, dtype=bf, device="cuda")
    padded = vae.pad_decoder_channels(params)
    lat = torch.randn(1, 9, 60, 104, 16, generator=g, device="cuda").to(bf)
    clip = (torch.rand(1, 5, 480, 832, 3, generator=g, device="cuda") * 2
            - 1).to(bf)
    launches = {}

    def stream(p):
        cache = vae.init_decoder_cache(p, cfg, 1, 60, 104, bf, "cuda")
        outs, ms = [], []
        for lo, hi in ((0, 3), (3, 6), (6, 9)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if lo == 0:
                y0, cache = vae.decode_frame(p, cfg, lat[:, :1], cache,
                                             first=True)
                y, cache = vae.decode_block(p, cfg, lat[:, 1:3], cache,
                                            first=False)
                y = torch.cat([y0, y], dim=1)
            else:
                y, cache = vae.decode_block(p, cfg, lat[:, lo:hi], cache,
                                            first=False)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
            outs.append(y)
        return torch.cat(outs, dim=1), ms

    def encode(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        z = vae.encode(p, cfg, clip)
        torch.cuda.synchronize()
        return z, (time.perf_counter() - t) * 1e3

    ref_px = ref_z = None
    for backend, p in ((None, params), ("pallas", params),
                       ("fused", padded)):
        vae.set_conv_backend(backend)
        stream(p)   # warm: first calls, cuDNN's algorithm choice
        cc.reset_launch_counts()
        tconv.reset_decline_counts()
        px, ms = stream(p)
        dec = dict(cc.launch_counts)
        dec_decl = dict(tconv.decline_counts)
        dec_copies = (cc.layout_copies["activations"], list(cc.copied))
        if backend == "fused":
            launches["norm_silu_conv3d"] = dec["norm_silu_conv3d"]
        encode(p)
        cc.reset_launch_counts()
        tconv.reset_decline_counts()
        z, enc_ms = encode(p)
        enc, enc_decl = dict(cc.launch_counts), dict(tconv.decline_counts)
        enc_copies = (cc.layout_copies["activations"], list(cc.copied))
        vae.set_conv_backend(None)
        if tuple(px.shape) != (1, 33, 480, 832, 3) or \
                tuple(z.shape) != (1, 2, 60, 104, 16):
            fail(f"vae {backend}: pixels {tuple(px.shape)}, latents "
                 f"{tuple(z.shape)}")
        if not (torch.isfinite(px.float()).all()
                and torch.isfinite(z.float()).all()):
            fail(f"vae {backend}: non-finite output")
        # 9 decoded latent frames; 2 encoded chunks (1 frame, 4 frames)
        want = {None: ({}, {}),
                "pallas": ({"conv3d_fused": 9 * PALLAS_DECODE},
                           {"conv3d_fused": 2 * PALLAS_ENCODE,
                            "conv3d_rgb": 2}),
                "fused": ({"norm_silu_conv3d": 9 * 2 * FUSED_DECODE[0]},
                          {"norm_silu_conv3d": 2 * 2 * FUSED_ENCODE[0]})
                }[backend]
        want_decl = {"fused": (9 * FUSED_DECODE[1], 2 * FUSED_ENCODE[1])}
        for tag, got, w in (("decode", dec, want[0]), ("encode", enc,
                                                       want[1])):
            exp = {k: w.get(k, 0) for k in got}
            if got != exp:
                fail(f"vae {backend} {tag}: launches {got}, expected {exp}")
        d_decl, e_decl = want_decl.get(backend, (0, 0))
        if (dec_decl["norm_silu_conv3d"], enc_decl["norm_silu_conv3d"]) != \
                (d_decl, e_decl) or dec_decl["conv3d_fused"] or \
                enc_decl["conv3d_fused"]:
            fail(f"vae {backend}: declines {dec_decl} / {enc_decl}, "
                 f"expected {d_decl} / {e_decl} fused blocks")
        if backend is None:
            ref_px, ref_z = px, z
            err_px = err_z = 0.0
        else:
            err_px, err_z = rel_l2(px, ref_px), rel_l2(z, ref_z)
        print(f"vae {backend or 'None (cudnn)'}: decode 3 blocks (9 latent "
              f"frames -> 33 pixel frames 480x832) per_block_ms="
              f"{[round(v, 1) for v in ms]} launches={dec} "
              f"declines={dec_decl} layout_copies={dec_copies} "
              f"pixels_vs_None_rel_l2={err_px:.3e}; "
              f"encode 1+4 frames ms={enc_ms:.1f} launches={enc} "
              f"declines={enc_decl} layout_copies={enc_copies} "
              f"latents_vs_None_rel_l2={err_z:.3e} "
              f"(host clock, second run)", flush=True)
        if err_px > 2e-2:
            fail(f"vae {backend}: pixels vs the None decode relative L2 "
                 f"{err_px:.3e} > 2e-2")
        if err_z > 1e-2:
            fail(f"vae {backend}: latents vs the None encode relative L2 "
                 f"{err_z:.3e} > 1e-2")
        del px, z
    del ref_px, ref_z, padded
    torch.cuda.empty_cache()

    # the i2v path under 'pallas' (inference.py --i2v): image -> encode ->
    # initial_latent -> inference with an independent first frame -> decode
    vae.set_conv_backend("pallas")
    dcfg = dataclasses.replace(WAN_1_3B, num_frame_per_block=3)
    dparams = make_params(dit, dcfg, seed)
    args = Config({"denoising_step_list": [1000, 750, 500, 250],
                   "warp_denoising_step": True, "timestep_shift": 8.0,
                   "num_frame_per_block": 3, "context_noise": 0,
                   "independent_first_frame": True})
    pipe = pipe_mod.CausalInferencePipeline(args, dparams, dcfg,
                                            vae_params=params,
                                            device="cuda", dtype=bf)
    image = (torch.rand(1, 1, 480, 832, 3, generator=g, device="cuda") * 2
             - 1).to(bf)
    context = torch.randn(1, N_CTX, dcfg.text_dim, generator=g,
                          device="cuda").to(bf)
    noise = torch.randn(1, 6, 16, 60, 104, generator=g, device="cuda").to(bf)
    torch.cuda.synchronize()
    cc.reset_launch_counts()
    t = time.perf_counter()
    z0 = vae.encode(params, cfg, image)
    video = pipe.inference(noise, context,
                           initial_latent=z0.permute(0, 1, 4, 2, 3),
                           generator=g)
    torch.cuda.synchronize()
    i2v_ms = (time.perf_counter() - t) * 1e3
    i2v = dict(cc.launch_counts)
    launches.update({k: i2v[k] for k in ("conv3d_fused", "conv2d_9tap",
                                         "conv3d_v2", "conv3d_f32",
                                         "conv3d_rgb")})
    frames = video.shape[1]
    if tuple(video.shape) != (1, 25, 3, 480, 832):
        fail(f"i2v: video {tuple(video.shape)}, expected (1, 25, 3, 480, 832)")
    if not torch.isfinite(video.float()).all():
        fail("i2v: non-finite video")
    if i2v["conv3d_fused"] != PALLAS_ENCODE + 7 * PALLAS_DECODE or \
            i2v["conv3d_rgb"] != 1:
        fail(f"i2v: conv3d_fused / conv3d_rgb launches {i2v['conv3d_fused']}"
             f" / {i2v['conv3d_rgb']}, expected "
             f"{PALLAS_ENCODE + 7 * PALLAS_DECODE} / 1")
    print(f"i2v 'pallas' (480x832 image -> 1 latent frame, 1.3B "
          f"inference with an independent first frame + 2 blocks of 3, "
          f"VAE decode of 7 latent frames): ms={i2v_ms:.1f} "
          f"pixel_frames={frames} launches={i2v} "
          f"layout_copies={cc.layout_copies['activations']} (host "
          f"clock, first calls of the DiT included)", flush=True)
    del pipe, dparams, video
    torch.cuda.empty_cache()

    # where the time goes: one encode of 1 + 4 frames under 'pallas' and
    # 'fused' (the RGB input's conv, conv_igemm_rgb, runs under 'pallas';
    # 'fused' leaves it to cuDNN), then one steady decode block under each
    # backend; the conv kernels' share (every kernel of csrc/conv3d.cu is
    # named conv_igemm*: the wide and RGB routes, the split-K reduction,
    # the norm pre-pass)
    for backend, p in (("pallas", params),
                       ("fused", vae.pad_decoder_channels(params))):
        vae.set_conv_backend(backend)
        enc = (lambda p=p: vae.encode(p, cfg, clip))
        enc()
        wall, rows, _, _ = profile_ms(enc)
        vae.set_conv_backend(None)
        busy = sum(ms for _, ms in rows)
        conv = sum(ms for name, ms in rows if "conv_igemm" in name)
        rgb = sum(ms for name, ms in rows if "conv_igemm_rgb" in name)
        print(f"profile vae {backend} encode (1 + 4 frames 480x832): "
              f"wall_ms={wall:.1f} device_busy_ms={busy:.1f} "
              f"idle_share={1 - busy / wall:.3f} conv_igemm_ms={conv:.2f} "
              f"conv_igemm_rgb_ms={rgb:.3f} rgb_share_of_busy="
              f"{rgb / max(busy, 1e-9):.4f}", flush=True)
        del p
    padded = vae.pad_decoder_channels(params)
    for backend, p in ((None, params), ("pallas", params),
                       ("fused", padded)):
        vae.set_conv_backend(backend)
        cache = vae.init_decoder_cache(p, cfg, 1, 60, 104, bf, "cuda")
        _, cache = vae.decode_frame(p, cfg, lat[:, :1], cache, first=True)
        block = (lambda p=p, cache=cache: vae.decode_block(
            p, cfg, lat[:, 1:4], list(cache), first=False))
        block()
        wall, rows, _, _ = profile_ms(block)
        vae.set_conv_backend(None)
        busy = sum(ms for _, ms in rows)
        conv = sum(ms for name, ms in rows if "conv_igemm" in name)
        top = "; ".join(f"{name[:48]}={ms:.2f}ms({ms / max(busy, 1e-9):.0%})"
                        for name, ms in rows[:6])
        print(f"profile vae {backend or 'None (cudnn)'} decode block (3 "
              f"latent frames): wall_ms={wall:.1f} device_busy_ms={busy:.1f} "
              f"idle_share={1 - busy / wall:.3f} conv_igemm_ms={conv:.1f} "
              f"conv_igemm_share_of_busy={conv / max(busy, 1e-9):.3f} "
              f"top: {top}", flush=True)
        del cache
    del padded
    torch.cuda.empty_cache()
    return launches


TRAIN_KERNELS = ("flash_fwd", "flash_bwd", "decode_fresh_free",
                 "cross_attention")
# flash launches a train step: the generator update's 3 score forwards
# (real with CFG, fake) of 30 layers; the critic's fake-score forward,
# its per-layer recomputation and the backward
GEN_FLASH = {"flash_fwd": 3, "flash_bwd": 0}
CRITIC_FLASH = {"flash_fwd": 2, "flash_bwd": 1}
# the decode / cross backward (SDPA's on the card): the generator update
# runs both (the rollout's exit block, the score models' cross attention),
# a critic update the cross one
TRAIN_BWD = ("decode_fresh_bwd", "cross_attention_bwd")


def _randomize_heads(models, seed):
    """Random output layers (zero at init), so every score and flow
    depends on every layer and the DMD gradient is not zero."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    for p in models:
        w = p["head"]["head"]["w"]
        w.copy_(torch.randn(w.shape, generator=g, device="cuda")
                * w.shape[0] ** -0.5)


def _norms(leaves):
    return [float(torch.linalg.vector_norm(t.detach().float()))
            for t in leaves]


def dmd_trainer(seed: int, softmax: str = "free", mesh=None,
                timing: bool = True):
    """The DMD trainer of ``configs/self_forcing_dmd.yaml`` at full
    Wan-1.3B width and depth (``model_kwargs`` attn_softmax =
    ``softmax``; random bf16 weights with random output layers, pseudo
    text context), on ``mesh`` when given: (trainer, context_fn, batches,
    layers, lora_rank)."""
    from self_forcing_tpu_torch import train
    from self_forcing_tpu_torch.config import load_config
    from self_forcing_tpu_torch.training.trainer_distillation import (
        ScoreDistillationTrainer)
    config = load_config(os.path.join(CONFIGS, "self_forcing_dmd.yaml"),
                         os.path.join(CONFIGS, "default_config.yaml"))
    config.seed = seed
    config.model_kwargs = {**dict(config.get("model_kwargs") or {}),
                           "attn_softmax": softmax}
    cfg0, gen, fake, real = train.build_models(
        config, torch.bfloat16, torch.device("cuda"))
    with torch.no_grad():
        _randomize_heads((gen, fake, real), seed + 7)
    context_fn = train.make_context_fn(config, cfg0, torch.device("cuda"))
    neg = context_fn([str(config.negative_prompt)])
    trainer = ScoreDistillationTrainer(config, gen, fake, real, cfg0, cfg0,
                                       cfg0, neg, device="cuda",
                                       timing=timing, mesh=mesh)
    batches = train.data_batches(config, "score_distillation", 1)
    return trainer, context_fn, batches, cfg0.num_layers, config.lora_rank


def phase_training(ca, seed: int, softmax: str = "free",
                   steps=(0, 1), keep: dict | None = None) -> dict:
    """Self-Forcing DMD training at full Wan-1.3B width and depth (the
    config of ``configs/self_forcing_dmd.yaml``, ``model_kwargs``
    attn_softmax = ``softmax``): the train ``steps`` through
    ``ScoreDistillationTrainer`` (step 0 updates the generator and the
    critic, step 1 the critic), launch counts reset just before and read
    just after each.  ``keep``: filled with step 0's log, ms, launches and
    ``card_checks.dmd_state`` on the host (phase 17(a)'s one-process
    reference).  Returns the launches."""
    from self_forcing_tpu_torch.parallel import card_checks
    trainer, context_fn, batches, layers, lora_rank = dmd_trainer(
        seed, softmax)
    before = card_checks.dmd_weights(trainer) if keep is not None else None
    gen_before, fake_before = (_norms(trainer.gen_leaves),
                               _norms(trainer.fake_leaves))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {k: 0 for k in ca.launch_counts}
    fwd = "flash_fwd" if softmax == "free" else f"flash_fwd_{softmax}"
    names = [fwd if k == "flash_fwd" else f"decode_fresh_{softmax}"
             if k == "decode_fresh_free" else k for k in TRAIN_KERNELS]
    shown = names + list(TRAIN_BWD)
    for step in steps:
        ctx = context_fn(list(next(batches)["prompts"]))
        trainer.state.step = step
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        log = trainer.train_step({"context": ctx})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(ca.launch_counts)
        for k, v in got.items():
            launches[k] += v
        if keep is not None and step == 0:
            keep.update(log=log, ms=ms, launches=dict(got),
                        peak_gb=torch.cuda.max_memory_allocated() / GB,
                        **card_checks.dmd_state(trainer, before))
            del before
        want = dict(CRITIC_FLASH)
        if step % trainer.dfake_gen_update_ratio == 0:
            want = {k: want[k] + GEN_FLASH[k] for k in want}
        want = {fwd if k == "flash_fwd" else k: n * layers
                for k, n in want.items()}
        if any(got[k] != n for k, n in want.items()):
            fail(f"train step {step}: flash launches "
                 f"{ {k: got[k] for k in want} }, expected {want}")
        bad = [k for k, v in log.items() if not math.isfinite(v)]
        if bad:
            fail(f"train step {step}: non-finite {bad}")
        split = {k: round(v, 1) for k, v in log.items() if k.endswith("_ms")}
        vals = {k: round(v, 6) for k, v in log.items()
                if not k.endswith("_ms")}
        print(f"train step {step} (Wan-1.3B width, {layers} layers, DMD, "
              f"attn_softmax={softmax}, 21 frames 60x104, LoRA rank "
              f"{lora_rank}): step_ms={ms:.1f} split_ms={split} "
              f"{vals} launches={ {k: got[k] for k in shown} } "
              f"(host clock, synchronised per phase)", flush=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    moved_g = sum(a != b for a, b in zip(gen_before,
                                         _norms(trainer.gen_leaves)))
    moved_f = sum(a != b for a, b in zip(fake_before,
                                         _norms(trainer.fake_leaves)))
    print(f"training ({softmax}): peak_mem_gb={peak_gb:.2f} generator "
          f"leaves moved {moved_g}/{len(gen_before)} critic leaves moved "
          f"{moved_f}/{len(fake_before)}", flush=True)
    gen_steps = any(st % trainer.dfake_gen_update_ratio == 0
                    for st in steps)
    if (gen_steps and not moved_g) or not moved_f:
        fail("training: the generator or the critic did not move")
    check_launches("training", launches,
                   names + list(TRAIN_BWD if gen_steps else TRAIN_BWD[1:]))
    return launches


def phase_training_grad(ca, dit, seed: int, softmax: str = "free") -> dict:
    """One critic-loss gradient at full Wan-1.3B width and 2 layers
    (``attn_softmax`` = ``softmax``), with the kernels and with their
    plain versions, the same draws (one generator seed); the launches of
    the kernels' run are returned.  Tolerance 1e-2 relative L2 over all the critic's
    leaves: the kernels round p and ds to bf16 where the plain versions
    round the same values (each within ~4e-3, an ulp of bf16), and the
    no-grad rollout feeding the loss carries the decode kernels'
    rounding of their bf16 operands."""
    from self_forcing_tpu_torch import train
    from self_forcing_tpu_torch.config import load_config
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    from self_forcing_tpu_torch.training.objectives import dmd
    from self_forcing_tpu_torch.training.trainer_distillation import (
        ScoreDistillationTrainer)
    config = load_config(os.path.join(CONFIGS, "self_forcing_dmd.yaml"),
                         os.path.join(CONFIGS, "default_config.yaml"))
    config.update(seed=seed, lora_rank=0)
    cfg = dataclasses.replace(WAN_1_3B, num_layers=2, attn_softmax=softmax)
    gen, fake, real = (dit.init_params(cfg, seed + i, torch.bfloat16, "cuda",
                                       causal=i == 0) for i in range(3))
    with torch.no_grad():
        _randomize_heads((gen, fake, real), seed + 8)
    ctx = train.make_context_fn(config, cfg, torch.device("cuda"))(["a cat"])
    trainer = ScoreDistillationTrainer(config, gen, fake, real, cfg, cfg,
                                       cfg, ctx, device="cuda")
    noise = torch.randn(1, 21, 16, 60, 104, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(seed))
    grads = []
    for kernels in (True, False):
        g = torch.Generator("cuda").manual_seed(seed + 9)
        ca.reset_launch_counts()
        loss, _ = dmd.critic_loss(trainer.bundle, trainer.obj, gen, fake,
                                  noise, ctx, ctx, 2, generator=g,
                                  kernels=kernels)
        gr = torch.autograd.grad(loss, trainer.fake_leaves, allow_unused=True)
        if kernels:
            launches = dict(ca.launch_counts)
        grads.append((float(loss.detach()), torch.cat(
            [x.float().flatten() for x in gr if x is not None])))
        del gr
    (lk, gk), (lp, gp) = grads
    err = rel_l2(gk, gp)
    print(f"critic-loss gradient (Wan-1.3B width, 2 layers, exit 2, "
          f"attn_softmax={softmax}): loss kernels={lk:.6f} plain={lp:.6f} "
          f"grad rel_l2={err:.3e} grad_norm={float(gk.norm()):.4e} "
          f"launches={ {k: v for k, v in launches.items() if v} }",
          flush=True)
    if not math.isfinite(err) or err > 1e-2:
        fail(f"critic-loss gradient ({softmax}): kernels vs plain relative "
             f"L2 {err:.3e} > 1e-2")
    fwd = "flash_fwd" if softmax == "free" else f"flash_fwd_{softmax}"
    check_launches(f"critic-loss gradient ({softmax})", launches,
                   (fwd, "flash_bwd"))
    return launches


# ---------------------------------------------------------------------
# 14. the other trainers: ODE regression, causal diffusion, GAN, SiD
# ---------------------------------------------------------------------

TRAIN_LATENT = (21, 16, 60, 104)   # a training video's latent [F, C, H, W]
OTHER_TRAINER_KERNELS = ("flash_fwd", "flash_bwd", "decode_fresh_free",
                         "cross_attention", "decode_fresh_bwd",
                         "cross_attention_bwd")


def score_launches(layers: int, grad: bool) -> dict:
    """Launches of one forward_train / forward_classify of ``layers``
    layers: a layer's flash and cross attention once; under autograd
    (``remat``) once more when the backward recomputes the layer, and
    one backward each."""
    n = 2 if grad else 1
    out = {"flash_fwd": n * layers, "cross_attention": n * layers}
    if grad:
        out.update(flash_bwd=layers, cross_attention_bwd=layers)
    return out


def rollout_launches(layers: int, exits, grad: bool) -> dict:
    """Launches of a training rollout (``inference_with_trajectory``): a
    block with exit e runs e + 1 denoise forwards and the cache refresh,
    each layer one decode and one cross attention; with gradient the
    exit forward, checkpointed whole and per layer, runs twice more in
    the backward (the whole forward replayed, then each layer replayed
    for its backward), and each layer has one decode and one cross
    backward."""
    fwd = sum(e + 2 for e in exits) + (2 * len(exits) if grad else 0)
    out = {"decode_fresh_free": fwd * layers,
           "cross_attention": fwd * layers}
    if grad:
        out.update(decode_fresh_bwd=len(exits) * layers,
                   cross_attention_bwd=len(exits) * layers)
    return out


def add_launches(*parts) -> dict:
    out = {k: 0 for k in OTHER_TRAINER_KERNELS}
    for p in parts:
        for k, v in p.items():
            out[k] += v
    return out


def expected_step_launches(kind: str, trainer, layers: int,
                           pose: bool = False) -> dict:
    """The exact launches of ``trainer``'s next ``train_step``, derived
    from the code: the exits come from a copy of the trainer's host RNG,
    drawn in the order ``train_step`` draws them (a pose batch's
    conditioning draws first).  ``kind`` 'dmd' / 'sid': the score
    distillation trainer, whose DMD score forwards run without
    gradient."""
    import copy
    if kind in ("ode", "diffusion"):
        return add_launches(score_launches(layers, True))
    rng = copy.deepcopy(trainer.host_rng)
    pipe = trainer.bundle.pipeline
    if kind == "gan":
        blocks = trainer.obj.num_training_frames // trainer.obj.num_frame_per_block
        parts = []
        gen = (trainer.step >= trainer.discriminator_warmup_steps and
               trainer.step % trainer.dfake_gen_update_ratio == 0)
        if gen:
            e = pipe.sample_exit_index(rng)
            rng.integers(2 ** 31)
            parts += [rollout_launches(layers, [e] * blocks, True),
                      score_launches(layers, True)]
        e = pipe.sample_exit_index(rng)
        parts += [rollout_launches(layers, [e] * blocks, False),
                  score_launches(layers, True)]
        return add_launches(*parts)
    # the ScoreDistillationTrainer draws the rollout length and the
    # exit(s) for each update, and a seed for the generator update: its
    # own methods, run on the copy
    live = trainer.host_rng
    trainer.host_rng = rng
    if pose:
        rng.integers(2 ** 31)
    try:
        def draw():
            shape = trainer._sample_rollout_shape([1, *TRAIN_LATENT])
            blocks = shape[1] // trainer.obj.num_frame_per_block
            e = pipe.sample_exit_index(rng, num_blocks=blocks)
            return [e] * blocks if isinstance(e, int) else list(e)
        parts = []
        exits = draw()
        if trainer.state.step % trainer.dfake_gen_update_ratio == 0:
            rng.integers(2 ** 31)
            parts += [rollout_launches(layers, exits, True)] + [
                score_launches(layers, kind == "sid")] * 3
        exits = draw()
    finally:
        trainer.host_rng = live
    parts += [rollout_launches(layers, exits, False),
              score_launches(layers, True)]
    return add_launches(*parts)


def write_stand_in_shards(d: str, seed: int) -> tuple[str, str]:
    """Seeded stand-in data through the port's ``RecordWriter``: an ODE
    shard of 2 trajectories of 5 snapshots [5, 21, 16, 60, 104] fp16 and
    a directory holding one shard of 2 latents [21, 16, 60, 104] fp16
    (and a stray file the dataset skips).  Returns (shard, directory)."""
    import numpy as np
    from self_forcing_tpu_torch.data.recordstore import (
        RecordWriter, store_arrays, write_shape_header)
    rng = np.random.default_rng(seed)
    ode = os.path.join(d, "ode_pairs.rs")
    with RecordWriter(ode) as w:
        lat = rng.standard_normal((2, 5, *TRAIN_LATENT), np.float32
                                  ).astype(np.float16)
        store_arrays(w, {"latents": lat,
                         "prompts": ["a red fox in snow", "a city at night"]})
        write_shape_header(w, "latents", lat.shape)
    shards = os.path.join(d, "latent_shards")
    os.makedirs(shards)
    with RecordWriter(os.path.join(shards, "shard_000.rs")) as w:
        lat = rng.standard_normal((2, *TRAIN_LATENT), np.float32
                                  ).astype(np.float16)
        store_arrays(w, {"latents": lat,
                         "prompts": ["waves on a beach", "a cat on a sofa"]})
        write_shape_header(w, "latents", lat.shape)
    with open(os.path.join(shards, "README"), "w") as f:
        f.write("not a shard\n")
    return ode, shards


def _trainer_groups(kind: str, trainer) -> dict:
    """{name: leaves} of the models a trainer updates."""
    if kind in ("ode", "diffusion"):
        return {"generator": trainer.leaves}
    if kind == "gan":
        return {"generator": trainer.gen_leaves,
                "critic": trainer.fake_leaves, "cls": trainer.cls_leaves}
    return {"generator": trainer.gen_leaves, "critic": trainer.fake_leaves}


def run_other_trainer(ca, kind: str, config_name: str, seed: int,
                      data_path: str | None, steps, **overrides) -> dict:
    """``kind``'s trainer at full Wan-1.3B width and depth through the
    CLI's functions (``train.build_models`` / ``make_context_fn`` /
    ``data_batches`` / ``make_batch`` / ``make_trainer``) on the config
    ``config_name`` (float32 weights, TF32 products, random weights with
    random output layers): ``steps`` train steps (each a step index: the
    step count is set to it first), each with its ms, the losses (finite)
    and the exact launch counts of :func:`expected_step_launches`; the
    leaves that moved; the peak memory.  Returns the launches."""
    import numpy as np
    from self_forcing_tpu_torch import train
    from self_forcing_tpu_torch.config import load_config
    dev = torch.device("cuda")
    config = load_config(os.path.join(CONFIGS, config_name),
                         os.path.join(CONFIGS, "default_config.yaml"))
    config.update(seed=seed, image_or_video_shape=[1, *TRAIN_LATENT],
                  **overrides)
    if data_path is not None:
        config.data_path = data_path
    dtype = torch.bfloat16 if config.get("mixed_precision") \
        else torch.float32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, gen, fake, real = train.build_models(config, dtype, dev)
    if kind != "sid":
        real = None         # only the SiD trainer holds the real score
    if kind in ("ode", "diffusion"):
        fake = None
    with torch.no_grad():
        _randomize_heads([p for p in (gen, fake, real) if p is not None],
                         seed + 7)
    context_fn = train.make_context_fn(config, cfg, dev)
    B = 1
    trainer = train.make_trainer(config, config.trainer, cfg, gen, fake,
                                 real, context_fn, B, dev, visualize=False,
                                 timing=kind in ("gan", "sid"))
    del gen, fake, real
    batches = train.data_batches(config, config.trainer, B)
    rng = np.random.default_rng(seed)
    shape = [B] + list(config.image_or_video_shape)[1:]
    groups = _trainer_groups(kind, trainer)
    before = {k: _norms(v) for k, v in groups.items()}
    layers = cfg.num_layers
    total = {k: 0 for k in ca.launch_counts}
    for step in steps:
        if kind == "sid":
            trainer.state.step = step
        else:
            trainer.step = step
        batch = train.make_batch(config, config.trainer, next(batches),
                                 context_fn, shape, rng, dev)
        want = expected_step_launches(kind, trainer, layers)
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        log = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(ca.launch_counts)
        for k, v in got.items():
            total[k] += v
        shown = {k: got[k] for k in OTHER_TRAINER_KERNELS}
        if shown != want or any(v for k, v in got.items()
                                if k not in OTHER_TRAINER_KERNELS):
            fail(f"{kind} train step {step}: launches "
                 f"{ {k: v for k, v in got.items() if v} }, expected {want}")
        bad = [k for k, v in log.items() if not math.isfinite(v)]
        if bad:
            fail(f"{kind} train step {step}: non-finite {bad}")
        split = {k: round(v, 1) for k, v in log.items() if k.endswith("_ms")}
        vals = {k: round(v, 6) for k, v in log.items()
                if not k.endswith("_ms")}
        lat = batch.get("ode_latent", batch.get("latents"))
        data = "prompts only" if lat is None else list(lat.shape)
        print(f"{kind} train step {step} ({config_name}, Wan-1.3B width, "
              f"{layers} layers, {str(dtype)[6:]} weights, data {data}): "
              f"step_ms={ms:.1f} split_ms={split} {vals} "
              f"launches={shown} (exact; host clock, synchronised)",
              flush=True)
    batches.close()
    moved = {k: sum(a != b for a, b in zip(before[k], _norms(v)))
             for k, v in groups.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"{kind} trainer: peak_mem_gb={peak_gb:.2f} leaves moved "
          f"{ {k: f'{moved[k]}/{len(groups[k])}' for k in groups} }",
          flush=True)
    still = [k for k, v in moved.items() if not v]
    if still:
        fail(f"{kind} trainer: no leaf of {still} moved")
    del trainer, groups, batches
    gc.collect()
    torch.cuda.empty_cache()
    return total


def other_trainers_vs_plain(ca, dit, seed: int, d: str) -> None:
    """At full Wan-1.3B width and 2 layers (float32 weights, random output
    layers): the GAN critic-loss gradient (no-grad rollout, the batch-2
    discriminator) and the causal-diffusion loss gradient (the
    teacher-forcing mask over 2 x 21 frames) with the kernels and with
    their plain versions on the same draws; 1e-2 relative L2 over all the
    trained leaves.  Then the checkpoints: a 2-layer GAN trainer's
    ``save_state`` -> ``load_state`` into a fresh trainer (every leaf and
    moment equal), and ``save_reference_checkpoint`` read back through
    ``load_torch_state_dict`` + ``convert_dit_state_dict`` (every leaf
    equal)."""
    from self_forcing_tpu_torch.config import load_config
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    from self_forcing_tpu_torch.models.wan.rope import RopeTables
    from self_forcing_tpu_torch.scheduler import FlowMatchScheduler
    from self_forcing_tpu_torch.training.objectives import (
        causal_diffusion, gan)
    from self_forcing_tpu_torch.training.trainer_gan import GANTrainer
    from self_forcing_tpu_torch.utils import checkpoints as ckpt
    from self_forcing_tpu_torch.utils.tree import items, leaves
    dev = "cuda"
    cfg = dataclasses.replace(WAN_1_3B, num_layers=2, num_frame_per_block=3)
    config = load_config(os.path.join(CONFIGS, "self_forcing_gan.yaml"),
                         os.path.join(CONFIGS, "default_config.yaml"))
    config.update(seed=seed, ema_weight=0.9)

    def gan_trainer():
        gen, fake = (dit.init_params(cfg, seed + i, torch.float32, dev,
                                     causal=i == 0) for i in range(2))
        with torch.no_grad():
            _randomize_heads((gen, fake), seed + 8)
        return GANTrainer(config, gen, fake, cfg, cfg, device=dev)
    trainer = gan_trainer()
    g = torch.Generator(dev).manual_seed(seed)
    ctx = torch.randn(1, 512, cfg.text_dim, generator=g, device=dev)
    noise, real = (torch.randn(1, *TRAIN_LATENT, generator=g, device=dev)
                   for _ in range(2))
    for name in ("gan critic loss", "causal diffusion loss"):
        grads = []
        for kernels in (True, False):
            gg = torch.Generator(dev).manual_seed(seed + 9)
            ca.reset_launch_counts()
            if name.startswith("gan"):
                loss, _ = gan.critic_loss(
                    trainer.bundle, trainer.obj, trainer.generator,
                    trainer.fake_score, trainer.cls_params, noise, real, ctx,
                    None, 2, generator=gg, kernels=kernels)
                wrt = trainer.fake_leaves + trainer.cls_leaves
            else:
                loss, _ = causal_diffusion.generator_loss(
                    trainer.generator, cfg,
                    RopeTables.create(cfg.head_dim, device=dev),
                    FlowMatchScheduler.create(1000, shift=5.0, training=True,
                                              device=dev),
                    real, ctx, 3, generator=gg, kernels=kernels)
                wrt = trainer.gen_leaves
            gr = torch.autograd.grad(loss, wrt, allow_unused=True)
            if kernels:
                launches = {k: v for k, v in ca.launch_counts.items() if v}
            grads.append((float(loss.detach()), torch.cat(
                [x.float().flatten() for x in gr if x is not None])))
            del gr
        (lk, gk), (lp, gp) = grads
        err = rel_l2(gk, gp)
        print(f"{name} gradient (Wan-1.3B width, 2 layers, float32 "
              f"weights): loss kernels={lk:.6f} plain={lp:.6f} grad "
              f"rel_l2={err:.3e} grad_norm={float(gk.norm()):.4e} "
              f"launches={launches}", flush=True)
        if not math.isfinite(err) or err > 1e-2:
            fail(f"{name} gradient: kernels vs plain relative L2 "
                 f"{err:.3e} > 1e-2")
        check_launches(name, launches, ("flash_fwd", "flash_bwd",
                                        "cross_attention"))

    trainer.train_step({"context": ctx, "latents": real})
    path = os.path.join(d, "gan_state.pt")
    t0 = time.perf_counter()
    trainer.save_state(path)
    fresh = gan_trainer()
    fresh.load_state(path)
    ms = (time.perf_counter() - t0) * 1e3
    pairs = list(zip(trainer.gen_leaves + trainer.fake_leaves
                     + trainer.cls_leaves,
                     fresh.gen_leaves + fresh.fake_leaves + fresh.cls_leaves))
    pairs += list(zip(leaves(trainer.cls_opt_state["nu"]),
                      leaves(fresh.cls_opt_state["nu"])))
    pairs += list(zip(leaves(trainer.generator_ema),
                      leaves(fresh.generator_ema)))
    if fresh.step != trainer.step or not all(
            a.device == b.device and torch.equal(a.detach(), b.detach())
            for a, b in pairs):
        fail("GAN trainer save_state -> load_state changed a leaf")
    size_gb = os.path.getsize(path) / 2 ** 30
    os.remove(path)
    ref = os.path.join(d, "reference.pt")
    ckpt.save_reference_checkpoint(ref, {"generator": trainer.generator},
                                   cfg)
    back = ckpt.convert_dit_state_dict(
        ckpt.load_torch_state_dict(ref, "generator"), cfg,
        dtype=torch.float32, device=dev)
    got = dict(items(back))
    if set(got) != {p for p, _ in items(trainer.generator)} or not all(
            torch.equal(got[p], t.detach()) for p, t in
            items(trainer.generator)):
        fail("save_reference_checkpoint did not read back equal")
    os.remove(ref)
    print(f"checkpoints (2-layer GAN trainer, float32): save_state -> "
          f"load_state of {len(pairs)} leaves equal ({size_gb:.2f} GB, "
          f"{ms:.0f} ms); reference checkpoint of the generator read back "
          f"equal ({len(got)} leaves)", flush=True)
    del trainer, fresh, back, got, pairs
    gc.collect()
    torch.cuda.empty_cache()


def phase_other_trainers(ca, dit, seed: int) -> dict:
    """Phase 14: the ODE, causal-diffusion, GAN and SiD trainers at full
    Wan-1.3B width and depth on seeded stand-in data (the port's record
    shards read back through its datasets and DataLoader), then the
    2-layer kernels-vs-plain gradients and the checkpoints.  Returns the
    launches of the four trainers' steps."""
    d = tempfile.mkdtemp(prefix="chip_smoke_trainers_")
    total = {k: 0 for k in ca.launch_counts}
    try:
        ode, shards = write_stand_in_shards(d, seed)
        runs = (("ode", "ode_init.yaml", ode, (0, 1), {}),
                ("diffusion", "causal_diffusion.yaml", shards, (0, 1), {}),
                # ratio 2: step 1 is the critic-only update
                ("gan", "self_forcing_gan.yaml", shards, (0, 1),
                 {"dfake_gen_update_ratio": 2}),
                ("sid", "self_forcing_sid.yaml", None, (0,), {}))
        for kind, name, data, steps, over in runs:
            got = run_other_trainer(ca, kind, name, seed, data, steps,
                                    **over)
            for k, v in got.items():
                total[k] += v
        other_trainers_vs_plain(ca, dit, seed, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return total


# ---------------------------------------------------------------------
# 15. pose-conditioned Self-Forcing distillation and the data-prep chain
# ---------------------------------------------------------------------

POSE_PIX = (480, 832)   # a pose video's pixel height and width
ODE_PAIR_STEPS = 4      # generate_ode_pairs' steps a prompt (default 48)


def write_lora_file(path: str, cfg, rank: int, seed: int) -> None:
    """A random rank-``rank`` LoRA of every target linear of ``cfg``'s
    layers in the diffusers key format under the ``diffusion_model.``
    prefix (``lora_A.default.weight`` [r, in], ``lora_B.default.weight``
    [out, r], bf16), saved with ``torch.save``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dims = {"q": (cfg.dim, cfg.dim), "k": (cfg.dim, cfg.dim),
            "v": (cfg.dim, cfg.dim), "o": (cfg.dim, cfg.dim)}
    sd = {}
    for i in range(cfg.num_layers):
        for mod, proj, (din, dout) in (
                [("self_attn.", p, d) for p, d in dims.items()]
                + [("cross_attn.", p, d) for p, d in dims.items()]
                + [("", "ffn.0", (cfg.dim, cfg.ffn_dim)),
                   ("", "ffn.2", (cfg.ffn_dim, cfg.dim))]):
            key = f"diffusion_model.blocks.{i}.{mod}{proj}."
            sd[key + "lora_A.default.weight"] = (torch.randn(
                rank, din, generator=g, device="cuda") * din ** -0.5).to(
                torch.bfloat16).cpu()
            sd[key + "lora_B.default.weight"] = (torch.randn(
                dout, rank, generator=g, device="cuda") * 1e-3).to(
                torch.bfloat16).cpu()
    torch.save(sd, path)


def write_pose_samples(d: str, seed: int, n: int = 2,
                       frames: int = 21) -> str:
    """``n`` seeded pose samples as ``.npz`` files: latents [frames, 16,
    60, 104], a DWPose video [3, 4 * frames - 3, 480, 832] (height before
    width, the orientation of the 60x104 latent grid), a reference pose
    and a first frame [480, 832, 3] (uint8)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = os.path.join(d, "pose_samples")
    os.makedirs(out)
    Hp, Wp = POSE_PIX
    for i in range(n):
        np.savez(os.path.join(out, f"{i:05d}.npz"),
                 prompt=f"a dancer turning, take {i}",
                 latents=rng.standard_normal(
                     (frames, *TRAIN_LATENT[1:]), np.float32),
                 dwpose_data=rng.integers(0, 256, (3, 4 * frames - 3, Hp, Wp),
                                          dtype=np.uint8),
                 random_ref_dwpose=rng.integers(0, 256, (Hp, Wp, 3),
                                                dtype=np.uint8),
                 first_frame=rng.integers(0, 256, (Hp, Wp, 3),
                                          dtype=np.uint8))
    return out


def phase_ode_pairs(ca, dit, vae, seed: int, model_dir: str, d: str) -> dict:
    """15a. The data-prep chain on phase 10's model directory (the T5, the
    1.3B DiT, the VAE and the stand-in tokenizer): the port's
    ``generate_ode_pairs`` (2 prompts, latents [1, 21, 16, 60, 104],
    guidance 6, ``--num_steps 4 --snapshots 0 1 2 3 -1`` where the default
    is 48 steps) with exact launches, then ``create_sharded_dataset`` and
    ``create_shards_iterative`` over its ``.npz`` files, whose rows the
    port's datasets read back equal to the snapshots.  Returns the
    launches."""
    import numpy as np
    from self_forcing_tpu_torch.data.datasets import (ODERegressionDataset,
                                                      ShardingDataset)
    from self_forcing_tpu_torch.scripts import (create_sharded_dataset,
                                                create_shards_iterative,
                                                generate_ode_pairs)
    if not os.path.exists(os.path.join(model_dir, "google", "umt5-xxl")):
        prepare_demo_dir(dit, vae, seed, model_dir)
        torch.cuda.empty_cache()
    prompts = os.path.join(d, "prompts.txt")
    with open(prompts, "w") as f:
        f.write("a fox runs through fresh snow\na neon city street at "
                "night in rain\n")
    pairs = os.path.join(d, "ode_pairs")
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    per_prompt = generate_ode_pairs.main([
        "--output_folder", pairs, "--caption_path", prompts, "--model_dir",
        model_dir, "--guidance_scale", "6", "--num_steps",
        str(ODE_PAIR_STEPS), "--snapshots", "0", "1", "2", "3", "-1",
        "--seed", str(seed), "--latent_shape", "1",
        *[str(n) for n in TRAIN_LATENT]])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(ca.launch_counts)
    layers = N_LAYERS
    fwd = 2 * len(per_prompt) * ODE_PAIR_STEPS * layers
    want = {"flash_fwd": fwd, "cross_attention": fwd}
    got = {k: v for k, v in launches.items() if v}
    if got != want:
        fail(f"generate_ode_pairs: launches {got}, expected {want}")
    shards = os.path.join(d, "ode_shards")
    create_sharded_dataset.main(["--data_path", pairs, "--output_dir",
                                 shards, "--rows_per_shard", "1"])
    single = os.path.join(d, "ode_pairs.rs")
    create_shards_iterative.main(["--data_path", pairs, "--output_path",
                                  single])
    files = sorted(os.listdir(pairs))
    for ds in (ShardingDataset(shards), ODERegressionDataset(single)):
        if len(ds) != len(files):
            fail(f"ode shards: {len(ds)} rows for {len(files)} prompts")
        for i, name in enumerate(files):
            npz = np.load(os.path.join(pairs, name))
            row = ds[i]
            snaps = npz["latents"][0].astype(np.float32)
            if row["prompts"] != str(npz["prompt"]) or not np.array_equal(
                    row["ode_latent"], snaps):
                fail(f"ode shards: row {i} differs from {name}")
            if not np.isfinite(snaps).all() or snaps.shape != (
                    5, *TRAIN_LATENT):
                fail(f"ode pairs: {name} snapshots {snaps.shape}")
    print(f"generate_ode_pairs (Wan-1.3B width, {layers} layers, "
          f"{len(per_prompt)} prompts, latents [1, 21, 16, 60, 104], "
          f"guidance 6, {ODE_PAIR_STEPS} steps, snapshots 0 1 2 3 -1): "
          f"ms_per_prompt={[round(x, 1) for x in per_prompt]} total_s="
          f"{total_s:.1f} (the models' load included) launches={got} "
          f"(exact); create_sharded_dataset {len(os.listdir(shards))} "
          f"shards and create_shards_iterative read back equal to the "
          f"snapshots (host clock, synchronised)", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def pose_config(d: str, seed: int, model_dir: str, data_path: str,
                pose_path: str, lora_path: str):
    """``configs/self_forcing_dmd.yaml`` with the pose keys, through a
    temporary YAML and ``load_config`` as the CLI reads it."""
    import yaml
    from self_forcing_tpu_torch.config import load_config
    with open(os.path.join(CONFIGS, "self_forcing_dmd.yaml")) as f:
        c = yaml.safe_load(f)
    c.update(seed=seed, use_pose_conditioning=True, pose_drop_prob=0.1,
             pose_weights_path=pose_path, lora_path=lora_path,
             data_path=data_path, model_dir=model_dir,
             image_or_video_shape=[1, *TRAIN_LATENT])
    c.pop("generator_ckpt", None)
    path = os.path.join(d, "self_forcing_dmd_pose.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(c, f)
    return load_config(path, os.path.join(CONFIGS, "default_config.yaml"))


def conditioning_split(trainer, batch, shape) -> dict:
    """Milliseconds of the conditioner's parts on ``batch`` (synchronised
    host clock): the DWPose CNN, the reference-pose CNN, CLIP, and the
    first frame's VAE encode."""
    from self_forcing_tpu_torch import conditioning as cond
    from self_forcing_tpu_torch.models import clip
    con = trainer.conditioner
    dev = torch.device("cuda")
    dw = torch.as_tensor(batch["dwpose_data"], device=dev)
    ref = torch.as_tensor(batch["random_ref_dwpose"], device=dev).permute(
        0, 3, 1, 2)
    img = torch.as_tensor(batch["first_frame"], device=dev).permute(
        0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0
    parts = {
        "dwpose_cnn": lambda: cond.dwpose_embedding(
            con.dwpose_params, cond.prepare_dwpose_input(dw)),
        "randomref_cnn": lambda: cond.randomref_embedding(
            con.randomref_params, ref.float() / 255.0),
        "clip": lambda: clip.encode_image(con.clip_params, con.clip_cfg,
                                          img),
        "vae_encode": lambda: cond.first_frame_condition(
            con.vae_params, con.vae_cfg, img, trainer.obj.num_training_frames,
            shape[3] * 8, shape[4] * 8)}
    out = {}
    with torch.no_grad():
        for name, fn in parts.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[name] = round((time.perf_counter() - t0) * 1e3, 1)
    return out


def run_pose_trainer(ca, dit, vae, seed: int, model_dir: str, d: str):
    """15b. Pose distillation through the entry point's functions
    (``build_models``, ``make_context_fn``, ``make_trainer``,
    ``data_batches``, ``make_batch``) on ``configs/self_forcing_dmd.yaml``
    (bf16, LoRA rank 128, 7 blocks of 3 frames, update ratio 5) with
    ``use_pose_conditioning``, ``pose_drop_prob`` 0.1, a random
    UniAnimate-layout ``pose_weights_path``, a random rank-128
    ``lora_path``, pose shards that ``create_pose_shards`` wrote from
    seeded samples, and a model directory holding the DiT, the VAE and
    CLIP (links to phase 10's files and a random CLIP): step 0 (generator
    and critic) and step 1 (critic), each with its ms split, losses and
    exact launches; the leaves that moved; the peak.  Returns (trainer,
    batch, launches)."""
    import numpy as np
    from self_forcing_tpu_torch import conditioning as cond
    from self_forcing_tpu_torch import train
    from self_forcing_tpu_torch.models import clip
    from self_forcing_tpu_torch.models.wan.configs import (WAN_1_3B,
                                                           apply_model_kwargs)
    from self_forcing_tpu_torch.scripts import create_pose_shards
    from self_forcing_tpu_torch.utils import tree
    dev = torch.device("cuda")
    mdir = os.path.join(d, "pose_models")
    os.makedirs(os.path.join(mdir, "Wan2.1-T2V-1.3B"))
    for name in (os.path.join("Wan2.1-T2V-1.3B", "model.pt"),
                 "Wan2.1_VAE.pth"):
        os.symlink(os.path.join(model_dir, name), os.path.join(mdir, name))
    ccfg = clip.CLIP_XLM_ROBERTA_VIT_H_14
    drawn = clip.init_vision_params(ccfg, seed + 81, device=dev)
    torch.save(export_clip_vision(drawn, ccfg),
               os.path.join(mdir, clip.CLIP_WEIGHTS))
    del drawn
    pose_path = os.path.join(d, "unianimate_pose.pt")
    torch.save(cond.export_pose_state_dict(
        cond.init_dwpose_params(seed + 82, device=dev),
        cond.init_randomref_params(seed + 83, device=dev)), pose_path)
    shards = os.path.join(d, "pose_shards")
    create_pose_shards.main(["--data_path", write_pose_samples(d, seed + 84),
                             "--output_dir", shards])
    lora_path = os.path.join(d, "lora_rank128.pt")
    config = pose_config(d, seed, mdir, shards, pose_path, lora_path)
    write_lora_file(lora_path, apply_model_kwargs(WAN_1_3B, config),
                    int(config.lora_rank), seed + 85)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg, gen, fake, real = train.build_models(config, torch.bfloat16, dev)
    with torch.no_grad():
        _randomize_heads((gen, fake, real), seed + 7)
    context_fn = train.make_context_fn(config, cfg, dev)
    trainer = train.make_trainer(config, "score_distillation", cfg, gen,
                                 fake, real, context_fn, 1, dev,
                                 timing=True)
    del gen, fake, real
    if trainer.conditioner is None or trainer.conditioner.clip_params is None \
            or trainer.bundle.vae_params is None:
        fail("pose trainer: no conditioner, CLIP or VAE")
    batches = train.data_batches(config, "score_distillation", 1)
    rng = np.random.default_rng(seed)
    shape = [1, *TRAIN_LATENT]
    before = {p: float(torch.linalg.vector_norm(t.detach().float()))
              for p, t in tree.items(trainer.state.generator)}
    before_f = _norms(trainer.fake_leaves)
    layers = cfg.num_layers
    total = {k: 0 for k in ca.launch_counts}
    for step in (0, 1):
        trainer.state.step = step
        batch = train.make_batch(config, "score_distillation", next(batches),
                                 context_fn, shape, rng, dev)
        if tuple(batch["dwpose_data"].shape) != (1, 3, 81, *POSE_PIX):
            fail(f"pose batch: dwpose_data {batch['dwpose_data'].shape}")
        want = expected_step_launches("dmd", trainer, layers, pose=True)
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        log = trainer.train_step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = dict(ca.launch_counts)
        for k, v in got.items():
            total[k] += v
        shown = {k: got[k] for k in OTHER_TRAINER_KERNELS}
        if shown != want or any(v for k, v in got.items()
                                if k not in OTHER_TRAINER_KERNELS):
            fail(f"pose train step {step}: launches "
                 f"{ {k: v for k, v in got.items() if v} }, expected {want}")
        bad = [k for k, v in log.items() if not math.isfinite(v)]
        if bad:
            fail(f"pose train step {step}: non-finite {bad}")
        split = {k: round(v, 1) for k, v in log.items() if k.endswith("_ms")}
        vals = {k: round(v, 6) for k, v in log.items()
                if not k.endswith("_ms")}
        sub = conditioning_split(trainer, batch, shape) if step == 0 else {}
        print(f"pose train step {step} (self_forcing_dmd.yaml + pose, "
              f"Wan-1.3B width, {layers} layers, bf16, LoRA rank "
              f"{config.lora_rank} from lora_path, pose video [1, 3, 81, "
              f"480, 832]): step_ms={ms:.1f} split_ms={split} "
              f"{'conditioning_parts_ms=' + str(sub) + ' ' if sub else ''}"
              f"{vals} launches={shown} (exact; host clock, synchronised)",
              flush=True)
    batches.close()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = [p for p, t in tree.items(trainer.state.generator)
             if float(torch.linalg.vector_norm(t.detach().float()))
             != before[p]]
    moved_f = sum(a != b for a, b in zip(before_f,
                                         _norms(trainer.fake_leaves)))
    lora_moved = [p for p in moved if "lora_A" in p or "lora_B" in p]
    pose_moved = [p for p in moved if "pose_proj" in p]
    print(f"pose trainer: peak_mem_gb={peak_gb:.2f} generator leaves moved "
          f"{len(moved)}/{len(before)} (LoRA {len(lora_moved)}, pose_proj "
          f"{len(pose_moved)}) critic leaves moved {moved_f}/"
          f"{len(before_f)}", flush=True)
    if not lora_moved or not pose_moved or not moved_f:
        fail("pose trainer: the LoRA, pose_proj or critic leaves did not "
             "move")
    if peak_gb >= 80:
        fail(f"pose trainer: peak {peak_gb:.2f} GB")
    return trainer, batch, total


def long_rollout(ca, trainer, batch, seed: int) -> dict:
    """15c. A 24-frame rollout at full width with the trainer's generator
    (``num_training_frames`` 24: the cache holds 24 frames, the first
    block runs as a no-grad prefix) through ``run_generator``, the pose
    tokens of a 93-frame pose video, then the backward of a loss on the
    trimmed output: the trim's VAE decode + re-encode timed, the output's
    21 frames and mask checked, the decode launches exact on the 37440-key
    window.  Returns the launches."""
    import dataclasses as dc
    from self_forcing_tpu_torch.models.wan import dit
    from self_forcing_tpu_torch.training.objectives.base import ModelBundle
    obj = dc.replace(trainer.obj, num_training_frames=24)
    b0 = trainer.bundle
    bundle = ModelBundle.create(b0.generator_cfg, b0.critic_cfg,
                                b0.teacher_cfg, obj,
                                [int(s) for s in
                                 trainer.config.denoising_step_list],
                                vae_params=b0.vae_params, vae_cfg=b0.vae_cfg,
                                device="cuda")
    bundle.pipeline.denoising_step_list = b0.pipeline.denoising_step_list
    gen = trainer.state.generator
    g = torch.Generator(device="cuda").manual_seed(seed + 90)
    Hp, Wp = POSE_PIX
    dw = torch.randint(0, 256, (1, 3, 93, Hp, Wp), generator=g,
                       device="cuda", dtype=torch.uint8)
    with torch.no_grad():
        cond = trainer.conditioner.build_conditioning(
            dw, num_frames=24, height=Hp, width=Wp)
    ctx = torch.randn(1, 512, bundle.generator_cfg.text_dim, generator=g,
                      device="cuda")
    noise = torch.randn(1, 24, *TRAIN_LATENT[1:], generator=g, device="cuda")
    exit_idx = 2
    layers = bundle.generator_cfg.num_layers
    trims = []
    trim = bundle.trim_rollout

    def timed_trim(pred):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = trim(pred)
        torch.cuda.synchronize()
        trims.append((time.perf_counter() - t0) * 1e3)
        return out
    bundle.trim_rollout = timed_trim
    torch.cuda.synchronize()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    ctx_kv = dit.precompute_context(gen, bundle.generator_cfg, ctx)
    pred, mask, _, _ = bundle.run_generator(gen, noise, ctx_kv, exit_idx,
                                            generator=g, cond=cond)
    loss = (pred.float().square() * mask).sum() / mask.sum()
    grads = torch.autograd.grad(loss, trainer.gen_leaves, allow_unused=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    got = {k: v for k, v in ca.launch_counts.items() if v}
    gnorm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(x.float()) for x in grads
         if x is not None])))
    del grads
    want = {k: v for k, v in add_launches(
        rollout_launches(layers, [exit_idx], False),
        rollout_launches(layers, [exit_idx] * 7, True)).items() if v}
    keys = 24 * 1560
    S = dit.init_kv_cache(bundle.generator_cfg, 1, 1560, 24,
                          device="meta").k.shape[2]
    if got != want:
        fail(f"24-frame rollout: launches {got}, expected {want}")
    if tuple(pred.shape) != (1, 21, *TRAIN_LATENT[1:]) or \
            not torch.isfinite(pred.float()).all() or \
            int(mask[:, :3].sum()) or not bool(mask[:, 3:].all()) or \
            not math.isfinite(gnorm) or gnorm == 0:
        fail(f"24-frame rollout: output {tuple(pred.shape)}, mask "
             f"{mask.float().mean(dim=(2, 3, 4)).tolist()}, grad norm "
             f"{gnorm}")
    print(f"24-frame rollout (Wan-1.3B width, {layers} layers, bf16, exit "
          f"{exit_idx}, the first block a no-grad prefix, pose tokens of a "
          f"93-frame pose video): ms={ms:.1f} (rollout, trim, backward) "
          f"trim_vae_decode_reencode_ms={trims[0]:.1f} output "
          f"{list(pred.shape)} mask frames {int(mask[0, :, 0, 0, 0].sum())}"
          f"/21 (the first block masked) grad_norm={gnorm:.4e} "
          f"last block's decode window {keys} keys (cache buffer {S}) "
          f"launches={got} (exact)", flush=True)
    return got


def pose_grad_vs_plain(ca, dit, seed: int, batch) -> None:
    """15d. The pose-conditioned critic-loss gradient at full Wan-1.3B
    width and 2 layers (the conditioning from the trainer's conditioner on
    the phase's pose batch) with the kernels and with their plain
    versions, the same draws; 1e-2 relative L2 (phase 7's limit)."""
    from self_forcing_tpu_torch.config import load_config
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    from self_forcing_tpu_torch.training.objectives import dmd
    from self_forcing_tpu_torch.training.trainer_distillation import (
        ScoreDistillationTrainer)
    config = load_config(os.path.join(CONFIGS, "self_forcing_dmd.yaml"),
                         os.path.join(CONFIGS, "default_config.yaml"))
    config.update(seed=seed, lora_rank=0, use_pose_conditioning=True)
    cfg = dataclasses.replace(WAN_1_3B, num_layers=2)
    gen, fake, real = (dit.init_params(cfg, seed + i, torch.bfloat16, "cuda",
                                       causal=i == 0) for i in range(3))
    with torch.no_grad():
        _randomize_heads((gen, fake, real), seed + 8)
    g = torch.Generator("cuda").manual_seed(seed)
    ctx = torch.randn(1, 512, cfg.text_dim, generator=g, device="cuda")
    trainer = ScoreDistillationTrainer(config, gen, fake, real, cfg, cfg,
                                       cfg, ctx, device="cuda")
    cond = trainer._build_cond({k: batch[k] for k in
                                ("dwpose_data", "random_ref_dwpose")},
                               [1, *TRAIN_LATENT], keep=torch.ones(1))
    noise = torch.randn(1, *TRAIN_LATENT, device="cuda", generator=g)
    grads = []
    for kernels in (True, False):
        gg = torch.Generator("cuda").manual_seed(seed + 9)
        ca.reset_launch_counts()
        loss, _ = dmd.critic_loss(trainer.bundle, trainer.obj, gen, fake,
                                  noise, ctx, ctx, 2, generator=gg,
                                  kernels=kernels, cond=cond)
        gr = torch.autograd.grad(loss, trainer.fake_leaves,
                                 allow_unused=True)
        if kernels:
            launches = {k: v for k, v in ca.launch_counts.items() if v}
        grads.append((float(loss.detach()), torch.cat(
            [x.float().flatten() for x in gr if x is not None])))
        del gr
    (lk, gk), (lp, gp) = grads
    err = rel_l2(gk, gp)
    print(f"pose critic-loss gradient (Wan-1.3B width, 2 layers, bf16, exit "
          f"2, pose tokens and the reference-pose y): loss kernels={lk:.6f} "
          f"plain={lp:.6f} grad rel_l2={err:.3e} grad_norm="
          f"{float(gk.norm()):.4e} launches={launches}", flush=True)
    if not math.isfinite(err) or err > 1e-2:
        fail(f"pose critic-loss gradient: kernels vs plain relative L2 "
             f"{err:.3e} > 1e-2")
    check_launches("pose critic-loss gradient", launches,
                   ("flash_fwd", "flash_bwd", "decode_fresh_free",
                    "cross_attention"))
    del trainer, gen, fake, real, grads
    gc.collect()
    torch.cuda.empty_cache()


def phase_pose_training(ca, dit, vae, seed: int, model_dir: str) -> dict:
    """Phase 15: the data-prep chain (a), pose distillation through the
    entry point's functions (b), a 24-frame rollout (c) and the 2-layer
    gradient against the plain versions (d), every earlier tensor freed
    first.  Returns the launches of (a)-(c)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # train.py's settings: the default conv route and PyTorch's default
    # cuDNN TF32 for the float32 VAE, CLIP and pose CNNs
    vae.set_conv_backend(None)
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_pose_")
    total = {k: 0 for k in ca.launch_counts}
    try:
        parts = [phase_ode_pairs(ca, dit, vae, seed, model_dir, d)]
        trainer, batch, launches = run_pose_trainer(ca, dit, vae, seed,
                                                    model_dir, d)
        parts.append(launches)
        parts.append(long_rollout(ca, trainer, batch, seed))
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        pose_grad_vs_plain(ca, dit, seed, batch)
        for p in parts:
            for k, v in p.items():
                total[k] += v
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    print(f"phase 15 ({smi}): {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return total


def profile_ms(fn) -> tuple:
    """Wall time of ``fn`` (ending in a synchronize) and the CUDA kernels
    it ran, [(name, device ms)] by device time, from torch.profiler, and
    the host stalls inside that wall; then (objects, ms) of a full
    collection.  The collection is made here so that the collector pass
    freeing the profile's cyclic garbage (a pass of 0.4-0.5 s landed in a
    later timed stream block) runs outside any timed span."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with HostStalls() as stalls:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    rows = []
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        rows.append((e.key, us / 1e3))
    del prof
    t = time.perf_counter()
    collected = (gc.collect(), (time.perf_counter() - t) * 1e3)
    return wall, sorted(rows, key=lambda r: -r[1]), stalls, collected


def phase_profile(dit, cfg, params, last, tag) -> None:
    """Where the time goes: one denoise forward at the last block's cache
    window and the decode of that block, under torch.profiler."""
    pipe = last["pipe"]
    ctx_kv = dit.precompute_context(params, cfg, last["context"])
    x = last["x"]
    t = torch.full(x.shape[:2], 500.0, device="cuda")
    fs = (x.shape[3] // 2) * (x.shape[4] // 2)
    start = last["start"]

    def forward():
        dit.forward_inference(params, cfg, x, t, ctx_kv, pipe._cache, start,
                              pipe.rope, static_kv_hi=start * fs,
                              write_cache=False)

    for label, fn in (("dit_forward", forward), last["decode"]):
        fn()  # warm
        walls = []   # the same call without the profiler, host clock
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        reserved = torch.cuda.memory_reserved() / 1e9
        wall, rows, stalls, (n_gc, gc_ms) = profile_ms(fn)
        busy = sum(ms for _, ms in rows)
        top = "; ".join(f"{name[:48]}={ms:.2f}ms({ms / max(busy, 1e-9):.0%})"
                        for name, ms in rows[:8])
        plain_wall = statistics.median(walls)
        print(f"profile {tag} {label} (cache holds "
              f"{pipe._cache.local_end} tokens): "
              f"wall_ms={wall:.1f} device_busy_ms={busy:.1f} "
              f"idle_share={1 - busy / wall:.3f} during the profiled call: "
              f"{stalls} reserved_gb={reserved:.2f}; after it a full "
              f"collection freed {n_gc} objects in {gc_ms:.1f} ms; "
              f"unprofiled_wall_ms="
              f"{[round(w, 1) for w in walls]} idle_share_unprofiled="
              f"{1 - busy / plain_wall:.3f} top: {top}", flush=True)


def save_stand_in_tokenizer(path: str) -> None:
    """A word-level stand-in for google/umt5-xxl (pad 0, eos 1 appended,
    unk 2), saved where ``load_wan_models`` looks for the tokenizer: the
    real tokenizer's files are not in the repository."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast
    words = ("a fox runs through fresh snow at night in a neon city street "
             "rain reflections cinematic warmup").split()
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    vocab.update({w: i + 3 for i, w in enumerate(dict.fromkeys(words))})
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Punctuation()])
    tok.post_processor = processors.TemplateProcessing(
        single="$A </s>", special_tokens=[("</s>", 1)])
    PreTrainedTokenizerFast(tokenizer_object=tok, pad_token="<pad>",
                            eos_token="</s>", unk_token="<unk>"
                            ).save_pretrained(path)


def prepare_demo_dir(dit, vae, seed: int, model_dir: str) -> tuple:
    """What the demo server needs under ``model_dir``: phase 10's model
    files (drawn from the seeds where they are missing), a random TAEHV
    (decoder and encoder) saved in ``taew2_1.pth``'s key layout, a
    stand-in tokenizer, and copies of ``configs/self_forcing_dmd.yaml``
    (naming ``model_dir``) and ``default_config.yaml``.  Returns (config
    path, TAEHV checkpoint path)."""
    from self_forcing_tpu_torch.models import taehv
    if not os.path.exists(os.path.join(model_dir, "Wan2.1_VAE.pth")):
        t5p, params, cfg, vae_src = model_dir_params(dit, vae, seed)
        export_model_dir(model_dir, t5p, params, cfg, vae_src)
        del t5p, params, vae_src
        torch.cuda.empty_cache()
    tae_path = os.path.join(model_dir, "taew2_1.pth")
    torch.save(taehv.export_taehv_state_dict({
        **taehv.init_decoder_params(seed=seed + 40, device="cuda"),
        **taehv.init_encoder_params(seed=seed + 41, device="cuda")}),
        tae_path)
    save_stand_in_tokenizer(os.path.join(model_dir, "google", "umt5-xxl"))
    cfg_dir = os.path.join(model_dir, "configs")
    os.makedirs(cfg_dir, exist_ok=True)
    for name in ("self_forcing_dmd.yaml", "default_config.yaml"):
        with open(os.path.join(CONFIGS, name)) as f:
            text = f.read()
        if name == "self_forcing_dmd.yaml":
            text += f"\nmodel_dir: {json.dumps(model_dir)}\n"
        with open(os.path.join(cfg_dir, name), "w") as f:
            f.write(text)
    return os.path.join(cfg_dir, "self_forcing_dmd.yaml"), tae_path


class WsClient:
    """A WebSocket client on the port's frame helpers (its frames go out
    unmasked, which the server's ``decode_frame`` takes); every read has a
    timeout."""

    def __init__(self, port: int, timeout: float = 300.0):
        import base64
        import socket
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((
            f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1\r\nUpgrade: websocket\r\n"
            f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
            f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        head = b""
        while b"\r\n\r\n" not in head:
            byte = self.sock.recv(1)
            if not byte:
                fail("serving: the server closed the handshake")
            head += byte
        if b" 101 " not in head.split(b"\r\n")[0]:
            fail(f"serving: handshake answered {head.splitlines()[0]!r}")

    def send(self, event: str, data: dict) -> None:
        from self_forcing_tpu_torch.serving.websocket import encode_frame
        self.sock.sendall(encode_frame(json.dumps(
            {"event": event, "data": data}).encode()))

    def recv(self) -> dict:
        from self_forcing_tpu_torch.serving.websocket import decode_frame
        frame = decode_frame(self.sock)
        if frame is None:
            fail("serving: the server closed the connection")
        return json.loads(frame[1].decode())

    def close(self) -> None:
        self.sock.close()


def serve_request(client, app, payload, counters, stop_after_block=False,
                  keep_jpegs=0, during=None):
    """One ``start_generation`` through ``client`` and every event up to
    ``generation_complete`` (and ``generation_stopped`` when this request
    is stopped after its first ``block_ready``), each stamped with the ms
    since the request was sent; any ``error`` fails the phase.  The
    kernels' launch counts are reset before and read after.  ``during``
    runs once ``generation_started`` has arrived."""
    import base64
    for c in counters:
        c.reset_launch_counts()
    t0 = time.perf_counter()
    client.send("start_generation", payload)
    events, jpegs, stopped = [], [], False
    while True:
        msg = client.recv()
        ms = (time.perf_counter() - t0) * 1e3
        ev, data = msg["event"], msg["data"] or {}
        if ev == "error":
            fail(f"serving: request {payload} answered error {data}")
        events.append((ms, ev, data))
        if ev == "generation_started" and during is not None:
            during()
        if ev == "frame_ready" and len(jpegs) < keep_jpegs:
            jpegs.append(base64.b64decode(data["jpeg"]))
        if ev == "block_ready" and stop_after_block and not stopped:
            client.send("stop_generation", {})
            stopped = True
        names = [e[1] for e in events]
        if "generation_complete" in names and (
                not stopped or "generation_stopped" in names):
            break
    deadline = time.time() + 60
    while app.busy and time.time() < deadline:
        time.sleep(0.01)
    if app.busy:
        fail("serving: the app stayed busy after generation_complete")
    torch.cuda.synchronize()
    launches = {}
    for c in counters:
        launches.update(c.launch_counts)
    return events, jpegs, launches


def request_line(tag, events, launches) -> tuple[int, dict]:
    """Print one request's readings; returns (pixel frames, the first
    timings)."""
    first = {}
    for ms, ev, _ in events:
        first.setdefault(ev, ms)
    frames = [ms for ms, ev, _ in events if ev == "frame_ready"]
    blocks = [d["block_s"] for _, ev, d in events if ev == "block_ready"]
    span = (frames[-1] - first["generation_started"]) / 1e3 if frames \
        else float("nan")
    fps = len(frames) / span if frames else 0.0
    ms = {ev: first.get(ev, float("nan")) for ev in (
        "generation_started", "block_ready", "frame_ready",
        "generation_complete")}
    print(f"serving {tag}: ms_to_generation_started="
          f"{ms['generation_started']:.1f} ms_to_first_block_ready="
          f"{ms['block_ready']:.1f} ms_to_first_frame_ready="
          f"{ms['frame_ready']:.1f} ms_to_generation_complete="
          f"{ms['generation_complete']:.1f} block_s={blocks} frames="
          f"{len(frames)} pushed_fps={fps:.3f} "
          f"(frames over the seconds from generation_started to the last "
          f"frame_ready, host clock of the client) launches="
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return len(frames), first


def phase_serving(ca, cm, dit, vae, seed, model_dir) -> dict:
    """12. The streaming demo server (``python -m
    self_forcing_tpu_torch.demo``) serving a few requests on the card.

    The model directory is phase 10's ``torch.save`` export (random T5,
    1.3B DiT, float32 VAE; made here from the same seeds when phase 10
    did not run), plus a random TAEHV (decoder and encoder) saved in
    ``taew2_1.pth``'s key layout and a word-level stand-in tokenizer
    (``prepare_demo_dir``).  A copy of ``configs/self_forcing_dmd.yaml``
    names that directory; the demo's own ``parse_args`` and ``build_app``
    (``--warmup``: kernels and one throwaway 7-block stream) build the
    app as its ``main`` does, and it serves on 127.0.0.1 at an ephemeral
    port in a thread, with
    PyTorch's default cuDNN TF32 and the default conv route, as the CLI
    runs.  Two instruments are added: the Wan decoder keeps a copy of
    each request's first decoded block (on the card), for (e), and the
    generation thread's wait for each block's pixels is timed (the
    lookahead hides it behind the next block's work).  A client on the
    port's frame helpers sends ``set_fps`` 1000, then: (a) parity, 3
    blocks with the Wan VAE; (b) the demo, ``quantize`` and ``taehv``, 3
    blocks, during which (c) a second connection's ``start_generation``
    must be refused ``busy``; (d) 7 blocks (the global cap), stopped after
    its first ``block_ready``, must answer ``generation_stopped``; (e) (a)
    again, its first block's frames within 1 uint8 level of (a)'s; (a')
    (a) with ``.cpu()`` at the flush in place of the pinned copy (the
    A/B of the lookahead's fetch); a demo request under torch.profiler
    (its device idle share and the host's synchronize waits); (f) ``GET
    /api/status``: not busy, ``hbm_in_use_gb`` the allocator's live
    bytes within 0.05 GB.  (a), (a'), (b), (e) and the profiled request
    must push every frame (33) in 3 ``block_ready`` events with the exact
    launch counts of 3 blocks."""
    import threading
    import urllib.request

    import cv2
    import numpy as np
    from self_forcing_tpu_torch import demo
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    from self_forcing_tpu_torch.serving import demo_server as ds
    from torch.profiler import ProfilerActivity, profile
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
    vae.set_conv_backend(None)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    cfg_path, tae_path = prepare_demo_dir(dit, vae, seed, model_dir)
    prep_s = time.perf_counter() - t

    t = time.perf_counter()
    args = demo.parse_args([
        "--config_path", cfg_path, "--taehv_checkpoint", tae_path,
        "--host", "127.0.0.1", "--port", "0", "--fps", "1000", "--warmup"])
    app = demo.build_app(args)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    pipe = app.pipeline
    if pipe.cfg.dim != WAN_1_3B.dim or pipe.cfg.num_layers != 30 or \
            pipe.device.type != "cuda" or app.latent_shape != (
                1, 21, 16, 60, 104) or "taehv" not in app._decoders:
        fail(f"serving: the demo built {pipe.cfg} on {pipe.device}, latent "
             f"shape {app.latent_shape}, decoders {list(app._decoders)}")
    print(f"serving: model dir ready in {prep_s:.1f} s (TAEHV checkpoint "
          f"{os.path.getsize(tae_path) / 1e6:.1f} MB); demo.build_app "
          f"(load_wan_models with t5_on_host, --warmup: one 7-block stream "
          f"with the Wan VAE) {build_s:.1f} s", flush=True)

    first_px, current = {}, [None]
    wan_decode, wan_reset = app._decoders["wan"]

    def keep_first(latents):
        px = wan_decode(latents)
        first_px.setdefault(current[0], px.clone())
        return px

    app._decoders["wan"] = (keep_first, wan_reset)
    # the second instrument: how long the generation thread waits for
    # each block's pixels (its CUDA event), after queueing the next
    # block's work; the last block has no next block to hide behind
    waits = []
    host_copy_numpy = ds._HostCopy.numpy

    def timed_numpy(self):
        t0 = time.perf_counter()
        out = host_copy_numpy(self)
        waits.append(round((time.perf_counter() - t0) * 1e3, 2))
        return out

    ds._HostCopy.numpy = timed_numpy
    server = app.server(args.host, args.port)
    port = server.server_address[1]
    serve_t = threading.Thread(target=server.serve_forever, daemon=True)
    serve_t.start()
    forwards = 5 * 3 - 1
    attn = 30 * forwards
    parity_want = {"decode_fresh_free": attn, "cross_attention": attn}
    demo_want = {"int8qk_quantize": attn, "decode_fresh_int8qk": attn,
                 "cross_attention": attn, "quantize_rows": 4 * attn + 60,
                 "w8a8_matmul": 4 * attn + 60, "w8a8_ffn1": attn,
                 "w8a8_ffn2": attn}
    readings = {}
    client = WsClient(port)
    try:
        client.send("set_fps", {"fps": 1000})

        def run(tag, payload, want, **kw):
            current[0] = tag
            waits.clear()
            events, jpegs, launches = serve_request(
                client, app, dict(payload, prompt="a fox runs through "
                                  "fresh snow at night", seed=seed + 50),
                (ca, cm), **kw)
            n, first = request_line(tag, events, launches)
            print(f"serving {tag}: the generation thread's wait for each "
                  f"block's pixels (ms, host clock): {waits}", flush=True)
            if want is not None:   # a whole 3-block request
                got = {k: v for k, v in launches.items() if v}
                started = [d for _, e, d in events
                           if e == "generation_started"][0]
                blocks = sum(e == "block_ready" for _, e, _ in events)
                done = [d for _, e, d in events
                        if e == "generation_complete"][0]
                if n != 33 or blocks != 3 or \
                        started["expected_frames"] != 33 or \
                        done["frames"] != 33:
                    fail(f"serving {tag}: {n} frames in {blocks} blocks "
                         f"(started {started}, complete {done}); expected "
                         f"33 in 3")
                if got != want:
                    fail(f"serving {tag}: launches {got}, expected {want}")
                if len(waits) != 3:
                    fail(f"serving {tag}: {len(waits)} blocks fetched "
                         f"through pinned memory, expected 3")
            readings[tag] = (events, jpegs, launches, first)
            return events, jpegs

        plain = {"blocks": 3, "taehv": False, "quantize": False}
        fast = {"blocks": 3, "taehv": True, "quantize": True}
        _, jpegs_a = run("(a) parity: Wan VAE, bf16 DiT, 3 blocks", plain,
                         parity_want, keep_jpegs=9)
        busy = {}

        def second_connection():
            other = WsClient(port)
            try:
                other.send("start_generation", {"prompt": "y", "seed": 1})
                busy["reply"] = other.recv()
            finally:
                other.close()

        run("(b) demo: quantize (W8A8 + int8-QK) + TAEHV, 3 blocks", fast,
            demo_want, during=second_connection)
        reply = busy.get("reply", {})
        print(f"serving (c) a second connection during (b): {reply}",
              flush=True)
        if reply.get("event") != "error" or \
                (reply.get("data") or {}).get("message") != "busy":
            fail(f"serving (c): expected error busy, got {reply}")
        events_d, _ = run("(d) 7 blocks, stopped after the first "
                          "block_ready", {"blocks": 7, "taehv": False,
                                          "quantize": False}, None,
                          stop_after_block=True)
        started_d = [d for _, e, d in events_d if e == "generation_started"]
        stopped_d = [ms for ms, e, _ in events_d if e == "generation_stopped"]
        blocks_d = sum(e == "block_ready" for _, e, _ in events_d)
        print(f"serving (d): generation_stopped {stopped_d[0]:.1f} ms after "
              f"start_generation (latent_frames "
              f"{started_d[0]['latent_frames']}), {blocks_d} of 7 blocks "
              f"pushed", flush=True)
        if started_d[0]["latent_frames"] != 21 or blocks_d >= 7:
            fail(f"serving (d): {started_d}, {blocks_d} blocks")
        _, jpegs_e = run("(e) (a) again", plain, parity_want, keep_jpegs=9)
        a_px = first_px["(a) parity: Wan VAE, bf16 DiT, 3 blocks"]
        e_px = first_px["(e) (a) again"]
        diff = int((a_px.int() - e_px.int()).abs().max())
        same_jpegs = sum(x == y for x, y in zip(jpegs_a, jpegs_e))
        print(f"serving (e) against (a): first block {tuple(e_px.shape)} "
              f"uint8, max abs difference {diff} levels (limit 1); "
              f"{same_jpegs} of {len(jpegs_a)} first-block JPEGs "
              f"byte-equal", flush=True)
        if tuple(a_px.shape) != (9, 480, 832, 3) or diff > 1:
            fail(f"serving (e): first block {tuple(a_px.shape)}, "
                 f"{diff} levels from (a)'s")
        img = cv2.imdecode(np.frombuffer(jpegs_e[0], np.uint8),
                           cv2.IMREAD_COLOR)
        if img is None or img.shape != (480, 832, 3) or img.std() < 1:
            fail(f"serving: a pushed JPEG decodes to "
                 f"{None if img is None else img.shape}")

        # the A/B behind the pinned copy: (a) with each block's pixels
        # fetched by .cpu() at the flush, which waits for every kernel
        # queued on the stream, the next block's included
        class CpuAtFlush:
            def __init__(self, px):
                self.px = px

            def __array__(self, dtype=None, copy=None):
                t0 = time.perf_counter()
                out = self.px.cpu().numpy()
                waits.append(round((time.perf_counter() - t0) * 1e3, 2))
                return out

        start_fetch = ds._start_fetch
        ds._start_fetch = CpuAtFlush
        try:
            run("(a') (a) with .cpu() at the flush", plain, parity_want)
        finally:
            ds._start_fetch = start_fetch

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run("(b) profiled", fast, demo_want)
            wall = (time.perf_counter() - t) * 1e3
        rows, waits = [], 0.0
        for e in prof.key_averages():
            if str(e.device_type).endswith("CUDA"):
                rows.append((e.key, getattr(e, "self_device_time_total",
                                            0) / 1e3))
            elif e.key in ("cudaEventSynchronize", "cudaStreamSynchronize",
                           "cudaDeviceSynchronize"):
                waits += e.self_cpu_time_total / 1e3
        del prof
        gc.collect()
        rows.sort(key=lambda r: -r[1])
        dev_busy = sum(ms for _, ms in rows)
        top = "; ".join(f"{k[:40]}={ms:.1f}ms" for k, ms in rows[:6])
        print(f"serving profile (the demo request, start_generation to "
              f"generation_complete): wall_ms={wall:.1f} device_busy_ms="
              f"{dev_busy:.1f} idle_share={1 - dev_busy / wall:.3f} "
              f"host_sync_wait_ms={waits:.1f} (the host's CUDA "
              f"synchronize calls: the lookahead's event waits, the T5's "
              f"copies) top: {top}", flush=True)
        if dev_busy <= 0:
            fail("serving profile: no device time recorded")

        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/status", timeout=60).read()
        status = json.loads(body)
        live = torch.cuda.memory_allocated() / 2 ** 30
        free, total = torch.cuda.mem_get_info()
        print(f"serving (f) /api/status: {status} (live tensors "
              f"torch.cuda.memory_allocated: {live:.2f} GiB; "
              f"torch.cuda.mem_get_info: free {free / 2 ** 30:.2f} of "
              f"{total / 2 ** 30:.2f} GiB)", flush=True)
        if status["busy"] or not status["taehv_available"] or \
                not status["quantize_available"] or \
                abs(status["hbm_in_use_gb"] - live) > 0.05 \
                or status["hbm_in_use_gb"] <= 0:
            fail(f"serving (f): status {status}: hbm_in_use_gb is not the "
                 f"allocator's live {live:.2f} GiB within 0.05")
        index = urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                       timeout=60).read()
        if b"<html" not in index.lower():
            fail("serving: / did not answer the demo page")
    finally:
        ds._HostCopy.numpy = host_copy_numpy
        client.close()
        stopper = threading.Thread(target=server.shutdown, daemon=True)
        stopper.start()
        stopper.join(60)
        server.server_close()
        serve_t.join(60)
    if stopper.is_alive() or serve_t.is_alive():
        fail("serving: the server did not shut down")
    del app, pipe, first_px
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    return {tag: r[2] for tag, r in readings.items()}


class CudaMarks:
    """CUDA events recorded around wrapped calls, read after a
    synchronize: ``wrap(label, fn)`` records "label>" before and "label<"
    after each call of ``fn``."""

    def __init__(self):
        self.events = []

    def mark(self, label: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((label, e))

    def wrap(self, label: str, fn):
        def run(*a, **k):
            self.mark(label + ">")
            out = fn(*a, **k)
            self.mark(label + "<")
            return out
        return run

    def spans(self, label: str) -> list:
        """ms of each call of ``label``, in order."""
        starts = [e for n, e in self.events if n == label + ">"]
        ends = [e for n, e in self.events if n == label + "<"]
        return [a.elapsed_time(b) for a, b in zip(starts, ends)]

    def starts(self, label: str) -> list:
        return [e for n, e in self.events if n == label + ">"]


def export_clip_vision(params, cfg) -> dict:
    """The CLIP vision tree -> the reference's ``visual.*`` state dict on
    the host: the inverse of ``clip.convert_clip_vision_state_dict``
    (linear weights back to [out, in], the patch matrix back to the conv's
    [D, 3, ph, pw])."""
    from self_forcing_tpu_torch.utils import tree
    d, ph = cfg.vision_dim, cfg.patch_size

    def host(t):
        return t.detach().contiguous().cpu()

    sd = {"visual.patch_embedding.weight": host(
        params["patch_embedding"]["w"].reshape(ph, ph, 3, d).permute(
            3, 2, 0, 1)),
          "visual.cls_embedding": host(params["cls_embedding"]),
          "visual.pos_embedding": host(params["pos_embedding"])}
    if "b" in params["patch_embedding"]:
        sd["visual.patch_embedding.bias"] = host(
            params["patch_embedding"]["b"])
    for n in ("pre_norm", "post_norm"):
        sd[f"visual.{n}.weight"] = host(params[n]["w"])
        sd[f"visual.{n}.bias"] = host(params[n]["b"])
    for i in range(cfg.vision_layers):
        bp, pre = tree.index(params["blocks"], i), f"visual.transformer.{i}."
        for name, p in (("attn.to_qkv", bp["attn"]["to_qkv"]),
                        ("attn.proj", bp["attn"]["proj"]),
                        ("mlp.0", bp["mlp"]["fc1"]),
                        ("mlp.2", bp["mlp"]["fc2"])):
            sd[pre + name + ".weight"] = host(p["w"].T)
            sd[pre + name + ".bias"] = host(p["b"])
        for n in ("norm1", "norm2"):
            sd[pre + n + ".weight"] = host(bp[n]["w"])
            sd[pre + n + ".bias"] = host(bp[n]["b"])
    return sd


class Patched:
    """``setattr(obj, name, wrapper(getattr(obj, name)))`` for the span of
    a ``with``, restored after."""

    def __init__(self, obj, name, wrapper):
        self.obj, self.name, self.wrapper = obj, name, wrapper

    def __enter__(self):
        self.old = getattr(self.obj, self.name)
        setattr(self.obj, self.name, self.wrapper(self.old))

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.old)


# the image-to-video path: WanI2V's forwards (flash_fwd and both cross
# attentions) and the causal pipeline's (decode and both cross attentions)
I2V_STEPS = 2          # WanI2V's 40 UniPC steps, cut for time
I2V_CAUSAL_STEPS = 4   # the causal pipeline's 50 steps, cut for time
I2V_CAUSAL_LAYERS = 20  # of 40: two 21-frame caches beside the weights


def phase_image_to_video(ca, dit, vae, seed) -> dict:
    """13. The image-to-video path at Wan-I2V-14B's full width (random
    weights from the seed; every earlier tensor freed and the peak
    counter reset), with PyTorch's default TF32 settings (cuDNN on, matmul
    off: CLIP runs float32 products).

    13a: CLIP ViT-H/14 drawn in float32, exported to the reference's
    ``visual.*`` state dict, ``torch.save``d under the reference's file
    name and read back by ``runtime.load_clip_vision`` (every leaf
    equal); ``encode_image`` of a seeded [1, 3, 480, 832] image: shape
    [1, 257, 1280], ms, and the same call on the CPU within 1e-4 relative
    L2.  13b: ``WanI2V.generate`` at ``WAN_I2V_14B``, all 40 layers, bf16
    DiT, float32 Wan VAE, 13a's CLIP, seeded context and negative context
    [1, 512, 4096] and a seeded 720x1280 image; 832x480, 81 frames (21
    latent frames, 32760 tokens), UniPC, shift 5, guidance 5, steps cut
    from 40 to 2: ms of CLIP, the y encode (81 frames through the VAE),
    each CFG step and forward (CUDA events) and the decode, the wall and
    peak memory; launches exactly 2 x 2 x 40 ``flash_fwd`` and 2 x 2 x 40
    x 2 ``cross_attention``, no decode; the video [81, 3, 480, 832]
    finite.  13c: one ``forward_train`` (no mask, y and CLIP tokens) on a
    4-layer cut at 32760 tokens with the kernels and with their plain
    versions (<= 2e-2 relative L2).  13e: one full-depth forward under
    torch.profiler.  13d: ``CausalDiffusionInferencePipeline`` on
    ``configs/causal_diffusion.yaml`` with ``image_encoder``, the i2v model
    at full width with 20 of its 40 layers (two 21-frame caches would
    need 53.7 GB beside 32.8 GB of weights at 40), the seeded image and a
    seeded pose video and reference pose (random pose CNNs), 2 blocks of
    3 latent frames, steps cut to 4: ms a block and a step, peak memory,
    launches exactly blocks x (2 x steps + 2) x 20 decode and twice that
    cross (the image keys)."""
    import tempfile
    from self_forcing_tpu_torch import conditioning as cond
    from self_forcing_tpu_torch import runtime, wan_generate
    from self_forcing_tpu_torch.config import load_config
    from self_forcing_tpu_torch.models import clip
    from self_forcing_tpu_torch.models.wan.configs import WAN_I2V_14B
    from self_forcing_tpu_torch.models.wan.rope import RopeTables
    from self_forcing_tpu_torch.pipelines import (
        causal_diffusion_inference as cd)
    from self_forcing_tpu_torch.utils import tree
    bf, dev = torch.bfloat16, torch.device("cuda")
    vae.set_conv_backend(None)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"i2v: start with {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated", flush=True)
    g = torch.Generator(device="cuda").manual_seed(seed + 60)

    # 13a: CLIP through the reference's file and the loader
    ccfg = clip.CLIP_XLM_ROBERTA_VIT_H_14
    with tempfile.TemporaryDirectory() as tmp:
        drawn = clip.init_vision_params(ccfg, seed + 61, device=dev)
        t0 = time.perf_counter()
        torch.save(export_clip_vision(drawn, ccfg),
                   os.path.join(tmp, clip.CLIP_WEIGHTS))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clip_params, lcfg = runtime.load_clip_vision(tmp)
        load_s = time.perf_counter() - t0
    got, want = dict(tree.items(clip_params)), dict(tree.items(drawn))
    if lcfg != ccfg or got.keys() != want.keys() or not all(
            got[k].dtype == torch.float32 and torch.equal(got[k], want[k])
            for k in got):
        fail("i2v 13a: load_clip_vision did not read back the saved CLIP")
    del drawn, got, want
    img = torch.rand(1, 3, 480, 832, generator=g, device=dev) * 2 - 1
    tokens = clip.encode_image(clip_params, ccfg, img)
    clip_ms = time_ms(lambda: clip.encode_image(clip_params, ccfg, img))
    t0 = time.perf_counter()
    cpu_tokens = clip.encode_image(
        tree.map_tree(lambda t: t.cpu(), clip_params), ccfg, img.cpu())
    cpu_s = time.perf_counter() - t0
    err = rel_l2(tokens.cpu(), cpu_tokens)
    n_par = sum(t.numel() for t in tree.leaves(clip_params))
    print(f"i2v 13a CLIP ViT-H/14 ({n_par / 1e6:.1f} M float32 parameters, "
          f"saved in {save_s:.1f} s, loaded by load_clip_vision in "
          f"{load_s:.1f} s, every leaf equal): encode_image [1, 3, 480, 832] "
          f"-> {list(tokens.shape)} ms={clip_ms:.3f} (CUDA events, median of "
          f"7; TF32 off) rel_l2 vs the CPU={err:.3e} (CPU {cpu_s:.1f} s)",
          flush=True)
    if tuple(tokens.shape) != (1, 257, 1280) or \
            not torch.isfinite(tokens).all() or err > 1e-4:
        fail(f"i2v 13a: CLIP tokens {tuple(tokens.shape)}, rel_l2 vs the "
             f"CPU {err:.3e} (want [1, 257, 1280] finite, <= 1e-4)")
    del img, tokens, cpu_tokens

    # 13b: WanI2V.generate at full width and depth
    cfg = WAN_I2V_14B
    t0 = time.perf_counter()
    params = make_params(dit, cfg, seed + 62)
    vae_params = vae.init_params(vae.WAN_VAE, seed=seed + 63,
                                 dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    ctx, neg = (torch.randn(1, N_CTX, cfg.text_dim, generator=g,
                            device=dev).to(bf) for _ in range(2))
    image = torch.rand(1, 3, 720, 1280, generator=g, device=dev) * 2 - 1
    model = wan_generate.WanI2V(params, cfg, vae_params=vae_params,
                                vae_cfg=vae.WAN_VAE, clip_params=clip_params,
                                clip_cfg=ccfg)
    marks, caught = CudaMarks(), {}

    def decode_peak(fn):
        # the sampling's peak, read before the decode adds its own
        def run(*a, **k):
            caught["peak_sampling"] = torch.cuda.max_memory_allocated()
            return marks.wrap("decode", fn)(*a, **k)
        return run

    def catch(label, fn):
        def run(*a, **k):
            caught[label] = out = marks.wrap(label, fn)(*a, **k)
            return out
        return run

    model._forward = marks.wrap("forward", model._forward)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    with Patched(wan_generate.clip_mod, "encode_image",
                 lambda f: catch("clip", f)), \
            Patched(wan_generate, "first_frame_condition",
                    lambda f: catch("y", f)), \
            Patched(wan_generate.vae_mod, "decode", decode_peak), \
            HostStalls() as st:
        video = model.generate(img=image, size=(832, 480), frame_num=81,
                               shift=5.0, sample_solver="unipc",
                               sampling_steps=I2V_STEPS, guide_scale=5.0,
                               seed=seed + 64, context=ctx, neg_context=neg)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = dict(ca.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms = marks.spans("forward")
    bounds = marks.starts("forward")[::2] + marks.starts("decode")
    step_ms = [a.elapsed_time(b) for a, b in zip(bounds, bounds[1:])]
    print(f"i2v 13b WanI2V.generate (WAN_I2V_14B: 40 layers, dim 5120, 40 "
          f"heads, bf16, random weights drawn in {draw_s:.1f} s; float32 Wan "
          f"VAE; 13a's CLIP; a seeded 720x1280 image; 832x480, 81 frames = "
          f"21 latent frames of 1560 tokens; UniPC, shift 5, guidance 5, "
          f"{I2V_STEPS} steps of 40, cut for time): wall_ms={wall:.1f} "
          f"clip_ms={marks.spans('clip')[0]:.1f} y_encode_ms (81 frames "
          f"through the VAE)={marks.spans('y')[0]:.1f} cfg_step_ms="
          f"{[round(x, 1) for x in step_ms]} forward_ms="
          f"{[round(x, 1) for x in fwd_ms]} decode_ms="
          f"{marks.spans('decode')[0]:.1f} (CUDA events) peak_gb="
          f"{peak_gb:.2f} (before the decode "
          f"{caught['peak_sampling'] / 1e9:.2f}; held before "
          f"{held / 1e9:.2f}) {st} launches="
          f"{{'flash_fwd': {launches['flash_fwd']}, 'cross_attention': "
          f"{launches['cross_attention']}}}", flush=True)
    want_n = 2 * I2V_STEPS * cfg.num_layers
    decode_n = sum(n for k, n in launches.items()
                   if k.startswith("decode_"))
    if launches["flash_fwd"] != want_n or decode_n or \
            launches["cross_attention"] != 2 * want_n:
        fail(f"i2v 13b: launches {launches}: expected flash_fwd {want_n}, "
             f"cross_attention {2 * want_n}, no decode")
    if tuple(video.shape) != (81, 3, 480, 832) or \
            not torch.isfinite(video).all():
        fail(f"i2v 13b: video {tuple(video.shape)} not [81, 3, 480, 832] "
             "finite")
    clip_fea, y = caught["clip"].to(bf), caught["y"].to(bf)
    del video, model, caught, marks
    torch.cuda.empty_cache()

    # 13c: one i2v forward on a 4-layer cut, kernels vs plain
    rope = RopeTables.create(cfg.head_dim, device=dev)
    cut_cfg = dataclasses.replace(cfg, num_layers=4)
    cut = dict(params, blocks=tree.map_tree(lambda t: t[:4],
                                            params["blocks"]))
    x = torch.randn(1, 21, 16, 60, 104, generator=g, device=dev).to(bf)
    t = torch.full((1, 21), 700.0, device=dev)
    flows = {k: dit.forward_train(cut, cut_cfg, x, t, ctx, None, rope,
                                  remat=False, kernels=k, y=y,
                                  clip_fea=clip_fea) for k in (True, False)}
    err = rel_l2(flows[True], flows[False])
    print(f"i2v 13c forward_train (4 of 40 layers, 32760 tokens, no mask, y "
          f"and CLIP tokens): kernels vs plain rel_l2={err:.3e}", flush=True)
    if not torch.isfinite(flows[True].float()).all() or err > 2e-2:
        fail(f"i2v 13c: kernels vs plain relative L2 {err:.3e} > 2e-2")
    del flows, cut

    # 13e: where a full-depth forward's time goes
    print_profile("i2v forward (40 layers, 32760 tokens, y and CLIP "
                  "tokens)", lambda: dit.forward_train(
                      params, cfg, x, t, ctx, None, rope, remat=False,
                      y=y, clip_fea=clip_fea))
    del params, x, t, rope, clip_fea, y
    gc.collect()
    torch.cuda.empty_cache()

    # 13d: the causal 50-step pipeline's input_image, 20 of 40 layers
    config = load_config(os.path.join(CONFIGS, "causal_diffusion.yaml"),
                         os.path.join(CONFIGS, "default_config.yaml"))
    config.sampling_steps = I2V_CAUSAL_STEPS
    nb, blocks, H, W = int(config.num_frame_per_block), 2, 60, 104
    F = blocks * nb
    cfg20 = dataclasses.replace(cfg, num_layers=I2V_CAUSAL_LAYERS)
    params = make_params(dit, cfg20, seed + 65)
    gcpu = torch.Generator().manual_seed(seed + 66)
    dwpose = torch.randint(0, 256, (1, 3, 4 * F - 3, 8 * H, 8 * W),
                           generator=gcpu, dtype=torch.uint8).to(dev)
    ref = torch.randint(0, 256, (8 * H, 8 * W, 3), generator=gcpu,
                        dtype=torch.uint8).to(dev)
    pipe = cd.CausalDiffusionInferencePipeline(
        config, params, cfg20, vae_params=vae_params, vae_cfg=vae.WAN_VAE,
        dwpose_params=cond.init_dwpose_params(seed + 67, device=dev),
        randomref_params=cond.init_randomref_params(seed + 68, device=dev),
        image_encoder=(clip_params, ccfg), device=dev, dtype=bf)
    noise = torch.randn(1, F, 16, H, W, generator=g, device=dev)
    steps = pipe.solver.num_steps
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    video, lat = pipe.inference(noise, context=ctx, neg_context=neg,
                                input_image=image, dwpose_data=dwpose,
                                random_ref_dwpose=ref, return_latents=True,
                                profile=True)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    causal = dict(ca.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = pipe.profile_ms
    blk = [prof[f"block{b}_ms"] for b in range(blocks)]
    want_n = blocks * (2 * steps + 2) * cfg20.num_layers
    print(f"i2v 13d CausalDiffusionInferencePipeline (causal_diffusion.yaml, "
          f"{steps} UniPC steps of 50, cut for time; WAN_I2V_14B width, "
          f"{cfg20.num_layers} of 40 layers; input_image 720x1280 + pose "
          f"video + reference pose; {blocks} blocks of {nb} latent frames "
          f"at {H}x{W}, float32 VAE): wall_ms={wall:.1f} init_ms="
          f"{prof['init_ms']:.1f} (CLIP, the y encode, context K/V, caches, "
          f"DWPose) block_ms={[round(b_, 1) for b_ in blk]} ms_per_step="
          f"{[round(b_ / (steps + 1), 1) for b_ in blk]} (a block over its "
          f"{steps} steps + the refresh) vae_ms={prof['vae_ms']:.1f} "
          f"peak_gb={peak_gb:.2f} (held before {held / 1e9:.2f}) launches="
          f"{{'decode_fresh_free': {causal['decode_fresh_free']}, "
          f"'cross_attention': {causal['cross_attention']}}} (host clock, "
          f"synchronised per block)", flush=True)
    if causal["decode_fresh_free"] != want_n or \
            causal["cross_attention"] != 2 * want_n:
        fail(f"i2v 13d: launches {causal}: expected decode_fresh_free "
             f"{want_n} = {blocks} x (2 x {steps} + 2) x "
             f"{cfg20.num_layers}, cross_attention {2 * want_n}")
    want_px = (1, 1 + 4 * (F - 1), 3, 8 * H, 8 * W)
    if tuple(video.shape) != want_px or not torch.isfinite(video).all() \
            or not torch.isfinite(lat).all():
        fail(f"i2v 13d: video {tuple(video.shape)} not {want_px} finite")
    del pipe, params, video, lat, noise, dwpose, ref, vae_params, \
        clip_params, image, ctx, neg
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = tf32
    return {"wan_i2v": launches, "causal_i2v": causal}


TRAIN_LAYERS = 1     # phase 17(b, c): the students' depth (of 30)
TEACHER_LAYERS = 2   # phase 17(c): the Wan-14B-wide teacher's depth
CACHE_LAYERS = 1     # phase 17(e): the rollout's depth
CACHE_EXIT = 0       # phase 17(e): every block's exit step
CLI_LAYERS = 1       # phase 17: train.main's depth
TP_RANKS = 2         # phase 16: ranks sharing the card
TP_BLOCKS = 2        # phase 16(b): 3-frame blocks of the 40-layer stream
SP_LAYERS = 10       # phase 16(c): the i2v model's depth on each rank
SP_FRAMES = 21       # phase 16(c): latent frames (padded to 22 at sp 2)


def _rank_results(d: str, name: str, world: int) -> list[dict]:
    out = []
    for r in range(world):
        with open(os.path.join(d, f"{name}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def phase_parallel(seed: int) -> dict:
    """16. Tensor and sequence parallelism on the card (last, every earlier
    tensor freed), the ranks spawned by ``parallel.launch.spawn`` and run
    by ``parallel/card_checks.py``: (a) an NCCL group of one rank, block 2
    at full Wan-1.3B width through ``forward_inference_tp`` beside
    ``dit.forward_inference`` (<= 1e-3 relative L2, the same launches);
    (b) two ranks on cuda:0 over gloo (NCCL refuses two ranks on one
    device; gloo stages every collective through pinned host memory) at
    Wan-14B's full width: block 2 on a 4-layer cut against the
    single-process forward and the rank caches against the dense cache
    (<= 2e-2), then ``CausalInferencePipeline(mesh=...).stream`` over
    TP_BLOCKS blocks at 40 layers with a 21-frame cache (ms a block, the
    host-staged all-reduces' ms, each rank's peak beside the fit estimate,
    exact launches); (c) ``forward_train_sp`` at Wan-I2V-14B's width and
    SP_LAYERS layers over 21 latent frames at 60x104 with seeded ``y`` and
    ``clip_fea`` against the single-process ``forward_train`` (<= 2e-2),
    exact ``cross_attention`` launches.  A rank that fails fails the
    phase.  Returns the tensor-parallel rows' launches for the kernel
    line."""
    from self_forcing_tpu_torch.models.wan.configs import (WAN_1_3B,
                                                           WAN_14B,
                                                           WAN_I2V_14B)
    from self_forcing_tpu_torch.parallel import card_checks, fit, launch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    for row in fit.table():
        print(f"parallel fit estimate {row['label']} (a rank, GB): " + " ".join(
            f"{k}={row[k] / 1e9:.2f}" for k in (
                "params", "kv_cache", "context", "activations", "total",
                "limit")) + f" fits={row['fits']}", flush=True)
    d = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        launch.spawn(card_checks.nccl_one_rank, 1, "nccl", dict(
            device="cuda", model=WAN_1_3B, layers=N_LAYERS,
            latent_hw=(60, 104), seed=seed), d)
        a = _rank_results(d, "nccl", 1)[0]
        if a["backend"] != "nccl" or not a["finite"]:
            fail(f"parallel (a): backend {a['backend']}, finite "
                 f"{a['finite']}")
        if a["launches_tp"] != a["launches_single"] or any(
                a["launches_tp"].get(k, 0) != N_LAYERS
                for k in PARITY_KERNELS):
            fail(f"parallel (a): launches {a['launches_tp']} vs single "
                 f"{a['launches_single']}")
        print(f"parallel (a) NCCL world 1, 1.3B block 2 "
              f"forward_inference_tp vs dit.forward_inference: "
              f"rel_l2={a['rel_l2']:.3e} max_abs={a['max_abs']:.3e} "
              f"launches tp={a['launches_tp']} single="
              f"{a['launches_single']}", flush=True)
        if a["rel_l2"] > 1e-3:
            fail(f"parallel (a): relative L2 {a['rel_l2']:.3e} > 1e-3")

        spec = dict(device="cuda", model=WAN_14B, layers=WAN_14B.num_layers,
                    cut_layers=4, latent_hw=(60, 104), blocks=TP_BLOCKS,
                    seed=seed, sp_model=WAN_I2V_14B, sp_layers=SP_LAYERS,
                    sp_frames=SP_FRAMES)
        launch.spawn(card_checks.gloo_two_ranks, TP_RANKS, "gloo", spec, d)
        rs = _rank_results(d, "gloo", TP_RANKS)
    finally:
        shutil.rmtree(d, ignore_errors=True)

    # (b) the 4-layer cut, then the stream: each block's 4 denoise
    # forwards, and the refresh of every block but the last
    forwards = TP_BLOCKS * len(card_checks.STEPS) + TP_BLOCKS - 1
    want = {k: forwards * WAN_14B.num_layers for k in PARITY_KERNELS}
    for r, res in enumerate(rs):
        c, s = res["cut"], res["stream"]
        print(f"parallel (b) rank {r}/{TP_RANKS} {res['backend']}: 14B "
              f"block 2, {c['layers']} of 40 layers, tp vs single "
              f"rel_l2={c['rel_l2']:.3e} cache k/v vs dense heads "
              f"rel_l2={c['cache_k_rel_l2']:.3e}/{c['cache_v_rel_l2']:.3e} "
              f"launches={c['launches']}", flush=True)
        for key in ("rel_l2", "cache_k_rel_l2", "cache_v_rel_l2"):
            if not c["finite"] or c[key] > 2e-2:
                fail(f"parallel (b) rank {r}: {key} {c[key]:.3e} > 2e-2 "
                     f"(finite {c['finite']})")
        fit_gb = s["fit_gb"]
        print(f"parallel (b) rank {r}: 14B stream tp {TP_RANKS}, "
              f"{s['layers']} layers, {s['blocks']} blocks (cache "
              f"{s['cache_frames']} frames, {s['cache_heads']} heads a "
              f"rank): block_ms={[round(x, 1) for x in s['block_ms']]} "
              f"total_ms={s['total_ms']:.1f} host_staged_allreduce_ms="
              f"{s['allreduce_ms']:.1f} ({s['allreduce_calls']} calls; "
              f"gloo on one card, not NCCL) weights_gb="
              f"{s['weights_gb']:.2f} (drawn in {s['init_s']:.1f} s) "
              f"peak_gb={s['peak_gb']:.2f} fit_estimate_gb="
              f"{fit_gb['total']:.2f} (params {fit_gb['params']:.2f}, cache "
              f"{fit_gb['kv_cache']:.2f}, context {fit_gb['context']:.2f}, "
              f"activations {fit_gb['activations']:.2f}; card "
              f"{fit_gb['limit']:.2f}) launches={s['launches']} "
              f"(host clock, synchronised a block)", flush=True)
        if s["launches"] != want:
            fail(f"parallel (b) rank {r}: launches {s['launches']}, "
                 f"expected {want}")
        if not s["finite"] or s["shape"] != [1, 3 * TP_BLOCKS, 16, 60, 104] \
                or s["cache_heads"] != WAN_14B.num_heads // TP_RANKS \
                or s["cache_frames"] != 21:
            fail(f"parallel (b) rank {r}: stream finite {s['finite']} "
                 f"shape {s['shape']} cache heads {s['cache_heads']} "
                 f"frames {s['cache_frames']}")
    if rs[0]["stream"]["checksum"] != rs[1]["stream"]["checksum"]:
        fail("parallel (b): the ranks' streams differ")

    # (c) one sequence-parallel forward: 2 cross attentions a layer (the
    # text keys and the image keys), no flash attention (the ring)
    want = {"cross_attention": 2 * SP_LAYERS}
    for r, res in enumerate(rs):
        sp = res["sp"]
        print(f"parallel (c) rank {r}/{TP_RANKS}: I2V-14B forward_train_sp, "
              f"{sp['layers']} of 40 layers, {sp['frames']} latent frames "
              f"(padded to {sp['frames_padded']}) at 60x104: "
              f"ms={sp['ms']:.1f} host_staged_ring_ms={sp['ring_ms']:.1f} "
              f"({sp['ring_calls']} calls) peak_gb={sp['peak_gb']:.2f} "
              f"fit_estimate_gb={sp['fit_gb']:.2f} "
              f"launches={sp['launches']}"
              + (f" vs single-process forward_train rel_l2="
                 f"{sp['rel_l2']:.3e}" if "rel_l2" in sp else ""),
              flush=True)
        if sp["launches"] != want or not sp["finite"] \
                or sp["shape"] != [1, SP_FRAMES, 16, 60, 104]:
            fail(f"parallel (c) rank {r}: launches {sp['launches']} "
                 f"(expected {want}), finite {sp['finite']}, shape "
                 f"{sp['shape']}")
        if sp.get("rel_l2", 0.0) > 2e-2:
            fail(f"parallel (c): relative L2 {sp['rel_l2']:.3e} > 2e-2")
    print(f"parallel: phase 16 took {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"decode_fresh_free_tp2": rs[0]["stream"]["launches"][
                "decode_fresh_free"],
            "cross_attention_tp2": rs[0]["stream"]["launches"][
                "cross_attention"]}


# Two one-process runs of phase 7's step 0 (scripts/dmd_step_spread.py,
# NVIDIA H100 80GB HBM3, 700.00 W) differ by 2.5e-4 in the generator's
# first moment and 5.6e-4 in the critic's: the flash backward adds dq by
# TMA reduce-add in a run-dependent order.  A gradient halved, doubled,
# zeroed or negated by a broken reduce reads 0.5 or more.
GRAD_TOL = 2e-3
# Adam's first step moves an element by lr * g / (|g| + eps), about lr *
# sign(g), so where that spread flips a near-zero gradient's sign the
# element moves by 2 lr: the same two runs' updates differ by 4.7e-3
# (generator) and 9.8e-3 (critic), phase 17 (c)'s by up to 1.6e-2; a
# zeroed or negated gradient reads 1 or 2
UPDATE_TOL = 5e-2
# (d): forward_train_tp's float32 gradients against one process's: a
# sound run reads 5.5e-5 over all leaves and 1.6e-2 at its worst leaf,
# the cross-attention key bias (its gradient sums over the context
# tokens through the all-reduced RMS norm of the keys); with one of the
# tensor-parallel backward rules broken (the norm's or copy_to's
# all-reduce dropped, reduce_from's added) the worst leaf moves by about
# half or more, all leaves together by several times TP_GRAD_TOL
TP_GRAD_TOL = 1e-3   # all leaves together
TP_LEAF_TOL = 1e-1   # the worst leaf


def _limit(key: str, tol: float) -> float:
    """The limit of a reading against one process: ``tol``, at least
    GRAD_TOL for a moment (a gradient) and UPDATE_TOL for an update."""
    if "moment" in key:
        return max(tol, GRAD_TOL)
    if "update" in key:
        return max(tol, UPDATE_TOL)
    return tol


def _vs_one(tag: str, res: dict, tol: float) -> None:
    """Fail unless a sharded run's readings agree with one process's
    (``card_checks.dmd_distances``, the logs) within ``_limit``."""
    v = res["vs_one_process"]
    bad = {k: x for k, x in v.items()
           if (k.endswith("rel_l2") or k == "log_rel")
           and not x <= _limit(k, tol)}
    if not res.get("finite", True) or bad:
        fail(f"{tag}: vs one process {bad} over their limits (tolerance "
             f"{tol}; {v})")


def _shown(launches: dict) -> dict:
    return {k: launches.get(k, 0) for k in TRAIN_KERNELS + TRAIN_BWD}


def phase_parallel_training(ca, seed: int, one: dict) -> None:
    """17. Parallel training (see the module's docstring): (a) here in an
    NCCL group of one rank against phase 7's step 0 (``one``), (b) - (e)
    and the CLI in two gloo ranks that ``parallel/card_checks.py`` runs;
    the one-process CLI run here."""
    import torch.distributed as dist
    from self_forcing_tpu_torch import train
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B, WAN_14B
    from self_forcing_tpu_torch.parallel import card_checks, fit, launch
    from self_forcing_tpu_torch.parallel import mesh as mesh_mod
    from self_forcing_tpu_torch.utils import tree
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    d = tempfile.mkdtemp(prefix="chip_smoke_train_ranks_")
    spec = dict(device="cuda", model=WAN_1_3B, layers=TRAIN_LAYERS,
                latent_hw=(60, 104), seed=seed, configs=CONFIGS,
                teacher=WAN_14B, teacher_layers=TEACHER_LAYERS,
                tp_model=WAN_14B, tp_layers=2, cache_layers=CACHE_LAYERS,
                cache_exit=CACHE_EXIT)
    try:
        # (b) - (e) and the CLI in two gloo ranks, which start up and run
        # (d) and (e) (a few GB of the card) while (a) runs here, then
        # wait for the go file
        cli_cfg = os.path.join(d, "cli.yaml")
        import yaml
        with open(os.path.join(CONFIGS, "causal_diffusion.yaml")) as f:
            c = yaml.safe_load(f)
        c.update(seed=seed, image_or_video_shape=[1, *TRAIN_LATENT],
                 data_path=os.path.join(d, "no_shards"),
                 model_dir=os.path.join(d, "no_models"), log_iters=1000)
        with open(cli_cfg, "w") as f:
            yaml.safe_dump(c, f)
        shutil.copy(os.path.join(CONFIGS, "default_config.yaml"), d)
        argv = ["--config_path", cli_cfg, "--max_steps", "2",
                "--no_visualize", "--disable-wandb", "--dist_backend",
                "gloo"]
        go = os.path.join(d, "go")
        spec2 = dict(spec, go=go, cli_layers=CLI_LAYERS,
                     cli_argv=argv + ["--logdir", os.path.join(d, "cli2")])
        t_ranks = time.perf_counter()
        ranks = launch.start(card_checks.train_gloo_two_ranks, 2, "gloo",
                             spec2, d)
        verdict = "stop"
        try:
            # (a) one NCCL rank in this process: phase 7's step 0 again,
            # through the sharded trainer on a mesh of one
            dist.init_process_group("nccl", store=dist.FileStore(
                os.path.join(d, "store_a"), 1), rank=0, world_size=1)
            try:
                backend = dist.get_backend()
                torch.cuda.reset_peak_memory_stats()
                trainer, context_fn, batches, layers, _ = dmd_trainer(
                    seed, mesh=mesh_mod.create_mesh(dp=1, fsdp=1, sp=1),
                    timing=False)
                ctx = context_fn(list(next(batches)["prompts"]))
                batches.close()
                trainer.state.step = 0
                before = card_checks.dmd_weights(trainer)
                torch.cuda.synchronize()
                ca.reset_launch_counts()
                t0 = time.perf_counter()
                log = trainer.train_step({"context": ctx})
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got = dict(ca.launch_counts)
                peak = torch.cuda.max_memory_allocated() / GB
                state = card_checks.dmd_state(trainer, before, host=False)
                del trainer, before
            finally:
                dist.destroy_process_group()
            torch.cuda.empty_cache()
            rel = card_checks.dmd_distances(state, one)
            del state
            log_rel = card_checks._log_rel(
                {k: v for k, v in log.items() if not k.endswith("_ms")},
                {k: v for k, v in one["log"].items()
                 if not k.endswith("_ms")})
            est = fit.sp_dmd_fit(WAN_1_3B, WAN_1_3B, 1, 1,
                                 limit=fit.card_limit())
            print(f"parallel training (a) {backend} world 1, mesh (1, 1, "
                  f"1): phase 7's DMD step 0 (generator + critic, {layers} "
                  f"layers, bf16, LoRA 128) through the sharded trainer "
                  f"(the gloo ranks running (d) and (e) meanwhile): step_ms="
                  f"{ms:.1f} (phase 7's one-process step "
                  f"{one['ms']:.1f}, timed per phase) losses "
                  f"{ {k: v for k, v in log.items()} } "
                  f"max_rel_vs_one_process="
                  f"{log_rel:.2e} rel_l2 "
                  f"{ {k: float(f'{v:.3e}') for k, v in rel.items()} } "
                  f"launches={_shown(got)} (one "
                  f"process {_shown(one['launches'])}) peak_gb={peak:.2f} "
                  f"(one process, both steps' trainer {one['peak_gb']:.2f}) "
                  f"sp_dmd_fit_gb={est['total'] / GB:.2f} (" + " ".join(
                      f"{k} {est[k] / GB:.2f}" for k in est
                      if isinstance(est[k], int) and k not in ("total",)
                      and not isinstance(est[k], bool)) +
                  f") [{smi}] (host clock, synchronised)", flush=True)
            if not log_rel <= 1e-5 or any(not v <= _limit(k, 1e-5)
                                          for k, v in rel.items()) \
                    or not all(math.isfinite(v) for v in log.values()):
                fail(f"parallel training (a): vs one process {log_rel}, "
                     f"{rel}")
            if {k: got.get(k, 0) for k in one["launches"]} \
                    != one["launches"] or any(
                        not got.get(k) for k in TRAIN_KERNELS + TRAIN_BWD):
                fail(f"parallel training (a): launches {got} vs one "
                     f"process {one['launches']}")
            verdict = "go"
        finally:
            with open(go, "w") as f:
                f.write(verdict)
            if verdict == "stop":   # (a) failed: the ranks read it and end
                ranks.join()
        t0 = time.perf_counter()
        ranks.join()
        join_s, ranks_s = time.perf_counter() - t0, \
            time.perf_counter() - t_ranks
        rs = _rank_results(d, "train_gloo", 2)
        # the one-process CLI run
        full = train.WAN_1_3B
        train.WAN_1_3B = dataclasses.replace(full, num_layers=CLI_LAYERS)
        try:
            t0 = time.perf_counter()
            train.main(argv + ["--logdir", os.path.join(d, "cli1")])
            cli1_s = time.perf_counter() - t0
        finally:
            train.WAN_1_3B = full
        cli = {k: torch.load(os.path.join(d, k, "final.pt"),
                             weights_only=True) for k in ("cli1", "cli2")}
        cli_rel = max(card_checks._tree_rel_l2(
            [t.float() for t in tree.leaves(cli["cli2"][k])],
            [t.float() for t in tree.leaves(cli["cli1"][k])])
            for k in cli["cli1"])
        lines = {k: open(os.path.join(d, k, "metrics.jsonl")).read()
                 .splitlines() for k in ("cli1", "cli2")}
    finally:
        shutil.rmtree(d, ignore_errors=True)

    for r, res in enumerate(rs):
        b = res["dmd"]
        print(f"parallel training (b) rank {r}/2 {res['backend']} fsdp 2: "
              f"DMD step, {b['layers']} of 30 layers (cut for the time "
              f"limit), batch 1 on both ranks: step_ms={b['ms']:.1f} "
              f"gloo_staged_collectives_ms={b['comm_ms']:.1f} "
              f"({b['comm_calls']} calls) losses {b['log']} "
              f"param_and_optimizer_gb={b['state_bytes'] / GB:.3f}"
              + (f" (one process {b['vs_one_process']['state_bytes'] / GB:.3f}"
                 f", ratio {b['state_bytes'] / b['vs_one_process']['state_bytes']:.3f}"
                 f"; one-process step_ms={b['vs_one_process']['ms']:.1f} "
                 f"vs_one_process {b['vs_one_process']})" if r == 0 else "")
              + f" peak_gb={b['peak_gb']:.2f} launches={_shown(b['launches'])}"
              f" [{smi}]", flush=True)
        if r == 0:
            _vs_one("parallel training (b) dmd", b, 1e-5)
            if b["launches"] != b["vs_one_process"]["launches"]:
                fail(f"parallel training (b): launches {b['launches']} vs "
                     f"one process {b['vs_one_process']['launches']}")
            if not 0.4 < b["state_bytes"] / b["vs_one_process"][
                    "state_bytes"] < 0.6:
                fail("parallel training (b): a rank's parameter + "
                     "optimizer bytes are not about half of one process's")
        elif b["launches"] != rs[0]["dmd"]["launches"]:
            fail("parallel training (b): the ranks' launches differ")
        df = res["diffusion"]
        print(f"parallel training (b) rank {r}/2: causal diffusion, "
              f"{TRAIN_LAYERS} layers, batch 2 split (a row a rank), 2 "
              f"steps: step_ms={[round(x, 1) for x in df['ms']]} "
              f"gloo_staged_collectives_ms={df['comm_ms']:.1f} logs "
              f"{df['logs']} param_and_optimizer_gb="
              f"{df['state_bytes'] / GB:.3f} peak_gb={df['peak_gb']:.2f} "
              f"launches={df['launches']}"
              + (f" vs_one_process {df['vs_one_process']}" if r == 0
                 else "") + f" [{smi}]", flush=True)
        if r == 0:
            _vs_one("parallel training (b) diffusion", df, 1e-3)
            # a kernel launch takes the whole batch: one process's
            # launches over 2 rows are a rank's over 1
            if df["launches"] != df["vs_one_process"]["launches"]:
                fail(f"parallel training (b) diffusion: launches "
                     f"{df['launches']} vs {df['vs_one_process']['launches']}")
        c = res["sp"]
        print(f"parallel training (c) rank {r}/2 sp 2, teacher_zero3_sp: "
              f"DMD step, students {c['layers']} layers, teacher Wan-14B "
              f"width {c['teacher_layers']} of 40 layers sliced over "
              f"(fsdp, sp): step_ms={c['ms']:.1f} gloo_staged_ms="
              f"{c['comm_ms']:.1f} teacher_gb_this_rank="
              f"{c['teacher_bytes'] / GB:.3f} losses {c['log']} "
              f"peak_gb={c['peak_gb']:.2f} launches={c['launches']}"
              + (f" (whole teacher {c['vs_one_process']['teacher_bytes'] / GB:.3f}"
                 f" GB in one process; vs_one_process "
                 f"{c['vs_one_process']})" if r == 0 else "")
              + f" [{smi}]", flush=True)
        if r == 0:
            _vs_one("parallel training (c)", c, 3e-3)
            one = c["vs_one_process"]["launches"]
            teacher_flash = 2 * TEACHER_LAYERS   # cond + uncond, no ring
            if c["launches"].get("flash_fwd", 0) + teacher_flash != \
                    one.get("flash_fwd", 0) or any(
                        c["launches"].get(k, 0) != one.get(k, 0)
                        for k in TRAIN_BWD + ("decode_fresh_free",
                                              "cross_attention")):
                fail(f"parallel training (c): launches {c['launches']} vs "
                     f"one process {one}")
        tp = res["tp"]
        print(f"parallel training (d) rank {r}/2 tp 2: forward_train_tp "
              f"gradients, Wan-14B width, {tp['layers']} layers, 3 frames: "
              f"ms={tp['ms']:.1f} gloo_staged_allreduce_ms="
              f"{tp['comm_ms']:.1f} ({tp['comm_calls']} calls) out_rel_l2="
              f"{tp['out_rel_l2']:.2e} grad_rel_l2 over all "
              f"{tp['leaves']} leaves={tp['grad_rel_l2_all']:.2e}, the "
              f"worst leaves {tp['grad_worst_leaves']} launches="
              f"{tp['launches']} [{smi}]", flush=True)
        if not tp["out_rel_l2"] <= 1e-2 \
                or not tp["grad_rel_l2_all"] <= TP_GRAD_TOL \
                or not tp["grad_rel_l2_max"] <= TP_LEAF_TOL:
            fail(f"parallel training (d) rank {r}: {tp}")
        ce = res["cache"]
        want = rollout_launches(CACHE_LAYERS, [CACHE_EXIT] * 7, True)
        got = {k: ce["constrained"]["launches"].get(k, 0) for k in want}
        print(f"parallel training (e) rank {r}/2 fsdp 2: 21-frame rollout "
              f"with gradient, {CACHE_LAYERS} layers: cache_gb_held "
              f"without={ce['free']['cache_bytes'] / GB:.3f} with the "
              f"constraint={ce['constrained']['cache_bytes'] / GB:.3f} loss "
              f"{ce['free']['loss']!r} / {ce['constrained']['loss']!r} "
              f"grad_rel_l2={ce['grad_rel_l2']:.2e} ms="
              f"{ce['free']['ms']:.1f} / {ce['constrained']['ms']:.1f} "
              f"peak_gb={ce['free']['peak_gb']:.2f} / "
              f"{ce['constrained']['peak_gb']:.2f} launches={got} "
              f"(exact) [{smi}]", flush=True)
        if ce["free"]["loss"] != ce["constrained"]["loss"] \
                or ce["grad_rel_l2"] > 1e-3 or got != want \
                or ce["free"]["launches"] != ce["constrained"]["launches"] \
                or ce["constrained"]["cache_bytes"] * 2 \
                != ce["free"]["cache_bytes"]:
            fail(f"parallel training (e) rank {r}: {ce}, launches {got} vs "
                 f"{want}")
    n1, n2 = len(lines["cli1"]), len(lines["cli2"])
    print(f"parallel training CLI: train.main 2 steps (causal_diffusion.yaml, "
          f"stand-in latents from the seed), {CLI_LAYERS} layers, "
          f"2 gloo ranks ({rs[0]['cli_s']:.1f} s) vs one process "
          f"({cli1_s:.1f} s): metrics.jsonl lines {n2} (one process {n1}), "
          f"final.pt rel_l2={cli_rel:.2e}", flush=True)
    if n1 != 2 or n2 != 2 or cli_rel > 1e-5:
        fail("parallel training CLI: rank 0 alone must log 2 steps and "
             "write the one-process checkpoint")
    print(f"parallel training: phase 17 took "
          f"{time.perf_counter() - t_phase:.1f} s (the gloo ranks "
          f"{ranks_s:.1f} s from their start, {join_s:.1f} s of it after "
          f"(a); (d) and (e) ran beside (a))", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, default=3,
                    help="3-frame blocks to stream (2..7; 7 = 21 frames)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build, kernels vs plain, their "
                         "times): the A/B of two checkouts' kernels, run "
                         "in turns")
    a = ap.parse_args()
    if not 2 <= a.blocks <= 7:
        fail("--blocks must be in 2..7")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run needs an NVIDIA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from self_forcing_tpu_torch.models import taehv
    from self_forcing_tpu_torch.models.wan import dit, vae
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    from self_forcing_tpu_torch.models.wan.rope import RopeTables
    from self_forcing_tpu_torch.ops import build, masks, quant
    from self_forcing_tpu_torch.ops.chip import chip_defaults
    from self_forcing_tpu_torch.ops import conv as tconv
    from self_forcing_tpu_torch.ops import cuda_attention as ca
    from self_forcing_tpu_torch.ops import cuda_conv as cc
    from self_forcing_tpu_torch.ops import cuda_matmul as cm
    from self_forcing_tpu_torch.pipelines import causal_inference as pipe_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    GC_CLOCK.install()
    t_start = time.perf_counter()

    def elapsed(done: str) -> None:
        print(f"elapsed: {time.perf_counter() - t_start:.1f} s after "
              f"{done} (host clock)", flush=True)

    # 1. environment and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}", flush=True)
    t = time.perf_counter()
    secs = build.build_all()
    for name in secs:
        build.load(name)
        regs = [ln.strip() for ln in build.build_log(name).splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"ptxas {name}: {' | '.join(regs)}", flush=True)
    print(f"build: {json.dumps({k: round(v, 1) for k, v in secs.items()})} "
          f"total_s={time.perf_counter() - t:.1f}", flush=True)

    # 2. kernels against their plain versions
    g = torch.Generator(device="cuda").manual_seed(a.seed)
    table = phase_kernels(ca, g)
    torch.cuda.empty_cache()
    table.update(phase_w8a8_kernels(cm, quant, g))
    torch.cuda.empty_cache()
    table.update(phase_wide_w8a8_kernels(cm, quant, g))
    torch.cuda.empty_cache()
    table.update(phase_window_kernels(ca, g))
    torch.cuda.empty_cache()
    table.update(phase_flash_kernels(ca, masks, g))
    torch.cuda.empty_cache()
    phase_trainer_flash_kernels(ca, masks, g)
    phase_i2v_kernels(ca, g)
    table.update(phase_tp_kernels(ca, g))
    table.update(phase_conv_kernels(tconv, g))
    torch.cuda.empty_cache()
    if a.kernels_only:
        print("kernels only: the main path was not run", flush=True)
        return

    elapsed("phases 1-2")

    # 3-5 for the parity configuration: one forward kernels vs plain, the
    # stream, where the time goes
    cfg = dataclasses.replace(WAN_1_3B, num_frame_per_block=3)
    params = make_params(dit, cfg, a.seed)
    rope = RopeTables.create(cfg.head_dim, device="cuda")
    inp = forward_inputs(cfg, g)
    flow_bf16 = phase_forward(dit, cfg, params, rope, inp)
    torch.cuda.empty_cache()
    launches, last = phase_stream(ca, dit, vae, pipe_mod, cfg, params,
                                  a.blocks, a.seed)
    phase_profile(dit, cfg, params, last, "parity")
    del last
    torch.cuda.empty_cache()
    # 3-4 under the bounded and online softmax
    launches.update(phase_softmax_modes(ca, dit, pipe_mod, cfg, params, rope,
                                        inp, flow_bf16, a.blocks, a.seed))

    # 3-5 for the demo configuration, as bench.py runs it: the same
    # weights quantized and the attention, both from the card's defaults;
    # then 3-4 with the full-int8 attention (attn_quant='int8', the
    # tile-bounded kernel on this global path)
    chip = chip_defaults()
    cfg_q = dataclasses.replace(cfg, attn_quant=chip["demo_attn_quant"])
    cfg_i8 = dataclasses.replace(cfg, attn_quant="int8")
    qparams = quant.quantize_dit_params(params, mode=chip["matmul_quant"])
    phase_demo_forward(dit, cfg_q, qparams, rope, inp, flow_bf16)
    phase_demo_forward(dit, cfg_i8, qparams, rope, inp, flow_bf16)
    del inp, flow_bf16
    torch.cuda.empty_cache()
    demo_launches, demo_last = phase_demo_stream(
        ca, cm, dit, taehv, pipe_mod, cfg_q, qparams, a.blocks, a.seed)
    launches.update({k: demo_launches[k] for k in DEMO_KERNELS
                     if k != "cross_attention"})
    phase_profile(dit, cfg_q, qparams, demo_last, "demo")
    del demo_last
    torch.cuda.empty_cache()
    # the registry's demo attention against the bf16 decode kernel on the
    # same W8A8 weights: the A/B behind ops/chip.py's demo_attn_quant
    cfg_qb = dataclasses.replace(cfg_q, attn_quant=None)
    _, bf_last = phase_demo_stream(ca, cm, dit, taehv, pipe_mod, cfg_qb,
                                   qparams, a.blocks, a.seed,
                                   kernels=DEMO_BF16_ATTN_KERNELS)
    phase_profile(dit, cfg_qb, qparams, bf_last, "demo bf16 attention")
    del bf_last
    torch.cuda.empty_cache()
    i8_launches, i8_last = phase_demo_stream(
        ca, cm, dit, taehv, pipe_mod, cfg_i8, qparams, a.blocks, a.seed,
        kernels=INT8_DEMO_KERNELS)
    launches.update({k: i8_launches[k] for k in ("int8_quantize_v",
                                                 "decode_fresh_int8_tile")})
    phase_profile(dit, cfg_i8, qparams, i8_last, "demo int8 attention")
    del i8_last   # its pipe holds a 6 GB KV cache

    # the windowed configurations, after freeing the global caches and
    # the bf16 parameters (the 24-frame buffer is 6.9 GB); with
    # attn_quant='int8' the windowed path runs the online int8 kernel
    del params
    torch.cuda.empty_cache()
    cfg_w = dataclasses.replace(cfg_q, local_attn_size=12, sink_size=1,
                                windowed_buffer_frames=24)
    win_last = phase_windowed(ca, cm, dit, taehv, pipe_mod, cfg_w, qparams,
                              a.seed)
    phase_profile(dit, cfg_w, qparams, win_last, "windowed")
    del win_last
    torch.cuda.empty_cache()
    cfg_wi8 = dataclasses.replace(cfg_w, attn_quant="int8")
    win_i8 = phase_windowed(ca, cm, dit, taehv, pipe_mod, cfg_wi8, qparams,
                            a.seed, kernels=INT8_WIN_KERNELS)
    phase_profile(dit, cfg_wi8, qparams, win_i8, "windowed int8 attention")
    launches["decode_fresh_int8_online"] = \
        win_i8["launches"]["decode_fresh_int8_online"]
    del win_i8, qparams
    torch.cuda.empty_cache()

    elapsed("phases 3-6")

    # 7. the training path, with float32 products in TF32 as train.py
    # runs them; then a critic-only step under the bounded softmax and
    # the critic-loss gradient under each softmax
    torch.backends.cuda.matmul.allow_tf32 = True
    dmd_one = {}    # step 0 in one process: phase 17(a)'s reference
    train_launches = phase_training(ca, a.seed, keep=dmd_one)
    launches.update({k: train_launches[k] for k in
                     ("flash_fwd", "flash_bwd")})
    torch.cuda.empty_cache()
    launches["flash_fwd_bounded"] = phase_training(
        ca, a.seed, "bounded", steps=(1,))["flash_fwd_bounded"]
    torch.cuda.empty_cache()
    for mode in ("free", "bounded", "online"):
        grad_launches = phase_training_grad(ca, dit, a.seed, mode)
        torch.cuda.empty_cache()
    launches["flash_fwd_online"] = grad_launches["flash_fwd_online"]

    elapsed("phase 7")

    # 8. the Wan VAE under its conv backends, and the i2v path
    torch.backends.cuda.matmul.allow_tf32 = False
    launches.update(phase_vae(cc, tconv, vae, dit, pipe_mod, a.seed))
    torch.cuda.empty_cache()

    elapsed("phase 8")

    # 9. the Wan-14B demo stream, last, with every earlier tensor freed
    wan14b = phase_wan14b(ca, cm, dit, taehv, pipe_mod, quant, chip,
                          a.blocks, a.seed)
    # the GEMM from raw x (quantize_rows takes every shape it takes) and
    # the cache-window attention (an entry point tests call) lie on no
    # shipped path: their counts are this run's readings all the same
    launches.update({k: wan14b[k] for k in (
        "w8a8_ffn1_xq", "w8a8_matmul_bf16x", "decode_window",
        "decode_window_f32")})

    elapsed("phase 9")

    # 10. the text-to-video main path: umT5, the checkpoint loaders and
    # the CLI's per-prompt function (its launches are checked there; the
    # kernel line keeps phase 4's); its model directory stays for 12
    model_dir = tempfile.mkdtemp(prefix="chip_smoke_models_")
    try:
        phase_text_to_video(ca, dit, vae, a.blocks, a.seed, model_dir)

        elapsed("phase 10")

        # 11. the pose-conditioned 50-step causal path (the CLI's
        # --dwpose_path) and the bidirectional samplers (their launches
        # are checked there; the kernel line keeps phase 4's)
        phase_pose_diffusion(ca, dit, vae, a.seed)

        elapsed("phase 11")

        # 12. the streaming demo server serving a few requests (its
        # launches are checked there; the kernel line keeps phase 4's)
        phase_serving(ca, cm, dit, vae, a.seed, model_dir)

        elapsed("phase 12")

        # 13. the image-to-video path at Wan-I2V-14B width, with every
        # earlier tensor freed (its launches are checked there; the
        # kernel line keeps phases 4 and 7's)
        phase_image_to_video(ca, dit, vae, a.seed)
        torch.cuda.empty_cache()

        elapsed("phase 13")

        # 14. the ODE, causal-diffusion, GAN and SiD trainers (float32
        # weights, TF32 products as train.py runs them; their launches
        # are checked there; the kernel line keeps phases 4 and 7's)
        torch.backends.cuda.matmul.allow_tf32 = True
        phase_other_trainers(ca, dit, a.seed)

        elapsed("phase 14")

        # 15. the data-prep chain on phase 10's model directory and pose
        # distillation (bf16, TF32 products as train.py runs them; the
        # launches are checked there; the kernel line keeps phases 4 and
        # 7's)
        phase_pose_training(ca, dit, vae, a.seed, model_dir)
        torch.backends.cuda.matmul.allow_tf32 = False
    finally:
        shutil.rmtree(model_dir, ignore_errors=True)

    elapsed("phase 15")

    # 16. tensor and sequence parallelism (its ranks are processes of
    # their own; they check their launches there)
    launches.update(phase_parallel(a.seed))

    elapsed("phase 16")

    # 17. parallel training, last (its launches are checked there; the
    # kernel line keeps phases 4 and 7's)
    torch.backends.cuda.matmul.allow_tf32 = True
    phase_parallel_training(ca, a.seed, dmd_one)
    torch.backends.cuda.matmul.allow_tf32 = False

    elapsed("phase 17")
    attn, w8a8 = "self_forcing_tpu/ops/pallas_attention.py", \
        "self_forcing_tpu/ops/pallas_matmul.py"
    pconv = "self_forcing_tpu/ops/pallas_conv.py"
    csrc = "self_forcing_tpu_torch/csrc/"
    sources = {"decode_fresh_free": (csrc + "decode_fresh.cu", attn + ":275"),
               "decode_fresh_free_noclamp": (csrc + "decode_fresh.cu",
                                             attn + ":275"),
               "decode_fresh_bounded": (csrc + "decode_fresh.cu",
                                        attn + ":275"),
               "decode_fresh_online": (csrc + "decode_fresh.cu",
                                       attn + ":275"),
               "int8qk_quantize": (csrc + "decode_int8qk.cu", attn + ":546"),
               "decode_fresh_int8qk": (csrc + "decode_fresh.cu",
                                       attn + ":475"),
               "int8_quantize_v": (csrc + "decode_int8.cu", attn + ":585"),
               "decode_fresh_int8_tile": (csrc + "decode_int8.cu",
                                          attn + ":475"),
               "decode_fresh_int8_global": (csrc + "decode_int8.cu",
                                            attn + ":475"),
               "decode_fresh_int8_online": (csrc + "decode_int8.cu",
                                            attn + ":475"),
               "flash_fwd_online": (csrc + "decode_fresh.cu",
                                    attn + ":1367"),
               "flash_fwd_bounded": (csrc + "decode_fresh.cu",
                                     attn + ":1367"),
               "cross_attention": (csrc + "decode_fresh.cu",
                                   attn + ":1224"),
               "decode_fresh_free_tp2": (csrc + "decode_fresh.cu",
                                         attn + ":275"),
               "cross_attention_tp2": (csrc + "decode_fresh.cu",
                                       attn + ":1224"),
               "quantize_rows": (csrc + "w8a8.cu", w8a8 + ":201"),
               "w8a8_matmul": (csrc + "w8a8_fc1.cu", w8a8 + ":27"),
               "w8a8_ffn1": (csrc + "w8a8_fc1.cu", w8a8 + ":71"),
               "w8a8_ffn2": (csrc + "w8a8_fc1.cu", w8a8 + ":117"),
               "w8a8_ffn1_xq": (csrc + "w8a8_fc1.cu", w8a8 + ":86"),
               "w8a8_matmul_bf16x": (csrc + "w8a8_fc1.cu", w8a8 + ":54"),
               "decode_window": (csrc + "decode_fresh.cu", attn + ":73"),
               "decode_window_f32": (csrc + "decode_fresh.cu",
                                     attn + ":73"),
               "conv3d_f32": (csrc + "conv3d.cu", pconv + ":120"),
               "flash_fwd": (csrc + "decode_fresh.cu", attn + ":1367"),
               "flash_bwd": (csrc + "flash_bwd.cu",
                             f"{attn}:1610, {attn}:1668"),
               "conv3d_fused": (csrc + "conv3d.cu", pconv + ":120"),
               "conv3d_rgb": (csrc + "conv3d.cu", pconv + ":120"),
               "conv2d_9tap": (csrc + "conv3d.cu", pconv + ":30"),
               "conv3d_v2": (csrc + "conv3d.cu", pconv + ":261"),
               "norm_silu_conv3d": (csrc + "conv3d.cu", pconv + ":402")}
    kernels = []
    for name, (src, replaces) in sources.items():
        row = table[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
