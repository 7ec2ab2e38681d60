"""The per-rank work of the parallel checks that ``chip_smoke.py`` (phase
16) runs on one card through :func:`launch.spawn`.  Each function writes
its readings as ``<out_dir>/<name>_rank<r>.json``; the caller holds them
to their limits and prints them.  The models and sizes come in ``spec``
(a dict: ``model`` / ``sp_model`` are ``WanConfig``s, ``layers``,
``cut_layers``, ``sp_layers``, ``latent_hw``, ``blocks``, ``sp_frames``,
``seed``, ``device``), so that a rehearsal can run the same code small
on the CPU.

- :func:`nccl_one_rank`: an NCCL group of one rank: the tensor-parallel
  forward of block 2 (``tensor.forward_inference_tp``) beside
  ``dit.forward_inference`` on the same weights, with the attention
  kernels' launches of each.
- :func:`gloo_two_ranks`: two ranks sharing the card over gloo (NCCL
  refuses two ranks on one device): the tensor-parallel forward of block
  2 on a cut of Wan-14B against the single-process forward of the same
  weights, and the rank caches against the dense cache; the
  tensor-parallel ``CausalInferencePipeline.stream`` at full depth, each
  rank drawing the model layer by layer from the seed and keeping its
  shard; then ``sequence.forward_train_sp`` on a cut of Wan-I2V-14B
  (both ranks holding the weights) against the single-process
  ``dit.forward_train``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import time

import torch

from self_forcing_tpu_torch.config import Config
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.ops import cuda_attention as ca
from self_forcing_tpu_torch.parallel import comm, fit, sequence, tensor
from self_forcing_tpu_torch.parallel import mesh as mesh_mod
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline)
from self_forcing_tpu_torch.utils import tree

STEPS = [1000, 750, 500, 250]


def _write(out_dir: str, name: str, rank: int, obj: dict) -> None:
    with open(os.path.join(out_dir, f"{name}_rank{rank}.json"), "w") as f:
        json.dump(obj, f)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _peak_gb(dev: torch.device) -> float | None:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _reset_peak(dev: torch.device) -> None:
    """Return the freed blocks to the card and restart the peak count."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def _params(cfg, seed: int, dev, rank: int = 0, tp: int = 1,
            causal: bool = True) -> dict:
    """Random bf16 weights drawn layer by layer from ``seed`` (rank r of
    ``tp`` keeps its shard of each layer as it is drawn) with the zero
    output layer drawn too, so that the flow depends on every layer."""
    fn = None if tp == 1 else functools.partial(tensor.shard_layer,
                                                rank=rank, tp=tp)
    p = dit.init_params(cfg, seed, torch.bfloat16, dev, causal=causal,
                        block_fn=fn)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    w = p["head"]["head"]["w"]
    p["head"]["head"]["w"] = (torch.randn(w.shape, generator=g, device=dev)
                              * w.shape[0] ** -0.5).to(w.dtype)
    return p


def _gb(params) -> float:
    return sum(t.numel() * t.element_size() for t in tree.leaves(params)) / 1e9


def _block_inputs(cfg, spec, dev, seed: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    nb, (H, W) = cfg.num_frame_per_block, spec["latent_hw"]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    return {"context": randn(1, 512, cfg.text_dim),
            "x0": randn(1, nb, 16, H, W), "x1": randn(1, nb, 16, H, W)}


def _block2(params, cfg, inp, rope, dev, mesh=None):
    """Block 1 written to a fresh 21-frame cache, then block 2's forward
    (timestep 750) reading it without a write, single-card or
    tensor-parallel over ``mesh``.  Returns (flow, cache, the attention
    kernels' launches of block 2's forward)."""
    nb, H, W = inp["x0"].shape[1], inp["x0"].shape[3], inp["x0"].shape[4]
    fs = (H // 2) * (W // 2)
    t0 = torch.zeros(1, nb, device=dev)
    t1 = torch.full((1, nb), 750.0, device=dev)
    if mesh is None:
        ctx = dit.precompute_context(params, cfg, inp["context"])
        cache = dit.init_kv_cache(cfg, 1, fs, 21, torch.bfloat16, dev)
        fwd = dit.forward_inference
    else:
        ctx = tensor.precompute_context_tp(params, cfg, inp["context"], mesh)
        cache = tensor.init_kv_cache_tp(cfg, mesh, 1, fs, 21,
                                        torch.bfloat16, dev)
        fwd = functools.partial(tensor.forward_inference_tp, mesh=mesh)
    _, cache = fwd(params, cfg, inp["x0"], t0, ctx, cache, 0, rope,
                   static_kv_hi=0)
    _sync(dev)
    ca.reset_launch_counts()
    flow, _ = fwd(params, cfg, inp["x1"], t1, ctx, cache, nb, rope,
                  static_kv_hi=nb * fs, write_cache=False)
    _sync(dev)
    return flow, cache, {k: v for k, v in ca.launch_counts.items() if v}


def nccl_one_rank(rank: int, world: int, spec: dict, out_dir: str) -> None:
    """Block 2 at full Wan-1.3B width through ``forward_inference_tp`` on
    an NCCL group of one rank, beside ``dit.forward_inference``."""
    dev = torch.device(spec["device"])
    cfg = dataclasses.replace(spec["model"], num_frame_per_block=3,
                              num_layers=spec["layers"])
    params = _params(cfg, spec["seed"], dev)
    rope = RopeTables.create(cfg.head_dim, device=dev)
    inp = _block_inputs(cfg, spec, dev, spec["seed"] + 20)
    flow_1, _, l_1 = _block2(params, cfg, inp, rope, dev)
    mesh = tensor.tp_mesh(1, dev.type)
    ptp = tensor.shard_params_tp(params, mesh)
    del params
    flow_tp, _, l_tp = _block2(ptp, cfg, inp, rope, dev, mesh)
    _write(out_dir, "nccl", rank, {
        "backend": torch.distributed.get_backend(), "world": world,
        "rel_l2": _rel_l2(flow_tp, flow_1),
        "max_abs": float((flow_tp.float() - flow_1.float()).abs().max()),
        "finite": bool(torch.isfinite(flow_tp.float()).all()),
        "launches_single": l_1, "launches_tp": l_tp})


def _tp_cut_check(spec: dict, dev, mesh) -> dict:
    """Block 2 on a cut of the model: tensor-parallel against the
    single-process forward of the same weights (each rank draws them
    whole), and the rank's cache against its heads of the dense one."""
    r, tp = tensor.mesh_rank_size(mesh)
    cfg = dataclasses.replace(spec["model"], num_frame_per_block=3,
                              num_layers=spec["cut_layers"])
    full = _params(cfg, spec["seed"], dev)
    rope = RopeTables.create(cfg.head_dim, device=dev)
    inp = _block_inputs(cfg, spec, dev, spec["seed"] + 20)
    flow_1, cache_1, _ = _block2(full, cfg, inp, rope, dev)
    flow_tp, cache_tp, launches = _block2(tensor.shard_params(full, r, tp),
                                          cfg, inp, rope, dev, mesh)
    n = cfg.num_heads // tp
    written = cache_tp.global_end
    out = {"layers": cfg.num_layers, "rel_l2": _rel_l2(flow_tp, flow_1),
           "finite": bool(torch.isfinite(flow_tp.float()).all()),
           "launches": launches}
    for kv in ("k", "v"):
        out[f"cache_{kv}_rel_l2"] = _rel_l2(
            getattr(cache_tp, kv)[:, :, :written],
            getattr(cache_1, kv)[:, r * n:(r + 1) * n, :written])
    return out


def _tp_stream(spec: dict, dev, mesh) -> dict:
    """The tensor-parallel stream at full depth: ``spec['blocks']`` blocks
    of 3 latent frames, a 21-frame cache, each block's ms on the host
    clock (synchronised), the gloo all-reduces' ms, the launches and the
    peak memory beside the fit estimate."""
    r, tp = tensor.mesh_rank_size(mesh)
    cfg = dataclasses.replace(spec["model"], num_frame_per_block=3,
                              num_layers=spec["layers"])
    _reset_peak(dev)
    t = time.perf_counter()
    params = _params(cfg, spec["seed"], dev, r, tp)
    _sync(dev)
    init_s = time.perf_counter() - t
    args = Config({"denoising_step_list": STEPS, "warp_denoising_step": True,
                   "timestep_shift": 8.0, "num_frame_per_block": 3,
                   "context_noise": 0})
    pipe = CausalInferencePipeline(args, params, cfg, device=dev,
                                   dtype=torch.bfloat16, mesh=mesh)
    H, W = spec["latent_hw"]
    g = torch.Generator(device=dev).manual_seed(spec["seed"] + 1)
    context = torch.randn(1, 512, cfg.text_dim, generator=g,
                          device=dev).to(torch.bfloat16)
    noise = torch.randn(1, 3 * spec["blocks"], 16, H, W, generator=g,
                        device=dev).to(torch.bfloat16)
    _sync(dev)
    comm.CLOCK.on = True
    comm.CLOCK.reset()
    ca.reset_launch_counts()
    block_ms, blocks = [], []
    t = t0 = time.perf_counter()
    for blk in pipe.stream(noise, context, generator=g):
        _sync(dev)
        now = time.perf_counter()
        block_ms.append((now - t) * 1e3)
        blocks.append(blk)
        t = now
    total_ms = (time.perf_counter() - t0) * 1e3
    comm.CLOCK.on = False
    out = torch.cat(blocks, dim=1)
    est = fit.tp_sampler_fit(cfg, tp=tp, height=8 * H, width=8 * W,
                             limit=fit.card_limit() if dev.type == "cuda"
                             else 0)
    parts = ("params", "kv_cache", "context", "activations", "total",
             "limit")
    return {"layers": cfg.num_layers, "blocks": spec["blocks"],
            "init_s": init_s, "weights_gb": _gb(params),
            "block_ms": block_ms, "total_ms": total_ms,
            "allreduce_ms": comm.CLOCK.ms, "allreduce_calls": comm.CLOCK.calls,
            "launches": {k: v for k, v in ca.launch_counts.items() if v},
            "shape": list(out.shape),
            "finite": bool(torch.isfinite(out.float()).all()),
            "checksum": float(out.float().abs().mean()),
            "cache_frames": pipe._cache.k.shape[2] // ((H // 2) * (W // 2)),
            "cache_heads": pipe._cache.k.shape[1],
            "peak_gb": _peak_gb(dev),
            "fit_gb": {k: est[k] / 1e9 for k in parts}}


def _sp_forward(spec: dict, dev) -> dict:
    """``forward_train_sp`` on a cut of the i2v model (every rank holds
    the weights) at ``spec['sp_frames']`` latent frames with seeded ``y``
    and ``clip_fea``: its ms, launches and peak; on rank 0 also the
    single-process ``dit.forward_train`` of the same inputs."""
    mesh = mesh_mod.create_mesh(dp=1, sp=torch.distributed.get_world_size(),
                                device_type=dev.type)
    cfg = dataclasses.replace(spec["sp_model"],
                              num_layers=spec["sp_layers"])
    _reset_peak(dev)
    params = _params(cfg, spec["seed"] + 5, dev, causal=False)
    rope = RopeTables.create(cfg.head_dim, device=dev)
    H, W = spec["latent_hw"]
    F = spec["sp_frames"]
    g = torch.Generator(device=dev).manual_seed(spec["seed"] + 6)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    x, y = randn(1, F, 16, H, W), randn(1, F, cfg.in_dim - 16, H, W)
    clip, ctx = randn(1, 257, 1280), randn(1, 512, cfg.text_dim)
    t = torch.full((1, F), 500.0, device=dev)
    _sync(dev)
    comm.CLOCK.on = True
    comm.CLOCK.reset()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    out = sequence.forward_train_sp(params, cfg, x, t, ctx, rope, mesh, y=y,
                                    clip_fea=clip)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    comm.CLOCK.on = False
    launches = {k: v for k, v in ca.launch_counts.items() if v}
    peak = _peak_gb(dev)
    est = fit.sp_forward_fit(cfg, sp=mesh.get_group("sp").size(),
                             height=8 * H, width=8 * W,
                             frame_num=4 * (F - 1) + 1,
                             limit=fit.card_limit() if dev.type == "cuda"
                             else 0)
    res = {"fit_gb": est["total"] / 1e9, "layers": cfg.num_layers,
           "frames": F,
           "frames_padded": -(-F // mesh.get_group("sp").size())
           * mesh.get_group("sp").size(), "ms": ms,
           "ring_ms": comm.CLOCK.ms, "ring_calls": comm.CLOCK.calls,
           "launches": launches, "peak_gb": peak, "shape": list(out.shape),
           "finite": bool(torch.isfinite(out.float()).all())}
    if mesh.get_local_rank("sp") == 0:
        ref = dit.forward_train(params, cfg, x, t, ctx, None, rope, y=y,
                                clip_fea=clip, remat=False)
        res["rel_l2"] = _rel_l2(out, ref)
    return res


def gloo_two_ranks(rank: int, world: int, spec: dict, out_dir: str) -> None:
    """The tensor-parallel cut check and stream, then the
    sequence-parallel forward, over a gloo group."""
    dev = torch.device(spec["device"])
    mesh = tensor.tp_mesh(world, dev.type)
    res = {"backend": torch.distributed.get_backend(), "world": world,
           "cut": _tp_cut_check(spec, dev, mesh)}
    res["stream"] = _tp_stream(spec, dev, mesh)
    res["sp"] = _sp_forward(spec, dev)
    _write(out_dir, "gloo", rank, res)
