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

Phase 17 (parallel training): :func:`train_gloo_two_ranks` on two gloo
ranks: the ZeRO-3 DMD and diffusion steps on an fsdp-2 mesh, the
ZeRO-3-over-sp teacher's DMD and SiD steps on an sp-2 mesh,
``forward_train_tp``'s gradients, the rollout with and without the
cache constraint and ``train.main``, each against one process where the
check names one; ``chip_smoke.py`` runs phase 17(a) in its own process
with :func:`_tree_rel_l2` / :func:`_log_rel`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
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


# ---------------------------------------------------------------------
# phase 17: parallel training (ZeRO-3 trainers, the cache constraint,
# tp gradients, the ZeRO-3-over-sp teacher, the CLI)
# ---------------------------------------------------------------------

def _dmd_config(spec: dict, name: str = "self_forcing_dmd.yaml",
                **over) -> Config:
    """``configs/<name>`` (spec['configs'] is its directory; by default
    ``self_forcing_dmd.yaml``) with the seed and ``over``."""
    from self_forcing_tpu_torch.config import load_config
    config = load_config(os.path.join(spec["configs"], name),
                         os.path.join(spec["configs"],
                                      "default_config.yaml"))
    config.update(seed=spec["seed"], **over)
    return config


def _context(config, cfg, dev, n: int = 1):
    """(the batch's text context [n, 512, text_dim], the negative
    prompt's [1, ...]) from ``train``'s pseudo embeddings."""
    from self_forcing_tpu_torch import train
    fn = train.make_context_fn(config, cfg, dev)
    return (fn([f"placeholder prompt {i}" for i in range(n)]),
            fn([str(config.negative_prompt)]))


def _whole_cpu(tree_) -> list[torch.Tensor]:
    return [t.detach().float().cpu() for t in tree.leaves(tree_)]


def _l2_parts(a: list, b: list) -> tuple[float, float]:
    """(||a - b||, ||b||) over two lists of leaves, in float32 on ``a``'s
    leaves' device (``b``'s are moved there one by one)."""
    num = den = 0.0
    for x, y in zip(a, b):
        x = x.float()
        y = y.to(x.device).float()
        num += float((x - y).pow(2).sum())
        den += float(y.pow(2).sum())
    return num ** 0.5, den ** 0.5


def _tree_rel_l2(a: list, b: list) -> float:
    """Relative L2 distance of two lists of leaves over all of them."""
    num, den = _l2_parts(a, b)
    return num / max(den, 1e-30)


def dmd_weights(trainer) -> dict:
    """A DMD trainer's whole generator and critic leaves (ZeRO-3 slices
    gathered) on the host: the ``before`` of :func:`dmd_state`."""
    return {name: [t.detach().to("cpu", copy=True)
                   for t in tree.leaves(model.full())]
            for name, model in (("generator", trainer.gen),
                                ("critic", trainer.fake))}


def dmd_state(trainer, before: dict, host: bool = True) -> dict:
    """A DMD trainer's state after a step, for the generator and the
    critic: the update of the whole tree (its leaves less ``before``'s,
    :func:`dmd_weights`, in each leaf's dtype: a step of a few ulps is
    exact there), the updated tree's L2 norm and the first AdamW moment
    (ZeRO-3 slices gathered); on the host unless ``host`` is False.  At
    lr 2e-6 (4e-7 for the critic) a step moves a bf16 weight by less
    than its rounding, so only the update and the moment (the gradient,
    with beta1 0) show what the step did."""
    out = {}
    for name, model, opt in (
            ("generator", trainer.gen, trainer.state.gen_opt_state),
            ("critic", trainer.fake, trainer.state.critic_opt_state)):
        upd, sq = [], 0.0
        for a, b in zip(tree.leaves(model.full()), before[name]):
            a = a.detach()
            sq += float(a.float().pow(2).sum())
            u = (a.float() - b.to(a.device).float()).to(a.dtype)
            upd.append(u.cpu() if host else u)
        out[name + "_update"], out[name + "_norm"] = upd, sq ** 0.5
        out[name + "_moment"] = [
            m.detach().to("cpu" if host else m.device, copy=True)
            for m in model.full_opt(opt)["mu"] if m is not None]
    return out


def dmd_distances(state: dict, ref: dict) -> dict:
    """A DMD step's :func:`dmd_state` against a reference step's from the
    same weights: for the generator and the critic the relative L2
    distance of the updated trees (``<model>_rel_l2``: the updates'
    difference over the reference tree's norm), of the updates
    (``<model>_update_rel_l2``) and of the first moments
    (``<model>_moment_rel_l2``)."""
    out = {}
    for m in ("generator", "critic"):
        num, den = _l2_parts(state[m + "_update"], ref[m + "_update"])
        out[m + "_rel_l2"] = num / max(ref[m + "_norm"], 1e-30)
        out[m + "_update_rel_l2"] = num / max(den, 1e-30)
        out[m + "_moment_rel_l2"] = _tree_rel_l2(state[m + "_moment"],
                                                 ref[m + "_moment"])
    return out


def _log_rel(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b
               if not k.endswith("_ms"))


def _state_bytes(trainer) -> int:
    """This rank's bytes of the generator's and the critic's parameters
    and AdamW moments (ZeRO-3 slices on a mesh)."""
    s = trainer.state
    n = 0
    for leaves, opt in ((trainer.gen_leaves, s.gen_opt_state),
                        (trainer.fake_leaves, s.critic_opt_state)):
        for t in leaves + [m for m in opt["mu"] + opt["nu"]
                           if m is not None]:
            n += t.numel() * t.element_size()
    return n


def _dmd_run(spec: dict, dev, mesh, layers: int, config,
             teacher_cfg=None, stamp: int = 0) -> dict:
    """One ``ScoreDistillationTrainer.train_step`` (the generator and the
    critic) on weights drawn from the seed: its log, ms (host clock,
    synchronised), launches, peak, the gloo collectives' ms and the
    state's bytes on this rank; and its :func:`dmd_state` (on the
    host)."""
    from self_forcing_tpu_torch.training.trainer_distillation import (
        ScoreDistillationTrainer)
    cfg = dataclasses.replace(spec["model"], num_layers=layers,
                              num_frame_per_block=3)
    tcfg = cfg if teacher_cfg is None else teacher_cfg
    seed = spec["seed"] + stamp
    gen = _params(cfg, seed, dev)
    fake = _params(cfg, seed + 1, dev, causal=False)
    real = _params(tcfg, seed + 2, dev, causal=False)
    ctx, neg = _context(config, cfg, dev)
    _reset_peak(dev)
    trainer = ScoreDistillationTrainer(config, gen, fake, real, cfg, cfg,
                                       tcfg, neg, device=dev, mesh=mesh)
    # the cache constraint is (e)'s: with it every forward would gather
    # each layer's cache through host memory
    trainer.bundle.rollout_act_shard = None
    real_bytes = trainer.real.nbytes() if mesh is not None \
        else int(_gb(real) * 1e9)
    del gen, fake, real
    before = dmd_weights(trainer)
    trainer.state.step = 0
    _sync(dev)
    comm.CLOCK.on = True
    comm.CLOCK.reset()
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    log = trainer.train_step({"context": ctx})
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    comm.CLOCK.on = False
    launches = {k: v for k, v in ca.launch_counts.items() if v}
    peak = _peak_gb(dev)
    out = {"log": log, "ms": ms, "launches": launches, "peak_gb": peak,
           "comm_ms": comm.CLOCK.ms, "comm_calls": comm.CLOCK.calls,
           "state_bytes": _state_bytes(trainer), "teacher_bytes": real_bytes,
           "layers": layers, "teacher_layers": tcfg.num_layers,
           "finite": all(math.isfinite(v) for v in log.values())}
    state = dmd_state(trainer, before)
    del trainer
    _reset_peak(dev)
    return out, state


def _compare(out: dict, state: dict, ref: dict, ref_state: dict) -> None:
    out["vs_one_process"] = {
        "log_rel": _log_rel(out["log"], ref["log"]),
        **dmd_distances(state, ref_state),
        "launches": ref["launches"], "ms": ref["ms"],
        "peak_gb": ref["peak_gb"], "state_bytes": ref["state_bytes"],
        "teacher_bytes": ref["teacher_bytes"]}


def _diffusion_run(spec: dict, dev, mesh, layers: int) -> tuple:
    """Two ``DiffusionTrainer`` steps (teacher forcing, blocks of 3) on a
    batch of 2 seeded latents, split over the ranks on a mesh."""
    from self_forcing_tpu_torch.config import load_config
    from self_forcing_tpu_torch.training.trainer_diffusion import (
        DiffusionTrainer)
    config = load_config(os.path.join(spec["configs"],
                                      "causal_diffusion.yaml"),
                         os.path.join(spec["configs"],
                                      "default_config.yaml"))
    config.update(seed=spec["seed"])
    cfg = dataclasses.replace(spec["model"], num_layers=layers)
    gen = _params(cfg, spec["seed"] + 3, dev)
    H, W = spec["latent_hw"]
    g = torch.Generator(device=dev).manual_seed(spec["seed"] + 4)
    batch = {"latents": torch.randn(2, 21, 16, H, W, generator=g,
                                    device=dev),
             "context": torch.randn(2, 512, cfg.text_dim, generator=g,
                                    device=dev)}
    _reset_peak(dev)
    trainer = DiffusionTrainer(config, gen, cfg, device=dev, mesh=mesh)
    del gen
    logs, ms = [], []
    ca.reset_launch_counts()
    comm.CLOCK.on = True
    comm.CLOCK.reset()
    for _ in range(2):
        t0 = time.perf_counter()
        logs.append(trainer.train_step(batch))
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    comm.CLOCK.on = False
    out = {"logs": logs, "ms": ms, "peak_gb": _peak_gb(dev),
           "comm_ms": comm.CLOCK.ms,
           "launches": {k: v for k, v in ca.launch_counts.items() if v},
           "state_bytes": sum(t.numel() * t.element_size() for t in
                              trainer.leaves + [
                                  m for m in trainer.opt_state["mu"]
                                  + trainer.opt_state["nu"]
                                  if m is not None])}
    whole = _whole_cpu(trainer.model.full())
    del trainer
    _reset_peak(dev)
    return out, whole


def _cache_run(spec: dict, dev, mesh, constrained: bool) -> dict:
    """The with-grad 21-frame rollout (exit spec['cache_exit'] in every
    block, blocks of 3)
    on the fsdp-2 mesh with and without the cache constraint: the loss of
    a seeded weighting of the trajectory, the generator's gradient slices
    (on the host), the cache bytes this rank held and the peak."""
    from self_forcing_tpu_torch.training.objectives.base import (
        ModelBundle, ObjectiveConfig)
    from self_forcing_tpu_torch.training.trainer_distillation import (
        TrainedModel)
    cfg = dataclasses.replace(spec["model"],
                              num_layers=spec["cache_layers"],
                              num_frame_per_block=3)
    obj = ObjectiveConfig(num_frame_per_block=3, num_training_frames=21)
    bundle = ModelBundle.create(cfg, cfg, cfg, obj, STEPS, device=dev)
    model = TrainedModel(_params(cfg, spec["seed"] + 8, dev), mesh, 2 ** 16)
    held = {}

    def act(cache):
        if constrained:
            cache = mesh_mod.rollout_cache_constraint(mesh)(cache)
        held["bytes"] = cache.k.nbytes + cache.v.nbytes
        return cache
    bundle.rollout_act_shard = act
    H, W = spec["latent_hw"]
    g = torch.Generator(device=dev).manual_seed(spec["seed"] + 9)
    noise = torch.randn(1, 21, 16, H, W, generator=g, device=dev)
    w = torch.randn(noise.shape, generator=g, device=dev)
    ctx = torch.randn(1, 512, cfg.text_dim, generator=g, device=dev)
    _reset_peak(dev)
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    params = model.fwd()
    ctx_kv = dit.precompute_context(params, cfg, ctx)
    traj, _, _, _ = bundle.run_generator(params, noise, ctx_kv,
                                         spec["cache_exit"],
                                         generator=torch.Generator(
                                             device=dev).manual_seed(1))
    loss = (traj.float() * w).mean()
    grads = model.reduce(torch.autograd.grad(loss, model.leaves,
                                             allow_unused=True))
    _sync(dev)
    return {"loss": float(loss.detach()),
            "ms": (time.perf_counter() - t0) * 1e3,
            "grads": [x.detach().float().cpu() for x in grads],
            "cache_bytes": held["bytes"], "peak_gb": _peak_gb(dev),
            "launches": {k: v for k, v in ca.launch_counts.items() if v}}


def _wait_for(path: str, timeout_s: float = 1800.0) -> str:
    """The text of the file at ``path`` once it exists (polled every
    0.1 s; 'stop' after ``timeout_s``)."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout_s:
            return "stop"
        time.sleep(0.1)
    with open(path) as f:
        return f.read().strip()


def _tp_grads_check(spec: dict, dev) -> dict:
    """``tensor.forward_train_tp`` at tp 2 on a cut of Wan-14B (float32
    weights, inputs and products, TF32 off, so that the comparison sees
    the collectives and not rounded partial products; the attention
    kernels round their operands to bf16 alike; 3 latent frames at
    60x104, one step of 500) and its gradients with respect to the
    rank's shard, against the single-process ``dit.forward_train``
    gradients (rank's slice) of the same weights: all leaves together
    and the three worst leaves by name."""
    mesh = tensor.tp_mesh(torch.distributed.get_world_size(), dev.type)
    r, tp = tensor.mesh_rank_size(mesh)
    cfg = dataclasses.replace(spec["tp_model"], num_layers=spec["tp_layers"])
    full = tree.map_tree(lambda t: t.float(),
                         _params(cfg, spec["seed"] + 10, dev, causal=False))
    rope = RopeTables.create(cfg.head_dim, device=dev)
    H, W = spec["latent_hw"]
    g = torch.Generator(device=dev).manual_seed(spec["seed"] + 11)
    x = torch.randn(1, 3, 16, H, W, generator=g, device=dev)
    ctx = torch.randn(1, 512, cfg.text_dim, generator=g, device=dev)
    t = torch.full((1, 3), 500.0, device=dev)

    def grads(params, fwd):
        leaves = tree.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        out = fwd(params)
        gs = torch.autograd.grad(out.float().pow(2).mean(), leaves,
                                 allow_unused=True)
        return out.detach(), [torch.zeros_like(p) if x_ is None else x_
                              for p, x_ in zip(leaves, gs)]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    ca.reset_launch_counts()
    comm.CLOCK.on = True
    comm.CLOCK.reset()
    t0 = time.perf_counter()
    out_tp, g_tp = grads(tensor.shard_params(full, r, tp),
                         lambda p: tensor.forward_train_tp(
                             p, cfg, x, t, ctx, None, rope, mesh))
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    comm.CLOCK.on = False
    launches = {k: v for k, v in ca.launch_counts.items() if v}
    out_1, g_1 = grads(full, lambda p: dit.forward_train(
        p, cfg, x, t, ctx, None, rope))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    per_leaf, mine = {}, []
    for (path, sp), a, b in zip(tree.items(tensor.tp_param_specs(full)),
                                g_tp, g_1):
        b = b if sp is None else b.chunk(tp, sp)[r]
        mine.append(b)
        if float(b.float().norm()) > 0:
            per_leaf["/".join(map(str, path))] = _rel_l2(a, b)
    worst = sorted(per_leaf.items(), key=lambda kv: -kv[1])[:3]
    return {"layers": cfg.num_layers, "ms": ms, "comm_ms": comm.CLOCK.ms,
            "comm_calls": comm.CLOCK.calls, "launches": launches,
            "out_rel_l2": _rel_l2(out_tp, out_1),
            "grad_rel_l2_max": worst[0][1], "grad_worst_leaves": worst,
            "grad_rel_l2_all": _tree_rel_l2(g_tp, mine),
            "leaves": len(g_tp)}


def train_gloo_two_ranks(rank: int, world: int, spec: dict,
                         out_dir: str) -> None:
    """(b) - (e) over a gloo group of two ranks sharing the card: a
    reduced-depth DMD step and two diffusion steps with batch 2 split on
    an fsdp-2 mesh, each against one process (rank 0) on the same
    weights; (c) a DMD step on an sp-2 mesh whose Wan-14B-width teacher
    is sliced over ("fsdp", "sp") (``teacher_zero3_sp``) against one
    process with the whole teacher; (d) tp-2 gradients; (e) the rollout
    with and without the cache constraint (spec['cache_layers'] layers);
    and a SiD step (``self_forcing_sid.yaml``) on the same layout, whose
    generator loss differentiates through the ring teacher; then
    ``train.main`` for two steps (``train.WAN_1_3B`` cut to
    spec['cli_layers'] layers).  (d) and (e), which hold little of the
    card, run first; then, with spec['go'] (a file path), the ranks wait
    for that file before the rest (the caller's own work goes on
    meanwhile) and stop if it reads 'stop'."""
    from self_forcing_tpu_torch import train
    dev = torch.device(spec["device"])
    # the float32 products in TF32, as train.py and phase 7 run them
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    d = torch.distributed
    mesh = mesh_mod.create_mesh(dp=1, fsdp=world, sp=1, device_type=dev.type)
    res = {"backend": d.get_backend(), "world": world}
    res["tp"] = _tp_grads_check(spec, dev)
    _reset_peak(dev)
    res["cache"] = {c: _cache_run(spec, dev, mesh, c) for c in (False, True)}
    a, b = res["cache"][False], res["cache"][True]
    res["cache"] = {"free": a, "constrained": b,
                    "grad_rel_l2": _tree_rel_l2(b.pop("grads"),
                                                a.pop("grads"))}
    _reset_peak(dev)
    if spec.get("go") and _wait_for(spec["go"]) == "stop":
        return
    config = _dmd_config(spec)
    out, state = _dmd_run(spec, dev, mesh, spec["layers"], config)
    if rank == 0:
        ref, ref_state = _dmd_run(spec, dev, None, spec["layers"], config)
        _compare(out, state, ref, ref_state)
    d.barrier()
    res["dmd"] = out
    out, whole = _diffusion_run(spec, dev, mesh, spec["layers"])
    if rank == 0:
        ref, ref_whole = _diffusion_run(spec, dev, None, spec["layers"])
        out["vs_one_process"] = {
            "log_rel": max(_log_rel(a, b) for a, b in zip(out["logs"],
                                                          ref["logs"])),
            "generator_rel_l2": _tree_rel_l2(whole, ref_whole),
            "launches": ref["launches"], "ms": ref["ms"],
            "state_bytes": ref["state_bytes"], "peak_gb": ref["peak_gb"]}
    d.barrier()
    res["diffusion"] = out
    # (c) the ZeRO-3-over-sp teacher
    sp_mesh = mesh_mod.create_mesh(dp=1, fsdp=1, sp=world,
                                   device_type=dev.type)
    tcfg = dataclasses.replace(spec["teacher"],
                               num_layers=spec["teacher_layers"])
    out, state = _dmd_run(spec, dev, sp_mesh, spec["layers"],
                          _dmd_config(spec, teacher_zero3_sp=True),
                          teacher_cfg=tcfg, stamp=20)
    if rank == 0:
        ref, ref_state = _dmd_run(spec, dev, None, spec["layers"], config,
                                  teacher_cfg=tcfg, stamp=20)
        _compare(out, state, ref, ref_state)
    d.barrier()
    res["sp"] = out
    # (c) SiD on the same layout: the generator's loss differentiates
    # through the ring teacher, whose layers are gathered again in the
    # backward (remat)
    out, state = _dmd_run(spec, dev, sp_mesh, spec["layers"],
                          _dmd_config(spec, "self_forcing_sid.yaml",
                                      teacher_zero3_sp=True),
                          teacher_cfg=tcfg, stamp=20)
    if rank == 0:
        ref, ref_state = _dmd_run(
            spec, dev, None, spec["layers"],
            _dmd_config(spec, "self_forcing_sid.yaml"), teacher_cfg=tcfg,
            stamp=20)
        _compare(out, state, ref, ref_state)
    d.barrier()
    res["sid"] = out
    train.WAN_1_3B = dataclasses.replace(train.WAN_1_3B,
                                         num_layers=spec["cli_layers"])
    t0 = time.perf_counter()
    train.main(spec["cli_argv"])
    res["cli_s"] = time.perf_counter() - t0
    _write(out_dir, "train_gloo", rank, res)
