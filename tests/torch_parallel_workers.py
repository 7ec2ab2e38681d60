"""Rank functions of the port's parallel CPU tests, run by
``parallel.launch.spawn`` in gloo process groups.  The children import
this module and the port only (no JAX): each reads its inputs from a
``torch.save`` file and writes its outputs to ``<out_dir>/rank<r>.pt``;
the test process compares them with the JAX package."""
from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from self_forcing_tpu_torch.config import Config
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.ops import attention as attn_ops
from self_forcing_tpu_torch.parallel import mesh as mesh_mod
from self_forcing_tpu_torch.parallel import sequence, tensor
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline)

# seconds a test's ranks may run: a collective that some rank never
# joins (a backward issuing its collectives in another order on one
# rank) then fails the test instead of hanging it
RANKS_TIMEOUT = 600.0


def _save(out: dict, out_dir: str, rank: int) -> None:
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _cache_dict(cache: dit.KVCache) -> dict:
    return {"k": cache.k.clone(), "v": cache.v.clone(),
            "kmax": cache.kmax.clone(), "global_end": cache.global_end}


def tp_worker(rank: int, world: int, inp_path: str, out_dir: str) -> None:
    """forward_inference_tp over two blocks with the carried cache (tp 2
    and 4), precompute_context_tp, forward_train_tp, the bounded softmax's
    kmax against the single-card forward, the TP pipeline's stream,
    global and windowed, and its inference with primed latents."""
    inp = torch.load(inp_path, weights_only=True)
    cfg = WanConfig(**inp["cfg"])
    full = inp["params"]
    rope = RopeTables.create(cfg.head_dim, device="cpu")
    B, F, C, H, W = inp["x"][0].shape
    fs = (H // 2) * (W // 2)
    out = {}
    for tp in (2, 4):
        mesh = tensor.tp_mesh(tp, "cpu")
        params = tensor.shard_params_tp(full, mesh)
        ctx_kv = tensor.precompute_context_tp(params, cfg, inp["ctx"], mesh)
        cache = tensor.init_kv_cache_tp(cfg, mesh, B, fs, 4, torch.float32,
                                        "cpu")
        flows, caches = [], []
        for blk, x in enumerate(inp["x"]):
            t = torch.full((B, F), 500.0)
            flow, cache = tensor.forward_inference_tp(
                params, cfg, x, t, ctx_kv, cache, blk * F, rope, mesh)
            flows.append(flow)
            caches.append(_cache_dict(cache))
        out[f"tp{tp}"] = {"ctx_kv": ctx_kv, "flows": flows,
                          "caches": caches,
                          "local_rank": mesh.get_local_rank("tp")}
        if tp == 4:
            out["train"] = tensor.forward_train_tp(
                params, cfg, inp["x_train"], inp["t_train"], inp["ctx"],
                None, rope, mesh, remat=False)

    # the bounded softmax's kmax, on the kernel route's plain versions:
    # the rank's bound all-reduced (max) against the single-card bound
    route = attn_ops._kernel_route
    attn_ops._kernel_route = lambda t: True
    cfg_b = dataclasses.replace(cfg, attn_softmax="bounded")
    mesh = tensor.tp_mesh(2, "cpu")
    params = tensor.shard_params_tp(full, mesh)
    ctx_tp = tensor.precompute_context_tp(params, cfg_b, inp["ctx"], mesh)
    ctx_1 = dit.precompute_context(full, cfg_b, inp["ctx"])
    c_tp = tensor.init_kv_cache_tp(cfg_b, mesh, B, fs, 4, torch.float32,
                                   "cpu")
    c_1 = dit.init_kv_cache(cfg_b, B, fs, 4, torch.float32, "cpu")
    t = torch.full((B, F), 500.0)
    f_tp, c_tp = tensor.forward_inference_tp(params, cfg_b, inp["x"][0], t,
                                             ctx_tp, c_tp, 0, rope, mesh)
    f_1, c_1 = dit.forward_inference(full, cfg_b, inp["x"][0], t, ctx_1,
                                     c_1, 0, rope)
    out["bounded"] = {"kmax_tp": c_tp.kmax, "kmax_1": c_1.kmax,
                      "flow_tp": f_tp, "flow_1": f_1}
    attn_ops._kernel_route = route

    args = Config(inp["pipe_args"])
    for name in ("global", "windowed"):
        cfg_p = dataclasses.replace(cfg, **inp["pipes"][name]["over"])
        mesh = tensor.tp_mesh(4, "cpu")
        pipe = CausalInferencePipeline(
            args, tensor.shard_params_tp(full, mesh), cfg_p, device="cpu",
            dtype=torch.float32, mesh=mesh)
        out[name] = list(pipe.stream(inp["pipes"][name]["noise"],
                                     inp["ctx"],
                                     eps=inp["pipes"][name]["eps"]))
        out[name + "_compactions"] = pipe.compactions
    # inference(): the priming of clean latents, then the whole-video loop
    inf = inp["inference"]
    mesh = tensor.tp_mesh(4, "cpu")
    pipe = CausalInferencePipeline(
        args, tensor.shard_params_tp(full, mesh), cfg, device="cpu",
        dtype=torch.float32, mesh=mesh)
    _, out["inference"] = pipe.inference(
        inf["noise"], inp["ctx"], initial_latent=inf["init"],
        return_latents=True, eps=inf["eps"])
    _save(out, out_dir, rank)


def sp_worker(rank: int, world: int, inp_path: str, out_dir: str) -> None:
    """ring_attention at sp 4 and forward_train_sp (t2v, i2v, frames
    padded to an sp multiple) on a ("dp", "fsdp", "sp") = (1, 1, 4) mesh,
    and WanT2V.generate through the sp route."""
    from self_forcing_tpu_torch.wan_generate import WanT2V
    inp = torch.load(inp_path, weights_only=True)
    mesh = mesh_mod.create_mesh(dp=1, sp=world, device_type="cpu")
    sp = mesh.get_local_rank("sp")
    out = {}
    q, k, v = inp["qkv"]
    L = q.shape[1] // world
    lo = sp * L
    out["ring"] = sequence.ring_attention(
        q[:, lo:lo + L], k[:, lo:lo + L], v[:, lo:lo + L],
        mesh.get_group("sp"))
    for name, case in inp["sp_cases"].items():
        cfg = WanConfig(**case["cfg"])
        rope = RopeTables.create(cfg.head_dim, device="cpu")
        out[name] = sequence.forward_train_sp(
            case["params"], cfg, case["x"], case["t"], case["ctx"], rope,
            mesh, y=case.get("y"), clip_fea=case.get("clip"))
    g = inp["generate"]
    model = WanT2V(g["params"], WanConfig(**g["cfg"]), mesh=mesh)
    out["generate"] = model.generate(
        size=g["size"], frame_num=g["frame_num"], sampling_steps=g["steps"],
        context=g["ctx"], neg_context=g["neg"], noise=g["noise"])
    _save(out, out_dir, rank)


def cli_worker(rank: int, world: int, argv: list, out_dir: str) -> None:
    """The CLI's main with ``argv`` in a process group the launcher
    initialised, every written video's frames saved as .npy instead."""
    from self_forcing_tpu_torch import inference
    from self_forcing_tpu_torch.utils import video_io

    def save_video(frames, path, fps=16):
        np.save(os.path.join(out_dir, f"rank{rank}_" +
                             os.path.basename(path) + ".npy"), frames)
        return path

    video_io.save_video = save_video
    inference.main(argv)


# ---------------------------------------------------------------------
# parallel training: ZeRO-3 trainers, the cache constraint, tp
# gradients, the ZeRO-3-over-sp teacher, the CLI
# ---------------------------------------------------------------------

def _trainer(kind: str, config: dict, models: dict, mesh,
             real: str = "real", teacher_cfg: dict | None = None):
    from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
    from self_forcing_tpu_torch.training import trainer_diffusion as td
    from self_forcing_tpu_torch.training import trainer_distillation as tdd
    from self_forcing_tpu_torch.training import trainer_gan as tg
    from self_forcing_tpu_torch.training import trainer_ode as to
    from self_forcing_tpu_torch.utils import tree
    c = Config(config)
    p = {k: tree.map_tree(lambda t: t.clone(), v) for k, v in models.items()
         if isinstance(v, (dict, list))}
    if kind in ("dmd", "sid"):
        teacher = WAN_TINY if teacher_cfg is None \
            else WanConfig(**teacher_cfg)
        return tdd.ScoreDistillationTrainer(
            c, p["gen"], p["fake"], p[real], WAN_TINY, WAN_TINY, teacher,
            models["neg"].clone(), device="cpu", mesh=mesh)
    if kind == "gan":
        return tg.GANTrainer(c, p["gen"], p["fake"], WAN_TINY, WAN_TINY,
                             cls_params=p["cls"], device="cpu", mesh=mesh)
    if kind == "ode":
        return to.ODETrainer(c, p["gen"], WAN_TINY, visualize=True,
                             device="cpu", mesh=mesh)
    return td.DiffusionTrainer(c, p["gen"], WAN_TINY, device="cpu",
                               mesh=mesh)


def _trainer_state(tr) -> dict:
    """A trainer's weights, moments and EMA, whole (gathered)."""
    from self_forcing_tpu_torch.training.trainer_distillation import (
        ScoreDistillationTrainer)
    if isinstance(tr, ScoreDistillationTrainer):
        s = tr.state
        out = {"gen": tr.gen.full(), "fake": tr.fake.full(),
               "gen_opt": tr.gen.full_opt(s.gen_opt_state),
               "critic_opt": tr.fake.full_opt(s.critic_opt_state)}
        if s.generator_ema is not None:
            out["ema"] = tr.gen.full(s.generator_ema)
        return out
    if hasattr(tr, "cls"):
        out = {"gen": tr.gen.full(), "fake": tr.fake.full(),
               "cls": tr.cls.full(),
               "gen_opt": tr.gen.full_opt(tr.gen_opt_state),
               "critic_opt": tr.fake.full_opt(tr.critic_opt_state),
               "cls_opt": tr.cls.full_opt(tr.cls_opt_state)}
        if tr.generator_ema is not None:
            out["ema"] = tr.gen.full(tr.generator_ema)
        return out
    out = {"gen": tr.model.full(), "opt": tr.model.full_opt(tr.opt_state)}
    if tr.ema is not None:
        out["ema"] = tr.model.full(tr.ema)
    return out


def _steps(tr, batch: dict, draws: list | None, n: int) -> list:
    logs = []
    for i in range(n):
        if draws is None:
            logs.append(tr.train_step(batch))
        else:
            logs.append(tr.train_step(batch, draws=draws[i]))
    return logs


def training_cases(inp: dict, mesh) -> dict:
    """Each trainer case of ``inp['cases']`` on ``mesh`` (None: one
    process): its logs and whole state after its steps."""
    out = {}
    for name, case in inp["cases"].items():
        tr = _trainer(case["kind"], case["config"], inp["models"], mesh,
                      case.get("real", "real"), case.get("teacher_cfg"))
        logs = _steps(tr, case["batch"], case.get("draws"), case["steps"])
        out[name] = {"logs": logs, "state": _trainer_state(tr)}
        if case.get("save_state"):
            tr.save_state(case["save_state"])
    return out


def _rollout_case(inp: dict, mesh, constrained: bool) -> dict:
    """The with-grad training rollout (``ModelBundle.run_generator``) and
    the gradient of sum(trajectory * w) for every generator slice, with or
    without the cache constraint; the cache bytes this rank held."""
    from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
    from self_forcing_tpu_torch.models.wan import dit as tdit
    from self_forcing_tpu_torch.training.objectives.base import (
        ModelBundle, ObjectiveConfig)
    from self_forcing_tpu_torch.training.trainer_distillation import (
        TrainedModel)
    r = inp["rollout"]
    obj = ObjectiveConfig(num_frame_per_block=1, num_training_frames=3,
                          timestep_shift=5.0)
    gen_cfg = dataclasses.replace(WAN_TINY, num_frame_per_block=1)
    bundle = ModelBundle.create(gen_cfg, WAN_TINY, WAN_TINY, obj,
                                [1000, 750, 500], device="cpu")
    model = TrainedModel({k: v for k, v in inp["models"]["gen"].items()},
                         mesh, 1024)
    held = {}
    if constrained:
        from self_forcing_tpu_torch.parallel import mesh as mesh_mod
        shard = mesh_mod.rollout_cache_constraint(mesh)

        def act(cache):
            cache = shard(cache)
            held["bytes"] = cache.k.nbytes + cache.v.nbytes
            return cache
        bundle.rollout_act_shard = act
    params = model.fwd()
    ctx_kv = tdit.precompute_context(params, gen_cfg, r["ctx"])
    traj, _, _, _ = bundle.run_generator(params, r["noise"], ctx_kv, 2,
                                         eps=r["eps"])
    loss = (traj * r["w"]).sum()
    grads = model.reduce(torch.autograd.grad(loss, model.leaves,
                                             allow_unused=True))
    whole = 2 * r["noise"].shape[0] * WAN_TINY.num_heads  # k, v, B*N
    return {"loss": loss.detach(), "traj": traj.detach(),
            "grads": [g.detach() for g in grads],
            "cache_bytes": held.get("bytes"), "bn_whole": whole}


def _tp_grads(inp: dict) -> dict:
    """forward_train_tp at tp 2 and the gradient of its sum of squares
    with respect to every leaf of the rank's shard."""
    from self_forcing_tpu_torch.utils import tree
    t = inp["tp"]
    cfg = WanConfig(**t["cfg"])
    rope = RopeTables.create(cfg.head_dim, device="cpu")
    mesh = tensor.tp_mesh(2, "cpu")
    params = tensor.shard_params_tp(t["params"], mesh)
    leaves = tree.leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = tensor.forward_train_tp(params, cfg, t["x"], t["t"], t["ctx"],
                                  None, rope, mesh, remat=False)
    grads = torch.autograd.grad((out ** 2).sum(), leaves, allow_unused=True)
    return {"out": out.detach(), "grads": [None if g is None else g
                                           for g in grads],
            "specs": tensor.tp_param_specs(t["params"]),
            "rank": mesh.get_local_rank("tp")}


def _sp_zero3(inp: dict, mesh) -> dict:
    """forward_train_sp with the teacher's weights sliced over
    ("fsdp", "sp") (``param_specs``), and the bytes of the rank's slices."""
    from self_forcing_tpu_torch.parallel import fsdp
    s = inp["sp"]
    cfg = WanConfig(**s["cfg"])
    rope = RopeTables.create(cfg.head_dim, device="cpu")
    specs = mesh_mod.combined_fsdp_specs(s["params"], mesh, min_size=1024)
    sharded = fsdp.ShardedParams.from_full(s["params"], specs, mesh)
    with torch.no_grad():
        flow = sequence.forward_train_sp(sharded.shards, cfg, s["x"], s["t"],
                                         s["ctx"], rope, mesh,
                                         param_specs=specs)
    return {"flow": flow, "bytes": sharded.nbytes(),
            "whole_bytes": sum(t.nbytes for t in _leaves(s["params"]))}


def _sp_grads(inp: dict, mesh) -> dict:
    """On the sp mesh: ``ring_attention``'s dq / dk / dv of a weighted sum
    of its output (each rank its own queries' terms), with and without
    ``kv_valid``; ``forward_train_sp``'s gradients with respect to x and
    the context of a weighted sum of the whole prediction (3 frames
    padded to 4), on whole weights and on ZeRO-3-over-sp slices; the
    teacher's per-layer gathers (``_View.materialize`` calls) of a
    no-grad forward and of a forward with its backward under remat and
    without."""
    from self_forcing_tpu_torch.parallel import fsdp
    g = inp["sp_grad"]
    group = mesh.get_group("sp")
    r, n = mesh.get_local_rank("sp"), group.size()
    out = {"ring": {}}
    for kv_valid in g["kv_valid"]:
        q, k, v = (t.chunk(n, 1)[r].clone().requires_grad_()
                   for t in g["qkv"])
        o = sequence.ring_attention(q, k, v, group, kv_valid=kv_valid,
                                    kv_chunk=g["kv_chunk"])
        out["ring"][kv_valid] = [t.detach() for t in torch.autograd.grad(
            (o * g["w_ring"].chunk(n, 1)[r]).sum(), (q, k, v))]
    s = inp["sp"]
    cfg = WanConfig(**s["cfg"])
    rope = RopeTables.create(cfg.head_dim, device="cpu")
    specs = mesh_mod.combined_fsdp_specs(s["params"], mesh, min_size=1024)
    sharded = fsdp.ShardedParams.from_full(s["params"], specs, mesh)
    gathers = [0]
    materialize = fsdp._View.materialize

    def counted(view):
        gathers[0] += 1
        return materialize(view)

    def grads(params, param_specs):
        x = g["x"].clone().requires_grad_()
        ctx = s["ctx"].clone().requires_grad_()
        gathers[0] = 0
        flow = sequence.forward_train_sp(params, cfg, x, g["t"], ctx, rope,
                                         mesh, param_specs=param_specs)
        got = torch.autograd.grad((flow * g["w"]).sum(), (x, ctx))
        return {"x": got[0], "ctx": got[1], "gathers": gathers[0]}

    checkpoint = sequence.checkpoint
    fsdp._View.materialize = counted
    try:
        out["whole"] = grads(s["params"], None)
        out["zero3"] = grads(sharded.shards, specs)
        # the same forward with the per-layer recompute taken out
        sequence.checkpoint = lambda fn, *a, use_reentrant: fn(*a)
        try:
            out["zero3_no_remat"] = grads(sharded.shards, specs)
        finally:
            sequence.checkpoint = checkpoint
        gathers[0] = 0
        with torch.no_grad():
            sequence.forward_train_sp(sharded.shards, cfg, g["x"], g["t"],
                                      s["ctx"], rope, mesh,
                                      param_specs=specs)
        out["no_grad_gathers"] = gathers[0]
    finally:
        fsdp._View.materialize = materialize
    return out


def _leaves(t):
    from self_forcing_tpu_torch.utils import tree
    return tree.leaves(t)


def _layout_checks(inp: dict, mesh) -> dict:
    """shard_params then a gather (exact), shard_batch's split,
    setup_mesh on the tiny config (and under no_shard)."""
    from self_forcing_tpu_torch import train
    full = inp["models"]["gen"]
    sharded = mesh_mod.shard_params(full, mesh, min_size=1024)
    back = sharded.full()
    exact = all(torch.equal(a, b) for a, b in zip(_leaves(full),
                                                  _leaves(back)))
    batch = {"context": torch.arange(8.0).reshape(8, 1).expand(8, 4),
             "odd": torch.ones(3, 2), "prompts": ["a"]}
    sb = train.shard_batch(batch, mesh)
    config = Config({"model_size": "tiny", "seed": 0,
                     "fsdp_min_param_size": 1024})
    cfg, g, f, r = train.build_models(config, torch.float32,
                                      torch.device("cpu"))
    m, g, f, r = train.setup_mesh(config, g, f, r, "cpu")
    big = [sp for t, sp in zip(_leaves(g.full()), g.spec_list())
           if t.numel() >= 1024]
    m2, *_ = train.setup_mesh(Config(dict(config, sharding_strategy=
                                          "no_shard")), {}, {}, {}, "cpu")
    rep = mesh_mod.replicate({"a": torch.full((3,), float(
        torch.distributed.get_rank()))}, mesh)
    return {"exact": exact, "context": sb["context"], "odd": sb["odd"],
            "prompts": sb["prompts"],
            "mesh_shape": mesh_mod.mesh_shape(m),
            "sharded_fraction": sum(sp is not None for sp in big)
            / max(len(big), 1), "no_shard": m2 is None,
            "replicated": rep["a"]}


def training_worker(rank: int, world: int, inp_path: str,
                    out_dir: str) -> None:
    """The parallel-training checks on two gloo ranks: layouts, the
    trainers on an fsdp-2 mesh, the cache constraint, tp-2 gradients, the
    sp-2 ZeRO-3 teacher (forward, gradients, a DMD and a SiD step), the
    CLI (DMD on fsdp 2, SiD on sp 2)."""
    from self_forcing_tpu_torch import train
    inp = torch.load(inp_path, weights_only=False)
    out = {}
    mesh = mesh_mod.create_mesh(dp=1, fsdp=world, sp=1, device_type="cpu")
    out["layout"] = _layout_checks(inp, mesh)
    out["trainers"] = training_cases(inp, mesh)
    out["rollout"] = {c: _rollout_case(inp, mesh, c) for c in (False, True)}
    out["tp"] = _tp_grads(inp)
    sp_mesh = mesh_mod.create_mesh(dp=1, fsdp=1, sp=world,
                                   device_type="cpu")
    out["sp"] = _sp_zero3(inp, sp_mesh)
    out["sp_grads"] = _sp_grads(inp, sp_mesh)
    out["sp_trainers"] = training_cases({"cases": inp["sp_cases"],
                                         "models": inp["models"]}, sp_mesh)
    train.main(inp["cli_argv"])
    train.main(inp["cli_sid_argv"])
    _save(out, out_dir, rank)


def hang_worker(rank: int, world: int, skip_collective: bool) -> None:
    """Hangs: rank 0 enters a barrier that rank 1 never joins
    (``skip_collective``), or every rank sleeps past its time limit."""
    if rank == 0 and skip_collective:
        dist.barrier()
    time.sleep(120)
