"""Rank functions of the port's parallel CPU tests, run by
``parallel.launch.spawn`` in gloo process groups.  The children import
this module and the port only (no JAX): each reads its inputs from a
``torch.save`` file and writes its outputs to ``<out_dir>/rank<r>.pt``;
the test process compares them with the JAX package."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from self_forcing_tpu_torch.config import Config
from self_forcing_tpu_torch.models.wan import dit
from self_forcing_tpu_torch.models.wan.configs import WanConfig
from self_forcing_tpu_torch.models.wan.rope import RopeTables
from self_forcing_tpu_torch.ops import attention as attn_ops
from self_forcing_tpu_torch.parallel import mesh as mesh_mod
from self_forcing_tpu_torch.parallel import sequence, tensor
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline)


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
