"""The port's data-prep scripts (``self_forcing_tpu_torch/scripts``)
against the JAX package's on the CPU:

- ``create_shards_iterative``, ``create_sharded_dataset`` and
  ``create_pose_shards``: the port's shards read back row-equal by the
  JAX package's datasets and the JAX scripts' shards by the port's, the
  files byte-equal;
- ``merge_lora``: the merged tree equal to the JAX package's
  ``convert_dit_state_dict`` + ``load_lora_weights`` + ``merge_lora``;
- ``generate_ode_pairs``: the CFG x0 step against the JAX script's step
  at WAN_TINY (1e-4), and the saved snapshots;
- ``python -m self_forcing_tpu_torch.train`` on a tiny pose-distillation
  config over pose shards the port's script wrote: two steps, finite
  logs, ``pose_proj`` moved.
"""
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from self_forcing_tpu import lora as jlora
from self_forcing_tpu.data import datasets as jds
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.scheduler import FlowMatchScheduler as JSched
from self_forcing_tpu.utils import checkpoints as jckpt
from self_forcing_tpu_torch import train
from self_forcing_tpu_torch.data import datasets as tds
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.scheduler import FlowMatchScheduler as TSched
from self_forcing_tpu_torch.scripts import create_pose_shards as tpose
from self_forcing_tpu_torch.scripts import create_sharded_dataset as tsharded
from self_forcing_tpu_torch.scripts import create_shards_iterative as titer
from self_forcing_tpu_torch.scripts import generate_ode_pairs as tgop
from self_forcing_tpu_torch.scripts import merge_lora as tmerge
from self_forcing_tpu_torch.utils import checkpoints as tckpt
from self_forcing_tpu_torch.utils import tree


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: under the suite's six
    workers the default (one a core) oversubscribes the machine, and the
    idle threads' spinning slowed these tests ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, C, H, W = 1, 16, 8, 8


def _jax_script(name):
    """A root ``scripts/`` module, loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax(name, argv):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [name] + argv)
        _jax_script(name).main()


def _pairs(d):
    """Three pair files: two prompts (one repeated, which the scripts
    skip), two samples in one file."""
    rng = np.random.default_rng(1)
    os.makedirs(d)
    for i, (prompt, n) in enumerate((("a fox", 2), ("a cat", 1),
                                     ("a fox", 1))):
        np.savez(os.path.join(d, f"{i:05d}.npz"), prompt=prompt,
                 latents=rng.standard_normal((n, 5, 2, C, 4, 4)).astype(
                     np.float16))


def _pose_samples(d):
    """Three pose samples with images; latents float32, which the script
    stores as fp16.  (A sample without the images beside ones with them
    gets no rows of theirs while its shard gets their shape headers: both
    packages' datasets then raise on its row.)"""
    rng = np.random.default_rng(2)
    os.makedirs(d)
    for i in range(3):
        arrays = {"latents": rng.standard_normal((2, C, 4, 4)).astype(
                      np.float32),
                  "dwpose_data": rng.integers(0, 256, (3, 5, 32, 48),
                                              dtype=np.uint8)}
        arrays.update(
            random_ref_dwpose=rng.integers(0, 256, (32, 48, 3),
                                           dtype=np.uint8),
            first_frame=rng.integers(0, 256, (32, 48, 3), dtype=np.uint8))
        np.savez(os.path.join(d, f"{i:05d}.npz"), prompt=f"dance {i}",
                 **arrays)


def _same_items(a, b):
    assert len(a) == len(b)
    for i in range(len(a)):
        x, y = a[i], b[i]
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], str):
                assert x[k] == y[k]
            else:
                np.testing.assert_array_equal(np.asarray(x[k]),
                                              np.asarray(y[k]), err_msg=k)


def _files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".rs"))


@pytest.mark.parametrize("script", ["create_shards_iterative",
                                    "create_sharded_dataset",
                                    "create_pose_shards"])
def test_shard_scripts_match_jax(tmp_path, script):
    """Both scripts over the same inputs: byte-equal files, and each
    package's dataset reads the other's rows equal to its own."""
    src = str(tmp_path / "src")
    (_pose_samples if script == "create_pose_shards" else _pairs)(src)
    outs = {}
    for side in ("jax", "port"):
        out = str(tmp_path / side)
        if script == "create_shards_iterative":
            argv = ["--data_path", src, "--output_path",
                    os.path.join(out, "ode.rs")]
        else:
            argv = ["--data_path", src, "--output_dir", out,
                    "--rows_per_shard", "2"]
        if side == "jax":
            _run_jax(script, argv)
        else:
            {"create_shards_iterative": titer, "create_sharded_dataset":
             tsharded, "create_pose_shards": tpose}[script].main(argv)
        outs[side] = out
    names = _files(outs["jax"])
    assert names == _files(outs["port"]) and names
    for n in names:
        with open(os.path.join(outs["jax"], n), "rb") as a, \
                open(os.path.join(outs["port"], n), "rb") as b:
            assert a.read() == b.read(), n
    if script == "create_shards_iterative":
        path = lambda side: os.path.join(outs[side], "ode.rs")
        jcls, tcls = jds.ODERegressionDataset, tds.ODERegressionDataset
    else:
        path = lambda side: outs[side]
        jcls, tcls = ((jds.PoseShardingDataset, tds.PoseShardingDataset)
                      if script == "create_pose_shards" else
                      (jds.ShardingDataset, tds.ShardingDataset))
    # each package reads the other's files
    _same_items(tcls(path("jax")), jcls(path("port")))
    rows = tcls(path("port"))
    assert len(rows) == (3 if script == "create_pose_shards" else 3)
    if script == "create_pose_shards":
        assert "first_frame" in rows[0] and rows[2]["dwpose_data"].shape == (
            3, 5, 32, 48)


def test_merge_lora_matches_jax(tmp_path):
    """``merge_lora.main`` (the 1.3B config swapped for a 2-layer tiny one)
    on a base checkpoint and a LoRA file: the saved generator equals the
    JAX package's merge of the same files in bf16, and the float32 merge
    agrees with JAX's float32 merge."""
    cfg = dataclasses.replace(WAN_TINY, num_layers=2)
    base = tdit.init_params(cfg, seed=5, dtype=torch.float32, device="cpu")
    base_sd = tckpt.export_dit_state_dict(base, cfg)
    rng = np.random.default_rng(6)
    lora_sd = {}
    for i in range(2):
        for name, (din, dout) in (("self_attn.q", (cfg.dim, cfg.dim)),
                                  ("self_attn.k", (cfg.dim, cfg.dim)),
                                  ("cross_attn.o", (cfg.dim, cfg.dim)),
                                  ("ffn.2", (cfg.ffn_dim, cfg.dim))):
            lora_sd[f"diffusion_model.blocks.{i}.{name}.lora_A.weight"] = \
                torch.from_numpy(rng.standard_normal((8, din)).astype(
                    np.float32))
            lora_sd[f"diffusion_model.blocks.{i}.{name}.lora_B.weight"] = \
                torch.from_numpy(rng.standard_normal((dout, 8)).astype(
                    np.float32) * 0.1)
    torch.save(base_sd, tmp_path / "base.pth")
    torch.save(lora_sd, tmp_path / "lora.pt")
    out = str(tmp_path / "merged.pt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmerge, "WAN_1_3B", cfg)
        tmerge.main(["--base", str(tmp_path / "base.pth"), "--lora",
                     str(tmp_path / "lora.pt"), "--output", out,
                     "--alpha", "4", "--model", "1.3b"])
    got = tckpt.restore_pytree(out)["generator"]
    for dtype, jdtype in ((None, jnp.bfloat16), (torch.float32,
                                                  jnp.float32)):
        want = jlora.merge_lora(jlora.load_lora_weights(
            jckpt.convert_dit_state_dict(base_sd, J_TINY, dtype=jdtype),
            lora_sd, alpha=4.0, head_dim=cfg.head_dim))
        if dtype is not None:
            got = tmerge.merge(base_sd, lora_sd, cfg, 4.0, dtype=dtype)
        flat = {tuple(k.key for k in p): v for p, v in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        mine = dict(tree.items(got))
        assert set(mine) == set(flat)
        assert not any("lora_A" in p for p in mine)
        for p, v in mine.items():
            w = np.asarray(flat[p], np.float32)
            if dtype is None:
                np.testing.assert_array_equal(v.float().numpy(), w,
                                              err_msg=str(p))
            else:
                np.testing.assert_allclose(v.numpy(), w, rtol=1e-6,
                                           atol=1e-6, err_msg=str(p))
    q0 = base["blocks"]["self_attn"]["q"]["w"]
    assert not torch.equal(got["blocks"]["self_attn"]["q"]["w"], q0)


def test_generate_ode_pairs_matches_jax(tmp_path):
    """One CFG x0 step (guidance 6) of the bidirectional WAN_TINY teacher
    at each of the 4-step schedule's timesteps against the JAX script's
    step; then ``generate_pairs`` writes an .npz a prompt with the chosen
    snapshots."""
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng
                      .standard_normal(np.shape(a)).astype(np.float32),
                      jdit.init_params(jax.random.PRNGKey(8), J_TINY,
                                       dtype=jnp.float32, causal=False))
    tp = params_from_jax(jp, "dit", device="cpu")
    latents = rng.standard_normal((B, 2, C, H, W)).astype(np.float32)
    ctx, neg = (rng.standard_normal((B, 8, J_TINY.text_dim)).astype(
        np.float32) for _ in range(2))
    jsched = JSched.create(4, shift=8.0, extra_one_step=True)
    tsched = TSched.create(4, shift=8.0, extra_one_step=True, device="cpu")
    jrope = JRope.create(J_TINY.head_dim)

    @jax.jit
    def jstep(latents, t_val):
        # the JAX script's cfg_x0_step
        Bn, F = latents.shape[:2]
        t = jnp.full((Bn, F), t_val, jnp.float32)
        flat = lambda a: a.reshape((Bn * F,) + a.shape[2:])
        flow_c = jdit.forward_train(jp, J_TINY, latents, t, ctx, None, jrope,
                                    remat=False)
        flow_u = jdit.forward_train(jp, J_TINY, latents, t, neg, None,
                                    jrope, remat=False)
        x0_c = jsched.convert_flow_pred_to_x0(flat(flow_c), flat(latents),
                                              t.reshape(-1))
        x0_u = jsched.convert_flow_pred_to_x0(flat(flow_u), flat(latents),
                                              t.reshape(-1))
        x0 = x0_u + 6.0 * (x0_c - x0_u)
        flow = jsched.convert_x0_to_flow_pred(x0, flat(latents),
                                              t.reshape(-1))
        return jsched.step(flow, jnp.broadcast_to(t_val, (Bn * F,)),
                           flat(latents)).reshape(latents.shape)

    trope = TRope.create(WAN_TINY.head_dim, device="cpu")
    np.testing.assert_array_equal(tsched.timesteps.numpy(),
                                  np.asarray(jsched.timesteps))
    for t_val in np.asarray(jsched.timesteps):
        want = jstep(latents, jnp.float32(t_val))
        got = tgop.cfg_x0_step(tp, WAN_TINY, trope, tsched,
                               torch.from_numpy(latents), float(t_val),
                               torch.from_numpy(ctx), torch.from_numpy(neg),
                               6.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)

    def encode(prompts):
        return torch.from_numpy(ctx if prompts != ["neg"] else neg)
    out = str(tmp_path / "pairs")
    times = tgop.generate_pairs(tp, WAN_TINY, encode, ["a fox", "a cat"],
                                out, "neg", num_steps=3,
                                snapshots=[0, 1, -1],
                                latent_shape=(B, 2, C, H, W), device="cpu")
    assert len(times) == 2 and sorted(os.listdir(out)) == ["00000.npz",
                                                           "00001.npz"]
    d = np.load(os.path.join(out, "00001.npz"))
    assert str(d["prompt"]) == "a cat"
    assert d["latents"].shape == (B, 3, 2, C, H, W)
    assert d["latents"].dtype == np.float16
    g = torch.Generator().manual_seed(1)
    np.testing.assert_array_equal(
        d["latents"][:, 0], torch.randn((B, 2, C, H, W), generator=g)
        .half().numpy())
    rows = list(titer.unique_rows(titer.pair_files(out)))
    assert [p for p, _ in rows] == ["a fox", "a cat"]


def test_train_cli_pose_distillation(tmp_path):
    """``train.main`` on a tiny copy of ``self_forcing_dmd.yaml`` with pose
    conditioning (LoRA rank 8, pose dropout 0.1, update ratio 2) over
    pose shards that ``create_pose_shards`` wrote: three steps (the
    generator and the critic, the critic, both again: the score models'
    output layers start at zero, so the generator's first DMD gradient is
    zero and its second is not), finite logs, and the generator's
    pose_proj moved."""
    samples = str(tmp_path / "samples")
    os.makedirs(samples)
    rng = np.random.default_rng(9)
    for i in range(2):
        np.savez(os.path.join(samples, f"{i}.npz"), prompt=f"dance {i}",
                 latents=rng.standard_normal((2, C, H, W)).astype(
                     np.float16),
                 dwpose_data=rng.integers(0, 256, (3, 5, 8 * H, 8 * W),
                                          dtype=np.uint8),
                 random_ref_dwpose=rng.integers(0, 256, (8 * H, 8 * W, 3),
                                                dtype=np.uint8))
    tpose.main(["--data_path", samples, "--output_dir",
                str(tmp_path / "shards")])
    with open(os.path.join(REPO, "configs", "self_forcing_dmd.yaml")) as f:
        c = yaml.safe_load(f)
    c.update(model_size="tiny", image_or_video_shape=[B, 2, C, H, W],
             num_training_frames=2, num_frame_per_block=1, lora_rank=8,
             lora_alpha=8, use_pose_conditioning=True, pose_drop_prob=0.1,
             dfake_gen_update_ratio=2, lr=1e-3, lr_critic=1e-3,
             data_path=str(tmp_path / "shards"), mixed_precision=False,
             model_dir=str(tmp_path / "no_models"))
    c.pop("generator_ckpt", None)
    cfg_path = tmp_path / "pose.yaml"
    cfg_path.write_text(yaml.safe_dump(c))
    logdir = tmp_path / "log"
    train.main(["--config_path", str(cfg_path), "--max_steps", "3",
                "--device", "cpu", "--logdir", str(logdir)])
    lines = [json.loads(ln) for ln in
             (logdir / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines] == [0, 1, 2]
    for ln in lines:
        assert all(np.isfinite(v) for v in ln.values()), ln
    assert ["generator_loss" in ln for ln in lines] == [True, False, True]
    assert lines[2]["generator_grad_norm"] > 0
    saved = torch.load(logdir / "final.pt", weights_only=True)["generator"]
    init = tdit.init_params(WAN_TINY, int(c["seed"]), torch.float32, "cpu",
                            causal=True)
    assert not torch.equal(saved["pose_proj"]["w"], init["pose_proj"]["w"])
    assert "lora_A" in saved["blocks"]["self_attn"]["q"]
