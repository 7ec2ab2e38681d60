"""The port's ZeRO-3 layouts and the parallel-training estimates and
utilities against the JAX package, in one process (no ranks):

- ``parallel/mesh.py``'s ``fsdp_shardings``, ``combined_fsdp_specs`` and
  ``spec_component`` pick, leaf by leaf, the dimension and axes the JAX
  package's PartitionSpecs pick: for the tiny tree (min size 1024, as
  ``configs/tiny_test.yaml``) and the Wan-1.3B and Wan-14B shape trees
  (``jax.eval_shape`` on the JAX side, the ``meta`` device on the
  port's) at fsdp 2 / 4 / 8 and fsdp x sp 2 x 4;
- ``cache_specs`` (the rollout cache constraint's layout) against the
  shardings the JAX constraint puts on a cache on the 8-device mesh;
- ``fit.dmd_state_bytes`` (``sp_dmd_fit``'s persistent state) against
  the JAX package's ``aot.per_device_bytes`` over the same specs, at the
  true 1.3B student / 14B teacher shapes on fsdp 4 x sp 4, with and
  without ``teacher_zero3``: exactly equal;
- ``utils/metrics.MetricsLogger`` and ``utils/misc.merge_dict_list``
  against the JAX package's (the records but their time stamps).
"""
import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_1_3B as J13
from self_forcing_tpu.models.wan.configs import WAN_14B as J14
from self_forcing_tpu.models.wan.configs import WAN_TINY as JTINY
from self_forcing_tpu.parallel import aot as jaot
from self_forcing_tpu.parallel import mesh as jmesh
from self_forcing_tpu.utils import metrics as jmetrics
from self_forcing_tpu.utils import misc as jmisc
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import (WAN_1_3B, WAN_14B,
                                                       WAN_TINY)
from self_forcing_tpu_torch.parallel import fit
from self_forcing_tpu_torch.parallel import mesh as tmesh
from self_forcing_tpu_torch.utils import metrics as tmetrics
from self_forcing_tpu_torch.utils import misc as tmisc
from self_forcing_tpu_torch.utils import tree

TREES = {"tiny": (JTINY, WAN_TINY, 1024), "1.3b": (J13, WAN_1_3B, 2 ** 16),
         "14b": (J14, WAN_14B, 2 ** 16)}


@pytest.fixture(scope="module")
def trees():
    """{name: (JAX shape tree, port meta tree, min size)}, causal."""
    out = {}
    for name, (jc, tc, min_size) in TREES.items():
        js = jax.eval_shape(lambda jc=jc: jdit.init_params(
            jax.random.PRNGKey(0), jc, jnp.bfloat16))
        ts = tdit.init_params(tc, dtype=torch.bfloat16, device="meta")
        out[name] = (js, ts, min_size)
    return out


def _keystr(path) -> str:
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _from_partition(entries):
    """(dim, axes) of a PartitionSpec's entries (None: replicated)."""
    for dim, e in enumerate(entries or ()):
        if e is not None:
            return dim, e if isinstance(e, tuple) else (e,)
    return None


def _jax_layout(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, (jax.sharding.PartitionSpec,
                                                jax.sharding.NamedSharding)))
    out = {}
    for path, s in flat[0]:
        spec = s.spec if isinstance(s, jax.sharding.NamedSharding) else s
        out[jax.tree_util.keystr(path)] = _from_partition(tuple(spec))
    return out


def _port_layout(specs) -> dict:
    return {_keystr(p): None if s is None else (s.dim, tuple(s.axes))
            for p, s in tree.items(specs)}


@pytest.mark.parametrize("name", list(TREES))
@pytest.mark.parametrize("fsdp", [2, 4, 8])
def test_fsdp_shardings_match_jax(trees, name, fsdp):
    js, ts, min_size = trees[name]
    mesh = jmesh.create_mesh(fsdp=fsdp, devices=jax.devices()[:fsdp])
    want = _jax_layout(jmesh.fsdp_shardings(js, mesh, min_size=min_size))
    got = _port_layout(tmesh.fsdp_shardings(ts, {"fsdp": fsdp},
                                            min_size=min_size))
    assert got == want
    assert any(v is not None for v in got.values())


@pytest.mark.parametrize("name", list(TREES))
def test_combined_specs_and_sp_component_match_jax(trees, name):
    js, ts, min_size = trees[name]
    mesh = jmesh.create_mesh(dp=1, fsdp=2, sp=4)
    jspecs = jmesh.combined_fsdp_specs(js, mesh, min_size=min_size)
    tspecs = tmesh.combined_fsdp_specs(ts, {"fsdp": 2, "sp": 4},
                                       min_size=min_size)
    assert _port_layout(tspecs) == _jax_layout(jspecs)
    assert _port_layout(tmesh.spec_component(tspecs, "sp")) == \
        _jax_layout(jmesh.spec_component(jspecs, "sp"))


@pytest.mark.parametrize("bn,s", [(8, 16), (6, 16), (8, 15), (3, 7)])
def test_cache_specs_match_jax_constraint(bn, s):
    """The layout the JAX constraint gives a [2, B*N, S, 4] cache on a
    (1, 2, 4) mesh, and the port's (no batch axis split), compared over
    the axes of more than one rank."""
    mesh = jmesh.create_mesh(dp=1, fsdp=2, sp=4)
    cache = jdit.KVCache(k=jnp.zeros((2, bn, s, 4)),
                             v=jnp.zeros((2, bn, s, 4)),
                             global_end=0, local_end=0,
                             kmax=jnp.zeros((2,)))
    out = jax.jit(jmesh.rollout_cache_constraint(mesh))(cache)
    sizes = {"dp": 1, "fsdp": 2, "sp": 4}

    def effective(e):
        # XLA drops the size-1 axes of a sharding it hands back
        axes = () if e is None else (e if isinstance(e, tuple) else (e,))
        return tuple(a for a in axes if sizes[a] > 1) or None
    spec = tuple(out.k.sharding.spec) + (None,) * 4
    got = tmesh.cache_specs(sizes, (2, bn, s, 4))
    assert tuple(effective(e) for e in got) == \
        tuple(effective(e) for e in spec[1:3])


def test_cache_specs_leave_out_the_batch_axes():
    """A batch split over dp x fsdp leaves the cache to the sp ranks,
    which repeat the rows."""
    sizes = {"dp": 1, "fsdp": 2, "sp": 2}
    assert tmesh.cache_specs(sizes, (2, 4, 16, 4)) == (("dp", "sp"),
                                                       ("fsdp",))
    assert tmesh.cache_specs(sizes, (2, 4, 16, 4), ("dp", "fsdp")) == \
        (("sp",), None)


def _duck_bytes(shapes, specs, sizes) -> int:
    """JAX's per_device_bytes over ShapeDtypeStruct-like leaves whose
    sharding names the axes of a mesh of ``sizes`` (fsdp x sp = 16 ranks:
    more than the CPU mesh's 8 devices, and per_device_bytes reads only
    the shapes)."""
    mesh = types.SimpleNamespace(shape=sizes)
    leaves = []
    for s, sp in zip(jax.tree_util.tree_leaves(shapes),
                     jax.tree_util.tree_leaves(
                         specs, is_leaf=lambda x: isinstance(
                             x, jax.sharding.PartitionSpec))):
        leaves.append(types.SimpleNamespace(
            shape=s.shape, dtype=s.dtype,
            sharding=types.SimpleNamespace(spec=sp, mesh=mesh)))
    return jaot.per_device_bytes(leaves)


@pytest.mark.parametrize("zero3", [False, True])
def test_dmd_state_bytes_equal_jax_per_device_bytes(zero3):
    """sp_dmd_fit's state at 1.3B student / 14B teacher, fsdp 4 x sp 4:
    every part equal to JAX's per_device_bytes over its specs (the
    student and critic over ("fsdp", "sp"), the teacher over "fsdp" or,
    with teacher_zero3, over both; Adam: the two moments in the specs
    of the parameters and the replicated int32 count, as
    ``aot._opt_state_structs`` lays out optax's state)."""
    sizes = {"dp": 1, "fsdp": 4, "sp": 4}
    jm = types.SimpleNamespace(shape=sizes)
    both = ("fsdp", "sp")
    key = jax.random.PRNGKey(0)
    gen = jax.eval_shape(lambda: jdit.init_params(
        key, dataclasses.replace(J13, num_frame_per_block=3),
        jnp.bfloat16))
    fake = jax.eval_shape(lambda: jdit.init_params(key, J13, jnp.bfloat16,
                                                   causal=False))
    real = jax.eval_shape(lambda: jdit.init_params(key, J14, jnp.bfloat16,
                                                   causal=False))
    gen_b = _duck_bytes(gen, jmesh.combined_fsdp_specs(gen, jm, both),
                        sizes)
    fake_b = _duck_bytes(fake, jmesh.combined_fsdp_specs(fake, jm, both),
                         sizes)
    if zero3:
        real_b = _duck_bytes(real, jmesh.combined_fsdp_specs(real, jm, both),
                             sizes)
    else:
        mesh = jmesh.create_mesh(fsdp=4, devices=jax.devices()[:4])
        real_b = jaot.per_device_bytes(jax.tree.map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
            real, jmesh.fsdp_shardings(real, mesh)))
    opt = jax.eval_shape(optax.chain(optax.clip_by_global_norm(10.0),
                                     optax.adamw(1e-4)).init, gen)
    moment_trees = [n for n in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda x: jax.tree_util.tree_structure(x)
        == jax.tree_util.tree_structure(gen))
        if jax.tree_util.tree_structure(n)
        == jax.tree_util.tree_structure(gen)]
    scalars = [x for x in jax.tree_util.tree_leaves(opt)
               if x.shape == ()]
    assert len(moment_trees) == 2
    opt_b = 2 * gen_b + sum(x.dtype.itemsize for x in scalars)
    got = fit.dmd_state_bytes(WAN_1_3B, WAN_14B, 4, 4, torch.bfloat16,
                              teacher_zero3=zero3)
    assert got == {"generator_params": gen_b, "generator_opt": opt_b,
                   "fake_score_params": fake_b,
                   "critic_opt": 2 * fake_b + (opt_b - 2 * gen_b),
                   "real_score_params": real_b, "generator_ema": gen_b}
    full = fit.sp_dmd_fit(WAN_1_3B, WAN_14B, 4, 4, teacher_zero3=zero3,
                          limit=80 * 2 ** 30)
    assert full["state_bytes_per_device"] == got
    assert full["total"] == sum(v for k, v in full.items()
                                if k not in ("label", "total", "limit",
                                             "fits",
                                             "state_bytes_per_device"))


def test_metrics_logger_and_merge_match_jax(tmp_path):
    recs = []
    for mod, d in ((jmetrics, tmp_path / "j"), (tmetrics, tmp_path / "t")):
        lg = mod.MetricsLogger(str(d), disable_wandb=True)
        lg.log({"loss": np.float32(0.5), "arr": np.arange(4.0), "n": 3},
               step=7)
        lg.log({"loss": 0.25})
        lg.close()
        recs.append([{k: v for k, v in json.loads(ln).items() if k != "ts"}
                     for ln in (d / "metrics.jsonl").read_text()
                     .splitlines()])
        quiet = mod.MetricsLogger(str(d / "rank1"), is_main=False)
        quiet.log({"loss": 1.0}, step=0)
        quiet.close()
        assert not (d / "rank1").exists()
    assert recs[0] == recs[1]
    video = np.zeros((3, 16, 16, 3), np.float32)
    path = tmetrics.MetricsLogger(str(tmp_path / "v")).log_video(
        "output", video, 5)
    assert path.endswith("videos/output_000005.mp4")
    logs = [{"a": 1.0, "b": np.ones(3)}, {"a": np.float32(3.0),
                                          "b": np.zeros(3), "c": 2}]
    jm, tm = jmisc.merge_dict_list(logs), tmisc.merge_dict_list(logs)
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_array_equal(np.asarray(tm[k]), np.asarray(jm[k]))


def test_train_cli_logs_the_ode_trainers_decoded_videos(tmp_path,
                                                        monkeypatch):
    """``train.main`` on a tiny ODE config whose ``model_dir`` holds a
    VAE (a tiny one, handed in for ``load_wan_models``): step 0's latent
    triplet is decoded and logged as three mp4 files, and
    ``--no_visualize`` logs none."""
    import yaml
    from self_forcing_tpu_torch import inference, train
    from self_forcing_tpu_torch.data.recordstore import (RecordWriter,
                                                         store_arrays,
                                                         write_shape_header)
    from self_forcing_tpu_torch.models.wan import vae as tvae
    rng = np.random.default_rng(3)
    with RecordWriter(str(tmp_path / "ode.rs")) as w:
        lat = rng.standard_normal((2, 5, 3, 16, 8, 8)).astype(np.float16)
        store_arrays(w, {"latents": lat, "prompts": ["a", "b"]})
        write_shape_header(w, "latents", lat.shape)
    (tmp_path / "models").mkdir()
    cfg = {"trainer": "ode", "model_size": "tiny", "num_frame_per_block": 3,
           "lr": 1e-4,
           "denoising_step_list": [1000, 750, 500, 250],
           "image_or_video_shape": [1, 3, 16, 8, 8], "visualize_every": 1,
           "data_path": str(tmp_path / "ode.rs"),
           "model_dir": str(tmp_path / "models")}
    (tmp_path / "ode.yaml").write_text(yaml.safe_dump(cfg))
    params = tvae.init_params(inference.TINY_VAE, 0, device="cpu")
    monkeypatch.setattr(train, "load_wan_models", lambda *a, **k:
                        types.SimpleNamespace(vae_params=params,
                                              vae_cfg=inference.TINY_VAE))
    argv = ["--config_path", str(tmp_path / "ode.yaml"), "--max_steps", "1",
            "--device", "cpu", "--no_save"]
    train.main(argv + ["--logdir", str(tmp_path / "log")])
    names = sorted(p.name for p in (tmp_path / "log" / "videos").iterdir())
    assert names == ["ground_truth_000000.mp4", "input_000000.mp4",
                     "output_000000.mp4"]
    train.main(argv + ["--logdir", str(tmp_path / "quiet"),
                       "--no_visualize"])
    assert not (tmp_path / "quiet" / "videos").exists()
