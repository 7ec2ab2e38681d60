"""The port's sequence parallelism (``self_forcing_tpu_torch/parallel/
sequence.py``) against the JAX package's on the conftest's 8-device CPU
mesh: four gloo ranks (``tests/torch_parallel_workers.py``, spawned once
for the module) on an sp = 4 mesh, the JAX side on ``create_mesh(dp=1,
fsdp=2, sp=4)``, on the JAX sequence-parallel tests' geometry (dim 128,
2 heads of 64, ffn 256, 2 layers; float32), weights handed across with
``params_from_jax``.  Tolerances: the ring attention 2e-5 against the
dense attention, the forwards and the 2-step ``WanT2V`` 5e-4 (the JAX
package's own, tests/test_sequence_parallel.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from self_forcing_tpu import wan_generate as jgen
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WanConfig as JConfig
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.ops.attention import dense_attention
from self_forcing_tpu.parallel.mesh import create_mesh
from self_forcing_tpu.parallel.sequence import forward_train_sp
from self_forcing_tpu_torch.parallel import launch
from self_forcing_tpu_torch.params import params_from_jax

KW = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, text_dim=64,
          freq_dim=32)
I2V = dict(KW, model_type="i2v", in_dim=36)
B, C, H, W = 1, 16, 8, 8
# name: (config, frames, i2v inputs); 6 frames pad to 8 at sp 4
CASES = {"t2v": (KW, 8, False), "i2v": (I2V, 8, True),
         "padded": (KW, 6, False)}
RING_TOL, TOL = 2e-5, 5e-4


def _params(cfg, seed):
    """JAX init with the zero output layer drawn, so that the flow depends
    on every layer."""
    p = jdit.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    p["head"]["head"]["w"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(seed + 9), p["head"]["head"]["w"].shape)
    return jax.tree.map(np.asarray, p)


def _jit_sp(mesh):
    """The JAX package's ``forward_train_sp`` jitted once per config (its
    shard_map dispatched op by op is slow on the CPU)."""
    cache = {}

    def fn(params, cfg, x, t, ctx, rope, mesh_, axis="sp", y=None,
           clip_fea=None):
        if cfg not in cache:
            cache[cfg] = jax.jit(
                lambda p, x, t, c, y, cf: forward_train_sp(
                    p, cfg, x, t, c, rope, mesh, axis, y=y, clip_fea=cf))
        return cache[cfg](params, x, t, ctx, y, clip_fea)

    return fn


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    torch.set_num_threads(2)
    d = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    T = lambda a: torch.tensor(np.asarray(a))   # noqa: E731
    qkv = [rng.standard_normal((1, 32, 2, 16)).astype(np.float32)
           for _ in range(3)]
    cases = {}
    for i, (name, (kw, frames, i2v)) in enumerate(CASES.items()):
        cfg = JConfig(**kw)
        case = {"cfg": kw, "jcfg": cfg, "jparams": _params(cfg, i),
                "x": rng.standard_normal((B, frames, C, H, W)).astype(
                    np.float32),
                "t": np.full((B, frames), 500.0, np.float32),
                "ctx": rng.standard_normal((B, 8, 64)).astype(np.float32)}
        if i2v:
            case["y"] = rng.standard_normal((B, frames, 20, H, W)).astype(
                np.float32)
            case["clip"] = rng.standard_normal((B, 257, 1280)).astype(
                np.float32)
        cases[name] = case
    gen_cfg = JConfig(**KW)
    gen = {"cfg": KW, "jparams": _params(gen_cfg, 7),
           "ctx": rng.standard_normal((1, 8, 64)).astype(np.float32),
           "neg": rng.standard_normal((1, 8, 64)).astype(np.float32),
           "noise": np.asarray(jax.random.normal(
               jax.random.PRNGKey(0), (1, 8, C, H, W), jnp.float32)),
           "size": (64, 64), "frame_num": 29, "steps": 2}
    sp_cases = {n: {k: (params_from_jax(v, "dit", "cpu") if k == "jparams"
                        else T(v) if isinstance(v, np.ndarray) else v)
                    for k, v in c.items() if k != "jcfg"}
                for n, c in cases.items()}
    for c in sp_cases.values():
        c["params"] = c.pop("jparams")
    torch.save({"qkv": [T(a) for a in qkv], "sp_cases": sp_cases,
                "generate": {"cfg": KW, "size": gen["size"],
                             "frame_num": gen["frame_num"],
                             "steps": gen["steps"],
                             "params": params_from_jax(gen["jparams"], "dit",
                                                       "cpu"),
                             "ctx": T(gen["ctx"]), "neg": T(gen["neg"]),
                             "noise": T(gen["noise"])}}, d / "inp.pt")
    ranks = launch.start(workers.sp_worker, 4, "gloo", str(d / "inp.pt"),
                         str(d), timeout=workers.RANKS_TIMEOUT)

    mesh = create_mesh(dp=1, fsdp=2, sp=4)
    sp_fn = _jit_sp(mesh)
    jref = {"ring": np.asarray(dense_attention(*qkv))}
    for name, c in cases.items():
        rope = JRope.create(c["jcfg"].head_dim)
        jref[name] = np.asarray(sp_fn(
            c["jparams"], c["jcfg"], c["x"], c["t"], c["ctx"], rope, mesh,
            y=c.get("y"), clip_fea=c.get("clip")))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgen, "forward_train_sp", sp_fn)
        model = jgen.WanT2V(gen["jparams"], gen_cfg, mesh=mesh)
        jref["generate"] = np.asarray(model.generate(
            "", size=gen["size"], frame_num=gen["frame_num"],
            sampling_steps=gen["steps"], context=gen["ctx"],
            neg_context=gen["neg"], seed=0))
    ranks.join()
    out = [torch.load(d / f"rank{r}.pt", weights_only=True)
           for r in range(4)]
    return out, jref


def test_ring_attention_matches_dense(run):
    ranks, jref = run
    got = np.concatenate([r["ring"].numpy() for r in ranks], axis=1)
    np.testing.assert_allclose(got, jref["ring"], rtol=RING_TOL,
                               atol=RING_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_train_sp_matches_jax(run, name):
    """t2v, i2v (``y`` concatenated, ``clip_fea`` replicated) and 6 frames
    padded to 8: every rank returns the whole prediction."""
    ranks, jref = run
    for r in ranks:
        assert tuple(r[name].shape) == jref[name].shape
        np.testing.assert_allclose(r[name].numpy(), jref[name], rtol=TOL,
                                   atol=TOL)


def test_wan_t2v_sp_route_matches_jax(run):
    ranks, jref = run
    for r in ranks:
        assert tuple(r["generate"].shape) == jref["generate"].shape
        np.testing.assert_allclose(r["generate"].numpy(), jref["generate"],
                                   rtol=TOL, atol=TOL)


def test_wan_t2v_needs_an_sp_dimension():
    from self_forcing_tpu_torch.models.wan.configs import WanConfig
    from self_forcing_tpu_torch.wan_generate import WanT2V
    p = params_from_jax(_params(JConfig(**KW), 3), "dit", "cpu")
    with pytest.raises(ValueError, match="'sp' dimension"):
        WanT2V(p, WanConfig(**KW), mesh=object())
