"""The port's pose conditioning against the JAX package on the CPU, float32:
``dwpose_embedding`` at [1, 3, 12, 64, 96] and ``randomref_embedding`` at
[1, 3, 64, 96] within 1e-5 relative L2 (JAX's weights DHWIO / HWIO, the
port's OIDHW / OIHW); ``load_pose_embedding_weights`` on a hand-built
UniAnimate state dict gives JAX's trees in torch's layouts, and
``export_pose_state_dict`` round-trips through both loaders;
``pose_tokens_for_block`` and its coverage error; and the DiT's
``forward_inference`` and ``forward_train`` with ``add_condition`` (pose
tokens through ``pose_proj``) and ``y`` on a y-consuming WAN_TINY variant
(in_dim 36, so the channel concat runs) within 1e-5 relative L2, the
teacher-forcing path with pose tokens on the noisy half only."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import conditioning as jcond
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.ops.masks import teacher_forcing_mask as j_tf_mask
from self_forcing_tpu_torch import conditioning as tcond
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.ops.masks import teacher_forcing_mask
from self_forcing_tpu_torch.params import params_from_jax

TOL = 1e-5
B, C, H, W = 1, 16, 8, 8
FS = (H // 2) * (W // 2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _to_torch(layers, conv3d):
    """JAX's DHWIO / HWIO conv trees in torch's OIDHW / OIHW."""
    perm = (4, 3, 0, 1, 2) if conv3d else (3, 2, 0, 1)
    return {"layers": [{"w": torch.from_numpy(np.asarray(p["w"]).transpose(
        perm).copy()), "b": torch.from_numpy(np.array(p["b"]))}
        for p in layers["layers"]]}


def test_dwpose_embedding_matches_jax():
    jp = jcond.init_dwpose_params(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).uniform(
        0, 1, (1, 3, 12, 64, 96)).astype(np.float32)
    want = np.asarray(jcond.dwpose_embedding(jp, jnp.asarray(x)))
    got = tcond.dwpose_embedding(_to_torch(jp, True), torch.from_numpy(x))
    # 12 pose frames -> 3 latent frames; 64x96 -> 4x6
    assert got.shape == want.shape == (1, 5120, 3, 4, 6)
    assert _rel(got.numpy(), want) <= TOL


def test_randomref_embedding_matches_jax():
    jp = jcond.init_randomref_params(jax.random.PRNGKey(1))
    x = np.random.default_rng(1).uniform(0, 1, (1, 3, 64, 96)).astype(
        np.float32)
    want = np.asarray(jcond.randomref_embedding(jp, jnp.asarray(x)))
    got = tcond.randomref_embedding(_to_torch(jp, False), torch.from_numpy(x))
    assert got.shape == want.shape == (1, 20, 8, 12)
    assert _rel(got.numpy(), want) <= TOL


def _unianimate_state_dict(seed, dtype=torch.float32, randomref=True):
    """A UniAnimate checkpoint's pose keys (Sequential indices skip the
    SiLUs), OIDHW / OIHW, plus a key of another module."""
    g = torch.Generator().manual_seed(seed)
    sd, cin = {}, 3
    for i, (cout, kern, _) in enumerate(tcond._DWPOSE_LAYERS):
        sd[f"dwpose_embedding.{2 * i}.weight"] = torch.randn(
            cout, cin, *kern, generator=g).to(dtype)
        sd[f"dwpose_embedding.{2 * i}.bias"] = torch.randn(
            cout, generator=g).to(dtype)
        cin = cout
    cin = 3
    for i, (cout, k, _) in enumerate(tcond._RANDOMREF_LAYERS):
        if not randomref:
            break
        sd[f"randomref_embedding_pose.{2 * i}.weight"] = torch.randn(
            cout, cin, k, k, generator=g).to(dtype)
        sd[f"randomref_embedding_pose.{2 * i}.bias"] = torch.randn(
            cout, generator=g).to(dtype)
        cin = cout
    sd["blocks.0.self_attn.q.lora_A.weight"] = torch.zeros(4, 4)
    return sd


@pytest.mark.parametrize("dtype,randomref", [(torch.float32, True),
                                             (torch.bfloat16, True),
                                             (torch.float32, False)])
def test_load_pose_embedding_weights_matches_jax(dtype, randomref):
    sd = _unianimate_state_dict(2, dtype, randomref)
    jdw, jrr = jcond.load_pose_embedding_weights(sd)
    tdw, trr = tcond.load_pose_embedding_weights(sd, device="cpu")
    assert len(tdw["layers"]) == len(jdw["layers"]) == 7
    for got, want, conv3d in ((tdw, jdw, True), (trr, jrr, False)):
        if not randomref and not conv3d:
            assert got is None and want is None
            continue
        conv = _to_torch(want, conv3d)
        for g_, w_ in zip(got["layers"], conv["layers"]):
            assert g_["w"].dtype == torch.float32
            assert torch.equal(g_["w"], w_["w"])
            assert torch.equal(g_["b"], w_["b"])


def test_export_pose_state_dict_round_trips():
    """The export's keys are a UniAnimate checkpoint's: the port's loader
    and the JAX package's read back the trees that were exported."""
    dw = tcond.init_dwpose_params(5, device="cpu")
    rr = tcond.init_randomref_params(6, device="cpu")
    sd = tcond.export_pose_state_dict(dw, rr)
    assert set(sd) == set(_unianimate_state_dict(0)) - {
        "blocks.0.self_attn.q.lora_A.weight"}
    got = tcond.load_pose_embedding_weights(sd, device="cpu")
    jgot = jcond.load_pose_embedding_weights(sd)
    for mine, back, jback, conv3d in ((dw, got[0], jgot[0], True),
                                      (rr, got[1], jgot[1], False)):
        for a, b, c in zip(mine["layers"], back["layers"],
                           _to_torch(jback, conv3d)["layers"]):
            for k in ("w", "b"):
                assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])


def test_pose_tokens_for_block_matches_jax():
    emb = np.random.default_rng(3).standard_normal(
        (1, 8, 5, 2, 3)).astype(np.float32)
    for start, n in ((0, 1), (1, 3), (3, 2)):
        want = np.asarray(jcond.pose_tokens_for_block(jnp.asarray(emb),
                                                      start, n))
        got = tcond.pose_tokens_for_block(torch.from_numpy(emb), start, n)
        assert got.shape == want.shape == (1, n * 6, 8)
        np.testing.assert_array_equal(got.numpy(), want)
    for mod, arr in ((tcond, torch.from_numpy(emb)),
                     (jcond, jnp.asarray(emb))):
        with pytest.raises(ValueError, match="fewer frames than required"):
            mod.pose_tokens_for_block(arr, 4, 2)


def test_prepare_dwpose_input_matches_jax():
    data = np.random.default_rng(4).integers(0, 256, (1, 3, 5, 16, 16),
                                             dtype=np.uint8)
    want = np.asarray(jcond.prepare_dwpose_input(jnp.asarray(data)))
    got = tcond.prepare_dwpose_input(torch.from_numpy(data))
    assert got.dtype == torch.float32 and got.shape == (1, 3, 8, 16, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def _conditioned_model(seed, in_dim):
    """Perturbed float32 JAX weights (the zero output layer made random)
    of a WAN_TINY with ``in_dim`` input channels and ``pose_proj``."""
    cfg_j = dataclasses.replace(J_TINY, in_dim=in_dim)
    cfg_t = dataclasses.replace(WAN_TINY, in_dim=in_dim)
    rng = np.random.default_rng(seed)
    jp = jdit.init_params(jax.random.PRNGKey(seed), cfg_j, jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32), jp)
    assert "pose_proj" in jp
    return cfg_j, cfg_t, jp, params_from_jax(jp, "dit", device="cpu")


def _inputs(seed, frames, y_ch=20):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, frames, C, H, W)).astype(np.float32)
    y = rng.standard_normal((B, frames, y_ch, H, W)).astype(np.float32)
    pose = rng.standard_normal((B, frames * FS, 5120)).astype(np.float32)
    ctx = rng.standard_normal((B, 12, WAN_TINY.text_dim)).astype(np.float32)
    return x, y, pose, ctx


def test_forward_inference_with_pose_and_y_matches_jax():
    cfg_j, cfg_t, jp, tp = _conditioned_model(10, 36)
    jrope, trope = JRope.create(cfg_j.head_dim), TRope.create(
        cfg_t.head_dim, device="cpu")
    jcache = jdit.init_kv_cache(cfg_j, B, FS, 21, jnp.float32)
    tcache = tdit.init_kv_cache(cfg_t, B, FS, 21, torch.float32, "cpu")
    ctx = _inputs(11, 3)[3]
    jctx_in = jdit.precompute_context(jp, cfg_j, jnp.asarray(ctx))
    tctx_in = tdit.precompute_context(tp, cfg_t, torch.from_numpy(ctx))
    t = np.full((B, 3), 500.0, np.float32)
    for chunk, start in enumerate((0, 3)):   # the second reads the first
        x, y, pose, _ = _inputs(12 + chunk, 3)
        jflow, jcache = jdit.forward_inference(
            jp, cfg_j, jnp.asarray(x), jnp.asarray(t), jctx_in, jcache,
            jnp.int32(start + 2), jrope, y=jnp.asarray(y),
            add_condition=jnp.asarray(pose), cache_start_frame=start)
        tflow, tcache = tdit.forward_inference(
            tp, cfg_t, torch.from_numpy(x), torch.from_numpy(t), tctx_in,
            tcache, start + 2, trope, cache_start_frame=start,
            y=torch.from_numpy(y), add_condition=torch.from_numpy(pose))
        assert tflow.shape == (B, 3, C, H, W)
        assert _rel(tflow.numpy(), np.asarray(jflow)) <= TOL
    # the conditioning reached the cache: the same chunk without it differs
    bare, _ = tdit.forward_inference(
        tp, cfg_t, torch.from_numpy(x), torch.from_numpy(t), tctx_in,
        tdit.reset_kv_cache(tcache), 5, trope, cache_start_frame=3,
        y=torch.zeros_like(torch.from_numpy(y)), write_cache=False)
    assert _rel(bare.numpy(), np.asarray(jflow)) > 1e-3


@pytest.mark.parametrize("case", ["bidirectional", "teacher_forcing"])
def test_forward_train_with_pose_matches_jax(case):
    """Cache-free: pose tokens and y on the in_dim 36 model; teacher
    forcing (no y: the clean half has only the latent's channels): pose
    tokens on the noisy half of a t2v model."""
    tf = case == "teacher_forcing"
    cfg_j, cfg_t, jp, tp = _conditioned_model(20, C if tf else 36)
    jrope, trope = JRope.create(cfg_j.head_dim), TRope.create(
        cfg_t.head_dim, device="cpu")
    x, y, pose, ctx = _inputs(21, 2)
    t = np.array([[750.0, 250.0]], np.float32)
    kw_j = dict(add_condition=jnp.asarray(pose), remat=False)
    kw_t = dict(add_condition=torch.from_numpy(pose), remat=False)
    jmask = tmask = None
    if tf:
        clean = np.random.default_rng(22).standard_normal(x.shape).astype(
            np.float32)
        jmask, tmask = j_tf_mask(2, FS, 1), teacher_forcing_mask(2, FS, 1)
        kw_j["clean_x"], kw_t["clean_x"] = jnp.asarray(clean), \
            torch.from_numpy(clean)
    else:
        kw_j["y"], kw_t["y"] = jnp.asarray(y), torch.from_numpy(y)
    want = np.asarray(jdit.forward_train(jp, cfg_j, jnp.asarray(x),
                                         jnp.asarray(t), jnp.asarray(ctx),
                                         jmask, jrope, **kw_j))
    got = tdit.forward_train(tp, cfg_t, torch.from_numpy(x),
                             torch.from_numpy(t), torch.from_numpy(ctx),
                             tmask, trope, **kw_t)
    assert got.shape == want.shape == (B, 2, C, H, W)
    assert _rel(got.detach().numpy(), want) <= TOL
