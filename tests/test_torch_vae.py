"""The port's Wan VAE against the JAX package on the CPU: the streaming
decode (decode_frame for the first frame, then decode_block with the
carried cache), the encoder (encode_chunk with its caches, then encode),
pad_decoder_channels, the streaming decode under the 'pallas' and 'fused'
conv backends, and the parameter bridge of the encoder leaves; weights
crossed over by self_forcing_tpu_torch.params.  float32; tolerance 1e-4
(pad_decoder_channels: 2e-5, as the JAX package's own test).

Under a Pallas backend the JAX side runs its conv kernels with
``interpret=True`` (the entry points patched as tests/test_vae.py does)
and the port's CPU path runs the kernels' plain versions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu.ops import attention as jatt
from self_forcing_tpu.ops import pallas_conv as jpc
from self_forcing_tpu_torch.models.wan import vae as tvae
from self_forcing_tpu_torch.ops import conv as tconv
from self_forcing_tpu_torch.params import params_from_jax

TOL = 1e-4


def _close(out_t, ref_j):
    np.testing.assert_allclose(out_t.numpy(), np.asarray(ref_j), rtol=TOL,
                               atol=TOL)


def test_streaming_decode_matches_jax():
    rng = np.random.default_rng(0)
    cfg = jvae.VAE_TINY
    jp = jvae.init_params(jax.random.PRNGKey(0), cfg)
    # perturb every leaf so the zero-initialised attention projection and
    # the zero biases take part
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    tp = params_from_jax(jp, "vae", device="cpu")
    B, h, w, z = 1, 4, 6, cfg.z_dim
    lat = rng.standard_normal((B, 5, h, w, z)).astype(np.float32)

    jc = jvae.init_decoder_cache(jp, cfg, B, h, w)
    tc = tvae.init_decoder_cache(tp, tvae.VAE_TINY, B, h, w, torch.float32,
                                 "cpu")
    assert [tuple(c.permute(0, 2, 3, 4, 1).shape) for c in tc] == \
        [c.shape for c in jc]

    jy, jc = jvae.decode_frame(jp, cfg, lat[:, :1], jc, first=True)
    ty, tc = tvae.decode_frame(tp, tvae.VAE_TINY, torch.from_numpy(
        lat[:, :1]), tc, first=True)
    assert ty.shape == (B, 1, 8 * h, 8 * w, 3)
    _close(ty, jy)
    # two steady-state blocks: the cache carried from the first frame, then
    # from a whole block
    for lo, hi in ((1, 3), (3, 5)):
        jy, jc = jvae.decode_block(jp, cfg, lat[:, lo:hi], jc, first=False)
        ty, tc = tvae.decode_block(tp, tvae.VAE_TINY,
                                   torch.from_numpy(lat[:, lo:hi]), tc,
                                   first=False)
        assert ty.shape == (B, 4 * (hi - lo), 8 * h, 8 * w, 3)
        _close(ty, jy)
    for a, b in zip(tc, jc):
        _close(a.permute(0, 2, 3, 4, 1), b)


def test_decode_matches_jax():
    rng = np.random.default_rng(1)
    cfg = jvae.VAE_TINY
    jp = jax.tree.map(np.asarray, jvae.init_params(jax.random.PRNGKey(1),
                                                   cfg))
    tp = params_from_jax(jp, "vae", device="cpu")
    lat = rng.standard_normal((1, 3, 4, 4, cfg.z_dim)).astype(np.float32)
    _close(tvae.decode(tp, tvae.VAE_TINY, torch.from_numpy(lat)),
           jvae.decode(jp, cfg, lat))


def _jittered(cfg, seed, rng):
    jp = jvae.init_params(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)


def _caches_close(tc, jc):
    assert len(tc) == len(jc)
    for a, b in zip(tc, jc):
        assert tuple(a.permute(0, 2, 3, 4, 1).shape) == b.shape
        _close(a.permute(0, 2, 3, 4, 1), b)


def test_encoder_matches_jax():
    """encode_chunk (first chunk of 1 frame, then 4) with its caches leaf
    by leaf, including the temporal downsamples' 1-frame slots; then
    encode of the whole 1 + 4-frame clip."""
    rng = np.random.default_rng(2)
    cfg = jvae.VAE_TINY
    jp = _jittered(cfg, 2, rng)
    tp = params_from_jax(jp, "vae", device="cpu")
    B, T, H, W = 1, 5, 16, 24
    px = rng.uniform(-1, 1, (B, T, H, W, 3)).astype(np.float32)
    jc = jvae.init_encoder_cache(jp, cfg, B, H, W)
    tc = tvae.init_encoder_cache(tp, tvae.VAE_TINY, B, H, W, torch.float32,
                                 "cpu")
    _caches_close(tc, jc)
    assert sum(c.shape[2] == 1 for c in tc) == 2   # the downsample slots
    for lo, hi in ((0, 1), (1, 5)):
        jy, jc = jvae.encode_chunk(jp, cfg, px[:, lo:hi], jc,
                                   first=lo == 0)
        ty, tc = tvae.encode_chunk(tp, tvae.VAE_TINY,
                                   torch.from_numpy(px[:, lo:hi]), tc,
                                   first=lo == 0)
        assert ty.shape == (B, 1, H // 8, W // 8, 2 * cfg.z_dim)
        _close(ty, jy)
        _caches_close(tc, jc)
    z = tvae.encode(tp, tvae.VAE_TINY, torch.from_numpy(px))
    assert z.shape == (B, 2, H // 8, W // 8, cfg.z_dim)
    _close(z, jvae.encode(jp, cfg, px))


def test_pad_decoder_channels_exact():
    """The padded decoder decodes what the unpadded one does (2e-5, as
    tests/test_vae.py's test of the JAX rewrite), and its leaves are the
    JAX rewrite's; gammas jittered so the sqrt(C / Cp) compensation
    counts."""
    rng = np.random.default_rng(3)
    cfg = jvae.VAE_TINY
    jp = _jittered(cfg, 3, rng)
    jpad = jax.tree.map(np.asarray, jvae.pad_decoder_channels(jp, align=16))
    tp = params_from_jax(jp, "vae", device="cpu")
    tpad = tvae.pad_decoder_channels(tp, align=16)
    assert tpad["decoder"]["stages"][-1]["blocks"][-1]["conv2"]["w"].shape[
        0] == 16
    for a, b in zip(jax.tree.leaves(params_from_jax(jpad, "vae",
                                                    device="cpu")),
                    jax.tree.leaves(tpad)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    lat = torch.from_numpy(rng.standard_normal((1, 3, 4, 4, cfg.z_dim))
                           .astype(np.float32))
    np.testing.assert_allclose(
        tvae.decode(tpad, tvae.VAE_TINY, lat).numpy(),
        tvae.decode(tp, tvae.VAE_TINY, lat).numpy(), rtol=2e-5, atol=2e-5)
    # the input tree is left as it was
    assert tp["decoder"]["head_conv"]["w"].shape[1] == 8


@pytest.mark.parametrize("backend", ["pallas", "fused"])
def test_streaming_decode_under_conv_backend_matches_jax(monkeypatch,
                                                          backend):
    """A streaming decode (the first frame, then a 2-frame block) with the
    conv backend set on both sides, caches leaf by leaf.  'pallas' at
    VAE_TINY's widths (every conv takes the kernel route); 'fused' with
    128-wide stages (and, after pad_decoder_channels, a 128-wide last
    stage), so that some blocks run fused and others decline, and the
    caches of the fused blocks hold raw inputs on both sides."""
    j_conv, j_nsc = jpc._conv3d_fused, jpc.norm_silu_conv3d_pallas
    monkeypatch.setattr(jpc, "_conv3d_fused",
                        lambda x, c, w, b, interpret=False: j_conv(
                            x, c, w, b, True))
    monkeypatch.setattr(jpc, "norm_silu_conv3d_pallas",
                        lambda *a, **k: j_nsc(*a, **{**k, "interpret": True}))
    monkeypatch.setattr(jatt, "_ATTENTION_BACKEND", "pallas")
    monkeypatch.setattr(jvae, "_CONV_BACKEND", backend)
    monkeypatch.setattr(tvae, "_CONV_BACKEND", backend)
    rng = np.random.default_rng(4)
    dims = dict(dim=32, z_dim=4, dim_mult=(1, 2, 4, 4), num_res_blocks=1) \
        if backend == "fused" else dict(dim=8, z_dim=4, dim_mult=(1, 2, 2, 2),
                                        num_res_blocks=1)
    jcfg, tcfg = jvae.VAEConfig(**dims), tvae.VAEConfig(**dims)
    jp = _jittered(jcfg, 4, rng)
    if backend == "fused":
        jp = jax.tree.map(np.asarray, jvae.pad_decoder_channels(jp))
    tp = params_from_jax(jp, "vae", device="cpu")
    h = w = 4
    lat = rng.standard_normal((1, 3, h, w, 4)).astype(np.float32)
    tconv.reset_decline_counts()
    jc = jvae.init_decoder_cache(jp, jcfg, 1, h, w)
    tc = tvae.init_decoder_cache(tp, tcfg, 1, h, w, torch.float32, "cpu")
    # jit: one compile of the first frame's interpreted kernels, not one
    # eager dispatch each
    jy, jc = jax.jit(jvae.decode_frame, static_argnums=(1, 4))(
        jp, jcfg, lat[:, :1], jc, True)
    ty, tc = tvae.decode_frame(tp, tcfg, torch.from_numpy(lat[:, :1]), tc,
                               first=True)
    _close(ty, jy)
    jy, jc = jvae.decode_block(jp, jcfg, lat[:, 1:], jc, first=False)
    ty, tc = tvae.decode_block(tp, tcfg, torch.from_numpy(lat[:, 1:]), tc,
                               first=False)
    assert ty.shape == (1, 8, 8 * h, 8 * w, 3)
    _close(ty, jy)
    _caches_close(tc, jc)
    if backend == "fused":   # 7 of the 10 blocks decline at 4x4 latents
        assert tconv.decline_counts["norm_silu_conv3d"] == 3 * 7
    else:
        assert tconv.decline_counts["conv3d_fused"] == 0


def test_params_from_jax_covers_the_encoder():
    """The 'vae' kind carries the encoder's leaves (2D stride-2 resample
    convs HWIO -> OIHW, the (3, 1, 1) time_conv DHWIO -> OIDHW) and the
    tree has init_params' keys in their order, with equal shapes."""
    cfg = jvae.VAE_TINY
    raw = jvae.init_params(jax.random.PRNGKey(6), cfg)
    jp = jax.tree.map(np.asarray, raw)
    tp = params_from_jax(jp, "vae", device="cpu")
    ti = tvae.init_params(tvae.VAE_TINY, seed=6, device="cpu")
    assert list(ti) == list(raw) == ["encoder", "conv1", "conv2", "decoder"]
    assert list(ti["encoder"]) == list(raw["encoder"])
    paths = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [p for p, _ in paths] == [
        p for p, _ in jax.tree_util.tree_flatten_with_path(ti)[0]]
    for (_, a), b in zip(paths, jax.tree.leaves(ti)):
        assert a.shape == b.shape
    rs = jp["encoder"]["stages"][0]["resample"]
    np.testing.assert_array_equal(
        tp["encoder"]["stages"][0]["resample"]["conv"]["w"].numpy(),
        rs["conv"]["w"].transpose(3, 2, 0, 1))
    tc = jp["encoder"]["stages"][1]["resample"]["time_conv"]["w"]
    assert tc.shape[:3] == (3, 1, 1)
    np.testing.assert_array_equal(
        tp["encoder"]["stages"][1]["resample"]["time_conv"]["w"].numpy(),
        tc.transpose(4, 3, 0, 1, 2))
