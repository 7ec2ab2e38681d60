"""The port's streaming Wan VAE decode against the JAX package on the CPU:
decode_frame (first frame) then decode_block (steady state) with the
carried cache, at VAE_TINY with weights crossed over by
self_forcing_tpu_torch.params.  float32; tolerance 1e-4."""
import jax
import numpy as np
import torch

from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu_torch.models.wan import vae as tvae
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
