"""The port's many-step samplers against the JAX package on the CPU, float32
at WAN_TINY with the tiny VAE (z_dim 16), the same perturbed weights on
both sides (``params_from_jax``) and the JAX side's noise:

- ``CausalDiffusionInferencePipeline`` with 4 steps of each solver, with
  pose (DWPose video and reference pose through the pose CNNs), with and
  without ``independent_first_frame``, with ``initial_latent`` priming
  and ``start_frame_index``, on a t2v model and on a y-consuming one
  (in_dim 36, where the reference pose becomes ``y``): latents within
  1e-4 relative L2, the video within 1e-4 absolute;
- the JAX package's own cases: frame counts the block schedule cannot
  consume raise, and guidance 1 is the positive branch alone (the
  negative context drops out) in the causal and bidirectional samplers;
- ``BidirectionalDiffusionInferencePipeline`` (each solver) and
  ``BidirectionalInferencePipeline`` (JAX's re-noising draws injected as
  ``eps``) within the same limits;
- the card's departure: the pose path with a bf16 DiT and bf16 caches
  against float32 activations over the same bf16 weights, the solver
  state in float32 (as the CLI runs) and forced into bf16."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import conditioning as jcond
from self_forcing_tpu.config import Config as JConfig
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.pipelines import bidirectional_diffusion_inference \
    as jbd
from self_forcing_tpu.pipelines import bidirectional_inference as jbi
from self_forcing_tpu.pipelines import causal_diffusion_inference as jcd
from self_forcing_tpu_torch import inference as tinf
from self_forcing_tpu_torch.config import Config as TConfig
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.pipelines import (
    bidirectional_diffusion_inference as tbd)
from self_forcing_tpu_torch.pipelines import bidirectional_inference as tbi
from self_forcing_tpu_torch.pipelines import causal_diffusion_inference \
    as tcd

TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
J_VAE = jvae.VAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2),
                       num_res_blocks=1)
# name: (solver, num_frame_per_block, independent_first_frame, noise
# frames, initial_latent frames, start_frame_index, model in_dim)
CASES = {
    "unipc_pose_y": ("unipc", 2, False, 4, 0, 0, 36),
    "dpmpp_pose_iff": ("dpm++", 2, True, 3, 0, 0, C),
    "unipc_prime_start": ("unipc", 2, False, 2, 2, 3, C),
    "dpmpp_prime_iff": ("dpm++", 1, True, 2, 3, 0, C),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32), tree)


def _to_torch_pose(layers, conv3d):
    perm = (4, 3, 0, 1, 2) if conv3d else (3, 2, 0, 1)
    return {"layers": [{"w": torch.from_numpy(np.asarray(p["w"]).transpose(
        perm).copy()), "b": torch.from_numpy(np.array(p["b"]))}
        for p in layers["layers"]]}


@functools.lru_cache(maxsize=None)
def _models(in_dim, causal=True):
    rng = np.random.default_rng(in_dim + 100 * causal)
    cfg = dataclasses.replace(J_TINY, in_dim=in_dim)
    dp = _perturbed(jdit.init_params(jax.random.PRNGKey(in_dim), cfg,
                                     jnp.float32, causal=causal), rng)
    vp = _perturbed(jvae.init_params(jax.random.PRNGKey(2), J_VAE), rng)
    dw = jcond.init_dwpose_params(jax.random.PRNGKey(7))
    rr = jcond.init_randomref_params(jax.random.PRNGKey(8))
    return cfg, dp, vp, dw, rr


def _contexts(seed):
    rng = np.random.default_rng(seed)
    ctx, neg = (rng.standard_normal((B, 12, WAN_TINY.text_dim)).astype(
        np.float32) for _ in range(2))
    return ctx, neg


def _args(solver, nb, iff, steps=4, guidance=5.0):
    return {"sampling_steps": steps, "sample_solver": solver,
            "timestep_shift": 5.0, "shift": 8.0, "guidance_scale": guidance,
            "num_frame_per_block": nb, "independent_first_frame": iff,
            "negative_prompt": ""}


def _pose_inputs(seed, pose_frames):
    rng = np.random.default_rng(seed)
    dw = rng.integers(0, 256, (B, 3, 4 * pose_frames - 3, 8 * H, 8 * W),
                      dtype=np.uint8)
    ref = rng.integers(0, 256, (B, 8 * H, 8 * W, 3), dtype=np.uint8)
    return dw, ref


def _pipes(case_args, in_dim, dtype=torch.float32, weights_dtype=None):
    cfg, dp, vp, dw, rr = _models(in_dim)
    jpipe = jcd.CausalDiffusionInferencePipeline(
        JConfig(case_args), dp, cfg, vae_params=vp, vae_cfg=J_VAE,
        dwpose_params=dw, randomref_params=rr)
    tpipe = tcd.CausalDiffusionInferencePipeline(
        TConfig(case_args),
        params_from_jax(dp, "dit", device="cpu", dtype=weights_dtype),
        dataclasses.replace(WAN_TINY, in_dim=in_dim),
        vae_params=params_from_jax(vp, "vae", device="cpu"),
        vae_cfg=tinf.TINY_VAE, dwpose_params=_to_torch_pose(dw, True),
        randomref_params=_to_torch_pose(rr, False), device="cpu",
        dtype=dtype)
    return jpipe, tpipe


@pytest.mark.parametrize("case", list(CASES))
def test_causal_diffusion_matches_jax(case):
    solver, nb, iff, F, F0, start, in_dim = CASES[case]
    args = _args(solver, nb, iff)
    jpipe, tpipe = _pipes(args, in_dim)
    rng = np.random.default_rng(sum(map(ord, case)))
    noise = rng.standard_normal((B, F, C, H, W)).astype(np.float32)
    init = None if not F0 else (0.5 * rng.standard_normal(
        (B, F0, C, H, W))).astype(np.float32)
    dw, ref = _pose_inputs(1, start + F0 + F)
    ctx, neg = _contexts(2)
    jvideo, jlat = jpipe.inference(
        jnp.asarray(noise), context=jnp.asarray(ctx),
        neg_context=jnp.asarray(neg), dwpose_data=jnp.asarray(dw),
        random_ref_dwpose=jnp.asarray(ref[0]),
        initial_latent=None if init is None else jnp.asarray(init),
        return_latents=True, start_frame_index=start)
    tvideo, tlat = tpipe.inference(
        torch.from_numpy(noise), context=torch.from_numpy(ctx),
        neg_context=torch.from_numpy(neg), dwpose_data=torch.from_numpy(dw),
        random_ref_dwpose=torch.from_numpy(ref[0]),
        initial_latent=None if init is None else torch.from_numpy(init),
        return_latents=True, start_frame_index=start)
    assert tlat.shape == (B, F0 + F, C, H, W) and tlat.dtype == torch.float32
    err = _rel(tlat.numpy(), jlat)
    print(f"{case}: latents rel L2 {err:.2e}")
    assert err <= TOL
    assert tvideo.shape == jvideo.shape == (B, 1 + 4 * (F0 + F - 1), 3,
                                            8 * H, 8 * W)
    np.testing.assert_allclose(tvideo.numpy(), np.asarray(jvideo), rtol=0,
                               atol=TOL)
    if init is not None:
        np.testing.assert_array_equal(tlat[:, :F0].numpy(), init)


def test_non_divisible_frames_raise():
    """The JAX package's case: the block schedule would drop frames or
    leave context frames unprimed."""
    _, tpipe = _pipes(_args("unipc", 2, False), C)
    ctx, neg = (torch.from_numpy(a) for a in _contexts(3))
    with pytest.raises(ValueError, match="not consumable"):
        tpipe.inference(torch.zeros(B, 3, C, H, W), context=ctx,
                        neg_context=neg)
    with pytest.raises(ValueError, match="never be primed"):
        tpipe.inference(torch.zeros(B, 2, C, H, W), context=ctx,
                        neg_context=neg,
                        initial_latent=torch.zeros(B, 1, C, H, W))
    with pytest.raises(ValueError, match="image_encoder"):
        tpipe.inference(torch.zeros(B, 2, C, H, W), context=ctx,
                        neg_context=neg, input_image=torch.zeros(1, 3, 8, 8))
    with pytest.raises(ValueError, match="fewer frames than required"):
        dw, _ = _pose_inputs(4, 1)
        tpipe.inference(torch.zeros(B, 2, C, H, W), context=ctx,
                        neg_context=neg, dwpose_data=torch.from_numpy(dw))


@pytest.mark.parametrize("kind", ["causal", "bidirectional"])
def test_guidance_one_is_the_positive_branch(kind):
    """u + 1 (c - u) = c: the negative context drops out (the JAX
    package's guidance identity), here to float32 rounding."""
    ctx, neg = (torch.from_numpy(a) for a in _contexts(5))
    noise = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, 2, C, H, W)).astype(np.float32))
    cfg, dp, _, _, _ = _models(C, causal=kind == "causal")
    tp = params_from_jax(dp, "dit", device="cpu")
    args = TConfig(_args("unipc", 2, False, guidance=1.0))
    if kind == "causal":
        pipe = tcd.CausalDiffusionInferencePipeline(
            args, tp, WAN_TINY, device="cpu", dtype=torch.float32)
    else:
        pipe = tbd.BidirectionalDiffusionInferencePipeline(
            args, tp, WAN_TINY, device="cpu", dtype=torch.float32)
    _, a = pipe.inference(noise, context=ctx, neg_context=neg,
                          return_latents=True)
    _, b = pipe.inference(noise, context=ctx, neg_context=ctx,
                          return_latents=True)
    _, c = pipe.inference(noise, context=ctx, neg_context=neg * 5,
                          return_latents=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("solver", ["unipc", "dpm++"])
def test_bidirectional_diffusion_matches_jax(solver):
    cfg, dp, vp, _, _ = _models(C, causal=False)
    args = _args(solver, 1, False)
    jpipe = jbd.BidirectionalDiffusionInferencePipeline(
        JConfig(args), dp, cfg, vae_params=vp, vae_cfg=J_VAE)
    tpipe = tbd.BidirectionalDiffusionInferencePipeline(
        TConfig(args), params_from_jax(dp, "dit", device="cpu"), WAN_TINY,
        vae_params=params_from_jax(vp, "vae", device="cpu"),
        vae_cfg=tinf.TINY_VAE, device="cpu", dtype=torch.float32)
    assert tpipe.shift == jpipe.shift == 8.0   # 'shift', not timestep_shift
    noise = np.random.default_rng(7).standard_normal(
        (B, 3, C, H, W)).astype(np.float32)
    ctx, neg = _contexts(8)
    jvideo, jlat = jpipe.inference(jnp.asarray(noise),
                                   context=jnp.asarray(ctx),
                                   neg_context=jnp.asarray(neg),
                                   return_latents=True)
    tvideo, tlat = tpipe.inference(torch.from_numpy(noise),
                                   context=torch.from_numpy(ctx),
                                   neg_context=torch.from_numpy(neg),
                                   return_latents=True)
    assert _rel(tlat.numpy(), jlat) <= TOL
    assert tvideo.shape == jvideo.shape == (B, 9, 3, 8 * H, 8 * W)
    np.testing.assert_allclose(tvideo.numpy(), np.asarray(jvideo), rtol=0,
                               atol=TOL)


def test_bidirectional_few_step_matches_jax():
    cfg, dp, _, _, _ = _models(C, causal=False)
    args = {"denoising_step_list": [1000, 750, 500, 250],
            "warp_denoising_step": True, "timestep_shift": 5.0}
    jpipe = jbi.BidirectionalInferencePipeline(JConfig(args), dp, cfg)
    tpipe = tbi.BidirectionalInferencePipeline(
        TConfig(args), params_from_jax(dp, "dit", device="cpu"), WAN_TINY,
        device="cpu", dtype=torch.float32)
    assert tpipe.denoising_step_list == pytest.approx(
        jpipe.denoising_step_list)
    noise = np.random.default_rng(9).standard_normal(
        (B, 3, C, H, W)).astype(np.float32)
    ctx, _ = _contexts(10)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jpipe.inference(jnp.asarray(noise), jnp.asarray(ctx),
                                      rng=key))
    eps, k = [], key     # sample_few_step: one split a re-noising step
    for _ in range(3):
        k, kk = jax.random.split(k)
        eps.append(torch.from_numpy(np.array(jax.random.normal(
            kk, noise.shape, jnp.float32))))
    got = tpipe.inference(torch.from_numpy(noise), torch.from_numpy(ctx),
                          eps=eps)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("state", ["float32", "bf16"])
def test_pose_path_bf16_stays_near_float32(state):
    """The card's route: a bf16 DiT and bf16 caches (the pipeline's
    ``dtype``), float32 noise, so the sample, the solver state and the
    guided flow stay float32, against float32 activations over the same
    bf16 weights; and the same with the solver state forced into bf16
    (bf16 noise).  4 UniPC steps, guidance 5, pose and reference pose on
    the y-consuming model, 2 blocks of 2 frames.  Measured here (uint8
    frames; latents relative L2): float32 state max 15, mean 1.07 levels,
    latents 1.060e-2; bf16 state max 14, mean 1.23 levels, latents
    1.086e-2: over 4 steps the bf16 activations, not the state's
    rounding, make the gap.  Bounds: max 24 levels, mean 2 levels."""
    args = _args("unipc", 2, False)
    out, lat = {}, {}
    rng = np.random.default_rng(12)
    noise = torch.from_numpy(rng.standard_normal((B, 4, C, H, W)).astype(
        np.float32))
    dw, ref = (torch.from_numpy(a) for a in _pose_inputs(13, 4))
    ctx, neg = (torch.from_numpy(a) for a in _contexts(14))
    for dtype in (torch.bfloat16, torch.float32):
        _, tpipe = _pipes(args, 36, dtype=dtype,
                          weights_dtype=torch.bfloat16)
        x = noise.to(torch.bfloat16) if (dtype == torch.bfloat16
                                         and state == "bf16") else noise
        video, lat[dtype] = tpipe.inference(
            x, context=ctx, neg_context=neg, dwpose_data=dw,
            random_ref_dwpose=ref[0], return_latents=True)
        assert lat[dtype].dtype == x.dtype
        out[dtype] = tinf.frames_uint8(video[0].float()).numpy().astype(
            np.int16)
    gap = np.abs(out[torch.bfloat16] - out[torch.float32])
    err = _rel(lat[torch.bfloat16].float().numpy(),
               lat[torch.float32].numpy())
    print(f"{state} state: bf16 vs float32 activations: max "
          f"{int(gap.max())}, mean {gap.mean():.4f} levels, "
          f"{(gap > 0).mean():.4f} of the values differ; latents rel L2 "
          f"{err:.3e}")
    assert gap.max() <= 24
    assert gap.mean() <= 2.0
