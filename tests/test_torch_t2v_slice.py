"""The text-to-video main path as a whole, the port against the JAX
package on the CPU: token ids -> tiny umT5 (``encode_for_dit``) ->
context -> ``CausalInferencePipeline.inference`` at WAN_TINY with the JAX
package's noise and re-noising draws injected -> Wan VAE decode -> uint8
frames, text to video (2 blocks of 3 frames) and image to video (a 48x48
image resized to 64x64 by ``utils.resize.resize_cubic``, encoded as an
independent first frame, 2 one-frame blocks).  float32 weights crossed
over by ``params_from_jax``.  The video in [0, 1] within 1e-4; the uint8
frames may differ by 1 where a value sits at a truncation edge (the
counts are asserted: at most 1e-3 of the values, none by more than 1).
``inference.generate``, the CLI's per-prompt function, is held to the
same frames with the same draws passed in, and its bf16 activations
(the card's route) to within a stated gap of float32 activations.  Then
the wrappers (``WanTextEncoder``, ``WanVAEWrapper``'s streaming
decode, ``WanDiffusionWrapper``'s cached and cache-free forwards, with
and without the pose conditioning ``add_condition`` / ``y``) against the
JAX package's, and the unported conditioning (classify, CLIP) raising."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import wrappers as jwrap
from self_forcing_tpu.config import Config as JConfig
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan import t5 as jt5
from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.pipelines.causal_inference import (
    CausalInferencePipeline as JPipe)
from self_forcing_tpu_torch import inference as tinf
from self_forcing_tpu_torch import wrappers as twrap
from self_forcing_tpu_torch.config import Config as TConfig
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan import t5 as tt5
from self_forcing_tpu_torch.models.wan import vae as tvae
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.pipelines.causal_inference import (
    CausalInferencePipeline as TPipe)
from self_forcing_tpu_torch.utils.resize import resize_cubic

TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
J_VAE = jvae.VAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2),
                       num_res_blocks=1)
STEPS = [1000, 750, 500, 250]
CASES = {"t2v": dict(nb=3, iff=False, frames=6),
         "i2v": dict(nb=1, iff=True, frames=2)}


def _perturbed(tree, rng):
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32), tree)


def _models(seed):
    rng = np.random.default_rng(seed)
    t5p = _perturbed(jt5.init_params(jax.random.PRNGKey(seed), jt5.T5_TINY,
                                     jnp.float32), rng)
    dp = _perturbed(jdit.init_params(jax.random.PRNGKey(seed + 1), J_TINY,
                                     jnp.float32), rng)
    vp = _perturbed(jvae.init_params(jax.random.PRNGKey(seed + 2), J_VAE),
                    rng)
    ids = rng.integers(1, jt5.T5_TINY.vocab_size, (B, 16)).astype(np.int32)
    mask = np.ones((B, 16), np.int32)
    mask[:, 10:] = 0
    ids[mask == 0] = 0
    return t5p, dp, vp, ids, mask


def _draws(rng, nblocks, nb):
    """The JAX sampler's re-noising draws: split(rng) once, then one key a
    block, split once a step."""
    _, k = jax.random.split(rng)
    eps = []
    for kb in jax.random.split(k, nblocks):
        blk = []
        for _ in range(len(STEPS) - 1):
            kb, kk = jax.random.split(kb)
            blk.append(torch.tensor(np.asarray(jax.random.normal(
                kk, (B, nb, C, H, W), jnp.float32))))
        eps.append(blk)
    return eps


@functools.lru_cache(maxsize=None)
def _jax_chain(case):
    """The JAX side of ``case`` as inference.py runs a prompt: ids ->
    context -> (i2v: the image resized and encoded) -> sampler -> VAE ->
    uint8 frames, with the draws of ``PRNGKey(3)``."""
    nb, iff, frames = (CASES[case][k] for k in ("nb", "iff", "frames"))
    t5p, dp, vp, ids, mask = _models(0)
    rng = np.random.default_rng(1)
    noise = rng.standard_normal((B, frames, C, H, W)).astype(np.float32)
    args = {"denoising_step_list": STEPS, "warp_denoising_step": True,
            "timestep_shift": 8.0, "num_frame_per_block": nb,
            "context_noise": 0, "independent_first_frame": iff}
    key = jax.random.PRNGKey(3)
    jctx = jt5.encode_for_dit(t5p, jt5.T5_TINY, jnp.asarray(ids),
                              jnp.asarray(mask))
    img = jinit = None
    if case == "i2v":
        img = rng.uniform(-1, 1, (48, 48, 3)).astype(np.float32)
        jimg = jax.image.resize(jnp.asarray(img), (8 * H, 8 * W, 3), "cubic")
        jinit = np.asarray(jvae.encode(vp, J_VAE, jimg[None, None])
                           ).transpose(0, 1, 4, 2, 3)
    jpipe = JPipe(JConfig(args), dp, J_TINY, vae_params=vp, vae_cfg=J_VAE)
    jvideo = np.asarray(jpipe.inference(noise, context=jctx,
                                        initial_latent=jinit, rng=key))
    jframes = (jvideo[0].transpose(0, 2, 3, 1) * 255).astype(np.uint8)
    return dict(t5p=t5p, dp=dp, vp=vp, ids=ids, mask=mask, noise=noise,
                img=img, args=args, key=key, jinit=jinit, jvideo=jvideo,
                jframes=jframes)


def _port_side(j):
    """The port's context (tiny umT5 on the same ids) and pipeline (the
    same weights) for a JAX chain."""
    tvp = params_from_jax(j["vp"], "vae", device="cpu")
    tctx = tt5.encode_for_dit(params_from_jax(j["t5p"], "t5", device="cpu"),
                              tt5.T5_TINY, torch.from_numpy(j["ids"]),
                              torch.from_numpy(j["mask"]))
    tpipe = TPipe(TConfig(j["args"]),
                  params_from_jax(j["dp"], "dit", device="cpu"),
                  dataclasses.replace(WAN_TINY), vae_params=tvp,
                  vae_cfg=tinf.TINY_VAE, device="cpu", dtype=torch.float32)
    return tctx, tpipe


def _assert_frames_match(case, tframes, jframes):
    diff = np.abs(tframes.astype(np.int16) - jframes)
    print(f"{case}: {int((diff > 0).sum())} of {diff.size} uint8 values "
          f"differ, by at most {int(diff.max())}")
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, int((diff > 0).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_text_to_frames_matches_jax(case):
    nb, frames = CASES[case]["nb"], CASES[case]["frames"]
    j = _jax_chain(case)
    tctx, tpipe = _port_side(j)
    tinit = None
    if case == "i2v":
        timg = resize_cubic(torch.from_numpy(j["img"]).permute(2, 0, 1),
                            8 * H, 8 * W).permute(1, 2, 0)
        tinit = tvae.encode(tpipe.vae_params, tinf.TINY_VAE,
                            timg[None, None]).permute(0, 1, 4, 2, 3)
        np.testing.assert_allclose(tinit.numpy(), j["jinit"], rtol=TOL,
                                   atol=TOL)
    tvideo = tpipe.inference(torch.from_numpy(j["noise"].copy()), tctx,
                             initial_latent=tinit,
                             eps=_draws(j["key"], frames // nb, nb))
    want_px = 1 + 4 * (frames + (case == "i2v") - 1)
    assert tvideo.shape == (B, want_px, 3, 8 * H, 8 * W)
    np.testing.assert_allclose(tvideo.numpy(), j["jvideo"], rtol=TOL,
                               atol=TOL)
    tframes = tinf.frames_uint8(tvideo[0]).numpy()
    assert tframes.shape == j["jframes"].shape == (want_px, 8 * H, 8 * W, 3)
    _assert_frames_match(case, tframes, j["jframes"])


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_the_jax_cli_chain(case):
    """``inference.generate``, the CLI's per-prompt function (the image's
    resize and encode, the noise cast, the sampler, the uint8 frames),
    against the JAX CLI's per-prompt body with the same noise and
    re-noising draws passed in; a wrongly shaped noise raises."""
    nb, frames = CASES[case]["nb"], CASES[case]["frames"]
    j = _jax_chain(case)
    tctx, tpipe = _port_side(j)
    image = torch.from_numpy(j["img"]) if case == "i2v" else None
    n_total = frames + (case == "i2v")
    out = tinf.generate(tpipe, tctx, n_total, (H, W), seed=0, image=image,
                        noise=torch.from_numpy(j["noise"].copy()),
                        eps=_draws(j["key"], frames // nb, nb))
    assert out.dtype == torch.uint8
    assert out.shape == j["jframes"].shape
    _assert_frames_match(case, out.numpy(), j["jframes"])
    with pytest.raises(ValueError, match="expected"):
        tinf.generate(tpipe, tctx, n_total + 1, (H, W), seed=0, image=image,
                      noise=torch.from_numpy(j["noise"].copy()))


@pytest.mark.parametrize("case", list(CASES))
def test_generate_bf16_activations_stay_near_float32(case):
    """The CLI's departure on the card: ``generate`` casts the noise and
    the context to the DiT's bf16, so the stream and the KV cache run in
    bf16, where the JAX CLI's float32 noise runs float32 activations over
    the same bf16 weights.  Both routes on the same inputs (bf16 DiT
    weights, the float32 VAE, the same noise and draws): the uint8 frames
    differ by at most 8 levels and by at most 1 level on average (measured
    at this size: at most 4 / 5 levels, 0.34 / 0.40 on average, t2v /
    i2v)."""
    nb, frames = CASES[case]["nb"], CASES[case]["frames"]
    j = _jax_chain(case)
    tctx, tpipe = _port_side(j)
    weights = params_from_jax(j["dp"], "dit", device="cpu",
                              dtype=torch.bfloat16)
    image = torch.from_numpy(j["img"]) if case == "i2v" else None
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        pipe = TPipe(TConfig(j["args"]), weights,
                     dataclasses.replace(WAN_TINY),
                     vae_params=tpipe.vae_params, vae_cfg=tinf.TINY_VAE,
                     device="cpu", dtype=dtype)
        out[dtype] = tinf.generate(
            pipe, tctx, frames + (case == "i2v"), (H, W), seed=0,
            image=image, noise=torch.from_numpy(j["noise"].copy()),
            eps=_draws(j["key"], frames // nb, nb)).numpy().astype(np.int16)
    gap = np.abs(out[torch.bfloat16] - out[torch.float32])
    print(f"{case}: bf16 vs float32 activations: max {int(gap.max())}, "
          f"mean {gap.mean():.4f} levels, {(gap > 0).mean():.4f} of the "
          f"values differ")
    assert gap.max() <= 8
    assert gap.mean() <= 1.0


def _forward_inputs(seed, frames):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, frames, C, H, W)).astype(np.float32)
    ctx = rng.standard_normal((B, 12, WAN_TINY.text_dim)).astype(np.float32)
    t = np.array([750.0], np.float32)
    return x, ctx, t


@pytest.mark.parametrize("causal", [True, False])
def test_diffusion_wrapper_forward_matches_jax(causal):
    _, dp, _, _, _ = _models(4)
    cfg_j = dataclasses.replace(J_TINY, num_frame_per_block=1)
    cfg_t = dataclasses.replace(WAN_TINY, num_frame_per_block=1)
    x, ctx, t = _forward_inputs(5, 3)
    jw = jwrap.WanDiffusionWrapper(dp, cfg_j, is_causal=causal)
    tw = twrap.WanDiffusionWrapper(params_from_jax(dp, "dit", device="cpu"),
                                   cfg_t, is_causal=causal)
    jflow, jx0 = jw(jnp.asarray(x), {"prompt_embeds": jnp.asarray(ctx)},
                    jnp.asarray(t))
    tflow, tx0 = tw(torch.from_numpy(x),
                    {"prompt_embeds": torch.from_numpy(ctx)},
                    torch.from_numpy(t))
    np.testing.assert_allclose(tflow.detach().numpy(), np.asarray(jflow),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx0.detach().numpy(), np.asarray(jx0),
                               rtol=TOL, atol=TOL)


def test_diffusion_wrapper_cached_forward_matches_jax():
    _, dp, _, _, _ = _models(6)
    x, ctx, t = _forward_inputs(7, 3)
    tparams = params_from_jax(dp, "dit", device="cpu")
    jw = jwrap.WanDiffusionWrapper(dp, J_TINY)
    tw = twrap.WanDiffusionWrapper(tparams, WAN_TINY)
    fs = (H // 2) * (W // 2)
    jcache = jdit.init_kv_cache(J_TINY, B, fs, 21, jnp.float32)
    tcache = tdit.init_kv_cache(WAN_TINY, B, fs, 21, torch.float32, "cpu")
    for start in (0, 3):   # the second chunk reads the first one's K/V
        (jflow, jx0), jcache = jw(
            jnp.asarray(x), {"prompt_embeds": jnp.asarray(ctx)},
            jnp.asarray(t), kv_cache=jcache, current_start=start * fs)
        (tflow, tx0), tcache = tw(
            torch.from_numpy(x), {"prompt_embeds": torch.from_numpy(ctx)},
            torch.from_numpy(t), kv_cache=tcache, current_start=start * fs)
        np.testing.assert_allclose(tflow.numpy(), np.asarray(jflow),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tx0.numpy(), np.asarray(jx0), rtol=TOL,
                                   atol=TOL)


def test_vae_wrapper_and_text_encoder_match_jax():
    t5p, _, vp, ids, mask = _models(8)
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((B, 3, C, H, W)).astype(np.float32)
    jw = jwrap.WanVAEWrapper(vp, J_VAE)
    tw = twrap.WanVAEWrapper(params_from_jax(vp, "vae", device="cpu"),
                             tinf.TINY_VAE)
    # streaming: one frame, then two, the cache carried between calls
    for lo, hi in ((0, 1), (1, 3)):
        jpx = jw.decode_to_pixel(jnp.asarray(lat[:, lo:hi]), use_cache=True)
        tpx = tw.decode_to_pixel(torch.from_numpy(lat[:, lo:hi]),
                                 use_cache=True)
        np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=TOL,
                                   atol=TOL)
    np.testing.assert_allclose(
        tw.decode_to_pixel(torch.from_numpy(lat)).numpy(),
        np.asarray(jw.decode_to_pixel(jnp.asarray(lat))), rtol=TOL,
        atol=TOL)

    class Tok:
        def __call__(self, prompts):
            return ids, mask

    class TTok:
        def __call__(self, prompts):
            return torch.from_numpy(ids), torch.from_numpy(mask)

    jenc = jwrap.WanTextEncoder(t5p, jt5.T5_TINY, tokenizer=Tok())
    tenc = twrap.WanTextEncoder(params_from_jax(t5p, "t5", device="cpu"),
                                tt5.T5_TINY, tokenizer=TTok())
    np.testing.assert_allclose(
        tenc(["x"])["prompt_embeds"].numpy(),
        np.asarray(jenc(["x"])["prompt_embeds"]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kwargs", [{"classify_mode": True},
                                    {"concat_time_embeddings": True}])
def test_diffusion_wrapper_unported_conditioning_raises(kwargs):
    """The classify mode (ported with the GAN trainer; against the JAX
    package in tests/test_torch_gan.py) raises until
    ``adding_cls_branch`` attaches the GAN head, then returns (flow,
    pred_x0, logits); ``concat_time_embeddings`` feeds the head's
    time-embedding inputs.  (The CLIP image features are ported since the
    i2v DiT was: tests/test_torch_i2v.py.)"""
    params = tdit.init_params(WAN_TINY, seed=0, dtype=torch.float32,
                              device="cpu")
    tw = twrap.WanDiffusionWrapper(params, WAN_TINY)
    x, ctx, t = _forward_inputs(10, 1)
    args = (torch.from_numpy(x), {"prompt_embeds": torch.from_numpy(ctx)},
            torch.from_numpy(t))
    kw = {"classify_mode": True, **kwargs}
    with pytest.raises(ValueError, match="adding_cls_branch"):
        tw(*args, **kw)
    head = tw.adding_cls_branch(time_embed_dim=WAN_TINY.dim if kwargs.get(
        "concat_time_embeddings") else 0)
    assert tw.cls_params is head
    with torch.no_grad():
        flow, x0, logits = tw(*args, **kw)
    assert flow.shape == x0.shape == x.shape and logits.shape == (B, 1)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("path", ["cached", "teacher_forcing", "cache_free"])
def test_diffusion_wrapper_conditioning_matches_jax(path):
    """``add_condition`` (pose tokens) and ``y`` through the wrapper, as
    arguments (cached, teacher forcing) or in the conditional dict (cache
    free), on a y-consuming model (in_dim 36; teacher forcing: pose tokens
    only, on the t2v model, since the clean half has no y channels)."""
    tf = path == "teacher_forcing"
    in_dim = C if tf else 36
    rng = np.random.default_rng(11)
    cfg_j = dataclasses.replace(J_TINY, in_dim=in_dim, num_frame_per_block=1)
    cfg_t = dataclasses.replace(WAN_TINY, in_dim=in_dim,
                                num_frame_per_block=1)
    dp = _perturbed(jdit.init_params(jax.random.PRNGKey(12), cfg_j,
                                     jnp.float32), rng)
    x, ctx, t = _forward_inputs(13, 2)
    fs = (H // 2) * (W // 2)
    pose = rng.standard_normal((B, 2 * fs, 5120)).astype(np.float32)
    y = rng.standard_normal((B, 2, 20, H, W)).astype(np.float32)
    jw = jwrap.WanDiffusionWrapper(dp, cfg_j)
    tw = twrap.WanDiffusionWrapper(params_from_jax(dp, "dit", device="cpu"),
                                   cfg_t)
    jcond = {"prompt_embeds": jnp.asarray(ctx)}
    tcond = {"prompt_embeds": torch.from_numpy(ctx)}
    jkw, tkw = {}, {}
    if path == "cache_free":
        jcond.update(add_condition=jnp.asarray(pose), y=jnp.asarray(y))
        tcond.update(add_condition=torch.from_numpy(pose),
                     y=torch.from_numpy(y))
    else:
        jkw["add_condition"] = jnp.asarray(pose)
        tkw["add_condition"] = torch.from_numpy(pose)
        if not tf:
            jkw["y"], tkw["y"] = jnp.asarray(y), torch.from_numpy(y)
    if tf:
        clean = rng.standard_normal(x.shape).astype(np.float32)
        jkw["clean_x"], tkw["clean_x"] = jnp.asarray(clean), \
            torch.from_numpy(clean)
    if path == "cached":
        jkw["kv_cache"] = jdit.init_kv_cache(cfg_j, B, fs, 21, jnp.float32)
        tkw["kv_cache"] = tdit.init_kv_cache(cfg_t, B, fs, 21, torch.float32,
                                             "cpu")
        jkw["current_start"] = tkw["current_start"] = 2 * fs
    jout = jw(jnp.asarray(x), jcond, jnp.asarray(t), **jkw)
    tout = tw(torch.from_numpy(x), tcond, torch.from_numpy(t), **tkw)
    if path == "cached":
        jout, tout = jout[0], tout[0]
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)
