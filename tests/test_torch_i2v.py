"""The port's image-to-video path against the JAX package on the CPU,
float32, the same perturbed weights on both sides and the JAX side's
noise.  The weights are drawn by the port's inits and carried to the JAX
package as numpy (its layouts: DHWIO / HWIO convs), so no JAX init is
compiled; the trees' structure is held to the JAX inits' by
``jax.eval_shape``.  The cases: the i2v DiT at WAN_TINY with ``in_dim`` 36 (16
latent + 4 mask + 16 first-frame latent channels) and 1280-wide CLIP
tokens (``init_params``' tree, ``embed_image``, ``precompute_context``
with image K/V, ``forward_train`` unmasked, heads-packed and
block-causal, two blocks of ``forward_inference``, the state-dict
converters, the wrapper's ``clip_feature``); ``PoseImageConditioner``
(the first frame, the reference pose, a given keep mask, the missing
encoders' error); and the slice as a whole: the causal 50-step pipeline's
``input_image`` and ``wan_generate``'s ``WanT2V`` / ``WanI2V``.
Relative L2 <= 1e-4 on model outputs and latents, 1e-3 absolute on
pixels."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import conditioning as jcond
from self_forcing_tpu import wan_generate as jgen
from self_forcing_tpu import wrappers as jwrap
from self_forcing_tpu.config import Config as JConfig
from self_forcing_tpu.models import clip as jclip
from self_forcing_tpu.models.wan import configs as jconfigs
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu.models.wan.rope import RopeTables as JRope
from self_forcing_tpu.ops import masks as jmasks
from self_forcing_tpu.pipelines import causal_diffusion_inference as jcd
from self_forcing_tpu.utils import checkpoints as jckpt
from self_forcing_tpu_torch import conditioning as tcond
from self_forcing_tpu_torch import inference as tinf
from self_forcing_tpu_torch import wan_generate as tgen
from self_forcing_tpu_torch import wrappers as twrap
from self_forcing_tpu_torch.config import Config as TConfig
from self_forcing_tpu_torch.models import clip as tclip
from self_forcing_tpu_torch.models.wan import configs as tconfigs
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan import vae as tvae
from self_forcing_tpu_torch.models.wan.rope import RopeTables as TRope
from self_forcing_tpu_torch.ops import masks as tmasks
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.pipelines import causal_diffusion_inference \
    as tcd
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


TOL = 1e-4
B, C, H, W = 1, 16, 8, 8
FS = (H // 2) * (W // 2)
N_IMG = 257
J_I2V = dataclasses.replace(jconfigs.WAN_TINY, model_type="i2v", in_dim=36)
T_I2V = dataclasses.replace(tconfigs.WAN_TINY, model_type="i2v", in_dim=36)
# head_dim 128: the heads-packed cross attention
J_PACKED = dataclasses.replace(J_I2V, dim=256, num_heads=2)
T_PACKED = dataclasses.replace(T_I2V, dim=256, num_heads=2)
J_VAE = jvae.VAEConfig(dim=8, z_dim=16, dim_mult=(1, 2, 2, 2),
                       num_res_blocks=1)
# the i2v DiT's img_emb takes 1280-wide CLIP tokens at any width
J_CLIP = jclip.CLIPConfig(image_size=28, patch_size=14, vision_dim=1280,
                          vision_heads=8, vision_layers=2)
T_CLIP = tclip.CLIPConfig(image_size=28, patch_size=14, vision_dim=1280,
                          vision_heads=8, vision_layers=2)


@pytest.fixture(scope="module", autouse=True)
def _jitted_jax_encoders():
    """The JAX package's VAE, CLIP and pose-CNN entry points jitted for
    this module: one compile a shape (every case here shares them) where
    eager dispatch compiles each op, which dominated these tests' time.
    The functions are the package's own; only their dispatch changes."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, name, static in ((jvae, "encode", (1,)),
                                  (jvae, "decode", (1,)),
                                  (jclip, "encode_image", (1,)),
                                  (jcond, "dwpose_embedding", ()),
                                  (jcond, "randomref_embedding", ())):
            mp.setattr(mod, name, jax.jit(getattr(mod, name),
                                          static_argnums=static))
        yield


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _perturbed(tree_, rng):
    """Every leaf perturbed, so zero-initialised leaves (the output layer,
    the norms' biases) take part."""
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32), tree_)


def _jax_layout(node, key=None):
    """A port tree as numpy in the JAX package's layout: conv weights
    OIDHW -> DHWIO and OIHW -> HWIO (the inverse of ``params_from_jax``'s
    VAE transposes); everything else as it is."""
    if isinstance(node, dict):
        return {k: _jax_layout(v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_jax_layout(v, key) for v in node)
    a = node.numpy()
    if key == "w" and a.ndim == 5:
        return a.transpose(2, 3, 4, 1, 0)
    if key == "w" and a.ndim == 4:
        return a.transpose(2, 3, 1, 0)
    return a


def _same_structure(np_tree, jax_init, *args):
    """The numpy tree has the JAX init's structure and shapes (traced
    abstractly, nothing compiled)."""
    want = jax.eval_shape(jax_init, jax.random.PRNGKey(0), *args)
    assert jax.tree.structure(np_tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(np_tree), jax.tree.leaves(want)):
        assert a.shape == b.shape


@functools.lru_cache(maxsize=None)
def _dit(packed=False):
    jc, tc = (J_PACKED, T_PACKED) if packed else (J_I2V, T_I2V)
    jp = _perturbed(_jax_layout(tdit.init_params(
        tc, seed=1, dtype=torch.float32, device="cpu")),
        np.random.default_rng(1))
    _same_structure(jp, functools.partial(jdit.init_params, cfg=jc,
                                          dtype=jnp.float32))
    return jp, params_from_jax(jp, "dit", device="cpu")


@functools.lru_cache(maxsize=None)
def _encoders():
    rng = np.random.default_rng(2)
    vp = _perturbed(_jax_layout(tvae.init_params(tinf.TINY_VAE, seed=2,
                                                 device="cpu")), rng)
    cp = _jax_layout(tclip.init_vision_params(T_CLIP, seed=3, device="cpu"))
    dw = _jax_layout(tcond.init_dwpose_params(seed=7, device="cpu"))
    rr = _jax_layout(tcond.init_randomref_params(seed=8, device="cpu"))
    for tree_, init in ((vp, functools.partial(jvae.init_params, cfg=J_VAE)),
                        (cp, functools.partial(jclip.init_vision_params,
                                               cfg=J_CLIP)),
                        (dw, jcond.init_dwpose_params),
                        (rr, jcond.init_randomref_params)):
        _same_structure(tree_, init)
    return vp, cp, dw, rr


def _torch_pose(layers, conv3d):
    perm = (4, 3, 0, 1, 2) if conv3d else (3, 2, 0, 1)
    return {"layers": [{"w": torch.from_numpy(np.asarray(p["w"]).transpose(
        perm).copy()), "b": torch.from_numpy(np.array(p["b"]))}
        for p in layers["layers"]]}


def _inputs(seed, F, text_dim=64):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((B, F, C, H, W)).astype(np.float32),
            "y": rng.standard_normal((B, F, 20, H, W)).astype(np.float32),
            "clip": rng.standard_normal((B, N_IMG, 1280)).astype(np.float32),
            "ctx": rng.standard_normal((B, 12, text_dim)).astype(np.float32),
            "neg": rng.standard_normal((B, 12, text_dim)).astype(np.float32),
            "t": np.full((B, F), 700.0, np.float32)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _fields(cfg):
    """A config's values of the port's WanConfig fields (but tp_group, a
    process group the JAX config has no counterpart of)."""
    return {f.name: getattr(cfg, f.name)
            for f in dataclasses.fields(tconfigs.WanConfig)
            if f.name != "tp_group"}


def test_configs_and_init_params_match_jax():
    """The registries equal the JAX package's; ``init_params`` of an i2v
    model has JAX's key tree, shapes and dtype (causal with pose_proj,
    and not)."""
    for name in ("WAN_CONFIGS", "SIZE_CONFIGS", "MAX_AREA_CONFIGS",
                 "SUPPORTED_SIZES"):
        tv, jv = getattr(tconfigs, name), getattr(jconfigs, name)
        assert tv.keys() == jv.keys()
        for k in tv:
            assert (_fields(tv[k]) == _fields(jv[k])
                    if name == "WAN_CONFIGS" else tv[k] == jv[k])
    assert _fields(tconfigs.WAN_I2V_14B) == _fields(jconfigs.WAN_I2V_14B)
    for causal in (True, False):
        tp = tdit.init_params(T_I2V, seed=0, dtype=torch.float32,
                              device="cpu", causal=causal)
        _same_structure(_jax_layout(tp), functools.partial(
            jdit.init_params, cfg=J_I2V, dtype=jnp.float32, causal=causal))
        assert all(a.dtype == torch.float32 for a in tree.leaves(tp))
        got = dict(tree.items(tp))
        assert ("img_emb", "fc1", "w") in got and \
            ("blocks", "cross_attn", "norm_k_img", "w") in got
        assert ("pose_proj", "w") in got if causal else \
            ("pose_proj", "w") not in got


@pytest.mark.parametrize("packed", [False, True], ids=["folded", "packed"])
def test_embed_image_and_context_match_jax(packed):
    jp, tp = _dit(packed)
    jc, tc = (J_PACKED, T_PACKED) if packed else (J_I2V, T_I2V)
    inp = _inputs(3, 2)
    np.testing.assert_allclose(
        tdit.embed_image(tp, _t(inp["clip"])).numpy(),
        np.asarray(jdit.embed_image(jp, jnp.asarray(inp["clip"]))),
        rtol=TOL, atol=TOL)
    jctx = jdit.precompute_context(jp, jc, inp["ctx"], inp["clip"])
    tctx = tdit.precompute_context(tp, tc, _t(inp["ctx"]), _t(inp["clip"]))
    assert tctx.keys() == jctx.keys() == {"k_txt", "v_txt", "k_img",
                                          "v_img"}
    for k in tctx:
        assert tctx[k].shape == jctx[k].shape
        assert _rel(tctx[k].numpy(), jctx[k]) <= TOL
    # a t2v model ignores the image tokens, as in the JAX package
    t2v = tdit.precompute_context(tp, dataclasses.replace(tc,
                                                          model_type="t2v"),
                                  _t(inp["ctx"]), _t(inp["clip"]))
    assert t2v.keys() == {"k_txt", "v_txt"}


@pytest.mark.parametrize("case", ["unmasked", "packed", "block_causal"])
def test_forward_train_matches_jax(case):
    packed = case == "packed"
    jp, tp = _dit(packed)
    jc, tc = (J_PACKED, T_PACKED) if packed else (J_I2V, T_I2V)
    F = 4
    inp = _inputs(4, F)
    jmask = tmask = None
    if case == "block_causal":
        jmask = jmasks.block_causal_mask(F, FS, 2)
        tmask = tmasks.block_causal_mask(F, FS, 2)
    ref = jdit.forward_train(jp, jc, jnp.asarray(inp["x"]),
                             jnp.asarray(inp["t"]), jnp.asarray(inp["ctx"]),
                             jmask, JRope.create(jc.head_dim),
                             y=jnp.asarray(inp["y"]),
                             clip_fea=jnp.asarray(inp["clip"]), remat=False)
    out = tdit.forward_train(tp, tc, _t(inp["x"]), _t(inp["t"]),
                             _t(inp["ctx"]), tmask,
                             TRope.create(tc.head_dim, device="cpu"),
                             y=_t(inp["y"]), clip_fea=_t(inp["clip"]),
                             remat=False)
    assert out.shape == (B, F, C, H, W)
    assert _rel(out.numpy(), ref) <= TOL
    # the image keys take part: other image tokens, another flow
    other = tdit.forward_train(tp, tc, _t(inp["x"]), _t(inp["t"]),
                               _t(inp["ctx"]), tmask,
                               TRope.create(tc.head_dim, device="cpu"),
                               y=_t(inp["y"]), clip_fea=-_t(inp["clip"]),
                               remat=False)
    assert _rel(other.numpy(), out.numpy()) > 1e-3


def test_forward_inference_with_image_keys_matches_jax():
    """Two 2-frame blocks through the KV cache, text and image cross
    attention and y, the cache written by the first."""
    jp, tp = _dit()
    inp = _inputs(5, 4)
    jctx = jdit.precompute_context(jp, J_I2V, inp["ctx"], inp["clip"])
    tctx = tdit.precompute_context(tp, T_I2V, _t(inp["ctx"]),
                                   _t(inp["clip"]))
    jrope = JRope.create(J_I2V.head_dim)
    trope = TRope.create(T_I2V.head_dim, device="cpu")
    jcache = jdit.init_kv_cache(J_I2V, B, FS, 21, jnp.float32)
    tcache = tdit.init_kv_cache(T_I2V, B, FS, 21, torch.float32, "cpu")
    for blk in range(2):
        sl = slice(2 * blk, 2 * blk + 2)
        jflow, jcache = jdit.forward_inference(
            jp, J_I2V, jnp.asarray(inp["x"][:, sl]),
            jnp.asarray(inp["t"][:, sl]), jctx, jcache, 2 * blk, jrope,
            y=jnp.asarray(inp["y"][:, sl]))
        tflow, tcache = tdit.forward_inference(
            tp, T_I2V, _t(inp["x"][:, sl]), _t(inp["t"][:, sl]), tctx,
            tcache, 2 * blk, trope, y=_t(inp["y"][:, sl]))
        assert _rel(tflow.numpy(), jflow) <= TOL
    assert _rel(tcache.k.numpy(), jcache.k) <= TOL


def test_dit_state_dict_round_trip_matches_jax():
    """JAX's export of an i2v tree through the port's converter is the
    tree the JAX converter gives; the port's export is JAX's export."""
    jp, tp = _dit()
    jsd = jckpt.export_dit_state_dict(jp, J_I2V)
    got = tckpt.convert_dit_state_dict({k: _t(v) for k, v in jsd.items()},
                                       T_I2V, torch.float32, device="cpu")
    want = params_from_jax(jckpt.convert_dit_state_dict(jsd, J_I2V,
                                                        jnp.float32),
                           "dit", device="cpu")
    g, w = dict(tree.items(got)), dict(tree.items(want))
    assert g.keys() == w.keys()
    assert all(torch.equal(g[p], w[p]) for p in g)
    tsd = tckpt.export_dit_state_dict(tp, T_I2V)
    assert tsd.keys() == jsd.keys()
    assert "img_emb.proj.4.bias" in tsd and \
        "blocks.1.cross_attn.norm_k_img.weight" in tsd
    for k, v in tsd.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jsd[k]))


@pytest.mark.parametrize("path", ["cache_free", "cached"])
def test_wrapper_clip_feature_matches_jax(path):
    """``clip_feature`` as an argument (cache-free) or a key of the
    conditional dict (cached) reaches the image keys, as in JAX's
    wrapper."""
    jp, tp = _dit()
    inp = _inputs(6, 2)
    jw = jwrap.WanDiffusionWrapper(jp, J_I2V, is_causal=False)
    tw = twrap.WanDiffusionWrapper(tp, T_I2V, is_causal=False)
    t = np.array([500.0], np.float32)
    if path == "cache_free":
        jout = jw(jnp.asarray(inp["x"]), {"prompt_embeds": inp["ctx"]}, t,
                  y=inp["y"], clip_feature=jnp.asarray(inp["clip"]))
        tout = tw(_t(inp["x"]), {"prompt_embeds": _t(inp["ctx"])}, _t(t),
                  y=_t(inp["y"]), clip_feature=_t(inp["clip"]))
    else:
        jout, _ = jw(jnp.asarray(inp["x"]),
                     {"prompt_embeds": inp["ctx"], "y": inp["y"],
                      "clip_feature": inp["clip"]}, t,
                     kv_cache=jdit.init_kv_cache(J_I2V, B, FS, 21,
                                                 jnp.float32))
        tout, _ = tw(_t(inp["x"]),
                     {"prompt_embeds": _t(inp["ctx"]), "y": _t(inp["y"]),
                      "clip_feature": _t(inp["clip"])}, _t(t),
                     kv_cache=tdit.init_kv_cache(T_I2V, B, FS, 21,
                                                 torch.float32, "cpu"))
    for a, b in zip(tout, jout):
        assert _rel(a.numpy(), b) <= TOL


# ------------------------------------------------------ PoseImageConditioner

def _conditioners(with_image=True):
    vp, cp, dw, rr = _encoders()
    kw = {}
    if with_image:
        kw = dict(clip_params=cp, clip_cfg=J_CLIP, vae_params=vp,
                  vae_cfg=J_VAE)
    jcon = jcond.PoseImageConditioner(dw, rr, **kw)
    if with_image:
        kw = dict(clip_params=params_from_jax(cp, "clip", device="cpu"),
                  clip_cfg=T_CLIP,
                  vae_params=params_from_jax(vp, "vae", device="cpu"),
                  vae_cfg=tinf.TINY_VAE)
    tcon = tcond.PoseImageConditioner(_torch_pose(dw, True),
                                      _torch_pose(rr, False), **kw)
    return jcon, tcon


def _pose_batch(seed, nb, F):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (nb, 3, 4 * F - 3, 8 * H, 8 * W),
                         dtype=np.uint8),
            rng.integers(0, 256, (nb, 48, 40, 3), dtype=np.uint8),
            rng.integers(0, 256, (nb, 8 * H, 8 * W, 3), dtype=np.uint8))


def _close_dicts(tout, jout):
    assert tout.keys() == jout.keys()
    for k in tout:
        assert tout[k].shape == jout[k].shape, k
        assert _rel(tout[k].numpy(), jout[k]) <= TOL, k


def test_pose_image_conditioner_matches_jax():
    """A uint8 first frame (resized 48x40 -> 64x64 by the jax.image.resize
    cubic) and a reference pose at drop 0: the pose tokens, CLIP tokens
    and y (mask, first-frame latent, the reference-pose bias)."""
    jcon, tcon = _conditioners()
    dw, img, ref = _pose_batch(9, 1, 2)
    kw = dict(num_frames=2, height=8 * H, width=8 * W)
    jout = jcon.build_conditioning(jnp.asarray(dw), jnp.asarray(img),
                                   jnp.asarray(ref), **kw)
    tout = tcon.build_conditioning(_t(dw), _t(img), _t(ref), **kw)
    _close_dicts(tout, jout)
    assert tout["y"].shape == (1, 2, 20, H, W)
    assert tout["clip_fea"].shape == (1, 5, 1280)


def test_pose_conditioner_keep_mask_matches_jax():
    """Condition dropout with JAX's keep mask given to the port: the
    dropped sample's pose tokens are zero and its y is the reference-pose
    map's zero (no image); ``__call__``'s pose embedding likewise.  The
    port's own draw comes from a torch.Generator."""
    jcon, tcon = _conditioners(with_image=False)
    dw, _, ref = _pose_batch(10, 2, 2)
    rng = jax.random.PRNGKey(3)
    keep = np.asarray(jax.random.bernoulli(rng, 0.5, (2,)))
    assert keep.tolist() == [True, False]
    jout = jcon.build_conditioning(jnp.asarray(dw), random_ref_dwpose=(
        jnp.asarray(ref)), num_frames=2, rng=rng, pose_drop_prob=0.5)
    tout = tcon.build_conditioning(_t(dw), random_ref_dwpose=_t(ref),
                                   num_frames=2, keep=_t(keep),
                                   pose_drop_prob=0.5)
    _close_dicts(tout, jout)
    assert not tout["add_condition"][1].any() and not tout["y"][1].any()
    ref_chw = ref.transpose(0, 3, 1, 2)
    jcon.drop_prob = tcon.drop_prob = 0.5
    _close_dicts(tcon(_t(dw), _t(ref_chw), keep=_t(keep)),
                 jcon(jnp.asarray(dw), jnp.asarray(ref_chw), rng=rng))
    g = torch.Generator().manual_seed(0)
    drawn = tcon(_t(dw), _t(ref_chw), generator=g)["dwpose_emb"]
    kept = [bool(drawn[i].any()) for i in range(2)]
    full = tcon(_t(dw), _t(ref_chw))["dwpose_emb"]
    for i in range(2):
        assert torch.equal(drawn[i], full[i] if kept[i]
                           else torch.zeros_like(full[i]))


def test_pose_conditioner_needs_the_image_encoders():
    _, tcon = _conditioners(with_image=False)
    dw, img, _ = _pose_batch(11, 1, 2)
    with pytest.raises(ValueError, match="needs clip_params and vae_params"):
        tcon.build_conditioning(_t(dw), _t(img), num_frames=2)
    with pytest.raises(ValueError, match="needs clip_params and vae_params"):
        tcon.encode_image(_t(img), 2, 8 * H, 8 * W)


# ------------------------------------------------------------ the slice

def _causal_pipes():
    jp, tp = _dit()
    vp, cp, dw, rr = _encoders()
    args = {"sampling_steps": 2, "sample_solver": "unipc",
            "timestep_shift": 5.0, "guidance_scale": 5.0,
            "num_frame_per_block": 1, "independent_first_frame": False,
            "negative_prompt": ""}
    jpipe = jcd.CausalDiffusionInferencePipeline(
        JConfig(args), jp, J_I2V, vae_params=vp, vae_cfg=J_VAE,
        dwpose_params=dw, randomref_params=rr,
        image_encoder=(cp, J_CLIP))
    tpipe = tcd.CausalDiffusionInferencePipeline(
        TConfig(args), tp, T_I2V,
        vae_params=params_from_jax(vp, "vae", device="cpu"),
        vae_cfg=tinf.TINY_VAE, dwpose_params=_torch_pose(dw, True),
        randomref_params=_torch_pose(rr, False),
        image_encoder=(params_from_jax(cp, "clip", device="cpu"), T_CLIP),
        device="cpu", dtype=torch.float32)
    return jpipe, tpipe


def test_causal_diffusion_input_image_matches_jax():
    """``input_image`` with a DWPose video and a reference pose through
    the 50-step causal pipeline (2 steps, 2 blocks of 1 frame): CLIP
    tokens on both contexts, the image y plus the reference-pose bias;
    another image changes the latents."""
    jpipe, tpipe = _causal_pipes()
    inp = _inputs(12, 2)
    rng = np.random.default_rng(13)
    img = rng.uniform(-1, 1, (1, 3, 48, 48)).astype(np.float32)
    dw, _, ref = _pose_batch(14, 1, 2)
    jv, jl = jpipe.inference(
        jnp.asarray(inp["x"]), context=jnp.asarray(inp["ctx"]),
        neg_context=jnp.asarray(inp["neg"]), input_image=jnp.asarray(img),
        dwpose_data=jnp.asarray(dw), random_ref_dwpose=jnp.asarray(ref[0]),
        return_latents=True)
    kw = dict(context=_t(inp["ctx"]), neg_context=_t(inp["neg"]),
              dwpose_data=_t(dw), random_ref_dwpose=_t(ref[0]),
              return_latents=True)
    tv, tl = tpipe.inference(_t(inp["x"]), input_image=_t(img), **kw)
    assert tl.shape == (B, 2, C, H, W)
    assert _rel(tl.numpy(), jl) <= TOL
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-3)
    _, other = tpipe.inference(_t(inp["x"]), input_image=-_t(img), **kw)
    assert _rel(other.numpy(), tl.numpy()) > 1e-3
    with pytest.raises(ValueError, match="image_encoder"):
        tpipe.image_encoder = None
        tpipe.inference(_t(inp["x"]), input_image=_t(img), **kw)


@pytest.mark.parametrize("kind", ["t2v", "i2v"])
def test_wan_generate_matches_jax(kind, monkeypatch):
    """``WanT2V.generate`` / ``WanI2V.generate`` at 2 UniPC steps on
    JAX's noise (5 pixel frames at 64x64; the image 48x40): the latents
    the VAE decodes (caught on their way) within 1e-4 relative L2, the
    pixels within 1e-3."""
    seen = {}

    def spy(mod, key):
        real = mod.decode

        def decode(p, c, z):
            seen[key] = np.asarray(z)
            return real(p, c, z)
        monkeypatch.setattr(mod, "decode", decode)

    spy(jgen.vae_mod, "jax")
    spy(tgen.vae_mod, "port")
    jp, tp = _dit()
    vp, cp, _, _ = _encoders()
    inp = _inputs(15, 2)
    tvp = params_from_jax(vp, "vae", device="cpu")
    kw = dict(size=(8 * W, 8 * H), frame_num=5, sampling_steps=2, seed=0,
              context=inp["ctx"], neg_context=inp["neg"])
    if kind == "t2v":
        jc = dataclasses.replace(J_I2V, model_type="t2v", in_dim=C)
        tc = dataclasses.replace(T_I2V, model_type="t2v", in_dim=C)
        jp2 = dict(jp, patch_embedding={
            k: v[:C * 4] if k == "w" else v
            for k, v in jp["patch_embedding"].items()})
        jp2.pop("img_emb")
        tp2 = params_from_jax(jp2, "dit", device="cpu")
        jm = jgen.WanT2V(jp2, jc, vae_params=vp, vae_cfg=J_VAE)
        tm = tgen.WanT2V(tp2, tc, vae_params=tvp, vae_cfg=tinf.TINY_VAE)
        args = ("a prompt",)
    else:
        img = np.random.default_rng(16).uniform(
            -1, 1, (1, 3, 48, 40)).astype(np.float32)
        jm = jgen.WanI2V(jp, J_I2V, vae_params=vp, vae_cfg=J_VAE,
                         clip_params=cp, clip_cfg=J_CLIP)
        tm = tgen.WanI2V(tp, T_I2V, vae_params=tvp, vae_cfg=tinf.TINY_VAE,
                         clip_params=params_from_jax(cp, "clip",
                                                     device="cpu"),
                         clip_cfg=T_CLIP)
        args = ("a prompt", img)
    jkw = dict(kw, context=jnp.asarray(inp["ctx"]),
               neg_context=jnp.asarray(inp["neg"]))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                         (1, 2, C, H, W), jnp.float32))
    targs = tuple(_t(a) if isinstance(a, np.ndarray) else a for a in args)
    jargs = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in args)
    jpx = jm.generate(*jargs, **jkw)
    tkw = dict(kw, context=_t(inp["ctx"]), neg_context=_t(inp["neg"]),
               noise=_t(noise))
    tpx = tm.generate(*targs, **tkw)
    assert tpx.shape == (5, 3, 8 * H, 8 * W) == jpx.shape
    np.testing.assert_allclose(tpx.numpy(), np.asarray(jpx), rtol=0,
                               atol=1e-3)
    assert seen["port"].shape == (1, 2, H, W, C)
    assert _rel(seen["port"], seen["jax"]) <= TOL


def test_wan_generate_mesh_raises():
    """The sequence-parallel route (ROADMAP Queue A item 10, ported:
    tests/test_torch_sequence_parallel.py) takes a DeviceMesh with an
    'sp' dimension; anything else is refused."""
    _, tp = _dit()
    with pytest.raises(ValueError, match="'sp' dimension"):
        tgen.WanI2V(tp, T_I2V, mesh=object())
