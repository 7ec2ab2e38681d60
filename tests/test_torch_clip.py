"""The port's CLIP (``self_forcing_tpu_torch/models/clip.py``) against the
JAX package on the CPU, float32 at CLIP_TINY, the same weights on both
sides (``params_from_jax`` with ``kind='clip'``): the vision tokens with and without
``use_31_block``, ``preprocess_images`` (PyTorch's bicubic, a = -0.75, no
antialias) and ``encode_image``, the text tower with its pad mask and the
pooled head, and one reference-layout state dict through both packages'
converters and ``runtime.load_clip_vision``.  Relative L2 <= 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from self_forcing_tpu.models import clip as jclip
from self_forcing_tpu_torch import runtime as trt
from self_forcing_tpu_torch.models import clip as tclip
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.utils import tree

TOL = 1e-5
CFG_J, CFG_T = jclip.CLIP_TINY, tclip.CLIP_TINY


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _vision(seed=0):
    jp = jclip.init_vision_params(jax.random.PRNGKey(seed), CFG_J)
    return jp, params_from_jax(jp, "clip", device="cpu")


def test_config_is_the_jax_packages():
    for name in ("CLIP_XLM_ROBERTA_VIT_H_14", "CLIP_TINY"):
        assert vars(getattr(tclip, name)) == vars(getattr(jclip, name))
    np.testing.assert_array_equal(tclip.CLIP_MEAN, jclip.CLIP_MEAN)
    np.testing.assert_array_equal(tclip.CLIP_STD, jclip.CLIP_STD)


@pytest.mark.parametrize("use_31_block", [True, False])
def test_vision_tokens_match_jax(use_31_block):
    jp, tp = _vision()
    x = np.random.default_rng(1).standard_normal(
        (2, 3, CFG_J.image_size, CFG_J.image_size)).astype(np.float32)
    ref = jclip.vision_forward(jp, CFG_J, jnp.asarray(x), use_31_block)
    out = tclip.vision_forward(tp, CFG_T, torch.from_numpy(x), use_31_block)
    P = (CFG_T.image_size // CFG_T.patch_size) ** 2
    assert out.shape == (2, P + 1, CFG_T.vision_dim)
    assert _rel(out.numpy(), ref) <= TOL


def test_preprocess_and_encode_image_match_jax():
    """The resize is PyTorch's bicubic (F.interpolate itself, within
    float32), not jax.image.resize's cubic; the image tokens of a
    non-square image equal JAX's."""
    jp, tp = _vision()
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (2, 3, 40, 56)).astype(np.float32)
    out = tclip.preprocess_images(torch.from_numpy(img), CFG_T)
    ref = jclip.preprocess_images(jnp.asarray(img), CFG_J)
    assert out.shape == (2, 3, CFG_T.image_size, CFG_T.image_size)
    assert _rel(out.numpy(), ref) <= TOL
    std = torch.from_numpy(tclip.CLIP_STD)[None, :, None, None]
    mean = torch.from_numpy(tclip.CLIP_MEAN)[None, :, None, None]
    raw = ((out * std + mean) - 0.5) * 2.0
    bicubic = F.interpolate(torch.from_numpy(img), size=(28, 28),
                            mode="bicubic", align_corners=False)
    np.testing.assert_allclose(raw.numpy(), bicubic.numpy(), rtol=0,
                               atol=2e-5)
    img1 = rng.uniform(-1, 1, (1, 3, 56, 40)).astype(np.float32)
    tok = tclip.encode_image(tp, CFG_T, torch.from_numpy(img1))
    assert _rel(tok.numpy(), jclip.encode_image(jp, CFG_J,
                                                jnp.asarray(img1))) <= TOL


def test_text_tower_matches_jax():
    """Per-token features with the pad keys masked (the real tokens' rows
    do not see what stands in the pad positions' ids) and the pooled
    head."""
    jp = jclip.init_text_params(jax.random.PRNGKey(3), CFG_J)
    tp = params_from_jax(jp, "clip", device="cpu")
    pad = CFG_J.pad_id
    ids = np.array([[5, 6, 7, pad, pad], [9, 10, 11, 12, 13]], np.int64)
    out = tclip.text_forward(tp, CFG_T, torch.from_numpy(ids))
    ref = jclip.text_forward(jp, CFG_J, jnp.asarray(ids, jnp.int32))
    assert out.shape == (2, 5, CFG_T.text_dim)
    assert _rel(out.numpy(), ref) <= TOL
    pooled = tclip.text_pooled(tp, CFG_T, torch.from_numpy(ids))
    assert pooled.shape == (2, CFG_T.embed_dim)
    assert _rel(pooled.numpy(), jclip.text_pooled(
        jp, CFG_J, jnp.asarray(ids, jnp.int32))) <= TOL
    # one more pad token at the end leaves the real tokens' features
    longer = tclip.text_forward(tp, CFG_T, torch.from_numpy(
        np.concatenate([ids[:1], [[pad]]], axis=1)))
    np.testing.assert_allclose(longer[:, :3].numpy(), out[:1, :3].numpy(),
                               rtol=1e-6, atol=1e-6)


def _reference_state_dict(cfg, seed):
    """A reference-layout (``visual.*``) state dict of random tensors,
    with a patch bias."""
    rng = np.random.default_rng(seed)
    d, ph = cfg.vision_dim, cfg.patch_size
    P = (cfg.image_size // ph) ** 2
    mlp = int(d * cfg.vision_mlp_ratio)

    def r(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * 0.1)

    sd = {"visual.patch_embedding.weight": r(d, 3, ph, ph),
          "visual.patch_embedding.bias": r(d),
          "visual.cls_embedding": r(1, 1, d),
          "visual.pos_embedding": r(1, P + 1, d)}
    for n in ("pre_norm", "post_norm"):
        sd[f"visual.{n}.weight"], sd[f"visual.{n}.bias"] = r(d), r(d)
    for i in range(cfg.vision_layers):
        p = f"visual.transformer.{i}."
        for name, (o, n) in {"attn.to_qkv": (3 * d, d), "attn.proj": (d, d),
                             "mlp.0": (mlp, d), "mlp.2": (d, mlp)}.items():
            sd[p + name + ".weight"], sd[p + name + ".bias"] = r(o, n), r(o)
        for n in ("norm1", "norm2"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = r(d), r(d)
    return sd


def test_vision_converter_and_loader_match_jax(tmp_path, monkeypatch):
    """One state dict through both converters gives the same tree (the
    patch conv flattened in (ph, pw, C) order equals torch's Conv2d on
    the patches), and ``runtime.load_clip_vision`` reads it back from the
    reference's file name; (None, None) without the file."""
    sd = _reference_state_dict(CFG_T, 4)
    jp = jclip.convert_clip_vision_state_dict(sd, CFG_J)
    tp = tclip.convert_clip_vision_state_dict(sd, CFG_T, device="cpu")
    ref = params_from_jax(jp, "clip", device="cpu")
    got, want = dict(tree.items(tp)), dict(tree.items(ref))
    assert got.keys() == want.keys()
    for path, a in got.items():
        assert torch.equal(a, want[path]), path
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 3, 28, 28)).astype(np.float32))
    conv = F.conv2d(x, sd["visual.patch_embedding.weight"],
                    sd["visual.patch_embedding.bias"], stride=14)
    xt = x.permute(0, 2, 3, 1).reshape(1, 2, 14, 2, 14, 3).permute(
        0, 1, 3, 2, 4, 5).reshape(1, 4, -1)
    np.testing.assert_allclose(
        (xt @ tp["patch_embedding"]["w"] + tp["patch_embedding"]["b"])
        .numpy(), conv.flatten(2).transpose(1, 2).numpy(), rtol=1e-5,
        atol=1e-5)

    assert trt.load_clip_vision(str(tmp_path), device="cpu") == (None, None)
    torch.save(sd, tmp_path / tclip.CLIP_WEIGHTS)
    monkeypatch.setattr(tclip, "CLIP_XLM_ROBERTA_VIT_H_14", CFG_T)
    lp, lcfg = trt.load_clip_vision(str(tmp_path), device="cpu")
    assert lcfg == CFG_T
    for (path, a), (_, b) in zip(tree.items(lp), tree.items(tp)):
        assert a.dtype == torch.float32 and torch.equal(a, b), path
