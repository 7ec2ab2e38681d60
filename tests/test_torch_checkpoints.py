"""The port's checkpoint readers and converters against the JAX package
on the CPU.  Each converter takes the same state dict as the JAX one and
must give exactly ``params_from_jax`` of the JAX converter's output: the
DiT (a state dict from the JAX package's ``export_dit_state_dict``, with
and without LoRA, float32 and bf16), the T5 encoder and the VAE (state
dicts built here).  ``export_dit_state_dict`` equals the JAX export and
round-trips; the T5 and VAE exports round-trip through both converters.  The safetensors reader reads f32, f16 and bf16 files
written with the ``safetensors`` package as ``safetensors.torch`` does;
``.pt`` files load through ``torch.load``.  Then ``load_dit_params`` /
``load_wan_models`` on a model directory written here, and the trainer's
loaders (``train.build_models`` / ``make_context_fn``) on it."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.lora import apply_lora
from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan import t5 as jt5
from self_forcing_tpu.models.wan import vae as jvae
from self_forcing_tpu.models.wan.configs import WanConfig as JWanConfig
from self_forcing_tpu.utils import checkpoints as jckpt
from self_forcing_tpu_torch.models.wan import dit as tdit
from self_forcing_tpu_torch.models.wan import t5 as tt5
from self_forcing_tpu_torch.models.wan import vae as tvae
from self_forcing_tpu_torch.models.wan.configs import WAN_TINY, WanConfig
from self_forcing_tpu_torch.params import params_from_jax
from self_forcing_tpu_torch.utils import checkpoints as tckpt
from self_forcing_tpu_torch.utils import tree

J_CFG = JWanConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                   text_dim=32, freq_dim=16)
T_CFG = WanConfig(dim=64, ffn_dim=128, num_heads=2, num_layers=2,
                  text_dim=32, freq_dim=16)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def assert_trees_equal(out, ref):
    out_items, ref_items = dict(tree.items(out)), dict(tree.items(ref))
    assert out_items.keys() == ref_items.keys(), \
        set(out_items) ^ set(ref_items)
    for k, t in out_items.items():
        r = ref_items[k]
        assert t.dtype == r.dtype and t.shape == r.shape, (k, t.dtype,
                                                            r.dtype)
        assert torch.equal(t, r), k


def _tsd(sd):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            sd.items()}


def _jax_dit(seed, lora):
    rng = np.random.default_rng(seed)
    jp = jdit.init_params(jax.random.PRNGKey(seed), J_CFG, jnp.float32)
    if lora:
        jp = apply_lora(jp, rank=2, alpha=4.0, key=jax.random.PRNGKey(9))
    # perturbed, so the zero-initialised head and LoRA B take part
    return jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32), jp)


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dit_converter_matches_jax(lora, dtype):
    jdt, tdt = DTYPES[dtype]
    jp = _jax_dit(0, lora)
    sd = jckpt.export_dit_state_dict(jp, J_CFG)
    scale = 2.0 if lora else None
    ref = params_from_jax(jckpt.convert_dit_state_dict(
        sd, J_CFG, jdt, lora_scale=scale), "dit", device="cpu", dtype=tdt)
    out = tckpt.convert_dit_state_dict(_tsd(sd), T_CFG, tdt,
                                       lora_scale=scale, device="cpu")
    if lora:
        # the JAX converter's override puts one scalar where the stacked
        # tree has a scale a layer; the port fills the stacked scale
        scales = out["blocks"]["self_attn"]["q"]["lora_scale"]
        assert scales.shape == (J_CFG.num_layers,)
        assert torch.all(scales == 2.0)
        for path, leaf in tree.items(out):
            if path[-1] == "lora_scale":
                assert torch.equal(leaf, torch.full_like(leaf, 2.0)), path
        out, ref = (tree.map_tree(lambda t: t, t_) for t_ in (out, ref))
        for t_ in (out, ref):
            _drop_lora_scale(t_)
    assert_trees_equal(out, ref)


def _drop_lora_scale(node):
    if isinstance(node, dict):
        node.pop("lora_scale", None)
        for v in node.values():
            _drop_lora_scale(v)


@pytest.mark.parametrize("lora", [False, True])
def test_dit_export_matches_jax_and_round_trips(lora):
    jp = _jax_dit(1, lora)
    tp = params_from_jax(jp, "dit", device="cpu")
    ref = jckpt.export_dit_state_dict(jp, J_CFG)
    sd = tckpt.export_dit_state_dict(tp, T_CFG)
    assert sd.keys() == ref.keys()
    for k, v in sd.items():
        assert v.dtype == torch.float32 and v.is_contiguous(), k
        np.testing.assert_array_equal(v.numpy(), ref[k], err_msg=k)
    back = tckpt.convert_dit_state_dict(sd, T_CFG, torch.float32,
                                        lora_scale=2.0 if lora else None,
                                        device="cpu")
    # alpha / r lives in the config, not in the state dict
    for path, leaf in tree.items(tp):
        if path[-1] == "lora_scale":
            leaf.fill_(2.0)
    assert_trees_equal(back, tp)


def test_dit_export_keeps_bf16_and_round_trips():
    tp = tdit.init_params(WAN_TINY, seed=3, dtype=torch.bfloat16,
                          device="cpu")
    sd = tckpt.export_dit_state_dict(tp, WAN_TINY)
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    assert "pose_proj.weight" in sd
    assert_trees_equal(tckpt.convert_dit_state_dict(
        sd, WAN_TINY, torch.bfloat16, device="cpu"), tp)


def test_dit_converter_rejects_the_i2v_model():
    sd = jckpt.export_dit_state_dict(_jax_dit(2, False), J_CFG)
    sd["img_emb.proj.0.weight"] = np.zeros(4, np.float32)
    with pytest.raises(NotImplementedError, match="Queue A item 6"):
        tckpt.convert_dit_state_dict(_tsd(sd), T_CFG, device="cpu")


def _t5_state_dict(cfg, seed):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"token_embedding.weight": r(cfg.vocab_size, cfg.dim),
          "norm.weight": r(cfg.dim)}
    for i in range(cfg.num_layers):
        p = f"blocks.{i}."
        sd.update({p + "norm1.weight": r(cfg.dim),
                   p + "norm2.weight": r(cfg.dim),
                   p + "pos_embedding.embedding.weight": r(cfg.num_buckets,
                                                           cfg.num_heads)})
        for n in "qkv":
            sd[p + f"attn.{n}.weight"] = r(cfg.dim_attn, cfg.dim)
        sd[p + "attn.o.weight"] = r(cfg.dim, cfg.dim_attn)
        sd[p + "ffn.gate.0.weight"] = r(cfg.dim_ffn, cfg.dim)
        sd[p + "ffn.fc1.weight"] = r(cfg.dim_ffn, cfg.dim)
        sd[p + "ffn.fc2.weight"] = r(cfg.dim, cfg.dim_ffn)
    return sd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t5_converter_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    sd = _t5_state_dict(jt5.T5_TINY, 0)
    ref = params_from_jax(jckpt.convert_t5_state_dict(sd, jt5.T5_TINY, jdt),
                          "t5", device="cpu", dtype=tdt)
    out = tckpt.convert_t5_state_dict(_tsd(sd), tt5.T5_TINY, tdt,
                                      device="cpu")
    assert out["blocks"]["pos_emb"].dtype == torch.float32
    assert_trees_equal(out, ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vae_converter_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    src = tvae.init_params(tvae.VAE_TINY, seed=0, dtype=torch.float32,
                           device="cpu")
    sd = tckpt.export_vae_state_dict(src)
    ref = params_from_jax(jckpt.convert_vae_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jvae.VAE_TINY, jdt), "vae",
        device="cpu", dtype=tdt)
    out = tckpt.convert_vae_state_dict(sd, tvae.VAE_TINY, tdt, device="cpu")
    assert_trees_equal(out, ref)
    if dtype == "float32":
        assert_trees_equal(out, src)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_t5_export_round_trips_through_both_converters(dtype):
    jdt, tdt = DTYPES[dtype]
    src = tt5.init_params(tt5.T5_TINY, seed=2, dtype=tdt, device="cpu")
    sd = tckpt.export_t5_state_dict(src)
    assert sd["blocks.0.pos_embedding.embedding.weight"].dtype == \
        torch.float32
    assert sd["blocks.1.attn.q.weight"].dtype == tdt
    assert all(v.is_contiguous() for v in sd.values())
    assert_trees_equal(tckpt.convert_t5_state_dict(sd, tt5.T5_TINY, tdt,
                                                   device="cpu"), src)
    assert_trees_equal(params_from_jax(
        jckpt.convert_t5_state_dict(sd, jt5.T5_TINY, jdt), "t5",
        device="cpu", dtype=tdt), src)


def test_vae_export_keeps_bf16_and_round_trips():
    src = tvae.init_params(tvae.VAE_TINY, seed=3, dtype=torch.bfloat16,
                           device="cpu")
    sd = tckpt.export_vae_state_dict(src)
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    assert_trees_equal(tckpt.convert_vae_state_dict(
        sd, tvae.VAE_TINY, torch.bfloat16, device="cpu"), src)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(5, 7, generator=g).to(dtype),
          "a.bias": torch.randn(7, generator=g).to(dtype),
          "b": torch.randn(2, 3, 4, generator=g).to(dtype),
          "scalar": torch.tensor(1.5, dtype=dtype),
          "ids": torch.arange(6, dtype=torch.int64)}
    path = str(tmp_path / "m.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    ref = load_file(path)
    out = tckpt.load_torch_state_dict(path)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype and torch.equal(out[k], ref[k])
    sub = tckpt.load_torch_state_dict(path, key="a")
    assert sub.keys() == {"weight", "bias"}
    assert torch.equal(sub["weight"], ref["a.weight"])
    with pytest.raises(KeyError):
        tckpt.load_torch_state_dict(path, key="missing")


def test_safetensors_reader_rejects_bad_offsets(tmp_path):
    header = json.dumps({"x": {"dtype": "F32", "shape": [4],
                               "data_offsets": [0, 12]}}).encode()
    path = tmp_path / "bad.safetensors"
    path.write_bytes(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="offsets"):
        tckpt.read_safetensors(str(path))


def test_torch_checkpoint_loads_nested_and_keyed(tmp_path):
    g = torch.Generator().manual_seed(1)
    ck = {"generator": {"model.x": torch.randn(3, generator=g).bfloat16()},
          "critic": {"model.y": torch.randn(2, generator=g)}}
    path = str(tmp_path / "ck.pt")
    torch.save(ck, path)
    out = tckpt.load_torch_state_dict(path)
    assert torch.equal(out["generator"]["model.x"], ck["generator"]["model.x"])
    assert out["generator"]["model.x"].dtype == torch.bfloat16
    sub = tckpt.load_torch_state_dict(path, key="critic")
    assert tckpt.strip_prefix(sub).keys() == {"y"}


def _model_dir(tmp_path):
    """A model directory of the reference's layout at tiny size: the base
    DiT as one .pth, a self-forcing checkpoint overlaying two leaves of its
    'generator', the T5 encoder and the VAE."""
    base = tdit.init_params(WAN_TINY, seed=4, dtype=torch.float32,
                            device="cpu")
    os.makedirs(tmp_path / "Wan2.1-T2V-1.3B")
    sd = tckpt.export_dit_state_dict(base, WAN_TINY)
    torch.save(sd, tmp_path / "Wan2.1-T2V-1.3B" / "model.pth")
    over = {"model.head.modulation": sd["head.modulation"] + 1,
            "model.blocks.1.ffn.0.bias": sd["blocks.1.ffn.0.bias"] - 1}
    torch.save({"generator": over, "critic": {}},
               tmp_path / "self_forcing_dmd.pt")
    t5p = _t5_state_dict(jt5.T5_TINY, 5)
    torch.save(_tsd(t5p), tmp_path / "models_t5_umt5-xxl-enc-bf16.pth")
    vsrc = tvae.init_params(tvae.VAE_TINY, seed=6, dtype=torch.float32,
                            device="cpu")
    torch.save(tckpt.export_vae_state_dict(vsrc),
               tmp_path / "Wan2.1_VAE.pth")
    return base, t5p, vsrc


def test_load_wan_models_from_a_model_directory(tmp_path, monkeypatch):
    from self_forcing_tpu_torch import runtime
    monkeypatch.setattr(tt5, "UMT5_XXL", tt5.T5_TINY)
    monkeypatch.setattr(tvae, "WAN_VAE", tvae.VAE_TINY)
    base, t5p, vsrc = _model_dir(tmp_path)
    models = runtime.load_wan_models(
        str(tmp_path), model_cfg=WAN_TINY,
        checkpoint_path=str(tmp_path / "self_forcing_dmd.pt"),
        checkpoint_key="generator_ema", dtype=torch.float32, device="cpu")
    want = tree.map_tree(lambda t: t.clone(), base)
    want["head"]["modulation"] += 1
    want["blocks"]["ffn"]["fc1"]["b"][1] -= 1
    assert_trees_equal(models.generator, want)
    assert_trees_equal(models.vae_params, vsrc)
    assert models.vae_params["conv1"]["w"].dtype == torch.float32
    assert_trees_equal(models.t5_params, tckpt.convert_t5_state_dict(
        _tsd(t5p), tt5.T5_TINY, torch.float32, device="cpu"))
    assert models.tokenizer is None
    with pytest.raises(ValueError, match="tokenizer"):
        models.encode_text(["a prompt"])
    # load_dit_params alone: the base weights, no overlay
    assert_trees_equal(runtime.load_dit_params(
        str(tmp_path), WAN_TINY, dtype=torch.float32, device="cpu"), base)
    # the T5 kept on the host for a device elsewhere streams per layer
    host = runtime.load_wan_models(str(tmp_path), model_cfg=WAN_TINY,
                                   load_dit=False, load_vae=False,
                                   t5_on_host=True, dtype=torch.float32,
                                   device="cpu")
    assert host.generator is None and host.vae_params is None
    assert tree.leaves(host.t5_params)[0].device.type == "cpu"


def test_encode_text_streams_a_host_resident_t5(tmp_path, monkeypatch):
    """``t5_on_host=True`` for a device elsewhere: ``encode_text`` takes
    the streamed route (``encode_streamed``, a layer at a time), which
    gives what the resident encoder gives, padded rows zero."""
    from self_forcing_tpu_torch import runtime
    monkeypatch.setattr(tt5, "UMT5_XXL", tt5.T5_TINY)
    _, t5p, _ = _model_dir(tmp_path)
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(1, tt5.T5_TINY.vocab_size, (2, 12)))
    mask = torch.ones(2, 12, dtype=torch.int64)
    mask[1, 5:] = 0
    ids = ids * mask
    models = runtime.load_wan_models(str(tmp_path), model_cfg=WAN_TINY,
                                     load_dit=False, load_vae=False,
                                     t5_on_host=True, dtype=torch.float32,
                                     device="cpu")
    models.tokenizer = lambda prompts: (ids, mask)
    resident = tt5.encode_for_dit(tckpt.convert_t5_state_dict(
        _tsd(t5p), tt5.T5_TINY, torch.float32, device="cpu"), tt5.T5_TINY,
        ids, mask)
    # the host encoder for a device of another type: the route is the
    # streamed one (its result is read on the CPU, where both routes run)
    calls = []
    monkeypatch.setattr(tt5, "encode_streamed", lambda *a, **k: calls.append(
        k["device"]) or resident)
    models.device = torch.device("meta")
    models.encode_text(["a", "b"])
    assert calls == [torch.device("meta")]
    monkeypatch.undo()
    streamed = tt5.encode_streamed(models.t5_params, tt5.T5_TINY, ids, mask,
                                   device="cpu")
    assert torch.equal(streamed, resident)
    assert torch.all(streamed[1, 5:] == 0)


def test_train_builds_models_from_a_model_directory(tmp_path, monkeypatch):
    from self_forcing_tpu_torch import train
    from self_forcing_tpu_torch.config import Config
    monkeypatch.setattr(tt5, "UMT5_XXL", tt5.T5_TINY)
    monkeypatch.setattr(train, "WAN_1_3B", WAN_TINY)
    base, t5p, _ = _model_dir(tmp_path)
    config = Config({"model_size": "1.3b", "model_dir": str(tmp_path),
                     "generator_ckpt": str(tmp_path / "self_forcing_dmd.pt"),
                     "seed": 0})
    cfg, gen, fake, real = train.build_models(config, torch.float32,
                                              torch.device("cpu"))
    assert cfg == WAN_TINY
    assert_trees_equal(fake, base)
    assert_trees_equal(real, base)
    assert torch.equal(gen["head"]["modulation"],
                       base["head"]["modulation"] + 1)
    # the T5 file exists: the contexts come from the encoder, through the
    # tokenizer the directory holds
    tok = _tiny_tokenizer(tmp_path / "google" / "umt5-xxl")
    ctx_fn = train.make_context_fn(config, cfg, torch.device("cpu"))
    ctx = ctx_fn(["a red fox", "snow"])
    assert ctx.shape == (2, 512, tt5.T5_TINY.dim)
    ids, mask = tok(["a red fox", "snow"])
    t5 = tckpt.convert_t5_state_dict(_tsd(t5p), tt5.T5_TINY, torch.bfloat16,
                                     device="cpu")
    assert torch.equal(ctx, tt5.encode_for_dit(t5, tt5.T5_TINY, ids, mask))


def _tiny_tokenizer(path):
    """A word-level tokenizer over a few words, saved where
    ``AutoTokenizer`` finds it, and the port's wrapper over it."""
    from test_torch_tokenizer import save_tiny_tokenizer
    from self_forcing_tpu_torch.tokenizer import HuggingfaceTokenizer
    save_tiny_tokenizer(path)
    return HuggingfaceTokenizer(str(path), seq_len=512)
