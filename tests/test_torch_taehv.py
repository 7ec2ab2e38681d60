"""The port's TAEHV (models/taehv.py) against the JAX package on the CPU,
float32, weights crossed over by ``params_from_jax(..., "taehv")`` (HWIO
-> OIHW) with every leaf perturbed so the zero biases take part.

Tolerance 1e-4 against JAX for the decoder and the encoder: both sum each
conv in float32, in another order, through 24 (decoder) or 23 (encoder)
convs.  The port's chunked stream against its own whole-video decode:
1e-5 (the same convs on other batch groupings of the same frames).  The
checkpoint converters and ``quantize_decoder_params`` are exact, and so
is the int8 decode: its convs sum int8 products exactly in both packages
and the glue is elementwise float32; the one op that is not, the input
clamp's tanh (XLA's approximation differs from PyTorch's in the last bit
on about half the elements), is taken from JAX in that test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu.models import taehv as jtaehv
from self_forcing_tpu_torch.models import taehv as ttaehv
from self_forcing_tpu_torch.params import params_from_jax

TOL = 1e-4
N, C, H, W = 1, 16, 4, 6


def _setup(seed, T):
    rng = np.random.default_rng(seed)
    jp = jtaehv.init_decoder_params(jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    x = rng.standard_normal((N, T, C, H, W)).astype(np.float32)
    return jp, params_from_jax(jp, "taehv", device="cpu"), x


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.mark.parametrize("trim", [True, False])
def test_decode_video_matches_jax(trim):
    jp, tp, x = _setup(0, 3)
    j = jtaehv.decode_video(jp, jnp.asarray(x), trim=trim)
    t = ttaehv.decode_video(tp, torch.from_numpy(x), trim=trim)
    frames = 4 * 3 - (jtaehv.FRAMES_TO_TRIM if trim else 0)
    assert t.shape == (N, frames, 3, 8 * H, 8 * W) == j.shape
    _close(t, j)


def test_stateful_stream_matches_jax_and_whole_decode():
    """Two chunks (1 latent frame, then 3, as the demo's first blocks):
    each against JAX's stateful decode, and the stream against the
    port's one-shot decode of all 4 frames."""
    jp, tp, x = _setup(1, 4)
    jstate = tstate = None
    touts = []
    for lo, hi in ((0, 1), (1, 4)):
        j, jstate = jtaehv.decode_video_stateful(
            jp, jnp.asarray(x[:, lo:hi]), jstate, trim=jstate is None)
        t, tstate = ttaehv.decode_video_stateful(
            tp, torch.from_numpy(x[:, lo:hi]), tstate, trim=tstate is None)
        assert set(tstate) == set(jstate)
        _close(t, j)
        touts.append(t)
    whole = ttaehv.decode_video(tp, torch.from_numpy(x))
    torch.testing.assert_close(torch.cat(touts, dim=1), whole, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("stateful", [True, False],
                         ids=["stateful", "overlap"])
def test_streamer_matches_jax(stateful):
    """TAEHVStreamer over chunks of 1, 3 and 2 latent frames, in both
    modes (the overlap mode re-decodes the last 3 latent frames)."""
    jp, tp, x = _setup(2, 6)
    js = jtaehv.TAEHVStreamer(jp, overlap=3, stateful=stateful)
    ts = ttaehv.TAEHVStreamer(tp, overlap=3, stateful=stateful)
    for lo, hi in ((0, 1), (1, 4), (4, 6)):
        j = js.decode_chunk(jnp.asarray(x[:, lo:hi]))
        t = ts.decode_chunk(torch.from_numpy(x[:, lo:hi]))
        assert t.shape == j.shape
        _close(t, j)


def test_init_decoder_params_has_the_jax_tree():
    """Same keys and, after the HWIO -> OIHW bridge, the same shapes."""
    jp = params_from_jax(jax.tree.map(
        np.asarray, jtaehv.init_decoder_params(jax.random.PRNGKey(0))),
        "taehv", device="cpu")
    tp = ttaehv.init_decoder_params(seed=0, device="cpu")
    jflat = {k: v.shape for k, v in _flat(jp)}
    tflat = {k: v.shape for k, v in _flat(tp)}
    assert tflat == jflat
    assert all(v.dtype == torch.float32 for _, v in _flat(tp))


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ------------------------------------------------------------ encoder

def _encoder_setup(seed):
    rng = np.random.default_rng(seed)
    jp = jtaehv.init_encoder_params(jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    return jp, params_from_jax(jp, "taehv", device="cpu"), rng


def test_encode_video_matches_jax():
    """8 RGB frames at 32x48 -> 2 latent frames at 4x6, through the three
    TPools (2, 2, 1), the stride-2 convs and nine MemBlocks."""
    jp, tp, rng = _encoder_setup(3)
    x = rng.uniform(size=(N, 8, 3, 32, 48)).astype(np.float32)
    j = jtaehv.encode_video(jp, jnp.asarray(x))
    t = ttaehv.encode_video(tp, torch.from_numpy(x))
    assert t.shape == (N, 2, C, 4, 6) == j.shape
    _close(t, j)
    with pytest.raises(ValueError, match="divisible by 4"):
        ttaehv.encode_video(tp, torch.zeros(1, 6, 3, 32, 48))


def test_init_encoder_params_has_the_jax_tree():
    jp = params_from_jax(jax.tree.map(
        np.asarray, jtaehv.init_encoder_params(jax.random.PRNGKey(0))),
        "taehv", device="cpu")
    tp = ttaehv.init_encoder_params(seed=0, device="cpu")
    assert {k: v.shape for k, v in _flat(tp)} == \
        {k: v.shape for k, v in _flat(jp)}


# ---------------------------------------------------------- converters

def _reference_state_dict(seed, tgrow0_stride=1, skip=False):
    """A random state dict in ``taew2_1.pth``'s key layout (the
    reference's Sequential indices, torch OIHW), built here: the decoder,
    the encoder, optionally a first TGrow saved with a larger stride than
    the decoder's (the converter keeps its last timestep's channels) and
    one MemBlock with a 1x1 skip conv."""
    rng = np.random.default_rng(seed)

    def w(*shape):   # weights at 0.5 / sqrt(fan in), biases at 0.05
        scale = 0.5 / np.sqrt(np.prod(shape[1:])) if len(shape) > 1 else 0.05
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    sd = {"decoder.1.weight": w(256, 16, 3, 3), "decoder.1.bias": w(256)}
    for s, (cin, cout) in enumerate(zip(ttaehv.N_F[:-1], ttaehv.N_F[1:])):
        for m in range(3):
            base = f"decoder.{3 + 6 * s + m}.conv"
            for j, i in ((0, 2 * cin), (2, cin), (4, cin)):
                sd[f"{base}.{j}.weight"] = w(cin, i, 3, 3)
                sd[f"{base}.{j}.bias"] = w(cin)
        stride = (tgrow0_stride, 2, 2)[s]
        sd[f"decoder.{7 + 6 * s}.conv.weight"] = w(cin * stride, cin, 1, 1)
        sd[f"decoder.{8 + 6 * s}.weight"] = w(cout, cin, 3, 3)
    sd["decoder.22.weight"] = w(3, 64, 3, 3)
    sd["decoder.22.bias"] = w(3)
    sd["encoder.0.weight"], sd["encoder.0.bias"] = w(64, 3, 3, 3), w(64)
    for s, stride in enumerate((2, 2, 1)):
        sd[f"encoder.{2 + 5 * s}.conv.weight"] = w(64, 64 * stride, 1, 1)
        sd[f"encoder.{3 + 5 * s}.weight"] = w(64, 64, 3, 3)
        for m in range(3):
            base = f"encoder.{4 + 5 * s + m}.conv"
            for j, i in ((0, 128), (2, 64), (4, 64)):
                sd[f"{base}.{j}.weight"] = w(64, i, 3, 3)
                sd[f"{base}.{j}.bias"] = w(64)
    sd["encoder.17.weight"], sd["encoder.17.bias"] = w(16, 64, 3, 3), w(16)
    if skip:
        sd["decoder.9.skip.weight"] = w(128, 128, 1, 1)
        sd["encoder.4.skip.weight"] = w(64, 64, 1, 1)
    return sd


@pytest.mark.parametrize("tgrow0_stride,skip", [(1, False), (2, True)],
                         ids=["as_built", "patched_tgrow_skip"])
def test_converters_match_jax(tgrow0_stride, skip):
    """``convert_taehv_state_dict`` (decoder + encoder) and
    ``convert_taehv_encoder_state_dict``: the port's tree equals the JAX
    package's, converted to OIHW, leaf for leaf; the export writes the
    state dict back (the first TGrow as the decoder uses it)."""
    sd = _reference_state_dict(4, tgrow0_stride, skip)
    j = params_from_jax(jax.tree.map(
        np.asarray, jtaehv.convert_taehv_state_dict(
            {k: v.numpy() for k, v in sd.items()})), "taehv", device="cpu")
    t = ttaehv.convert_taehv_state_dict(sd, device="cpu")
    jf, tf = dict(_flat(j)), dict(_flat(t))
    assert tf.keys() == jf.keys()
    assert ("emem0_0", "conv0", "w") in tf and \
        (("mem1_0", "skip", "w") in tf) == skip
    for k in tf:
        assert torch.equal(tf[k], jf[k]), k
    assert tf[("tgrow0", "w")].shape == (256, 256, 1, 1)
    enc = ttaehv.convert_taehv_encoder_state_dict(sd, device="cpu")
    jenc = params_from_jax(jax.tree.map(
        np.asarray, jtaehv.convert_taehv_encoder_state_dict(sd)),
        "taehv", device="cpu")
    assert {k: v for k, v in _flat(enc)}.keys() == dict(_flat(jenc)).keys()
    assert all(torch.equal(v, dict(_flat(jenc))[k]) for k, v in _flat(enc))
    back = ttaehv.export_taehv_state_dict(t)
    if tgrow0_stride == 1:
        assert back.keys() == sd.keys()
        assert all(torch.equal(back[k], sd[k]) for k in sd)
    again = ttaehv.convert_taehv_state_dict(back, device="cpu")
    assert all(torch.equal(v, tf[k]) for k, v in _flat(again))


def test_converted_checkpoint_decodes_as_jax():
    """A converted checkpoint through both decoders and encoders."""
    sd = _reference_state_dict(5)
    jp = jtaehv.convert_taehv_state_dict({k: v.numpy() for k, v in sd.items()})
    tp = ttaehv.convert_taehv_state_dict(sd, device="cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((N, 2, C, H, W)).astype(np.float32)
    _close(ttaehv.decode_video(tp, torch.from_numpy(x)),
           jtaehv.decode_video(jp, jnp.asarray(x)))
    v = rng.uniform(size=(N, 4, 3, 8 * H, 8 * W)).astype(np.float32)
    _close(ttaehv.encode_video(tp, torch.from_numpy(v)),
           jtaehv.encode_video(jp, jnp.asarray(v)))


# ---------------------------------------------------------------- int8

@pytest.fixture
def quantized():
    jp, tp, _ = _setup(6, 1)
    jq = jtaehv.quantize_decoder_params(jax.tree.map(jnp.asarray, jp))
    return jq, ttaehv.quantize_decoder_params(tp)


def test_quantize_decoder_params_matches_jax(quantized):
    """Every conv (TGrow's 1x1 too) int8 with per-output-channel scales,
    equal to the JAX package's tree converted to OIHW."""
    jq, tq = quantized
    jflat = dict(_flat(params_from_jax(jax.tree.map(np.asarray, jq),
                                       "taehv", device="cpu")))
    tflat = dict(_flat(tq))
    assert tflat.keys() == jflat.keys()
    assert not any(k[-1] == "w" for k in tflat)
    for k, v in tflat.items():
        assert v.dtype == jflat[k].dtype and torch.equal(v, jflat[k]), k


def test_int8_decode_is_bit_equal_to_jax(quantized, monkeypatch):
    """The whole int8 decoder (24 int8 convs) and the stateful stream over
    it (two 1-frame chunks: each chunk has its own activation scales)
    equal the JAX package's eager decodes bit for bit.  The clamp's tanh
    is XLA's in both (see the module docstring)."""
    jq, tq = quantized
    x = np.random.default_rng(7).standard_normal(
        (N, 2, C, H, W)).astype(np.float32) * 2
    j = np.asarray(jtaehv.decode_video(jq, jnp.asarray(x)))
    tanh = torch.tanh
    monkeypatch.setattr(torch, "tanh", lambda v: torch.from_numpy(np.array(
        jnp.tanh(jnp.asarray(v.numpy())))) if v.device.type == "cpu"
        else tanh(v))
    t = ttaehv.decode_video(tq, torch.from_numpy(x)).numpy()
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)
    s = ttaehv.TAEHVStreamer(tq)
    jstate = None
    for i in range(2):
        jc, jstate = jtaehv.decode_video_stateful(
            jq, jnp.asarray(x[:, i:i + 1]), jstate, trim=jstate is None)
        tc = s.decode_chunk(torch.from_numpy(x[:, i:i + 1])).numpy()
        np.testing.assert_array_equal(tc, np.asarray(jc))


@pytest.mark.parametrize("k,stride", [(3, 1), (3, 2), (1, 1)])
def test_int8_conv_sums_past_2_24_exactly(k, stride):
    """``_conv_q`` where every int8 sum passes 2^24 (4608 taps, the
    decoder's widest conv, of large positive products: float32 would
    round them): bit-equal to the JAX package's s32 conv, and its integer
    sums equal numpy's int64."""
    rng = np.random.default_rng(k + stride)
    cin, cout = 4608 // (k * k), 24
    xx = rng.uniform(0.6, 1.0, (2, 6, 7, cin)).astype(np.float32)
    w_q = rng.integers(100, 128, (k, k, cin, cout)).astype(np.int8)
    w_scale = rng.uniform(1e-3, 2e-3, cout).astype(np.float32)
    jp = {"w_q": jnp.asarray(w_q), "w_scale": jnp.asarray(w_scale),
          "b": jnp.asarray(rng.standard_normal(cout).astype(np.float32))}
    pad = (k - 1) // 2
    j = np.asarray(jtaehv._conv_q(jp, jnp.asarray(xx), stride,
                                  ((pad, pad), (pad, pad))))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "taehv", device="cpu")
    t = ttaehv._conv_q(tp, torch.from_numpy(xx), stride, pad).numpy()
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)
    xq = torch.from_numpy(np.clip(np.round(xx / (xx.max() / np.float32(
        127))), -127, 127).astype(np.int8))
    sums = ttaehv._int8_conv(xq, tp["w_q"], stride, pad).numpy()
    xp = np.pad(xq.numpy().astype(np.int64),
                ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ref = sum(np.einsum("nhwc,co->nhwo",
                        xp[:, i:i + stride * (sums.shape[1] - 1) + 1:stride,
                           jj:jj + stride * (sums.shape[2] - 1) + 1:stride],
                        w_q[i, jj].astype(np.int64))
              for i in range(k) for jj in range(k))
    assert ref.min() > 2 ** 24
    np.testing.assert_array_equal(sums, ref.astype(np.float32))


def test_int8_conv_chunks_equal_one_pass(monkeypatch):
    """The unfold runs a chunk of frames at a time (bounded operand bytes
    on the card); one frame a chunk gives the same sums as one pass."""
    rng = np.random.default_rng(9)
    xq = torch.from_numpy(rng.integers(-127, 128, (5, 6, 7, 32), np.int8))
    w_q = torch.from_numpy(rng.integers(-127, 128, (40, 32, 3, 3), np.int8))
    whole = ttaehv._int8_conv(xq, w_q, 2, 1)
    monkeypatch.setattr(ttaehv, "_UNFOLD_BYTES", 1)
    assert torch.equal(ttaehv._int8_conv(xq, w_q, 2, 1), whole)
    assert whole.shape == (5, 3, 4, 40)
