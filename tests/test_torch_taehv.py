"""The port's TAEHV decoder (models/taehv.py) against the JAX package on
the CPU, float32, weights crossed over by ``params_from_jax(..., "taehv")``
(HWIO -> OIHW) with every leaf perturbed so the zero biases take part.

Tolerance 1e-4 against JAX: both sum each conv in float32, in another
order, through 24 convs.  The port's chunked stream against its own
whole-video decode: 1e-5 (the same convs on other batch groupings of the
same frames)."""
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
