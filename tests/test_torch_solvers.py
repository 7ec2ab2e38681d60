"""The port's flow solvers (``self_forcing_tpu_torch/solvers.py``) against
the JAX package's on the CPU: the UniPC and DPM-Solver++ coefficient
tables, built in float64 numpy by both, equal to 1e-12 and bit-equal once
stored as float32 (with the sigmas and the model's timesteps); one
``step`` at the first, second, a middle and the last index on a random
state within 1e-6 relative; a 50-step ``sample`` on a linear toy flow
within 1e-5 relative L2; and ``make_solver``'s dispatch and its error."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_forcing_tpu import solvers as jsol
from self_forcing_tpu_torch import solvers as tsol

GRID = [(4, 5.0), (50, 8.0)]
NAMES = ["unipc", "dpm++"]


def _both(name, steps, shift):
    return (jsol.make_solver(name, steps, shift),
            tsol.make_solver(name, steps, shift, device="cpu"))


def _sigmas(name, steps, shift, mod):
    if name == "unipc":
        sigma_max = 1.0 - 1.0 / 1000
        s = np.linspace(sigma_max, 0.0, steps + 1)[:-1]
        s = shift * s / (1 + (shift - 1) * s)
        return np.concatenate([s, [0.0]])
    return np.concatenate([mod.get_sampling_sigmas(steps, shift), [0.0]])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("steps,shift", GRID)
def test_tables_match_jax(name, steps, shift):
    js = _sigmas(name, steps, shift, jsol)
    ts = _sigmas(name, steps, shift, tsol)
    np.testing.assert_array_equal(ts, js)
    if name == "unipc":
        jp, jc = jsol._unipc_coeffs(js)
        tp, tc = tsol._unipc_coeffs(ts)
        np.testing.assert_allclose(tc, jc, rtol=1e-12, atol=1e-12)
    else:
        jp, tp = jsol._dpmpp_coeffs(js), tsol._dpmpp_coeffs(ts)
    assert tp.dtype == jp.dtype == np.float64
    np.testing.assert_allclose(tp, jp, rtol=1e-12, atol=1e-12)
    jsolver, tsolver = _both(name, steps, shift)
    for field in ("sigmas", "pred", "corr"):
        t = getattr(tsolver, field)
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(getattr(jsolver, field)))
    np.testing.assert_array_equal(tsolver.timesteps, jsolver.timesteps)
    assert tsolver.num_steps == jsolver.num_steps == steps
    assert tsolver.has_corrector == jsolver.has_corrector == (name == "unipc")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("i", [0, 1, 25, 49])
def test_step_matches_jax(name, i):
    jsolver, tsolver = _both(name, 50, 8.0)
    rng = np.random.default_rng(i)
    m1, m2, last, flow, x = (rng.standard_normal((1, 2, 4, 4, 4)).astype(
        np.float32) for _ in range(5))
    jstate, jx = jsolver.step(i, jsol.SolverState(
        m1=jnp.asarray(m1), m2=jnp.asarray(m2), last=jnp.asarray(last)),
        jnp.asarray(flow), jnp.asarray(x))
    tstate, tx = tsolver.step(i, tsol.SolverState(
        m1=torch.from_numpy(m1), m2=torch.from_numpy(m2),
        last=torch.from_numpy(last)), torch.from_numpy(flow),
        torch.from_numpy(x))
    for got, want in ((tx, jx), (tstate.m1, jstate.m1),
                      (tstate.m2, jstate.m2), (tstate.last, jstate.last)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_sample_on_a_linear_flow_matches_jax(name):
    """50 steps of a flow linear in x with a t-dependent offset, so the
    multistep buffers and the corrector all enter."""
    jsolver, tsolver = _both(name, 50, 8.0)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((1, 3, 4, 8, 8)).astype(np.float32)
    offset = rng.standard_normal(noise.shape).astype(np.float32)

    def jflow(x, t, i):
        return 0.3 * x + 0.05 * np.sin(0.01 * t) * jnp.asarray(offset)

    def tflow(x, t, i):
        return 0.3 * x + 0.05 * np.sin(0.01 * t) * torch.from_numpy(offset)

    want = np.asarray(jsolver.sample(jflow, jnp.asarray(noise)))
    got = tsolver.sample(tflow, torch.from_numpy(noise)).numpy()
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= 1e-5, err


@pytest.mark.parametrize("name,corrector", [("unipc", True), ("dpm++", False),
                                            ("dpmpp", False), ("dpm", False)])
def test_make_solver_dispatch(name, corrector):
    jsolver, tsolver = _both(name, 6, 3.0)
    assert tsolver.has_corrector == jsolver.has_corrector == corrector
    np.testing.assert_array_equal(tsolver.pred.numpy(),
                                  np.asarray(jsolver.pred))
    with pytest.raises(NotImplementedError, match="Unsupported solver"):
        tsol.make_solver("euler", 6, 3.0, device="cpu")
    with pytest.raises(NotImplementedError, match="Unsupported solver"):
        jsol.make_solver("euler", 6, 3.0)
