"""The port's quantized linears (ops/quant.py) and the plain versions of
its W8A8 kernels (ops/cuda_matmul.py) against the JAX package on the CPU.

Inputs come from numpy seeds.  The JAX side of every W8A8 comparison runs
the Pallas kernels of ops/pallas_matmul.py with ``interpret=True`` (the
route the CUDA kernels replace; JAX's own CPU route quantizes the FFN
hidden per token, a different function).  Tolerances:
- int8 weights and int8 activations: equal.  XLA may divide by 127 as a
  multiplication by its reciprocal, one ulp off a true division; a scale
  one ulp apart flips a value only when x / s lies within an ulp of a .5
  tie, which these inputs do not reach.
- scales: 1e-6 relative (the same ulp).
- products: 1e-5 relative L2 (the int32 sums are exact on both sides; the
  f32 epilogue differs by the scales' ulp).
- the FFN hidden: gelu's tanh differs by ulps between XLA and PyTorch, so
  a hidden value may round one int8 step the other way: at most 0.5% of
  them, by one step; the FFN output to 1e-3 relative L2.
"""
import functools

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
import ml_dtypes
import numpy as np
import pytest
import torch

from self_forcing_tpu.models.wan import dit as jdit
from self_forcing_tpu.models.wan.configs import WAN_TINY as J_TINY
from self_forcing_tpu.ops import pallas_matmul as jpm
from self_forcing_tpu.ops import quant as jquant
from self_forcing_tpu_torch.ops import cuda_matmul as cm
from self_forcing_tpu_torch.ops import quant as tquant
from self_forcing_tpu_torch.params import params_from_jax


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.float8_e4m3fn:
            return t.float().numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype == ml_dtypes.float8_e4m3fn else a


def _linear(rng, d_in, d_out, lead=(), scale=0.05):
    w = (rng.standard_normal(lead + (d_in, d_out)) * scale).astype(np.float32)
    b = (rng.standard_normal(lead + (d_out,)) * 0.1).astype(np.float32)
    return w, b


def _pair(w, b):
    return ({"w": jnp.asarray(w), "b": jnp.asarray(b)},
            {"w": torch.from_numpy(w.copy()), "b": torch.from_numpy(b.copy())})


def _assert_scales(t, j):
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=0)


@pytest.fixture
def pallas_route(monkeypatch):
    """The JAX package's TPU route, with its Pallas kernels interpreted."""
    monkeypatch.setattr(jquant, "_use_pallas", lambda: True)
    for name in ("quantize_rows_pallas", "w8a8_matmul", "w8a8_matmul_bf16x",
                 "w8a8_ffn"):
        monkeypatch.setattr(jpm, name, functools.partial(
            getattr(jpm, name), interpret=True))


@pytest.mark.parametrize("mode", ["w8", "w8a8", "fp8"])
def test_quantize_linear_params_matches_jax(mode):
    rng = np.random.default_rng(0)
    w, b = _linear(rng, 256, 384, lead=(2,))
    w[1, :, 7] = 0.0   # a zero output channel: the 1e-8 scale floor
    jp, tp = _pair(w, b)
    jq = jquant.quantize_linear_params(jp, mode)
    tq = tquant.quantize_linear_params(tp, mode)
    key = {"w8": "w_q", "w8a8": "w_qa", "fp8": "w_f8"}[mode]
    assert set(jq) == {key, "w_scale", "b"}
    assert set(tq) - {"w_qa_t"} == set(jq)
    np.testing.assert_array_equal(_np(tq[key]), _np(jq[key]))
    _assert_scales(tq["w_scale"], jq["w_scale"])
    if mode == "w8a8":
        np.testing.assert_array_equal(
            tq["w_qa_t"].numpy(), np.swapaxes(_np(jq["w_qa"]), -1, -2))


def test_quantize_linear_params_refuses_unmerged_lora():
    p = {"w": torch.zeros(8, 8), "lora_A": torch.zeros(8, 2)}
    with pytest.raises(ValueError):
        tquant.quantize_linear_params(p)


@pytest.mark.parametrize("fp8", [False, True], ids=["int8", "fp8"])
def test_quantize_activations_matches_jax(fp8):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 20, 256)).astype(np.float32)
    x[0, 4] = 0.0
    jfn = jquant.quantize_activations_fp8 if fp8 else \
        jquant.quantize_activations
    tfn = tquant.quantize_activations_fp8 if fp8 else \
        tquant.quantize_activations
    jq, js = jfn(jnp.asarray(x))
    tq, ts = tfn(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(tq), _np(jq))
    _assert_scales(ts, js)


@pytest.mark.parametrize("mode,rows", [("w8", 48), ("fp8", 48),
                                       ("w8a8", 48), ("w8a8", 12)],
                         ids=["w8", "fp8", "w8a8", "w8a8_declined"])
def test_quantized_linear_matches_jax(pallas_route, mode, rows):
    """w8a8 at 48 rows runs the quantize_rows and w8a8_matmul kernels'
    routes; at 12 rows (not a multiple of 8) both packages decline them
    and fall back to per-token quantization and a plain int product."""
    rng = np.random.default_rng(2)
    w, b = _linear(rng, 256, 384)
    jp, tp = _pair(w, b)
    x = rng.standard_normal((2, rows // 2, 256)).astype(np.float32)
    jy = jquant.quantized_linear(jquant.quantize_linear_params(jp, mode),
                                 jnp.asarray(x))
    ty = tquant.quantized_linear(tquant.quantize_linear_params(tp, mode),
                                 torch.from_numpy(x))
    assert ty.shape == (2, rows // 2, 384)
    assert _rel_l2(ty.numpy(), jy) < 1e-5


def test_quantize_dit_params_fused_qkv_matches_jax():
    rng = np.random.default_rng(3)
    cfg = J_TINY
    jp = jdit.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jp)
    tp = params_from_jax(jp, "dit", device="cpu")
    jq = jquant.quantize_dit_params(jp, min_dim=64, fuse_qkv=True)
    tq = tquant.quantize_dit_params(tp, min_dim=64, fuse_qkv=True)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jq)[0])
    seen = 0

    def walk(node, path):
        nonlocal seen
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            if k == "w_qa_t":
                continue
            ref = jflat[tuple(jax.tree_util.DictKey(p) for p in path + (k,))]
            if k == "w_scale":
                _assert_scales(v, ref)
            else:
                np.testing.assert_array_equal(_np(v), _np(ref))
            seen += 1

    walk(tq, ())
    assert seen == len(jflat)
    sa = tq["blocks"]["self_attn"]
    assert "qkv" in sa and "q" not in sa
    assert sa["qkv"]["w_qa"].shape == (cfg.num_layers, cfg.dim, 3 * cfg.dim)
    assert "w" in tq["blocks"]["self_attn"]["norm_q"]   # norms stay


def test_params_bridge_carries_quantized_leaves():
    rng = np.random.default_rng(4)
    w, b = _linear(rng, 128, 256)
    jp, _ = _pair(w, b)
    tree = {"a": jquant.quantize_linear_params(jp, "w8a8"),
            "f": jquant.quantize_linear_params(jp, "fp8")}
    tree = jax.tree.map(np.asarray, tree)
    t = params_from_jax(tree, "dit", device="cpu", dtype=torch.bfloat16)
    assert t["a"]["w_qa"].dtype == torch.int8
    np.testing.assert_array_equal(t["a"]["w_qa_t"].numpy(),
                                  tree["a"]["w_qa"].T)
    assert t["f"]["w_f8"].dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_np(t["f"]["w_f8"]), _np(tree["f"]["w_f8"]))
    assert t["a"]["w_scale"].dtype == torch.float32
    assert t["a"]["b"].dtype == torch.bfloat16


# ---------------------------------------------------- the kernels' plain versions

def _x_with_edges(rng, M, K):
    """Random rows plus a zero row (the scale floor) and a row whose
    values land on .5 ties (max 127 -> scale 1)."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[3] = 0.0
    x[5] = np.round(rng.uniform(-100, 100, K)) + 0.5
    x[5, 0] = 127.0
    return x


@pytest.mark.parametrize("M,K", [(48, 256), (4680 // 15, 1536)])
def test_quantize_rows_ref_matches_pallas(M, K):
    rng = np.random.default_rng(5)
    x = _x_with_edges(rng, M, K)
    jq, js = jpm.quantize_rows_pallas(jnp.asarray(x), interpret=True)
    tq, ts = cm.quantize_rows_ref(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.shape == (M, 1)
    _assert_scales(ts[:, 0], np.asarray(js)[:, 0])


def test_w8a8_matmul_ref_matches_pallas():
    rng = np.random.default_rng(6)
    M, K, N = 48, 256, 384
    x = _x_with_edges(rng, M, K)
    w, b = _linear(rng, K, N)
    jp, tp = _pair(w, b)
    jl, tl = (jquant.quantize_linear_params(jp),
              tquant.quantize_linear_params(tp))
    jq, js = jpm.quantize_rows_pallas(jnp.asarray(x), interpret=True)
    tq, ts = cm.quantize_rows_ref(torch.from_numpy(x))
    jy = jpm.w8a8_matmul(jq, js, jl["w_qa"], jl["w_scale"], jl["b"],
                         out_dtype=jnp.float32, interpret=True)
    ty = cm.w8a8_matmul_ref(tq, ts, tl["w_qa_t"], tl["w_scale"], tl["b"],
                            out_dtype=torch.float32)
    assert _rel_l2(ty.numpy(), jy) < 1e-5


def test_w8a8_ffn_ref_matches_pallas():
    """H = 1792: two 896-column groups of the hidden."""
    rng = np.random.default_rng(7)
    M, K, H, N = 48, 256, 1792, 256
    x = _x_with_edges(rng, M, K)
    (w1, b1), (w2, b2) = _linear(rng, K, H, scale=0.06), \
        _linear(rng, H, N, scale=0.03)
    j1, t1 = (f(p) for f, p in zip(
        (jquant.quantize_linear_params, tquant.quantize_linear_params),
        _pair(w1, b1)))
    j2, t2 = (f(p) for f, p in zip(
        (jquant.quantize_linear_params, tquant.quantize_linear_params),
        _pair(w2, b2)))
    assert cm.ffn_group(M, K, H, N, raw_x=True) == 896
    jy = jpm.w8a8_ffn(jnp.asarray(x), None, j1["w_qa"], j1["w_scale"],
                      j1["b"], j2["w_qa"], j2["w_scale"], j2["b"],
                      out_dtype=jnp.float32, interpret=True)
    ty = cm.w8a8_ffn_ref(torch.from_numpy(x), None, t1["w_qa_t"],
                         t1["w_scale"], t1["b"], t2["w_qa_t"],
                         t2["w_scale"], t2["b"], out_dtype=torch.float32)
    assert _rel_l2(ty.numpy(), jy) < 1e-3

    # the hidden against the fc1 Pallas kernel alone
    hq, hs = cm.w8a8_ffn1(torch.from_numpy(x), t1["w_qa_t"],
                          t1["w_scale"], t1["b"], 896)
    jh = jax.jit(functools.partial(_jax_ffn1, tg=896))(
        jnp.asarray(x), j1["w_qa"], j1["w_scale"], j1["b"])
    jhq, jhs = (np.asarray(a) for a in jh)
    step = np.abs(hq.numpy().astype(np.int32) - jhq.astype(np.int32))
    assert step.max() <= 1 and (step > 0).mean() <= 5e-3
    np.testing.assert_allclose(hs.numpy(), jhs[:, ::128], rtol=1e-5)


def _jax_ffn1(x, w1, ws, b, tg):
    """The JAX package's fc1 kernel (raw x) run alone, interpreted."""
    from jax.experimental import pallas as pl
    M, K = x.shape
    H = w1.shape[1]
    return pl.pallas_call(
        jpm._ffn1_kernel_bf16x, grid=(M // 8, H // tg),
        in_specs=[pl.BlockSpec((8, K), lambda i, j: (i, 0)),
                  pl.BlockSpec((K, tg), lambda i, j: (0, j)),
                  pl.BlockSpec((1, tg), lambda i, j: (0, j)),
                  pl.BlockSpec((1, tg), lambda i, j: (0, j))],
        out_specs=[pl.BlockSpec((8, tg), lambda i, j: (i, j)),
                   pl.BlockSpec((8, 128), lambda i, j: (i, j))],
        out_shape=[jax.ShapeDtypeStruct((M, H), jnp.int8),
                   jax.ShapeDtypeStruct((M, (H // tg) * 128), jnp.float32)],
        interpret=True,
    )(x, w1, ws.reshape(1, H), b.reshape(1, H))


def _jax_ffn2(h_q, h_s, w2, ws, b, tg):
    """The JAX package's fc2 kernel run alone, interpreted: h_s [M, ng]
    broadcast across the 128 lanes of each group, as fc1 writes it."""
    from jax.experimental import pallas as pl
    M, H = h_q.shape
    N = w2.shape[1]
    ng = H // tg
    return pl.pallas_call(
        functools.partial(jpm._ffn2_kernel, nk=ng), grid=(M // 8, 1, ng),
        in_specs=[pl.BlockSpec((8, tg), lambda i, j, k: (i, k)),
                  pl.BlockSpec((8, 128), lambda i, j, k: (i, k)),
                  pl.BlockSpec((tg, N), lambda i, j, k: (k, j)),
                  pl.BlockSpec((1, N), lambda i, j, k: (0, j)),
                  pl.BlockSpec((1, N), lambda i, j, k: (0, j))],
        out_specs=pl.BlockSpec((8, N), lambda i, j, k: (i, j)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32),
        scratch_shapes=[pltpu.VMEM((8, N), jnp.float32)],
        interpret=True,
    )(h_q, jnp.repeat(h_s, 128, axis=1), w2, ws.reshape(1, N),
      b.reshape(1, N))


@pytest.mark.parametrize("tg", [768, 896])
def test_w8a8_ffn2_ref_matches_pallas_fc2_alone(tg):
    """fc2 alone against the interpreted ``_ffn2_kernel``, from a seeded
    int8 hidden of three groups whose scales differ by 10^6 (~1e3, ~1e-3,
    ~1 times a per-row factor): each group's exact int32 partial takes its
    own row scale, so a wrong group or a wrong scale is off by orders of
    magnitude.  1e-6 relative L2: XLA may contract the interpreted
    kernel's ``acc += p * s`` into one rounding, which the plain version
    (every product and sum rounded on its own, as the CUDA kernel) does
    not.  The card test holds the kernel to the plain version bit for
    bit."""
    rng = np.random.default_rng(36)
    M, N, ng = 48, 256, 3
    H = ng * tg
    hq = rng.integers(-127, 128, (M, H), dtype=np.int8)
    hs = (rng.uniform(0.5, 2.0, (M, 1)) * np.array([1e3, 1e-3, 1.0])
          ).astype(np.float32)
    w2 = rng.integers(-127, 128, (H, N), dtype=np.int8)
    ws = rng.uniform(1e-4, 1e-3, N).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    jy = jax.jit(functools.partial(_jax_ffn2, tg=tg))(
        jnp.asarray(hq), jnp.asarray(hs), jnp.asarray(w2), jnp.asarray(ws),
        jnp.asarray(b))
    ty = cm.w8a8_ffn2_ref(torch.from_numpy(hq), torch.from_numpy(hs),
                          torch.from_numpy(np.ascontiguousarray(w2.T)),
                          torch.from_numpy(ws), torch.from_numpy(b), tg,
                          out_dtype=torch.float32)
    assert _rel_l2(ty.numpy(), np.asarray(jy)) < 1e-6


@pytest.mark.parametrize("M,K,H,N", [
    (48, 256, 1792, 256), (4680, 1536, 8960, 1536), (44, 256, 1792, 256),
    (48, 200, 1792, 256), (48, 1664, 1792, 256), (48, 256, 1800, 256),
    (512, 1536, 4608, 1536), (48, 4224, 256, 256)])
def test_tile_rules_match_jax(M, K, H, N):
    """The port declines exactly the shapes the JAX kernels decline
    (shapes only: the kernels are traced, not run)."""
    def declines(fn, *shapes):
        args = [jax.ShapeDtypeStruct(s, d) for s, d in shapes]
        return jax.eval_shape(fn, *args) is None

    f32, i8 = jnp.float32, jnp.int8
    assert (cm.quantize_rows_tiling(M, K) is None) == declines(
        jpm.quantize_rows_pallas, ((M, K), f32))
    assert (not cm.matmul_tiling(M, K, N)) == declines(
        jpm.w8a8_matmul, ((M, K), i8), ((M, 1), f32), ((K, N), i8),
        ((N,), f32))
    for raw_x in (True, False):
        ffn = functools.partial(jpm.w8a8_ffn, b1=None, b2=None)
        sx = None if raw_x else jnp.ones((M, 1), f32)
        assert (cm.ffn_group(M, K, H, N, raw_x) is None) == declines(
            lambda x, w1, s1, w2, s2: ffn(x, sx, w1, s1, w2_q=w2,
                                          w2_scale=s2),
            ((M, K), f32 if raw_x else i8), ((K, H), i8), ((H,), f32),
            ((H, N), i8), ((N,), f32))


# ------------------------------------------- true division and the bf16x GEMM

def _division_sensitive(rng, rows, cols):
    """Rows whose absmax lies in [0.5, 1): 4-5% of them have
    x * (1 / 127) != x / 127 (and the same for 448) in float32, so a
    reciprocal multiply in place of the division moves their scale."""
    x = rng.uniform(-1.0, 1.0, (rows, cols)).astype(np.float32)
    x[np.arange(rows), rng.integers(0, cols, rows)] = rng.uniform(
        0.5, 1.0, rows).astype(np.float32)
    return x


@pytest.mark.parametrize("name", ["quantize_activations",
                                  "quantize_activations_fp8",
                                  "_quantize_weight", "_quantize_weight_fp8"])
def test_quantization_helpers_divide_like_jax_bit_for_bit(name):
    """The port's four helpers divide by a tensor: their scales and
    quantized values equal the JAX package's bit for bit on inputs where a
    reciprocal multiply would differ (the same calls on CUDA are held to
    these in tests/test_torch_cuda_kernels.py)."""
    rng = np.random.default_rng(11)
    x = _division_sensitive(rng, 4000, 64)
    top = 448.0 if name.endswith("fp8") else 127.0
    amax = np.abs(x).max(axis=1)
    assert (amax / np.float32(top) != amax * np.float32(1.0 / top)).mean() \
        > 0.02
    if name.startswith("_quantize_weight"):
        x = np.ascontiguousarray(x.T)     # [in, out]: scales per column
        args = (0,)
    else:
        args = ()
    jv, js = getattr(jquant, name)(jnp.asarray(x), *args)
    tv, ts = getattr(tquant, name)(torch.from_numpy(x), *args)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_np(tv), _np(jv))


def test_w8a8_matmul_bf16x_ref_matches_pallas():
    """The plain version (per-token int8 as ``_quant_rows``: floor 1e-8
    before the division by 127, then the GEMM's epilogue) against the
    interpreted ``_kernel_bf16x``: the int32 sums are exact on both sides
    and the scales are equal (both divide), so the f32 results agree to
    rounding of the epilogue's order (1e-6 relative L2)."""
    rng = np.random.default_rng(12)
    M, K, N = 48, 384, 1536
    x = _x_with_edges(rng, M, K)
    w, b = _linear(rng, K, N)
    jp, tp = _pair(w, b)
    jl, tl = (jquant.quantize_linear_params(jp),
              tquant.quantize_linear_params(tp))
    assert cm.bf16x_tiling(M, K, N)
    jy = jpm.w8a8_matmul_bf16x(jnp.asarray(x), jl["w_qa"], jl["w_scale"],
                               jl["b"], out_dtype=jnp.float32,
                               interpret=True)
    ty = cm.w8a8_matmul_bf16x_ref(torch.from_numpy(x), tl["w_qa_t"],
                                  tl["w_scale"], tl["b"],
                                  out_dtype=torch.float32)
    assert _rel_l2(ty.numpy(), jy) < 1e-6
    # the same per-token quantization as quantize_rows (and its kernel)
    q, s = cm._quant_rows(torch.from_numpy(x), cm.ACT_FLOOR)
    rq, rs = cm.quantize_rows_ref(torch.from_numpy(x))
    assert torch.equal(q, rq) and torch.equal(s, rs)


@pytest.mark.parametrize("M,K,N", [(48, 256, 384), (44, 256, 384),
                                   (48, 1664, 384), (48, 256, 200),
                                   (4680, 1536, 4608)])
def test_bf16x_tile_rule_matches_jax(M, K, N):
    args = [jax.ShapeDtypeStruct(s, d) for s, d in
            (((M, K), jnp.float32), ((K, N), jnp.int8), ((N,), jnp.float32))]
    declined = jax.eval_shape(jpm.w8a8_matmul_bf16x, *args) is None
    assert (not cm.bf16x_tiling(M, K, N)) == declined


# ------------------- raw x = quantize_rows, then the int8-x kernels

def _jax_ffn1_xq(x_q, s_x, w1, ws, b, tg):
    """The JAX package's fc1 kernel from int8 x (``_ffn1_kernel``, K in
    one step) run alone, interpreted."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    M, K = x_q.shape
    H = w1.shape[1]
    return pl.pallas_call(
        functools.partial(jpm._ffn1_kernel, nk=1), grid=(M // 8, H // tg, 1),
        in_specs=[pl.BlockSpec((8, K), lambda i, j, k: (i, k)),
                  pl.BlockSpec((8, 1), lambda i, j, k: (i, 0)),
                  pl.BlockSpec((K, tg), lambda i, j, k: (k, j)),
                  pl.BlockSpec((1, tg), lambda i, j, k: (0, j)),
                  pl.BlockSpec((1, tg), lambda i, j, k: (0, j))],
        out_specs=[pl.BlockSpec((8, tg), lambda i, j, k: (i, j)),
                   pl.BlockSpec((8, 128), lambda i, j, k: (i, j))],
        out_shape=[jax.ShapeDtypeStruct((M, H), jnp.int8),
                   jax.ShapeDtypeStruct((M, (H // tg) * 128), jnp.float32)],
        scratch_shapes=[pltpu.VMEM((8, tg), jnp.int32)],
        interpret=True,
    )(x_q, s_x, w1, ws.reshape(1, H), b.reshape(1, H))


@pytest.mark.parametrize("M,K,H,N", [(48, 256, 1792, 256),
                                     (40, 1536, 1280, 384)])
def test_ffn1_from_raw_x_is_quantize_rows_then_int8_x(M, K, H, N):
    """The port runs raw-x fc1 as the ``quantize_rows`` kernel followed by
    fc1 from int8 x.  That is the same function, bit for bit in the int8
    hidden and its group scales (two groups here), on the port's plain
    versions and on the JAX package's interpreted kernels
    (``_ffn1_kernel_bf16x`` against ``quantize_rows_pallas`` then
    ``_ffn1_kernel``), and so through fc2 of ``w8a8_ffn``."""
    rng = np.random.default_rng(13)
    x = _x_with_edges(rng, M, K)
    (w1, b1), (w2, b2) = _linear(rng, K, H, scale=0.06), \
        _linear(rng, H, N, scale=0.03)
    j1, t1 = (f(p) for f, p in zip(
        (jquant.quantize_linear_params, tquant.quantize_linear_params),
        _pair(w1, b1)))
    j2, t2 = (f(p) for f, p in zip(
        (jquant.quantize_linear_params, tquant.quantize_linear_params),
        _pair(w2, b2)))
    tg = cm.ffn_group(M, K, H, N, raw_x=True)
    assert tg is not None and H // tg == 2

    xt = torch.from_numpy(x)
    a1 = (t1["w_qa_t"], t1["w_scale"], t1["b"], tg)
    hq, hs = cm.w8a8_ffn1_ref(xt, None, *a1)
    hq2, hs2 = cm.w8a8_ffn1_ref(*cm.quantize_rows_ref(xt), *a1)
    assert torch.equal(hq, hq2) and torch.equal(hs, hs2)

    xj = jnp.asarray(x)
    jq, js = jpm.quantize_rows_pallas(xj, interpret=True)
    raw = jax.jit(functools.partial(_jax_ffn1, tg=tg))(
        xj, j1["w_qa"], j1["w_scale"], j1["b"])
    pre = jax.jit(functools.partial(_jax_ffn1_xq, tg=tg))(
        jq, js[:, :1], j1["w_qa"], j1["w_scale"], j1["b"])
    for a, b in zip(raw, pre):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    ffn = functools.partial(jpm.w8a8_ffn, w1_q=j1["w_qa"],
                            w1_scale=j1["w_scale"], b1=j1["b"],
                            w2_q=j2["w_qa"], w2_scale=j2["w_scale"],
                            b2=j2["b"], out_dtype=jnp.float32,
                            interpret=True)
    np.testing.assert_array_equal(np.asarray(ffn(xj, None)),
                                  np.asarray(ffn(jq, js)))


@pytest.mark.parametrize("M,K,N", [(48, 384, 1536), (40, 1536, 768)])
def test_bf16x_is_quantize_rows_then_the_int8_linear(M, K, N):
    """``w8a8_matmul_bf16x`` runs as the ``quantize_rows`` kernel then the
    int8-x linear: on the port's plain versions the same bits as
    ``w8a8_matmul`` of ``quantize_rows``; on the JAX package's interpreted
    kernels ``_kernel_bf16x`` against ``quantize_rows_pallas`` then
    ``_kernel`` to 1e-6 relative L2 (XLA may order the epilogue's
    products differently in the two kernels)."""
    rng = np.random.default_rng(14)
    x = _x_with_edges(rng, M, K)
    w, b = _linear(rng, K, N)
    jp, tp = _pair(w, b)
    jl, tl = (jquant.quantize_linear_params(jp),
              tquant.quantize_linear_params(tp))
    xt = torch.from_numpy(x)
    args = (tl["w_qa_t"], tl["w_scale"], tl["b"])
    y = cm.w8a8_matmul_bf16x_ref(xt, *args, out_dtype=torch.float32)
    y2 = cm.w8a8_matmul_ref(*cm.quantize_rows_ref(xt), *args,
                            out_dtype=torch.float32)
    assert torch.equal(y, y2)

    xj = jnp.asarray(x)
    jy = jpm.w8a8_matmul_bf16x(xj, jl["w_qa"], jl["w_scale"], jl["b"],
                               out_dtype=jnp.float32, interpret=True)
    jq, js = jpm.quantize_rows_pallas(xj, interpret=True)
    jy2 = jpm.w8a8_matmul(jq, js, jl["w_qa"], jl["w_scale"], jl["b"],
                          out_dtype=jnp.float32, interpret=True)
    assert _rel_l2(jy, jy2) < 1e-6
    assert _rel_l2(y.numpy(), jy) < 1e-6
