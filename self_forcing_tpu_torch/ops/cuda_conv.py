"""Hand-written CUDA causal convs of the Wan VAE (csrc/conv3d.cu).

One implicit-GEMM kernel (``conv3d_launch``) replaces the four TPU kernels
of ``self_forcing_tpu/ops/pallas_conv.py``; each wrapper counts its
launches under the name of the entry point it serves:

- :func:`conv3d` as ``conv3d_fused`` (``_conv3d_kernel``) or
  ``conv3d_v2`` (``_conv3d_v2_kernel``): all 27 taps in one launch;
- :func:`conv2d_tap` as ``conv2d_9tap`` (``_conv2d_kernel``): one
  temporal tap of the split route;
- :func:`norm_silu_conv3d` as ``norm_silu_conv3d`` (``_nsc3d_kernel``): the
  inverse-norm pre-pass (``rms_inv_launch``) and the conv with the
  RMS-norm + SiLU prologue and the residual epilogue, one count a call.

Float32 inputs of :func:`conv3d` and :func:`conv2d_tap` (the TPU kernels'
f32 mode, which the fused and split rules accept at some shapes) run the
3xTF32 kernel ``conv3d_f32_launch`` (float32-accurate products on tf32
wgmma: the wide route's halo tiles, with the tile, K split and grid of
``conv_plan(f32=True)`` and the weights split once per parameter,
:func:`f32_weight`) and count as ``conv3d_f32`` whichever entry point
they serve.  Every C takes that route: C % 4 != 0 (the RGB input in
float32) is zero padded to a multiple of 4 channels first (a copy of x
and the cache, counted in ``layout_copies``).

Inside ``conv3d_launch`` a bf16 conv takes one of two routes, by shape,
as :func:`conv_plan` decides and the launcher checks: 'wide' (C % 8 ==
0; wgmma + TMA on halo tiles of 4 x 64 pixels, with the channel tile, K
split and grid the plan picks, K-split partials in an f32 workspace this
module allocates) or 'narrow' (the RGB input, C <= 3, whose 6-byte
pixels TMA cannot stride: K packed as 27 taps x C, :func:`rgb_weight`;
frames read as rows of W * C values, padded to a multiple of 8 by a copy
where they are not; counted once more as ``conv3d_rgb``).  Other C % 8
!= 0 are zero padded to a multiple of 8 channels (a copy of x and the
cache, counted in ``layout_copies``) and take the wide route.

The routing (which shapes take a kernel) and the plain versions live in
``ops/conv.py``; these wrappers take CUDA bf16 or float32 tensors (the
norm + SiLU conv bf16 only) and raise on anything else.  Activations are
channels-last [B, T, H, W, C]; a tensor
whose storage is not contiguous in that order is copied first, and each
such copy adds one to ``layout_copies`` (the first few are listed in
``copied``: wrapper, shape and strides).  Weights [Cout, C, 3, 3, 3]
(OIDHW) become the kernel's K-contiguous copy [Cout, 27, Cp] (bf16 with Cp
= C rounded up to 8, or float32 with Cp = C rounded up to 4, then split
into its tf32 parts) once per parameter and dtype: :func:`kernel_weight`
and :func:`f32_weight` keep it for as long as the parameter lives and is
not written in place.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from self_forcing_tpu_torch.ops import build

launch_counts = {"conv3d_fused": 0, "conv2d_9tap": 0, "conv3d_v2": 0,
                 "norm_silu_conv3d": 0, "conv3d_f32": 0, "conv3d_rgb": 0}

layout_copies = {"activations": 0}
copied: list = []

# the wide route's tile (csrc/conv3d.cu): output rows and columns, and the
# channels of one K step (bf16; float32: CK_F32)
TR, TW, CK, CK_F32 = 4, 64, 32, 16
MAX_SPLITS = 16
# the narrow route: inputs of at most RGB_MAX_C channels, K packed to RGB_K
RGB_MAX_C, RGB_K = 3, 96
# a K split must promise this much in conv_plan's model to be taken: the
# model leaves out the partials' traffic and their reduction, which made a
# promised 19% gain a 12% loss at 60x104, 384 channels
SPLIT_GAIN = 1.4

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_weights: WeakIdKeyDictionary = WeakIdKeyDictionary()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
    layout_copies["activations"] = 0
    copied.clear()


def _made_once(w: torch.Tensor, key, make) -> torch.Tensor:
    """``make()``, a kernel copy of parameter ``w``, kept under ``key`` for
    as long as ``w`` lives and is not written in place."""
    made = _weights.get(w)
    hit = None if made is None else made.get(key)
    if hit is not None and hit[0] == w._version:
        return hit[1]
    out = make()
    if made is None:
        made = _weights[w] = {}
    made[key] = (w._version, out)
    return out


def kernel_weight(w: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The kernel layout of a conv weight [Cout, C, 3, 3, 3] in ``dtype``
    (bf16 or float32): [Cout, 27, Cp], taps in (kt, di, dj) order,
    channels zero padded to 16 bytes (a multiple of 8 bf16 or 4 float32);
    made once per parameter and dtype (and again after an in-place write
    to it)."""
    def make():
        Cout, C = w.shape[:2]
        step = 16 // torch.tensor([], dtype=dtype).element_size()
        wk = w.detach().permute(0, 2, 3, 4, 1).reshape(Cout, 27, C)
        return F.pad(wk.to(dtype), (0, -(-C // step) * step - C)).contiguous()
    return _made_once(w, dtype, make)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``x`` as big = tf32(x) and small = tf32(x - big), each
    rounded to nearest with ties away from zero (the device's
    ``cvt.rna.tf32.f32``, csrc/attention_common.cuh::split_tf32): float32
    words whose low 13 mantissa bits are zero; big + small is x to ~2^-22
    of |x|."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    big = rna(x)
    return big, rna(x - big)


def f32_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The float32 kernel's weights: :func:`kernel_weight` in float32
    ([Cout, 27, Cp], Cp = C rounded up to 4) as its big and small tf32
    parts (:func:`split_tf32`), made once per parameter, as
    :func:`kernel_weight`."""
    return _made_once(w, "tf32",
                      lambda: split_tf32(kernel_weight(w, torch.float32)))


def rgb_weight(w: torch.Tensor) -> torch.Tensor:
    """The narrow route's weight [Cout, C <= 3, 3, 3, 3] as bf16 [Cout,
    RGB_K], K packed as k = ((kt * 3 + di) * 3 + dj) * C + c and zero
    past 27 C: for output pixel w, the 3 C values of k = (kt, di, *, *)
    are the contiguous run [C (w - 1), C (w + 2)) of image row h + di - 1
    of timeline frame t + kt, seen as rows of W * C values.  Made once per
    parameter, as :func:`kernel_weight`."""
    def make():
        Cout, C = w.shape[:2]
        wk = w.detach().permute(0, 2, 3, 4, 1).reshape(Cout, 27 * C)
        return F.pad(wk.to(torch.bfloat16), (0, RGB_K - 27 * C)).contiguous()
    return _made_once(w, "rgb", make)


def conv_plan(B: int, T: int, H: int, W: int, C: int, Cout: int,
              taps_t: int, sms: int, norm: bool = False,
              f32: bool = False) -> dict:
    """The kernel's route and work split on a card of ``sms`` SMs:
    ``route`` 'narrow' for C <= 3 (bn 0, splits 1, grid 0: the launcher
    sizes its grid), else 'wide' (at C rounded up to 8, the channels the
    wrapper pads to).  The wide route's output-channel tile ``bn``,
    ``tiles`` (4 x 64-pixel tiles x channel tiles), ``ksteps`` (temporal taps x
    32-channel steps a tile), ``splits``, the runs its K steps are cut
    into (1 for the ``norm`` + SiLU conv), and ``grid``, the persistent
    CTAs (one an SM, at most one an item).  An item costs its
    K steps plus one (the epilogue), each in proportion to bn + 32 (the
    halo's share of a step does not shrink with bn); the card takes
    ceil(items / sms) rounds.  bn is 192, 128, 96 or 64, the cheapest
    that divides Cout (a narrower tile for more items where the wide one
    leaves SMs idle: the 60x104 stage at 384 channels and T = 1 is 60
    tiles of 192 channels, 120 of 96), else 32 (the last tile masked
    where 32 does not divide Cout: the RGB head).  A K split writes f32
    partials that a second pass sums: it is taken where it beats no split
    by SPLIT_GAIN.  ``f32``: the float32 kernel, the wide route at every C
    (rounded up to 4, the channels the wrapper pads to), K steps of
    CK_F32 channels, bn 96 or 64 (a running sum beside each chain holds
    twice the accumulators), else 32."""
    if C <= RGB_MAX_C and not f32:
        return dict(route="narrow", bn=0, tiles=None, ksteps=None,
                    splits=1, grid=0)
    C = -(-C // 4) * 4 if f32 else -(-C // 8) * 8
    mtiles = B * T * -(-H // TR) * -(-W // TW)
    ksteps = taps_t * -(-C // (CK_F32 if f32 else CK))

    def cost(bn, s):
        return (-(-mtiles * -(-Cout // bn) * s // sms)
                * (-(-ksteps // s) + 1) * (bn + 32))

    tiles = (96, 64) if f32 else (192, 128, 96, 64)
    bn = min([b for b in tiles if Cout % b == 0] or [32],
             key=lambda b: cost(b, 1))
    splits = 1
    if not norm and Cout % bn == 0 and Cout % 8 == 0:
        s = min(range(1, min(ksteps, MAX_SPLITS) + 1),
                key=lambda s: cost(bn, s))
        if cost(bn, s) * SPLIT_GAIN < cost(bn, 1):
            splits = s
    tiles = mtiles * -(-Cout // bn)
    return dict(route="wide", bn=bn, tiles=tiles, ksteps=ksteps,
                splits=splits, grid=min(tiles * splits, sms))


_sms: dict = {}


def _sm_count(device: torch.device) -> int:
    if device not in _sms:
        _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sms[device]


def _copy(name: str, t: torch.Tensor, made: torch.Tensor) -> torch.Tensor:
    """Count ``made``, a copy of activation ``t`` in the kernel's layout."""
    layout_copies["activations"] += 1
    if len(copied) < 8:
        copied.append((name, tuple(t.shape), t.stride()))
    return made


def _cl(name: str, t: torch.Tensor,
        dtypes=(torch.bfloat16, torch.float32)) -> torch.Tensor:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes "
                        f"{' or '.join(map(str, dtypes))}, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name}: the kernel takes CUDA tensors")
    if t.is_contiguous():
        return t
    return _copy(name, t, t.contiguous())


def _launch(name: str, fn: str, *args) -> None:
    """Call the C launcher ``fn`` of csrc/conv3d.cu (tensors as pointers,
    None as null, ints, floats, then the current stream); raise on its
    error."""
    types = [_P if a is None or isinstance(a, torch.Tensor) else
             _F if isinstance(a, float) else _I for a in args]
    vals = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    f = build.function("conv3d", fn, types + [_P])
    build.raise_on(name, f(*vals, torch.cuda.current_stream().cuda_stream))


def _run(name: str, x, cache, w, b, taps_t: int, tau0: int,
         residual=None, gamma=None, eps: float = 0.0):
    """The conv of ``name``; with ``gamma``, the norm + SiLU prologue (its
    inverse norms from the rms_inv pre-pass; bf16 only) and
    ``residual``."""
    norm = gamma is not None
    dtypes = (torch.bfloat16,) if norm else (torch.bfloat16, torch.float32)
    x, cache = _cl(name, x, dtypes), _cl(name, cache, dtypes)
    B, T, H, W, C = x.shape
    if cache.shape != (B, 2, H, W, C) or cache.dtype != x.dtype:
        raise ValueError(f"{name}: cache {tuple(cache.shape)} "
                         f"{cache.dtype} for x {tuple(x.shape)} {x.dtype}")
    f32 = x.dtype == torch.float32
    if w.shape[1] != C:
        raise ValueError(f"{name}: weight {tuple(w.shape)} for {C} input "
                         f"channels")
    Cout = w.shape[0]
    bias = None if b is None else b.detach().float().contiguous()
    out = torch.empty(B, T, H, W, Cout, dtype=x.dtype, device=x.device)
    tau0 = tau0 if taps_t == 1 else 0
    if not f32 and C <= RGB_MAX_C and not norm:
        # the narrow route's TMA boxes read frames of H rows of W * C values
        # from 16-byte aligned rows: pad the rows where W * C % 8 != 0 (a
        # copy), copy a base that is not 16-byte aligned
        pad = -(W * C) % 8
        x, cache = (
            _copy(name, t, F.pad(t.reshape(*t.shape[:3], W * C), (0, pad)))
            if pad else t if t.data_ptr() % 16 == 0
            else _copy(name, t, t.clone()) for t in (x, cache))
        _launch(name, "conv3d_launch", x, cache, rgb_weight(w), bias, None,
                None, None, out, None, B, T, H, W, C, RGB_K, Cout, taps_t,
                tau0, 0, 1, 0, 0.0)
        launch_counts[name] += 1
        launch_counts["conv3d_rgb"] += 1
        return out
    step = 4 if f32 else 8
    if C % step and not norm:
        pad = -C % step   # zero channels, the weight copy's padding
        x, cache = (_copy(name, t, F.pad(t, (0, pad))) for t in (x, cache))
        C += pad
    plan = conv_plan(B, T, H, W, C, Cout, taps_t, _sm_count(x.device), norm,
                     f32)
    if f32:
        w_big, w_small = f32_weight(w)
        splits = plan["splits"]
        ws = None if splits == 1 else torch.empty(
            splits, B * T * H * W, Cout, dtype=torch.float32, device=x.device)
        _launch(name, "conv3d_f32_launch", x, cache, w_big, w_small, bias,
                out, ws, B, T, H, W, C, w_big.shape[2], Cout, taps_t, tau0,
                plan["bn"], splits, plan["grid"])
        launch_counts["conv3d_f32"] += 1
        return out
    wk = kernel_weight(w, x.dtype)
    Cp = wk.shape[2]
    inv = g = None
    if norm:
        if plan["route"] != "wide" or Cout % plan["bn"]:
            raise ValueError(f"{name}: {C} -> {Cout} channels, the kernel "
                             f"takes C % 8 == 0 and Cout % 32 == 0")
        if residual is not None:
            residual = _cl(name, residual, (torch.bfloat16,))
            if residual.shape != out.shape:
                raise ValueError(f"{name}: residual "
                                 f"{tuple(residual.shape)}")
        inv = torch.empty(B, 2 + T, H, W, dtype=torch.float32,
                          device=x.device)
        _launch(name, "rms_inv_launch", x, cache, inv, B, T, H, W, C,
                float(eps))
        g = gamma.detach().float().contiguous()
    splits = plan["splits"]
    ws = None if splits == 1 else torch.empty(
        splits, B * T * H * W, Cout, dtype=torch.float32, device=x.device)
    _launch(name, "conv3d_launch", x, cache, wk, bias, residual, inv, g,
            out, ws, B, T, H, W, C, Cp, Cout, taps_t, tau0, plan["bn"],
            splits, plan["grid"], math.sqrt(C) if norm else 0.0)
    launch_counts[name] += 1
    return out


def conv3d(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
           b: torch.Tensor, name: str = "conv3d_fused") -> torch.Tensor:
    """27-tap causal conv: x [B, T, H, W, C], cache [B, 2, H, W, C] (bf16
    or float32), w [Cout, C, 3, 3, 3], b [Cout] -> [B, T, H, W, Cout] in
    x's dtype; counted as ``name`` ('conv3d_fused' or 'conv3d_v2'), or as
    'conv3d_f32' for float32."""
    return _run(name, x, cache, w, b, 3, 0)


def conv2d_tap(x: torch.Tensor, cache: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor | None, tau: int) -> torch.Tensor:
    """One temporal tap of the split route: output frame t convolves
    timeline frame t + tau with ``w[:, :, tau]`` (3x3 SAME), + b where
    given -> [B, T, H, W, Cout] in x's dtype."""
    return _run("conv2d_9tap", x, cache, w, b, 1, tau)


def norm_silu_conv3d(x: torch.Tensor, cache: torch.Tensor,
                     gamma: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     residual: torch.Tensor | None = None,
                     eps: float = 1e-24) -> torch.Tensor:
    """``silu(rms_norm_channel(.))`` of the raw timeline [cache | x]
    (x [T, H, W, C], cache [2, H, W, C] bf16), the 27-tap conv, + b
    (+ residual [T, H, W, Cout]) -> [T, H, W, Cout] bf16, on the wide
    route with a channel tile that divides Cout and no K split."""
    res = None if residual is None else residual[None]
    return _run("norm_silu_conv3d", x[None], cache[None], w, b, 3, 0,
                residual=res, gamma=gamma, eps=eps)[0]
