"""A/B of versions of the port's VAE conv kernel on one NVIDIA card.

    python scripts/conv_ab.py A.cu B.cu [...] [--tiles=128x1,96x1,128x4]
                              [--only=RGB]

Each file is a version of ``self_forcing_tpu_torch/csrc/conv3d.cu``: the
current launcher (``conv3d_launch`` taking the whole weight copy, a K
split count and a grid size) or the one before the wgmma redesign (the weight copy at its
first tap, a row stride, no split; told apart by its source).  A version
whose RGB input runs ``conv_igemm_rgb`` gets the packed weight copy
(``cuda_conv.rgb_weight``) at C <= 3, an older one the per-tap copy.  Each is
built with the package's nvcc flags into
``self_forcing_tpu_torch/csrc/build/ab/`` and called through ctypes at
the conv shapes of ``chip_smoke.py``'s phase 2 (the 27-tap shapes of the
VAE's paths, the 3-launch split route, v2, and the norm + SiLU conv with
its residual at T = 1 and 3), with the same CUDA-event timer.  The versions run in order and
then in reverse; the median of the readings is printed with each
reading, the relative L2 against the plain float32 conv, the bound (the
products at 989 TFLOP/s or the bytes at 3.35 TB/s, the larger) and the
share of it, cuDNN's bf16 conv on the concatenated timeline once a shape,
and ptxas's register and spill lines.  ``--tiles`` also times each
listed (channel tile)x(K splits) of the current versions at the wide
shapes (those whose Cout the tile divides; no split for the norm + SiLU
conv, which the launcher runs unsplit).  ``--only`` keeps the shapes
whose label holds the given text.
"""
from __future__ import annotations

import ctypes
import math
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import bound, conv_bytes, rel_l2, time_ms  # noqa: E402
from scripts.int8qk_ab import build_versions  # noqa: E402
from self_forcing_tpu_torch.ops import conv as tconv  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_conv as cc  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# (label, (B, T, H, W, C), Cout, kind): kind 'conv' (27 taps), 'split' (3
# one-tap launches summed in bf16) or 'nsc' (norm + SiLU + residual)
SHAPES = [
    ("decoder 480x832x96", (1, 4, 480, 832, 96), 96, "conv"),
    ("decoder 240x416x192", (1, 4, 240, 416, 192), 192, "conv"),
    ("decoder 120x208x384", (1, 2, 120, 208, 384), 384, "conv"),
    ("decoder 120x208x384 T=1", (1, 1, 120, 208, 384), 384, "conv"),
    ("decoder 60x104x384", (1, 1, 60, 104, 384), 384, "conv"),
    ("decoder conv1 16->384", (1, 1, 60, 104, 16), 384, "conv"),
    ("decoder 120x208 192->384", (1, 2, 120, 208, 192), 384, "conv"),
    ("encoder 240x416 96->192", (1, 4, 240, 416, 96), 192, "conv"),
    ("encoder conv1 RGB->96", (1, 4, 480, 832, 3), 96, "conv"),
    ("encoder conv1 RGB->96 T=1", (1, 1, 480, 832, 3), 96, "conv"),
    ("decoder head 96->RGB", (1, 4, 480, 832, 96), 3, "conv"),
    ("encoder head 384->32", (1, 1, 60, 104, 384), 32, "conv"),
    ("split route 60x104x384", (1, 1, 60, 104, 384), 384, "split"),
    ("v2 480x832x128", (1, 4, 480, 832, 128), 128, "conv"),
    ("nsc T=1 60x104x384 +res", (1, 1, 60, 104, 384), 384, "nsc"),
    ("nsc T=3 60x104x384 +res", (1, 3, 60, 104, 384), 384, "nsc"),
]


def launcher_kind(path: str) -> tuple[bool, bool]:
    """(the current launcher, the packed-K RGB route) of a source."""
    with open(path) as f:
        src = f.read()
    return "int splits" in src, "conv_igemm_rgb" in src


class Version:
    """One built version: its launchers with the argument types of its
    signature."""

    def __init__(self, lib_path: str, current: bool, rgb: bool):
        self.lib = ctypes.CDLL(lib_path)
        self.current = current
        self.rgb = rgb
        f = self.lib.conv3d_launch
        f.restype = _I
        if current:
            f.argtypes = [_P] * 9 + [_I] * 12 + [_F, _P]
        else:
            f.argtypes = [_P] * 8 + [_I] * 10 + [_F, _P]
        g = self.lib.rms_inv_launch
        g.restype = _I
        g.argtypes = [_P] * 3 + [_I] * 5 + [_F, _P]

    def conv(self, x, cache, w, bias, out, taps_t, tau0, tile=None,
             res=None, inv=None, gamma=None, gscale=0.0):
        B, T, H, W, C = x.shape
        ptr = (lambda t: None if t is None else t.data_ptr())
        st = torch.cuda.current_stream().cuda_stream
        if self.rgb and C <= cc.RGB_MAX_C:
            err = self.lib.conv3d_launch(
                ptr(x), ptr(cache), ptr(cc.rgb_weight(w)), ptr(bias), None,
                None, None, ptr(out), None, B, T, H, W, C, cc.RGB_K,
                w.shape[0], taps_t, tau0, 0, 1, 0, 0.0, st)
            if err:
                raise RuntimeError(f"conv3d_launch: CUDA error {err}")
            return
        wk = cc.kernel_weight(w)
        Cout, _, Cp = wk.shape
        if self.current:
            sms = cc._sm_count(x.device)
            plan = cc.conv_plan(B, T, H, W, C, Cout, taps_t, sms,
                                inv is not None)
            bn, splits, grid = plan["bn"], plan["splits"], plan["grid"]
            if tile is not None:
                bn, splits = tile
                items = (B * T * -(-H // cc.TR) * -(-W // cc.TW)
                         * -(-Cout // bn) * splits)
                grid = min(items, sms)
            ws = None if splits == 1 else torch.empty(
                splits, B * T * H * W, Cout, device="cuda")
            err = self.lib.conv3d_launch(
                ptr(x), ptr(cache), ptr(wk), ptr(bias), ptr(res), ptr(inv),
                ptr(gamma), ptr(out), ptr(ws), B, T, H, W, C, Cp, Cout,
                taps_t, tau0, bn, splits, grid, gscale, st)
        else:
            err = self.lib.conv3d_launch(
                ptr(x), ptr(cache), ptr(wk[:, 9 * tau0]), ptr(bias),
                ptr(res), ptr(inv), ptr(gamma), ptr(out), B, T, H, W, C, Cp,
                Cout, taps_t, tau0, 27 * Cp, gscale, st)
        if err:
            raise RuntimeError(f"conv3d_launch: CUDA error {err}")

    def call(self, kind, x, cache, w, bias, gamma=None, res=None,
             tile=None):
        """The conv of ``kind`` (a fresh output each call, as the path)."""
        B, T, H, W, C = x.shape
        Cout = w.shape[0]

        def one(taps_t, tau0, b):
            out = torch.empty(B, T, H, W, Cout, dtype=x.dtype, device="cuda")
            self.conv(x, cache, w, b, out, taps_t, tau0, tile)
            return out

        if kind == "conv":
            return one(3, 0, bias)
        if kind == "split":
            acc = None
            for tau in range(3):
                y = one(1, tau, bias if tau == 2 else None)
                acc = y if acc is None else acc + y
            return acc
        inv = torch.empty(B, 2 + T, H, W, device="cuda")
        err = self.lib.rms_inv_launch(
            x.data_ptr(), cache.data_ptr(), inv.data_ptr(), B, T, H, W, C,
            tconv.NSC_EPS, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rms_inv_launch: CUDA error {err}")
        out = torch.empty(B, T, H, W, Cout, dtype=x.dtype, device="cuda")
        self.conv(x, cache, w, bias, out, 3, 0, tile, res=res, inv=inv,
                  gamma=gamma, gscale=math.sqrt(C))
        return out


def operands(g, shape, Cout, kind):
    B, T, H, W, C = shape
    bf = torch.bfloat16
    x = torch.randn(B, T, H, W, C, generator=g, device="cuda").to(bf)
    cache = torch.randn(B, 2, H, W, C, generator=g, device="cuda").to(bf)
    w = (torch.randn(Cout, C, 3, 3, 3, generator=g, device="cuda")
         * (27 * C) ** -0.5).to(bf)
    b = (torch.randn(Cout, generator=g, device="cuda") * 0.1).to(bf)
    gamma = res = None
    if kind == "nsc":
        gamma = (1 + 0.2 * torch.randn(C, generator=g, device="cuda")).to(bf)
        res = torch.randn(B, T, H, W, Cout, generator=g, device="cuda").to(bf)
    return x, cache, w, b, gamma, res


def reference(kind, x, cache, w, b, gamma, res):
    if kind == "conv":
        return tconv.conv3d_ref(x, cache, w, b)
    if kind == "split":
        return tconv.split_ref(x, cache, w, b)
    return tconv.nsc_ref(x[0], cache[0], gamma, w, b, res[0])[None]


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    only = [a.split("=", 1)[1] for a in sys.argv[1:]
            if a.startswith("--only=")]
    sweep = [tuple(int(n) for n in v.split("x")) for a in sys.argv[1:]
             if a.startswith("--tiles=") for v in a.split("=", 1)[1].split(",")]
    if not args:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this A/B needs an NVIDIA card")
    libs = build_versions(args)
    vers = {name: Version(path, *launcher_kind(src))
            for (name, path), src in zip(libs.items(), args)}
    names = list(vers)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for label, shape, Cout, kind in SHAPES:
        if only and not any(o in label for o in only):
            continue
        x, cache, w, b, gamma, res = operands(g, shape, Cout, kind)
        B, T, H, W, C = shape
        bias = b.float()
        ref = reference(kind, x, cache, w, b, gamma, res)
        flops = 2.0 * 27 * C * Cout * B * T * H * W
        b_ms, b_by = bound(flops, conv_bytes(B, T, H, W, C, Cout,
                                             kind == "nsc"))
        lib = "none"
        if kind != "nsc":
            xin = torch.cat([cache, x], dim=1).permute(0, 4, 1, 2, 3)
            wc = w.contiguous(memory_format=torch.channels_last_3d)
            lib = f"{time_ms(lambda: F.conv3d(xin, wc, b, padding=(0, 1, 1))):.4f}"
            del xin
        gf = None if gamma is None else gamma.float()
        call = (lambda v, tile=None: v.call(kind, x, cache, w, bias, gf,
                                            res, tile))
        readings, errs = {n: [] for n in names}, {}
        for order in (names, names[::-1]):
            for n in order:
                errs[n] = rel_l2(call(vers[n]), ref)
                readings[n].append(time_ms(lambda: call(vers[n])))
        plan = cc.conv_plan(B, T, H, W, C, Cout, 1 if kind == "split" else 3,
                            cc._sm_count(x.device))
        for n in names:
            ms = statistics.median(readings[n])
            print(f"{label} {list(shape)}->{Cout} ({kind}, route "
                  f"{plan['route']}, splits {plan['splits']}) {n}: "
                  f"ms={ms:.4f} readings={[round(t, 4) for t in readings[n]]}"
                  f" rel_l2={errs[n]:.3e} bound_ms={b_ms:.4f} ({b_by}) "
                  f"bound_share={b_ms / ms:.3f} cudnn_ms={lib}", flush=True)
        if sweep and plan["route"] == "wide":
            for n in names:
                if not vers[n].current:
                    continue
                for bn, s in sweep:
                    if s > plan["ksteps"] or Cout % bn or (
                            kind == "nsc" and s > 1):
                        continue
                    err = rel_l2(call(vers[n], (bn, s)), ref)
                    ms = time_ms(lambda: call(vers[n], (bn, s)))
                    print(f"  {label} {n} bn={bn} splits={s}: ms={ms:.4f} "
                          f"rel_l2={err:.3e} bound_share={b_ms / ms:.3f}",
                          flush=True)
        del x, cache, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
