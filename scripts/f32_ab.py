"""A/B of versions of the port's float32 kernels on one NVIDIA card.

    python scripts/f32_ab.py DIR_A DIR_B [...]

Each DIR holds a version of ``self_forcing_tpu_torch/csrc``: its
``decode_fresh.cu`` (the float32 window attention, ``decode_window_f32``)
and ``conv3d.cu`` (the float32 conv, ``conv3d_f32``) beside the headers
they include (quoted includes resolve beside the file first, so a
parent's copy from ``git archive`` builds against its own headers).  A
version's launchers are the current ones (``decode_window_f32_launch``
with its pre-pass workspace; ``conv3d_f32_launch`` taking the weights'
tf32 parts, ``ops/cuda_conv.py::f32_weight``, and the plan of
``conv_plan(f32=True)``) or the ones before the tf32 wgmma redesign
(``decode_window_launch`` with a float32 flag; ``conv3d_f32_launch``
taking the float32 weight copy at its first tap and a row stride), told
apart by the source.  Both sources of every version are built at once
with the package's nvcc flags into ``self_forcing_tpu_torch/csrc/build/
ab/``, and ptxas's registers and spills of the float32 kernels are
printed.  Shapes: ``chip_smoke.py`` phase 2's (the window attention at
4680 queries onto [0, 28080) of 32760 keys, 12 heads of 128; the conv at
[1, 4, 480, 832, 96] -> 96) and three more float32 convs (16 -> 384 and
the 3-launch split route at 60x104, the 384 -> 32 head with its K
split).  The versions run in order and then in reverse (A B B A, CUDA
events behind a spin kernel as ``chip_smoke.time_ms``); each prints the
median of its readings, the readings, the relative L2 against the plain
float32 version (TF32 off), the bound (the products as three TF32
products at 495 TFLOP/s, or the bytes at 3.35 TB/s, the larger) and the
share of it, beside the library call timed once a shape: SDPA in float32
on the window slice, cuDNN's float32 conv (TF32 off) on the concatenated
timeline.  The first line is the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (HEAD_DIM, LAST_KV_END, LQ, N_HEADS,  # noqa: E402
                        PEAK_3XTF32_FLOPS, SEQ_TRAIN, bound, conv_bytes,
                        rel_l2, time_ms)
from self_forcing_tpu_torch.ops import build  # noqa: E402
from self_forcing_tpu_torch.ops import conv as tconv  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_attention as ca  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_conv as cc  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = ("decode_fresh", "conv3d")
KERNELS = ("decode_window_f32_kernel", "window_split_f32", "conv_igemm_f32")

# (label, (B, T, H, W, C), Cout, kind): 'conv' (27 taps) or 'split' (3
# one-tap launches summed in float32)
CONV_SHAPES = [
    ("decoder 480x832x96", (1, 4, 480, 832, 96), 96, "conv"),
    ("decoder conv1 16->384", (1, 1, 60, 104, 16), 384, "conv"),
    ("split route 60x104x384", (1, 1, 60, 104, 384), 384, "split"),
    ("encoder head 384->32", (1, 1, 60, 104, 384), 32, "conv"),
]


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register and spill lines of the float32 kernels, each with
    its (mangled) kernel name."""
    out, name = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif name and any(k in name for k in KERNELS) and (
                "registers" in ln or "spill" in ln):
            out.append(f"{name[:60]}: {ln.strip()}")
    return out


def build_versions(dirs: list[str]) -> list[dict]:
    """Build both sources of every version at once; returns each
    version's library paths by source."""
    out = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out, exist_ok=True)
    jobs = []
    for i, d in enumerate(dirs):
        for src in SOURCES:
            lib = os.path.join(out, f"libf32_{i}_{src}.so")
            jobs.append((i, src, lib, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                 os.path.join(d, src + ".cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = [{} for _ in dirs]
    for i, src, lib, proc in jobs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {dirs[i]}/{src}.cu:\n"
                             f"{log[-3000:]}")
        for ln in ptxas_lines(log):
            print(f"build {dirs[i]} {src}: {ln}", flush=True)
        libs[i][src] = lib
    return libs


class Version:
    """One built version: its float32 launchers with the argument types of
    their signatures."""

    def __init__(self, d: str, libs: dict):
        with open(os.path.join(d, "decode_fresh.cu")) as f:
            self.new_attn = "decode_window_f32_launch" in f.read()
        with open(os.path.join(d, "conv3d.cu")) as f:
            self.new_conv = "w_small" in f.read()
        self.attn = ctypes.CDLL(libs["decode_fresh"])
        self.conv_lib = ctypes.CDLL(libs["conv3d"])
        if self.new_attn:
            self.win = self.attn.decode_window_f32_launch
            self.win.argtypes = [_P] * 9 + [_I] * 4 + [_F, _P]
        else:
            self.win = self.attn.decode_window_launch
            self.win.argtypes = [_P] * 5 + [_I] * 4 + [_F, _I, _P]
        self.win.restype = _I
        self.cf = self.conv_lib.conv3d_f32_launch
        self.cf.argtypes = ([_P] * 7 + [_I] * 12 + [_P] if self.new_conv
                            else [_P] * 5 + [_I] * 10 + [_P])
        self.cf.restype = _I

    def window(self, q, k, v, bounds, scale):
        """q [1, Lq, N*D], k / v [N, S, D] float32 -> out like q."""
        BN, S, D = k.shape
        out = torch.empty_like(q)
        st = torch.cuda.current_stream().cuda_stream
        if self.new_attn:
            kp = k.new_empty(2, BN, S, D)
            vp = k.new_empty(2, BN, D, -(-S // 32) * 32)
            err = self.win(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           bounds.data_ptr(), out.data_ptr(),
                           kp[0].data_ptr(), kp[1].data_ptr(),
                           vp[0].data_ptr(), vp[1].data_ptr(), 1, BN,
                           q.shape[1], S, scale, st)
        else:
            err = self.win(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           bounds.data_ptr(), out.data_ptr(), 1, BN,
                           q.shape[1], S, scale, 1, st)
        if err:
            raise RuntimeError(f"window launch: CUDA error {err}")
        return out

    def conv(self, x, cache, w, bias, taps_t, tau0):
        B, T, H, W, C = x.shape
        Cout = w.shape[0]
        out = torch.empty(B, T, H, W, Cout, device="cuda")
        ptr = (lambda t: None if t is None else t.data_ptr())
        st = torch.cuda.current_stream().cuda_stream
        if self.new_conv:
            wb, wsm = cc.f32_weight(w)
            plan = cc.conv_plan(B, T, H, W, C, Cout, taps_t,
                                cc._sm_count(x.device), f32=True)
            part = None if plan["splits"] == 1 else torch.empty(
                plan["splits"], B * T * H * W, Cout, device="cuda")
            err = self.cf(ptr(x), ptr(cache), ptr(wb), ptr(wsm), ptr(bias),
                          ptr(out), ptr(part), B, T, H, W, C, wb.shape[2],
                          Cout, taps_t, tau0, plan["bn"], plan["splits"],
                          plan["grid"], st)
        else:
            wk = cc.kernel_weight(w, torch.float32)
            Cp = wk.shape[2]
            err = self.cf(ptr(x), ptr(cache), ptr(wk[:, 9 * tau0]),
                          ptr(bias), ptr(out), B, T, H, W, C, Cp, Cout,
                          taps_t, tau0, 27 * Cp, st)
        if err:
            raise RuntimeError(f"conv3d_f32_launch: CUDA error {err}")
        return out

    def conv_call(self, kind, x, cache, w, bias):
        if kind == "conv":
            return self.conv(x, cache, w, bias, 3, 0)
        acc = None
        for tau in range(3):
            y = self.conv(x, cache, w, bias if tau == 2 else None, 1, tau)
            acc = y if acc is None else acc + y
        return acc


def report(label, names, readings, errs, b_ms, b_by, lib_name, lib):
    for n in names:
        ms = statistics.median(readings[n])
        print(f"{label} {n}: ms={ms:.4f} readings="
              f"{[round(t, 4) for t in readings[n]]} rel_l2={errs[n]:.3e} "
              f"bound_ms={b_ms:.4f} ({b_by}) bound_share={b_ms / ms:.3f} "
              f"{lib_name}={lib:.4f}", flush=True)


def ab(vers, call, ref):
    """Each version's readings (in order, then in reverse) and error."""
    names = list(vers)
    readings, errs = {n: [] for n in names}, {}
    for order in (names, names[::-1]):
        for n in order:
            errs[n] = rel_l2(call(vers[n]), ref)
            readings[n].append(time_ms(lambda: call(vers[n])))
    return names, readings, errs


def main() -> None:
    dirs = sys.argv[1:]
    if not dirs:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this A/B needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    libs = build_versions(dirs)
    vers = {f"{i}:{d}": Version(d, lib)
            for i, (d, lib) in enumerate(zip(dirs, libs))}
    g = torch.Generator(device="cuda").manual_seed(0)
    dev, D, N, S, hi = "cuda", HEAD_DIM, N_HEADS, SEQ_TRAIN, LAST_KV_END

    q = torch.randn(1, LQ, N * D, generator=g, device=dev)
    k = torch.randn(N, S, D, generator=g, device=dev)
    v = torch.randn(N, S, D, generator=g, device=dev)
    bounds = torch.tensor([0, hi], dtype=torch.int32, device=dev)
    scale = D ** -0.5
    ref = ca.decode_window_ref(q.view(1, LQ, N, D), k, v, 0, hi).reshape(
        q.shape)
    qh = q.view(1, LQ, N, D).transpose(1, 2)
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qh, k[None, :, :hi], v[None, :, :hi]))
    b_ms, b_by = bound(4.0 * LQ * hi * D * N, 4.0 * (2 * LQ + 2 * hi) * N * D,
                       PEAK_3XTF32_FLOPS)
    names, readings, errs = ab(
        vers, lambda ver: ver.window(q, k, v, bounds, scale), ref)
    report(f"decode_window_f32 (Lq {LQ}, [0, {hi}) of {S}, {N} heads)",
           names, readings, errs, b_ms, b_by, "sdpa_f32_ms", lib)
    del q, k, v, ref, qh
    torch.cuda.empty_cache()

    for label, (B, T, H, W, C), Cout, kind in CONV_SHAPES:
        x = torch.randn(B, T, H, W, C, generator=g, device=dev)
        cache = torch.randn(B, 2, H, W, C, generator=g, device=dev)
        w = torch.randn(Cout, C, 3, 3, 3, generator=g, device=dev) * (
            27 * C) ** -0.5
        b = torch.randn(Cout, generator=g, device=dev) * 0.1
        ref = (tconv.conv3d_ref if kind == "conv" else tconv.split_ref)(
            x, cache, w, b)
        xin = torch.cat([cache, x], dim=1).permute(0, 4, 1, 2, 3)
        wc = w.contiguous(memory_format=torch.channels_last_3d)
        lib = time_ms(lambda: F.conv3d(xin, wc, b, padding=(0, 1, 1)))
        del xin
        b_ms, b_by = bound(2.0 * 27 * C * Cout * B * T * H * W,
                           2.0 * conv_bytes(B, T, H, W, C, Cout),
                           PEAK_3XTF32_FLOPS)
        names, readings, errs = ab(
            vers, lambda ver: ver.conv_call(kind, x, cache, w, b), ref)
        report(f"conv3d_f32 {label} {[B, T, H, W, C]}->{Cout} ({kind})",
               names, readings, errs, b_ms, b_by, "cudnn_f32_ms", lib)
        del x, cache, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
