"""A/B of versions of the port's decode kernel in its int8-QK mode on one
NVIDIA card.

    python scripts/int8qk_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/decode_fresh.cu``
(same launchers: ``int8qk_attend_launch`` and ``decode_fresh_launch``).
Each is built with the package's nvcc flags into
``self_forcing_tpu_torch/csrc/build/ab/`` and loaded in turn as the
library behind ``cuda_attention.int8qk_attend`` and ``decode_fresh_free``,
which are timed at the two shapes of ``chip_smoke.py``'s
``phase_int8qk_kernels`` with the same CUDA-event timer: the global demo
window at block 7 (28080 cached + 4680 fresh keys, tiles 784 / 2048 /
1568) and the windowed steady state (a 1560-token sink and a 12480-token
window of a 37440-token buffer, tiles 936 / 1560 / 1568), 12 heads.  The
pre-pass runs once per shape (the package's ``int8qk_quantize``).  The
versions run in order and then in reverse; the median of the readings is
printed with each reading, the relative L2 against the plain version
``int8qk_attend_ref``, bf16 SDPA on the same keys, the bf16 decode kernel
of the same version, the bound (int8 QK^T at 1979 TOP/s plus bf16 P.V at
989 TFLOP/s) and ptxas's register and spill lines.
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

from chip_smoke import (LAST_KV_END, LQ, N_HEADS, N_LAYERS,  # noqa: E402
                        PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_INT8_OPS, S_CACHE,
                        rel_l2, time_ms)
from self_forcing_tpu_torch.ops import build  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_attention as ca  # noqa: E402
from self_forcing_tpu_torch.ops.attention import decode_tiles  # noqa: E402

D = 128
S_WIN = 24 * 1560


def build_versions(paths: list[str]) -> dict[str, str]:
    """Build every version at once; returns name -> library path."""
    out = os.path.join(build.BUILD_DIR, "ab")
    os.makedirs(out, exist_ok=True)
    jobs = {}
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        lib = os.path.join(out, f"lib{name}.so")
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC, "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
    for name, (_, proc) in jobs.items():
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{logs[name][-3000:]}")
        lines = sorted({ln.strip() for ln in logs[name].splitlines()
                        if "registers" in ln or "spill" in ln
                        or "C75" in ln})
        print(f"build {name}: {lines}", flush=True)
    return {name: lib for name, (lib, _) in jobs.items()}


def shapes(g):
    """(label, q, k_c, v_c, kn, vn, window, tk_align) of the two phase-2
    shapes."""
    bf = torch.bfloat16
    q = (torch.randn(1, LQ, N_HEADS * D, generator=g, device="cuda")
         * (D ** -0.5 * 1.4426950408889634)).to(bf)
    kn, vn = (torch.randn(1, LQ, N_HEADS * D, generator=g, device="cuda",
                          dtype=bf) for _ in range(2))
    kc, vc = (torch.randn(N_LAYERS // 10, N_HEADS, S_CACHE, D, generator=g,
                          device="cuda", dtype=bf) for _ in range(2))
    kw, vw = (torch.randn(N_HEADS, S_WIN, D, generator=g, device="cuda",
                          dtype=bf) for _ in range(2))
    return (("global block 7", q, kc, vc, kn, vn,
             dict(layer_idx=2, kv_start=0, kv_end=LAST_KV_END, sink_end=0,
                  static_hi=LAST_KV_END), None),
            ("windowed steady state", q, kw, vw, kn, vn,
             dict(layer_idx=0, kv_start=S_WIN - LQ - 8 * 1560,
                  kv_end=S_WIN - LQ, sink_end=1560, static_hi=None), 1560))


def main() -> None:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this A/B needs an NVIDIA card")
    libs = build_versions(sys.argv[1:])
    names = list(libs)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    heads = lambda t: t.reshape(1, -1, N_HEADS, D).transpose(1, 2)
    for label, q, k_c, v_c, kn, vn, win, align in shapes(g):
        tq, tk, tf = decode_tiles(LQ, k_c.shape[-2], LQ, "int8qk", "free",
                                  align)
        iw = dict(win, num_heads=N_HEADS, tq=tq, tk=tk, tf=tf)
        bw = dict(win, num_heads=N_HEADS)
        qq = ca.int8qk_quantize(q, k_c, kn, **iw)
        ref = ca.int8qk_attend_ref(qq, q, v_c, vn, **iw)
        lo, hi, sk = win["kv_start"], win["kv_end"], win["sink_end"]
        lay = k_c[win["layer_idx"]] if k_c.dim() == 4 else k_c
        lav = v_c[win["layer_idx"]] if v_c.dim() == 4 else v_c
        vis = torch.cat([torch.arange(sk), torch.arange(lo, hi)]).cuda()
        kv_k = torch.cat([lay[:, vis][None], heads(kn)], dim=2)
        kv_v = torch.cat([lav[:, vis][None], heads(vn)], dim=2)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
            heads(q), kv_k, kv_v, scale=math.log(2.0)))
        del kv_k, kv_v
        n_keys = sk + (hi - lo) + LQ
        ops = 2.0 * LQ * n_keys * D * N_HEADS
        nbytes = 2.0 * (2 * LQ * N_HEADS * D + 2 * n_keys * N_HEADS * D)
        bound_ms = max(ops / PEAK_INT8_OPS + ops / PEAK_BF16_FLOPS,
                       nbytes / PEAK_BYTES) * 1e3
        readings = {n: [] for n in names}
        bf16 = {n: [] for n in names}
        errs = {}
        for order in (names, names[::-1]):
            for name in order:
                build._loaded["decode_fresh"] = ctypes.CDLL(libs[name])
                try:
                    out = ca.int8qk_attend(qq, q, v_c, vn, **iw)
                    torch.cuda.synchronize()
                except RuntimeError as e:   # a refused launch: go on
                    print(f"{label} {name}: {e}", flush=True)
                    readings[name].append(float("nan"))
                    bf16[name].append(float("nan"))
                    errs[name] = float("nan")
                    continue
                errs[name] = rel_l2(out, ref)
                readings[name].append(time_ms(
                    lambda: ca.int8qk_attend(qq, q, v_c, vn, **iw)))
                bf16[name].append(time_ms(
                    lambda: ca.decode_fresh_free(q, k_c, v_c, kn, vn, **bw)))
        for name in names:
            ms = statistics.median(readings[name])
            print(f"{label} {name}: ms={ms:.4f} "
                  f"readings={[round(t, 4) for t in readings[name]]} "
                  f"rel_l2={errs[name]:.3e} sdpa_bf16_ms={sdpa_ms:.4f} "
                  f"decode_fresh_bf16_ms={statistics.median(bf16[name]):.4f} "
                  f"bound_ms={bound_ms:.4f} "
                  f"share_of_bound={bound_ms / ms:.3f}", flush=True)
        del qq, ref


if __name__ == "__main__":
    main()
