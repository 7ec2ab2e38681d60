"""A/B of versions of the port's full-int8 decode attention on one NVIDIA
card.

    python scripts/int8_attend_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/decode_int8.cu``
(same launchers: ``int8_quantize_v_launch`` and ``int8_attend_launch``).
Each is built with the package's nvcc flags into
``self_forcing_tpu_torch/csrc/build/ab/`` (its ``#include "..."`` headers
are found beside it first, then in the package's ``csrc/``: a version
from another commit sits beside that commit's headers; the file names
name the versions, so they differ) and loaded in turn as the
library behind ``cuda_attention.int8_attend``, which is timed with
``chip_smoke.py``'s CUDA-event timer at the shapes of its
``phase_mode_kernels``: the global demo window at block 7 (28080 cached +
4680 fresh keys, tiles 472 / 2048 / 1184) in 'tile' (the Cauchy-Schwarz
bound), 'global' (the max score + 0.5) and online mode, and the windowed
steady state (a 1560-token sink and a 12480-token window of a
37440-token buffer, tiles 472 / 1560 / 1184) online, 12 heads.  The
pre-passes run once per shape (the package's ``int8qk_quantize`` and
``int8_quantize_v``).  The versions run in order and then in reverse;
the median of the readings is printed with each reading, the relative L2
against the plain version ``int8_attend_ref``, bf16 SDPA on the same keys,
the bound of the function's two products at 1979 TOP/s and that of the
products a two-pass design runs (three where the row max is needed), and
ptxas's register and spill lines.
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

from chip_smoke import (LAST_KV_END, LQ, N_HEADS, N_LAYERS,  # noqa: E402
                        PEAK_BYTES, PEAK_INT8_OPS, S_CACHE, _window, rel_l2,
                        time_ms)
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


def cases(g):
    """(label, mode, q, k_c, v_c, kn, vn, window, tk_align, m0) of the
    four phase-2 rows."""
    bf = torch.bfloat16
    q, kn, vn = (torch.randn(1, LQ, N_HEADS * D, generator=g, device="cuda",
                             dtype=bf) for _ in range(3))
    kc, vc = (torch.randn(N_LAYERS // 10, N_HEADS, S_CACHE, D, generator=g,
                          device="cuda", dtype=bf) for _ in range(2))
    kw, vw = (torch.randn(N_HEADS, S_WIN, D, generator=g, device="cuda",
                          dtype=bf) for _ in range(2))
    glob = dict(layer_idx=2, kv_start=0, kv_end=LAST_KV_END, sink_end=0,
                static_hi=LAST_KV_END)
    wwin = dict(layer_idx=0, kv_start=S_WIN - LQ - 8 * 1560,
                kv_end=S_WIN - LQ, sink_end=1560, static_hi=None)
    qh = q.reshape(1, LQ, N_HEADS, D).transpose(1, 2).float()
    kk, _ = _window(kc, vc, kn, vn, glob["layer_idx"], glob)
    cs = (D ** -0.5 * qh.norm(dim=-1).amax()
          * kk.float().norm(dim=-1).amax()).reshape(1)
    smax = torch.stack([(qh[0, n] @ kk[0, n].float().T).amax()
                        for n in range(N_HEADS)]).amax() * D ** -0.5
    del kk
    label = "global block 7"
    return ((label, "tile", q, kc, vc, kn, vn, glob, None, cs),
            (label, "global", q, kc, vc, kn, vn, glob, None,
             (smax + 0.5).reshape(1)),
            (label, "online", q, kc, vc, kn, vn, glob, None, None),
            ("windowed steady state", "online", q, kw, vw, kn, vn, wwin,
             1560, None))


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
    for label, mode, q, k_c, v_c, kn, vn, win, align, m0 in cases(g):
        tq, tk, tf = decode_tiles(LQ, k_c.shape[-2], LQ, "int8", None, align)
        tiles = dict(win, num_heads=N_HEADS, tk=tk, tf=tf)
        qq = ca.int8qk_quantize(q, k_c, kn, tq=tq, **tiles)
        vv = ca.int8_quantize_v(v_c, vn, **tiles)
        att = dict(tiles, mode=mode, m0=m0, scale=D ** -0.5, tq=tq,
                   cache_len=k_c.shape[-2], fresh_len=LQ)
        ref = ca.int8_attend_ref(qq, vv, q, **att)
        kk, kv = _window(k_c, v_c, kn, vn, win["layer_idx"], win)
        n_keys = kk.shape[2]
        qh = q.reshape(1, LQ, N_HEADS, D).transpose(1, 2)
        sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(qh, kk, kv))
        del kk, kv
        ops = 2.0 * LQ * n_keys * D * N_HEADS   # each product
        nbytes = (LQ + 2 * n_keys) * N_HEADS * D + 2.0 * LQ * N_HEADS * D
        bound_ms = max(2 * ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES) * 1e3
        products = 2 if mode == "global" else 3
        design_ms = max(products * ops / PEAK_INT8_OPS,
                        nbytes / PEAK_BYTES) * 1e3
        readings = {n: [] for n in names}
        errs = {}
        for order in (names, names[::-1]):
            for name in order:
                build._loaded["decode_int8"] = ctypes.CDLL(libs[name])
                try:
                    out = ca.int8_attend(qq, vv, q, **att)
                    torch.cuda.synchronize()
                except RuntimeError as e:   # a refused launch: go on
                    print(f"{label} {mode} {name}: {e}", flush=True)
                    readings[name].append(float("nan"))
                    errs[name] = float("nan")
                    continue
                errs[name] = rel_l2(out, ref)
                readings[name].append(time_ms(
                    lambda: ca.int8_attend(qq, vv, q, **att)))
        for name in names:
            ms = statistics.median(readings[name])
            print(f"{label} {mode} (keys {n_keys}, tiles {tq}/{tk}/{tf}) "
                  f"{name}: ms={ms:.4f} "
                  f"readings={[round(t, 4) for t in readings[name]]} "
                  f"rel_l2={errs[name]:.3e} sdpa_bf16_ms={sdpa_ms:.4f} "
                  f"bound_ms={bound_ms:.4f} share_of_bound="
                  f"{bound_ms / ms:.3f} products={products} "
                  f"design_bound_ms={design_ms:.4f} share_of_design_bound="
                  f"{design_ms / ms:.3f}", flush=True)
        del qq, vv, ref


if __name__ == "__main__":
    main()
