"""A/B of versions of the port's int8-QK pre-pass on one NVIDIA card.

    python scripts/int8qk_prepass_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/decode_int8qk.cu``
(same launcher, ``int8qk_quantize_launch``).  Each is built with the
package's nvcc flags into ``self_forcing_tpu_torch/csrc/build/ab/`` and
loaded in turn as the library behind ``cuda_attention.int8qk_quantize``,
which is timed at the three pre-pass shapes of ``chip_smoke.py``'s phase
2 with the same CUDA-event timer: the 1.3B global demo window at block 7
(28080 cached + 4680 fresh keys, tiles 784 / 2048 / 1568, 12 heads), the
windowed steady state (a 1560-token sink and a 12480-token window of a
37440-token buffer, tiles 936 / 1560 / 1568) and the 14B global window
(40 heads).  The versions run in order and then in reverse; the median
of the readings is printed with each reading, whether the version's int8
values and scales equal the plain version's bit for bit (dead cache tiles
are not written and not compared), the bound (a bf16 read and an int8
write of every element and the scales at 3.35 TB/s) and ptxas's register
and spill lines.
"""
from __future__ import annotations

import ctypes
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (DIM_14B, LAST_KV_END, LQ, N_HEADS,  # noqa: E402
                        PEAK_BYTES, S_CACHE, time_ms)
from scripts.int8qk_ab import build_versions  # noqa: E402
from self_forcing_tpu_torch.ops import build  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_attention as ca  # noqa: E402
from self_forcing_tpu_torch.ops.attention import decode_tiles  # noqa: E402

D = 128
S_WIN = 24 * 1560


def shapes(g):
    """(label, q, k_cache, k_new, window) of the three phase-2 shapes."""
    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    q, kn = rand(1, LQ, N_HEADS * D), rand(1, LQ, N_HEADS * D)
    n14 = DIM_14B // D
    glob = dict(layer_idx=0, kv_start=0, kv_end=LAST_KV_END, sink_end=0,
                static_hi=LAST_KV_END)
    yield "1.3B global block 7", q, rand(N_HEADS, S_CACHE, D), kn, glob, None
    yield ("windowed steady state", q, rand(N_HEADS, S_WIN, D), kn,
           dict(layer_idx=0, kv_start=S_WIN - LQ - 8 * 1560,
                kv_end=S_WIN - LQ, sink_end=1560, static_hi=None), 1560)
    yield ("14B global block 7", rand(1, LQ, n14 * D), rand(n14, S_CACHE, D),
           rand(1, LQ, n14 * D), glob, None)


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
    for label, q, k_c, kn, win, align in shapes(g):
        N = q.shape[-1] // D
        tq, tk, tf = decode_tiles(LQ, k_c.shape[-2], LQ, "int8qk", "free",
                                  align)
        w = dict(win, num_heads=N, tq=tq, tk=tk, tf=tf)
        ref = ca.int8qk_quantize_ref(q, k_c, kn, **w)
        live = torch.tensor(ca.live_cache_tiles(
            ref.ksc.shape[1], tk, win["kv_start"], win["kv_end"],
            win["sink_end"]), device="cuda")
        rows = live.repeat_interleave(tk)
        elems = (2 * LQ + int(live.sum()) * tk) * N * D
        nbytes = 3.0 * elems + 4.0 * N * sum(t.shape[1] for t in (
            ref.qs, ref.ksc, ref.ksf))
        bound_ms = nbytes / PEAK_BYTES * 1e3
        readings, equal = {n: [] for n in names}, {}
        for order in (names, names[::-1]):
            for name in order:
                build._loaded["decode_int8qk"] = ctypes.CDLL(libs[name])
                qq = ca.int8qk_quantize(q, k_c, kn, **w)
                torch.cuda.synchronize()
                equal[name] = all(torch.equal(a, b) for a, b in (
                    (qq.q8, ref.q8), (qq.kc8[:, rows], ref.kc8[:, rows]),
                    (qq.kn8, ref.kn8), (qq.qs, ref.qs), (qq.ksc, ref.ksc),
                    (qq.ksf, ref.ksf)))
                readings[name].append(time_ms(
                    lambda: ca.int8qk_quantize(q, k_c, kn, **w)))
        for name in names:
            ms = statistics.median(readings[name])
            print(f"{label} ({N} heads, tiles {tq}/{tk}/{tf}) {name}: "
                  f"ms={ms:.4f} readings={[round(t, 4) for t in readings[name]]}"
                  f" bit_equal={equal[name]} bound_ms={bound_ms:.4f} "
                  f"share_of_bound={bound_ms / ms:.3f}", flush=True)
        del ref


if __name__ == "__main__":
    main()
