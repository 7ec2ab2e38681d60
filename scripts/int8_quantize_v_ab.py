"""A/B of versions of the port's full-int8 V pre-pass on one NVIDIA card.

    python scripts/int8_quantize_v_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/decode_int8.cu``
(same launcher, ``int8_quantize_v_launch``).  Each is built with the
package's nvcc flags into ``self_forcing_tpu_torch/csrc/build/ab/`` and
loaded in turn as the library behind ``cuda_attention.int8_quantize_v``,
which is timed at the two V pre-pass shapes of ``chip_smoke.py``'s phase
2 with the same CUDA-event timer: the 1.3B global demo window at block 7
(28080 cached + 4680 fresh keys, tiles 2048 / 1184, 12 heads) and the
windowed steady state (a 1560-token sink and a 12480-token window of a
37440-token buffer, tiles 1560 / 1184).  The versions run in order and
then in reverse; the median of the readings is printed with each
reading, whether the version's int8 values and scales equal the plain
version's bit for bit (dead cache tiles are not written and not
compared), the bound (a bf16 read and an int8 write of every live
element at 3.35 TB/s, as phase 2 counts it) and ptxas's register and
spill lines.
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

from chip_smoke import (LAST_KV_END, LQ, N_HEADS, PEAK_BYTES,  # noqa: E402
                        S_CACHE, time_ms)
from scripts.int8qk_ab import build_versions  # noqa: E402
from self_forcing_tpu_torch.ops import build  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_attention as ca  # noqa: E402
from self_forcing_tpu_torch.ops.attention import decode_tiles  # noqa: E402

D = 128
S_WIN = 24 * 1560


def shapes(g):
    """(label, v_cache, v_new, window, tk_align) of the two shapes."""
    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda",
                           dtype=torch.bfloat16)
    vn = rand(1, LQ, N_HEADS * D)
    yield ("1.3B global block 7", rand(N_HEADS, S_CACHE, D), vn,
           dict(layer_idx=0, kv_start=0, kv_end=LAST_KV_END, sink_end=0,
                static_hi=LAST_KV_END), None)
    yield ("windowed steady state", rand(N_HEADS, S_WIN, D), vn,
           dict(layer_idx=0, kv_start=S_WIN - LQ - 8 * 1560,
                kv_end=S_WIN - LQ, sink_end=1560, static_hi=None), 1560)


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
    for label, v_c, vn, win, align in shapes(g):
        _, tk, tf = decode_tiles(LQ, v_c.shape[-2], LQ, "int8", None, align)
        w = dict(win, num_heads=N_HEADS, tk=tk, tf=tf)
        ref = ca.int8_quantize_v_ref(v_c, vn, **w)
        live = torch.tensor(ca.live_cache_tiles(
            ref.vsc.shape[1], tk, win["kv_start"], win["kv_end"],
            win["sink_end"]), device="cuda")
        n_v = int(live.sum()) * tk + LQ
        bound_ms = 3.0 * n_v * N_HEADS * D / PEAK_BYTES * 1e3
        readings, equal = {n: [] for n in names}, {}
        for order in (names, names[::-1]):
            for name in order:
                build._loaded["decode_int8"] = ctypes.CDLL(libs[name])
                vv = ca.int8_quantize_v(v_c, vn, **w)
                torch.cuda.synchronize()
                equal[name] = all(torch.equal(a, b) for a, b in (
                    (vv.vc8[:, live], ref.vc8[:, live]), (vv.vn8, ref.vn8),
                    (vv.vsc, ref.vsc), (vv.vsf, ref.vsf)))
                readings[name].append(time_ms(
                    lambda: ca.int8_quantize_v(v_c, vn, **w)))
        for name in names:
            ms = statistics.median(readings[name])
            got = [round(t, 4) for t in readings[name]]
            print(f"{label} (tiles {tk}/{tf}, {n_v} rows) {name}: "
                  f"ms={ms:.4f} readings={got}"
                  f" bit_equal={equal[name]} bound_ms={bound_ms:.4f} "
                  f"share_of_bound={bound_ms / ms:.3f}", flush=True)
        del ref


if __name__ == "__main__":
    main()
