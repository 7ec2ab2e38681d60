"""A/B of versions of the port's W8A8 kernel at its GEMM shapes, on one
NVIDIA card.

    python scripts/w8a8_gemm_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/w8a8_fc1.cu``
(same launchers). Each is built with the package's nvcc flags, all at
once (``scripts/w8a8_fc1_ab.py``'s ``build_versions``), and loaded in
turn as the library behind ``cuda_matmul.w8a8_ffn2`` and
``w8a8_matmul``, which are timed at the shapes of ``chip_smoke.py``'s
phases 2 and 9 with its CUDA-event timer: fc2 at Wan-1.3B (M 4680, H
8960 in groups of 896, N 1536; and at M 4224, 33 row tiles, which the
192-column tiles cut into exactly two waves of 132 items: the difference
is what the 1.3B shape's third, partial wave costs) and at Wan-14B (H
13824 in groups of 768, N 5120), from a seeded int8 hidden; the linears
from int8 x at 1.3B (qkv N 4608; o / cross q / cross o N 1536; cross k /
v, 512 rows; and at fc2's shape, K 8960 onto N 1536, the same mainloop
and 192-column tile without the group folds) and at 14B (K 5120: qkv N
15360, o N 5120). The versions run in order and then in reverse; the
median of the two readings is printed with each reading,
``torch._int_mm`` on the same int8 operands, the bound (int8 peak 1979
TOP/s), whether the first version's output equals the plain version's
bit for bit, and whether each version's equals the first's.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import PEAK_INT8_OPS, time_ms  # noqa: E402
from self_forcing_tpu_torch.ops import build, quant  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_matmul as cm  # noqa: E402
from w8a8_fc1_ab import build_versions, weight  # noqa: E402

M = 4680   # tokens of one 3-frame block at 60x104 latents


def cases(g):
    """(label, call, plain call, _int_mm call, int8 operations) at the
    phase-2 and phase-9 shapes, made one at a time."""
    for label, rows, H, N, tg in (("w8a8_ffn2 1.3B", M, 8960, 1536, 896),
                                  ("w8a8_ffn2 1.3B", 33 * 128, 8960, 1536,
                                   896),
                                  ("w8a8_ffn2 14B", M, 13824, 5120, 768)):
        hq = torch.randint(-127, 128, (rows, H), generator=g, device="cuda",
                           dtype=torch.int8)
        hs = torch.rand(rows, H // tg, generator=g, device="cuda") * 0.02
        p = weight(g, H, N)
        a = (hq, hs, p["w_qa_t"], p["w_scale"], p["b"], tg)
        yield (f"{label} {rows}x{H}x{N}, groups of {tg}",
               lambda: cm.w8a8_ffn2(*a), lambda: cm.w8a8_ffn2_ref(*a),
               lambda: torch._int_mm(hq, p["w_qa_t"].t()),
               2.0 * rows * H * N)
    for label, rows, K, N in (("1.3B qkv", M, 1536, 4608),
                              ("1.3B o/cross q/cross o", M, 1536, 1536),
                              ("1.3B cross k/v", 512, 1536, 1536),
                              # fc2's mainloop and tile without the folds
                              ("at the 1.3B fc2 shape", M, 8960, 1536),
                              ("14B qkv", M, 5120, 15360),
                              ("14B o/cross q/cross o", M, 5120, 5120)):
        x = torch.randn(rows, K, generator=g, device="cuda").to(torch.bfloat16)
        xq, sx = quant.quantize_activations(x)
        p = weight(g, K, N)
        a = (xq, sx, p["w_qa_t"], p["w_scale"], p["b"])
        yield (f"w8a8_matmul {label} {rows}x{K}x{N}",
               lambda: cm.w8a8_matmul(*a), lambda: cm.w8a8_matmul_ref(*a),
               lambda: torch._int_mm(xq, p["w_qa_t"].t()),
               2.0 * rows * K * N)


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
    for label, call, plain, int_mm, ops in cases(g):
        lib_ms = time_ms(int_mm)
        bound_ms = ops / PEAK_INT8_OPS * 1e3
        first, readings, equal = None, {n: [] for n in names}, {}
        for order in (names, names[::-1]):
            for name in order:
                build._loaded["w8a8_fc1"] = ctypes.CDLL(libs[name])
                out = call()
                torch.cuda.synchronize()
                if first is None:
                    first = out
                    plain_equal = torch.equal(out, plain())
                equal[name] = torch.equal(out, first)
                readings[name].append(time_ms(call))
        for name in names:
            ms = statistics.median(readings[name])
            print(f"{label} {name}: ms={ms:.4f} "
                  f"readings={[round(t, 4) for t in readings[name]]} "
                  f"int_mm_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"share_of_bound={bound_ms / ms:.3f} "
                  f"tops={ops / ms / 1e9:.1f} first_equals_plain="
                  f"{plain_equal} equal_to_first={equal[name]}", flush=True)
        del first, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
