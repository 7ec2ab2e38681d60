"""A/B of versions of the port's W8A8 fc1 kernel on one NVIDIA card.

    python scripts/w8a8_fc1_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/w8a8_fc1.cu``
(same launchers, ``w8a8_ffn1_xq_launch`` and ``w8a8_linear_xq_launch``).
Each is built with the package's nvcc flags into
``self_forcing_tpu_torch/csrc/build/ab/`` and loaded in turn as the
library behind ``cuda_matmul.w8a8_ffn1`` and ``w8a8_matmul_bf16x``, which
are timed at the phase-2 shapes of ``chip_smoke.py`` with the same
CUDA-event timer: the Wan-1.3B fc1 from raw bf16 x (M 4680, K 1536, H
8960, groups of 896; the ``quantize_rows`` pre-pass included), the
Wan-14B fc1 from int8 x (K 5120, H 13824, groups of 768) and the 1.3B qkv
GEMM from raw x (N 4608).  The versions run in order and then in
reverse; the median of the two readings is printed with each reading,
``torch._int_mm`` on the same operands, the bound (int8 peak 1979
TOP/s), ptxas's register and spill lines, and whether each version's
outputs equal the first version's bit for bit.
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

from chip_smoke import PEAK_INT8_OPS, time_ms  # noqa: E402
from self_forcing_tpu_torch.ops import build, quant  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_matmul as cm  # noqa: E402


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


def weight(g, d_in, d_out):
    w = torch.randn(d_in, d_out, generator=g, device="cuda") * d_in ** -0.5
    b = torch.randn(d_out, generator=g, device="cuda") * 0.02
    return quant.quantize_linear_params(
        {"w": w.to(torch.bfloat16), "b": b.to(torch.bfloat16)}, "w8a8")


def cases(g):
    """(label, call, int8 x for _int_mm, weight, ops) at the phase-2
    shapes."""
    M = 4680
    out = []
    x = torch.randn(M, 1536, generator=g, device="cuda").to(torch.bfloat16)
    p = weight(g, 1536, 8960)
    a = (p["w_qa_t"], p["w_scale"], p["b"], 896)
    out.append(("w8a8_ffn1 1.3B", lambda: cm.w8a8_ffn1(x, *a),
                cm.quantize_rows_ref(x)[0], p["w_qa_t"],
                2.0 * M * 1536 * 8960))
    x14 = torch.randn(M, 5120, generator=g, device="cuda").to(torch.bfloat16)
    xq, sx = quant.quantize_activations(x14)
    p14 = weight(g, 5120, 13824)
    a14 = (p14["w_qa_t"], p14["w_scale"], p14["b"], 768, sx)
    out.append(("w8a8_ffn1_xq 14B", lambda: cm.w8a8_ffn1(xq, *a14), xq,
                p14["w_qa_t"], 2.0 * M * 5120 * 13824))
    pq = weight(g, 1536, 4608)
    aq = (pq["w_qa_t"], pq["w_scale"], pq["b"])
    out.append(("w8a8_matmul_bf16x 1.3B qkv",
                lambda: cm.w8a8_matmul_bf16x(x, *aq),
                cm.quantize_rows_ref(x)[0], pq["w_qa_t"],
                2.0 * M * 1536 * 4608))
    return out


def same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(same(u, v) for u, v in zip(a, b))
    return torch.equal(a, b)


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
    for label, call, xq, w_t, ops in cases(g):
        lib_ms = time_ms(lambda: torch._int_mm(xq, w_t.t()))
        bound_ms = ops / PEAK_INT8_OPS * 1e3
        first, readings, equal = None, {n: [] for n in names}, {}
        for order in (names, names[::-1]):
            for name in order:
                build._loaded["w8a8_fc1"] = ctypes.CDLL(libs[name])
                out = call()
                torch.cuda.synchronize()
                if first is None:
                    first = out
                equal[name] = same(out, first)
                readings[name].append(time_ms(call))
        for name in names:
            ms = statistics.median(readings[name])
            print(f"{label} {name}: ms={ms:.4f} "
                  f"readings={[round(t, 4) for t in readings[name]]} "
                  f"int_mm_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} "
                  f"share_of_bound={bound_ms / ms:.3f} "
                  f"tops={ops / ms / 1e9:.1f} equal_to_first={equal[name]}",
                  flush=True)


if __name__ == "__main__":
    main()
