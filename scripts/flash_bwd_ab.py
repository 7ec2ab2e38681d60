"""A/B of versions of the port's flash backward kernel on one NVIDIA card.

    python scripts/flash_bwd_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/flash_bwd.cu``
(same launcher, ``flash_bwd_launch``).  Each is built with the package's
nvcc flags into ``self_forcing_tpu_torch/csrc/build/ab/`` and loaded in
turn as the library behind ``cuda_attention.flash_bwd``, which is timed
at the phase-2 shapes of ``chip_smoke.py`` (B 1, L 32760, 12 heads of
128, bf16; no mask and the 7-block block-causal mask) with the same
CUDA-event timer.  The versions run in order and then in reverse; the
median of the two readings is printed with each reading, ptxas's spill
line, and each version's largest relative L2 distance (dq, dk, dv) from
the first version's gradients (dq's fp32 partials are summed in an
order that changes from run to run, ~3e-5).
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

from chip_smoke import time_ms  # noqa: E402
from self_forcing_tpu_torch.ops import build, masks  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_attention as ca  # noqa: E402


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
        spills = sorted({ln.strip() for ln in logs[name].splitlines()
                         if "spill" in ln or "C75" in ln})
        print(f"build {name}: {spills}", flush=True)
    return {name: lib for name, (lib, _) in jobs.items()}


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


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
    L, N, D = 32760, 12, 128
    q = (torch.randn(1, L, N, D, generator=g, device="cuda")
         * (D ** -0.5 * 1.4426950408889634)).to(torch.bfloat16)
    k, v, do = (torch.randn(1, L, N, D, generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(3))
    for label, mask in (("no mask", None), ("block-causal 7x3 frames",
                                            masks.block_causal_mask(
                                                21, 1560, 3))):
        out, lse = ca.flash_fwd(q, k, v, mask)
        args = (q, k, v, do, lse, ca.flash_delta(out, do), mask)
        first, readings, dist = None, {n: [] for n in names}, {}
        for order in (names, names[::-1]):
            for name in order:
                build._loaded["flash_bwd"] = ctypes.CDLL(libs[name])
                grads = ca.flash_bwd(*args)
                torch.cuda.synchronize()
                first = first or grads
                dist[name] = max(rel_l2(a, b) for a, b in zip(grads, first))
                readings[name].append(time_ms(lambda: ca.flash_bwd(*args)))
        for name in names:
            print(f"{label} {name}: ms={statistics.median(readings[name]):.4f}"
                  f" readings={[round(t, 4) for t in readings[name]]} "
                  f"rel_l2_to_first={dist[name]:.2e}", flush=True)


if __name__ == "__main__":
    main()
