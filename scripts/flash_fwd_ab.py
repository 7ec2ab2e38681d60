"""A/B of versions of the port's flash forward kernel on one NVIDIA card.

    python scripts/flash_fwd_ab.py A.cu B.cu [...]

Each file is a version of ``self_forcing_tpu_torch/csrc/decode_fresh.cu``
(same launcher, ``flash_fwd_launch``).  Each is built with the package's
nvcc flags into ``self_forcing_tpu_torch/csrc/build/ab/`` and loaded in
turn as the library behind ``cuda_attention.flash_fwd``, which is timed
at the phase-2 shapes of ``chip_smoke.py`` (B 1, L 32760, 12 heads of
128, bf16; no mask and the 7-block block-causal mask; the free mode on
q carrying head_dim**-0.5 * log2(e), the online and bounded modes on
unfolded q at head_dim**-0.5) with the same CUDA-event timer.  The
versions run in order and then in reverse; the median of the two
readings is printed with each reading, ptxas's spill line, the bound's
share and each version's relative L2 distance of out (and the largest
lse difference) from the plain version ``flash_fwd_ref`` computed once.
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

from chip_smoke import PEAK_BF16_FLOPS, rel_l2, time_ms  # noqa: E402
from scripts.int8qk_ab import build_versions  # noqa: E402
from self_forcing_tpu_torch.ops import build, masks  # noqa: E402
from self_forcing_tpu_torch.ops import cuda_attention as ca  # noqa: E402

LOG2E = 1.4426950408889634


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
         * (D ** -0.5 * LOG2E)).to(torch.bfloat16)
    k, v = (torch.randn(1, L, N, D, generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    qu = (q.float() / (D ** -0.5 * LOG2E)).to(q.dtype)
    m0 = (D ** -0.5 * qu.float().norm(dim=-1).amax()
          * k.float().norm(dim=-1).amax()).reshape(1)
    runs = {"free": (q, {}),
            "online": (qu, dict(mode="online", scale=D ** -0.5)),
            "bounded": (qu, dict(mode="bounded", scale=D ** -0.5, m0=m0))}
    for label, mask in (("no mask", None), ("block-causal 7x3 frames",
                                            masks.block_causal_mask(
                                                21, 1560, 3))):
        frac = 1.0 if mask is None else float(
            (mask.end1 - mask.start1).astype("int64").sum()
            + (mask.end2 - mask.start2).astype("int64").sum()) / L / L
        bound_ms = 4.0 * L * L * D * N * frac / PEAK_BF16_FLOPS * 1e3
        for mode, (qm, kw) in runs.items():
            ref, ref_lse = ca.flash_fwd_ref(qm, k, v, mask, **kw)
            readings, dist = {n: [] for n in names}, {}
            for order in (names, names[::-1]):
                for name in order:
                    build._loaded["decode_fresh"] = ctypes.CDLL(libs[name])
                    out, lse = ca.flash_fwd(qm, k, v, mask, **kw)
                    torch.cuda.synchronize()
                    dist[name] = (rel_l2(out, ref),
                                  float((lse - ref_lse).abs().max()))
                    readings[name].append(time_ms(
                        lambda: ca.flash_fwd(qm, k, v, mask, **kw)))
            for name in names:
                ms = statistics.median(readings[name])
                print(f"{label} {mode} {name}: ms={ms:.4f} readings="
                      f"{[round(t, 4) for t in readings[name]]} "
                      f"bound_share={bound_ms / ms:.3f} rel_l2_to_plain="
                      f"{dist[name][0]:.2e} lse_max_abs={dist[name][1]:.2e}",
                      flush=True)
            del ref, ref_lse


if __name__ == "__main__":
    main()
