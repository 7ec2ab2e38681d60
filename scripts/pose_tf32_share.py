"""How much of the random DWPose embedding depends on the pose video, and
what TF32 rounding does to that part, on the CPU.

    python scripts/pose_tf32_share.py [--hw 128 192] [--frames 9] [--seed 52]

The pose CNN of ``conditioning.init_dwpose_params`` (uniform weights
within 1/sqrt(fan_in), SiLU between layers) on a seeded uint8 pose video
and on a black one.  Prints, layer by layer, the standard deviation of
the difference of the two activations (the part that depends on the
video) beside that of the activation, and its share of the activation's
norm.  Then the whole embedding's and that part's relative L2 distance
when every conv operand is rounded to TF32 (10 mantissa bits, round to
nearest even) against float32.  The rounding is an emulation: cuDNN's
choice of algorithm a layer decides what the card does.
"""
import argparse
import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from self_forcing_tpu_torch import conditioning as cond  # noqa: E402


def tf32(t: torch.Tensor) -> torch.Tensor:
    i = t.contiguous().view(torch.int32)
    i = (i + 0x1000 + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def layers(params, x, rnd):
    """The DWPose CNN's activations, each conv's operands through
    ``rnd``."""
    h, out = x, []
    last = len(cond._DWPOSE_LAYERS) - 1
    for i, (p, (_, kern, stride)) in enumerate(
            zip(params["layers"], cond._DWPOSE_LAYERS)):
        pad = 0 if kern == (1, 2, 2) else tuple(k // 2 for k in kern)
        h = F.conv3d(rnd(h), rnd(p["w"]), p["b"], stride=stride,
                     padding=pad)
        if i != last:
            h = F.silu(h)
        out.append(h)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, nargs=2, default=(128, 192))
    ap.add_argument("--frames", type=int, default=9,
                    help="pose frames, 4F - 3 for F latent frames")
    ap.add_argument("--seed", type=int, default=52)
    a = ap.parse_args()
    params = cond.init_dwpose_params(a.seed, device="cpu")
    video = torch.randint(0, 256, (1, 3, a.frames, *a.hw), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(a.seed))
    x = cond.prepare_dwpose_input(video)
    x0 = torch.zeros_like(x)
    same = lambda t: t  # noqa: E731
    acts, acts0 = layers(params, x, same), layers(params, x0, same)
    for i, (h, h0) in enumerate(zip(acts, acts0)):
        print(f"layer {i}: std of the video's part {float((h - h0).std()):.3e}"
              f", of the activation {float(h.std()):.3e}, share of the "
              f"norm {float((h - h0).norm() / h.norm()):.3e}")
    e, e0 = acts[-1], acts0[-1]
    t, t0 = layers(params, x, tf32)[-1], layers(params, x0, tf32)[-1]

    def rel(u, v):
        return float((u - v).norm() / v.norm())

    print(f"pose video [1, 3, {a.frames}, {a.hw[0]}, {a.hw[1]}] -> "
          f"{list(e.shape)}: the video's part is "
          f"{float((e - e0).norm() / e.norm()):.3e} of the embedding's "
          f"norm; TF32-rounded operands move the whole "
          f"by {rel(t, e):.3e}, the video's part by {rel(t - t0, e - e0):.3e}")


if __name__ == "__main__":
    main()
