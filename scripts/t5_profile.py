"""Where the umT5-XXL encode's time goes on one NVIDIA card.

    python scripts/t5_profile.py [--tokens 120]

Random bf16 weights from a seed at full width (24 layers, dim 4096, 64
heads), seeded ids at L = 512 with ``--tokens`` real tokens and the rest
padding.  Prints the card's name and power limit, one
``encode_for_dit`` under torch.profiler (wall, the kernels' summed time,
the 15 largest kernels), then the pieces of one encoder layer timed alone
(CUDA events, median of 7 behind a spin kernel): three of the seven
linears, the float32 score product (the upcast the encoder runs, and
``torch.bmm(..., out_dtype=float32)`` beside it where the build has it),
the position-bias gather and add, the softmax, and the whole layer.
"""
import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from self_forcing_tpu_torch.models.wan import t5 as t5m  # noqa: E402
from self_forcing_tpu_torch.utils import tree  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=120)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, L = t5m.UMT5_XXL, 512
    p = t5m.init_params(cfg, seed=1, dtype=torch.bfloat16, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(1, cfg.vocab_size, (1, L), generator=g,
                        device="cuda")
    mask = torch.zeros(1, L, dtype=torch.int64, device="cuda")
    mask[:, :a.tokens] = 1

    def encode():
        t5m.encode_for_dit(p, cfg, ids * mask, mask)

    encode()
    wall, rows, _, _ = cs.profile_ms(encode)
    busy = sum(ms for _, ms in rows)
    bound_ms, by = cs.t5_bound(cfg, L)
    print(f"encode_for_dit: wall_ms={wall:.2f} kernel_sum_ms={busy:.2f} "
          f"bound_ms={bound_ms:.4f} ({by})", flush=True)
    for name, ms in rows[:15]:
        print(f"  {ms:8.3f}  {name[:110]}", flush=True)

    bp = tree.index(p["blocks"], 0)
    nh, hd = cfg.num_heads, cfg.dim_attn // cfg.num_heads
    x = p["token_embedding"][ids]
    h = t5m.t5_layer_norm(x, bp["norm1"]["w"], cfg.eps)
    q = (h @ bp["attn"]["q"]["w"]).view(1, L, nh, hd).transpose(1, 2)
    k = (h @ bp["attn"]["k"]["w"]).view(1, L, nh, hd).transpose(1, 2)
    buckets = t5m._buckets(cfg, L, "cuda")
    pad = t5m._pad_bias(mask)
    hidden = torch.randn(1, L, cfg.dim_ffn, generator=g, device="cuda"
                         ).to(torch.bfloat16)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    bias = bp["pos_emb"].float().t()[:, buckets] + pad

    def show(name, fn):
        print(f"{name}: {cs.time_ms(fn):.4f} ms", flush=True)

    show("q linear", lambda: h @ bp["attn"]["q"]["w"])
    show("gate linear", lambda: h @ bp["ffn"]["gate"]["w"])
    show("fc2 linear", lambda: hidden @ bp["ffn"]["fc2"]["w"])
    show("scores, float32 upcast",
         lambda: torch.matmul(q.float(), k.float().transpose(-1, -2)))
    qb, kb = q.reshape(nh, L, hd), k.reshape(nh, L, hd).transpose(1, 2)
    try:
        s2 = torch.bmm(qb, kb, out_dtype=torch.float32)
    except (TypeError, RuntimeError) as e:
        print(f"scores, bmm out_dtype: not in this build ({e!r:.80})")
    else:
        print(f"scores, bmm out_dtype: max |diff| vs the upcast "
              f"{float((s[0] - s2).abs().max()):.3e}", flush=True)
        show("scores, bmm out_dtype",
             lambda: torch.bmm(qb, kb, out_dtype=torch.float32))
    show("position bias gather + padding",
         lambda: bp["pos_emb"].float().t()[:, buckets] + pad)
    scratch = s.clone()
    show("bias add (in place)", lambda: scratch.add_(bias))
    show("softmax + cast", lambda: torch.softmax(s, dim=-1).to(
        torch.bfloat16))
    show("layer", lambda: t5m._encoder_block(bp, cfg, x, buckets, pad))


if __name__ == "__main__":
    main()
