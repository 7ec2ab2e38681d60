"""Gloo's ``all_gather`` against ``parallel/comm.py``'s gloo gather (a
broadcast from each rank in turn into one buffer), two ranks on one host.

    python scripts/gloo_gather_ab.py [--device cuda] [--mb 43 86] [--reps 5]

Each rank holds a seeded bf16 chunk of ``--mb`` MB (on ``--device``; a
CUDA chunk is staged through pinned host memory as ``comm.py`` stages
it, and both ranks share cuda:0).  Prints, for each size, the median ms
of ``--reps`` calls of each route (host clock, synchronised) and whether
they gathered the same bytes.  These are gloo's host times, not an NCCL
or NVLink speed.
"""
import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from self_forcing_tpu_torch.parallel import comm, launch  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _gloo_all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """gloo's all_gather, staged as comm.py stages a CUDA tensor."""
    src = t.cpu().pin_memory() if t.is_cuda else t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out]


def _median_ms(fn, dev, reps: int) -> float:
    fn()
    times = []
    for _ in range(reps):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_main(rank: int, world: int, args: dict, out_dir: str) -> None:
    dev = torch.device(args["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    rows = []
    for mb in args["mb"]:
        n = int(mb * 1e6) // 2
        g = torch.Generator().manual_seed(rank)
        t = torch.randn(n, generator=g).to(torch.bfloat16).to(dev)
        world_group = dist.group.WORLD
        a = _median_ms(lambda: _gloo_all_gather(t), dev, args["reps"])
        b = _median_ms(lambda: comm.all_gather(t, world_group), dev,
                       args["reps"])
        same = all(torch.equal(x, y) for x, y in zip(
            _gloo_all_gather(t), comm.all_gather(t, world_group)))
        rows.append(f"{mb} MB a rank: gloo all_gather {a:.1f} ms, "
                    f"broadcasts {b:.1f} ms, same bytes {same}")
    if rank == 0:
        with open(os.path.join(out_dir, "rows.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--mb", type=float, nargs="+", default=[43.0, 86.0])
    ap.add_argument("--reps", type=int, default=5)
    a = ap.parse_args()
    if a.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    print(f"torch {torch.__version__}, {os.cpu_count()} cores", flush=True)
    with tempfile.TemporaryDirectory() as d:
        launch.spawn(rank_main, 2, "gloo", vars(a), d)
        with open(os.path.join(d, "rows.txt")) as f:
            print(f.read(), end="", flush=True)


if __name__ == "__main__":
    main()
