"""Where a ZeRO-3 DMD step's time goes on two gloo ranks sharing one card
(``chip_smoke.py`` phase 17(b)'s step).

    python scripts/zero3_step_profile.py [--layers 1] [--seed 0]
                                         [--profile cold|warm] [--tf32]

Builds the kernels, then two ranks on cuda:0 over gloo each draw phase
17(b)'s models (Wan-1.3B width at ``--layers`` layers, bf16,
``configs/self_forcing_dmd.yaml``, fsdp 2, the cache constraint set
aside as phase 17 does; with ``--tf32`` the float32 products in TF32, as
``train.py`` runs them) and run the generator + critic step twice (the
step count reset to 0 each time), the ``--profile`` one under
torch.profiler.  Each rank prints each step's ms and its host-staged
collectives' ms (host clock, synchronised); rank 0 the profiled step's
operators by host time and by device time.  Gloo on one card: no time
here is an NCCL or NVLink time.
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from self_forcing_tpu_torch.parallel import launch  # noqa: E402

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs")


def rank_main(rank: int, world: int, args: dict, out_dir: str) -> None:
    from self_forcing_tpu_torch.models.wan.configs import WAN_1_3B
    from self_forcing_tpu_torch.parallel import card_checks as cc
    from self_forcing_tpu_torch.parallel import comm
    from self_forcing_tpu_torch.parallel import mesh as mesh_mod
    from self_forcing_tpu_torch.training.trainer_distillation import (
        ScoreDistillationTrainer)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = args["tf32"]
    torch.backends.cudnn.allow_tf32 = args["tf32"]
    spec = dict(model=WAN_1_3B, seed=args["seed"], configs=CONFIGS)
    cfg = dataclasses.replace(WAN_1_3B, num_layers=args["layers"],
                              num_frame_per_block=3)
    config = cc._dmd_config(spec)
    mesh = mesh_mod.create_mesh(dp=1, fsdp=world, sp=1, device_type="cuda")
    gen = cc._params(cfg, args["seed"], dev)
    fake = cc._params(cfg, args["seed"] + 1, dev, causal=False)
    real = cc._params(cfg, args["seed"] + 2, dev, causal=False)
    ctx, neg = cc._context(config, cfg, dev)
    trainer = ScoreDistillationTrainer(config, gen, fake, real, cfg, cfg,
                                       cfg, neg, device=dev, mesh=mesh)
    trainer.bundle.rollout_act_shard = None
    del gen, fake, real
    lines = []
    for run in ("cold", "warm"):
        trainer.state.step = 0
        torch.cuda.synchronize()
        comm.CLOCK.on = True
        comm.CLOCK.reset()
        prof = None
        if run == args["profile"]:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        trainer.train_step({"context": ctx})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            prof.__exit__(None, None, None)
        comm.CLOCK.on = False
        lines.append(f"rank {rank} {run} step: {ms:.1f} ms, collectives "
                     f"{comm.CLOCK.ms:.1f} ms ({comm.CLOCK.calls} calls)")
        if prof is not None and rank == 0:
            ka = prof.key_averages()
            lines.append(ka.table(sort_by="self_cpu_time_total",
                                  row_limit=30, max_name_column_width=60))
            lines.append(ka.table(sort_by="self_device_time_total",
                                  row_limit=15, max_name_column_width=60))
    with open(os.path.join(out_dir, f"rank{rank}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", choices=("cold", "warm"), default="warm")
    ap.add_argument("--tf32", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from self_forcing_tpu_torch.ops import build
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build.build_all()
    with tempfile.TemporaryDirectory() as d:
        launch.spawn(rank_main, 2, "gloo", vars(a), d)
        for r in range(2):
            with open(os.path.join(d, f"rank{r}.txt")) as f:
                print(f.read(), end="", flush=True)


if __name__ == "__main__":
    main()
