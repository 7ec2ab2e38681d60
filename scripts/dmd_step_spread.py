"""Two one-process runs of ``chip_smoke.py`` phase 7's DMD step 0, the
spread phase 17(a)'s limits rest on; then phase 17 (and phases 14, 16).

    python scripts/dmd_step_spread.py [--seed 0] [--phase14] [--phase16]
                                      [--no-phase17] [--keep-going]

Builds the kernels, runs phase 7's full-depth Wan-1.3B DMD step 0 (random
bf16 weights from the seed, ``configs/self_forcing_dmd.yaml``) as phase 7
runs it and keeps it, then the same step again in a fresh trainer, and
prints how far the second run lies from the first by the measures phase
17 holds the sharded steps to (``card_checks.dmd_distances``: the
losses, the updated trees, the updates and the first moments).  Then the
phases asked for, each with its host-clock seconds.  ``--keep-going``
prints a failed check and goes on, so that one call reads every limit.
"""
import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phase14", action="store_true")
    ap.add_argument("--phase16", action="store_true")
    ap.add_argument("--no-phase17", action="store_true")
    ap.add_argument("--keep-going", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    if a.keep_going:
        cs.fail = lambda msg: print(f"CHECK FAILED: {msg}", flush=True)
    from self_forcing_tpu_torch.models.wan import dit
    from self_forcing_tpu_torch.ops import build
    from self_forcing_tpu_torch.ops import cuda_attention as ca
    from self_forcing_tpu_torch.parallel import card_checks
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cs.GC_CLOCK.install()
    t = time.perf_counter()
    for name in build.build_all():
        build.load(name)
    print(f"build {time.perf_counter() - t:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = True

    one = {}
    cs.phase_training(ca, a.seed, steps=(0,), keep=one)
    torch.cuda.empty_cache()
    trainer, context_fn, batches, _, _ = cs.dmd_trainer(a.seed,
                                                        timing=False)
    ctx = context_fn(list(next(batches)["prompts"]))
    batches.close()
    trainer.state.step = 0
    before = card_checks.dmd_weights(trainer)
    log = trainer.train_step({"context": ctx})
    state = card_checks.dmd_state(trainer, before)
    del trainer, before
    torch.cuda.empty_cache()
    rel = card_checks.dmd_distances(state, one)
    log_rel = card_checks._log_rel(
        {k: v for k, v in log.items() if not k.endswith("_ms")},
        {k: v for k, v in one["log"].items() if not k.endswith("_ms")})
    print(f"two one-process runs of phase 7's DMD step 0: losses "
          f"max_rel={log_rel:.3e} "
          f"{ {k: float(f'{v:.3e}') for k, v in rel.items()} }",
          flush=True)
    del state

    if a.phase14:
        t = time.perf_counter()
        cs.phase_other_trainers(ca, dit, a.seed)
        print(f"phase 14 {time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.phase16:
        t = time.perf_counter()
        cs.phase_parallel(a.seed)
        print(f"phase 16 {time.perf_counter() - t:.1f} s", flush=True)
        torch.cuda.empty_cache()
    if not a.no_phase17:
        torch.backends.cuda.matmul.allow_tf32 = True
        t = time.perf_counter()
        cs.phase_parallel_training(ca, a.seed, one)
        print(f"phase 17 {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main()
