"""Pose-conditioned training shards for ``PoseShardingDataset`` (port of
``scripts/create_pose_shards.py``).

    python -m self_forcing_tpu_torch.scripts.create_pose_shards \\
        --data_path SAMPLES --output_dir data/pose_shards --rows_per_shard 256

Input: a directory of ``.npz`` samples, one row each, with ``prompt`` and
``latents`` [F, 16, h, w] (stored fp16), ``dwpose_data`` [3, 4F - 3, H, W]
(uint8, height before width: 480x832 pixels for the 60x104 latents), and
optionally ``random_ref_dwpose`` and ``first_frame`` [H, W, 3] (uint8).
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from self_forcing_tpu_torch.scripts.create_sharded_dataset import ShardSink

ARRAYS = ("latents", "dwpose_data", "random_ref_dwpose", "first_frame")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--rows_per_shard", type=int, default=256)
    args = ap.parse_args(argv)
    files = sorted(glob.glob(os.path.join(args.data_path, "*.npz")))
    if not files:
        raise FileNotFoundError(f"no .npz sample files in {args.data_path}")
    sink = ShardSink(args.output_dir, args.rows_per_shard)
    for f in files:
        d = np.load(f, allow_pickle=True)
        sink.put({"prompts": str(d["prompt"]), **{
            name: d[name].astype(np.float16 if name == "latents"
                                 else np.uint8)
            for name in ARRAYS if name in d}})
    sink.flush()
    print(f"wrote {len(files)} rows into {sink.shard_id + 1} shards -> "
          f"{args.output_dir}")


if __name__ == "__main__":
    main()
