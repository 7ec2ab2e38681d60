"""Aggregate latent / prompt pairs into several record shards for
``ShardingDataset`` (port of ``scripts/create_sharded_dataset.py``).

    python -m self_forcing_tpu_torch.scripts.create_sharded_dataset \\
        --data_path PAIRS --output_dir data/shards --rows_per_shard 512

Each shard ``shard_{k:04d}.rs`` holds up to ``--rows_per_shard`` rows.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from self_forcing_tpu_torch.data.recordstore import (RecordWriter,
                                                     store_arrays,
                                                     write_shape_header)
from self_forcing_tpu_torch.scripts.create_shards_iterative import (
    pair_files, unique_rows)


class ShardSink:
    """Rows into numbered shards of ``rows_per_shard`` rows each; every
    array's shape header is written when its shard closes."""

    def __init__(self, out_dir: str, rows_per_shard: int):
        self.out_dir, self.rows_per_shard = out_dir, rows_per_shard
        self.shard_id, self.writer, self.rows = -1, None, 0
        self.shapes: dict = {}
        os.makedirs(out_dir, exist_ok=True)

    def put(self, row: dict) -> None:
        """One row: {name: array or, for 'prompts', a str}, stored in the
        dict's order."""
        if self.writer is None or self.rows >= self.rows_per_shard:
            self.flush()
            self.shard_id += 1
            self.writer = RecordWriter(os.path.join(
                self.out_dir, f"shard_{self.shard_id:04d}.rs"))
            self.rows = 0
        store_arrays(self.writer, {
            k: [v] if isinstance(v, str) else np.asarray(v)[None]
            for k, v in row.items()}, self.rows)
        self.shapes.update({k: np.asarray(v).shape for k, v in row.items()
                            if not isinstance(v, str)})
        self.rows += 1

    def flush(self) -> None:
        if self.writer is not None and self.rows:
            for name, shape in self.shapes.items():
                write_shape_header(self.writer, name,
                                   (self.rows,) + tuple(shape))
            write_shape_header(self.writer, "prompts", (self.rows,))
            self.writer.close()
            self.writer = None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--rows_per_shard", type=int, default=512)
    args = ap.parse_args(argv)
    sink = ShardSink(args.output_dir, args.rows_per_shard)
    total = 0
    for prompt, row in unique_rows(pair_files(args.data_path)):
        sink.put({"latents": row, "prompts": prompt})
        total += 1
    sink.flush()
    print(f"wrote {total} rows into {sink.shard_id + 1} shards "
          f"-> {args.output_dir}")


if __name__ == "__main__":
    main()
