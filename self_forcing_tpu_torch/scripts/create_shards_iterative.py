"""Aggregate ODE-pair files into one record shard (port of
``scripts/create_shards_iterative.py``).

    python -m self_forcing_tpu_torch.scripts.create_shards_iterative \\
        --data_path PAIRS --output_path data/ode_shard.rs

Reads the ``.npz`` files of ``generate_ode_pairs`` and the reference's
``.pt`` files ({prompt: tensor}); a prompt seen before is skipped.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from self_forcing_tpu_torch.data.recordstore import (RecordWriter,
                                                     store_arrays,
                                                     write_shape_header)


def pair_files(data_path: str) -> list[str]:
    files = sorted(glob.glob(os.path.join(data_path, "*.npz"))
                   + glob.glob(os.path.join(data_path, "*.pt")))
    if not files:
        raise FileNotFoundError(f"no pair files in {data_path}")
    return files


def load_pairs(path: str):
    """(prompt, latents fp16 with a leading sample axis) of a file."""
    if path.endswith(".npz"):
        d = np.load(path, allow_pickle=True)
        yield str(d["prompt"]), np.asarray(d["latents"], np.float16)
    else:
        for prompt, video in torch.load(path, map_location="cpu",
                                        weights_only=True).items():
            yield prompt, video.half().numpy()


def unique_rows(files):
    """(prompt, row) of every sample of each first-seen prompt."""
    seen = set()
    for f in files:
        for prompt, latents in load_pairs(f):
            if prompt in seen:
                continue
            seen.add(prompt)
            for row in latents:
                yield prompt, row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--output_path", required=True)
    args = ap.parse_args(argv)
    files = pair_files(args.data_path)
    os.makedirs(os.path.dirname(args.output_path) or ".", exist_ok=True)
    counter, row_shape = 0, None
    with RecordWriter(args.output_path) as w:
        for prompt, row in unique_rows(files):
            store_arrays(w, {"latents": row[None], "prompts": [prompt]},
                         counter)
            row_shape = row.shape
            counter += 1
        write_shape_header(w, "latents", (counter,) + tuple(row_shape))
        write_shape_header(w, "prompts", (counter,))
    print(f"wrote {counter} rows -> {args.output_path}")


if __name__ == "__main__":
    main()
