"""The datasets (port of ``self_forcing_tpu/data/datasets.py``): prompts
and images for the inference CLI, and the training datasets over the
record shards of ``data/recordstore.py`` (the reference's LMDB schema:
'latents' rows fp16 and 'prompts' rows str with their shape headers;
pose shards add 'dwpose_data' uint8 and optionally 'random_ref_dwpose' /
'first_frame').  PIL is imported when an image is read.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from self_forcing_tpu_torch.data.recordstore import (RecordReader,
                                                     get_array_shape,
                                                     retrieve_row)


class TextDataset:
    """Newline-separated prompts (blank lines skipped), with optional
    extended prompts line for line."""

    def __init__(self, prompt_path: str,
                 extended_prompt_path: str | None = None):
        with open(prompt_path, encoding="utf-8") as f:
            self.prompt_list = [line.rstrip("\n") for line in f
                                if line.strip()]
        self.extended_prompt_list = None
        if extended_prompt_path is not None:
            with open(extended_prompt_path, encoding="utf-8") as f:
                self.extended_prompt_list = [line.rstrip("\n") for line in f
                                             if line.strip()]
            if len(self.extended_prompt_list) != len(self.prompt_list):
                raise ValueError(
                    f"{extended_prompt_path} has "
                    f"{len(self.extended_prompt_list)} prompts, "
                    f"{prompt_path} {len(self.prompt_list)}")

    def __len__(self):
        return len(self.prompt_list)

    def __getitem__(self, idx):
        out = {"prompts": self.prompt_list[idx], "idx": idx}
        if self.extended_prompt_list is not None:
            out["extended_prompts"] = self.extended_prompt_list[idx]
        return out


class ODERegressionDataset:
    """One shard of ODE trajectories: an item is {'prompts': str,
    'ode_latent': float32 [T, F, C, H, W]} (one snapshot gets T = 1)."""

    def __init__(self, data_path: str, max_pair: int = int(1e8)):
        self.reader = RecordReader(data_path)
        self.latents_shape = get_array_shape(self.reader, "latents")
        self.max_pair = max_pair

    def __len__(self):
        return min(self.latents_shape[0], self.max_pair)

    def __getitem__(self, idx):
        latents = retrieve_row(self.reader, "latents", np.float16, idx,
                               self.latents_shape[1:])
        if latents.ndim == 4:
            latents = latents[None]
        return {"prompts": retrieve_row(self.reader, "prompts", str, idx),
                "ode_latent": latents.astype(np.float32)}


class ShardingDataset:
    """A directory of shards (the ``.rs`` files, in name order; other
    files are skipped) behind one (shard, row) index; items as
    :class:`ODERegressionDataset`'s."""

    def __init__(self, data_path: str, max_pair: int = int(1e8)):
        self.readers, self.index, self.latents_shape = [], [], []
        for fname in sorted(os.listdir(data_path)):
            if not fname.endswith(".rs"):
                continue
            reader = RecordReader(os.path.join(data_path, fname))
            shape = get_array_shape(reader, "latents")
            self.index.extend((len(self.readers), i)
                              for i in range(shape[0]))
            self.readers.append(reader)
            self.latents_shape.append(shape)
        self.max_pair = max_pair

    def __len__(self):
        return min(len(self.index), self.max_pair)

    def __getitem__(self, idx):
        shard_id, local_idx = self.index[idx]
        reader = self.readers[shard_id]
        latents = retrieve_row(reader, "latents", np.float16, local_idx,
                               self.latents_shape[shard_id][1:])
        if latents.ndim == 4:
            latents = latents[None]
        return {"prompts": retrieve_row(reader, "prompts", str, local_idx),
                "ode_latent": latents.astype(np.float32)}


class PoseShardingDataset(ShardingDataset):
    """:class:`ShardingDataset` with each row's DWPose video
    ('dwpose_data' uint8) and, where the shard has them, its
    'random_ref_dwpose' and 'first_frame' images."""

    def __getitem__(self, idx):
        shard_id, local_idx = self.index[idx]
        reader = self.readers[shard_id]
        out = super().__getitem__(idx)
        for name in ("dwpose_data", "random_ref_dwpose", "first_frame"):
            if reader.get(f"{name}_shape") is None \
                    and name != "dwpose_data":
                continue
            shape = get_array_shape(reader, name)
            out[name] = retrieve_row(reader, name, np.uint8, local_idx,
                                     shape[1:])
        return out


class TextImagePairDataset:
    """The i2v evaluation set: images and a ``target_crop_info_*.json``
    list of {image_name | image_path, caption | prompt}.  An item's
    ``image`` is a float32 tensor [H, W, 3] in [-1, 1]."""

    def __init__(self, data_dir: str, transform=None):
        self.data_dir = data_dir
        self.transform = transform
        metas = [f for f in os.listdir(data_dir)
                 if f.startswith("target_crop_info") and f.endswith(".json")]
        if not metas:
            raise FileNotFoundError(
                f"no target_crop_info_*.json in {data_dir}")
        with open(os.path.join(data_dir, metas[0]), encoding="utf-8") as f:
            self.metadata = json.load(f)

    def __len__(self):
        return len(self.metadata)

    def __getitem__(self, idx):
        entry = self.metadata[idx]
        from PIL import Image
        if "image_name" in entry:
            img_path = os.path.join(self.data_dir, "images",
                                    entry["image_name"])
        else:
            img_path = os.path.join(self.data_dir, entry["image_path"])
        with Image.open(img_path) as im:
            image = im.convert("RGB")
        if self.transform is not None:
            image = self.transform(image)
        else:
            image = torch.from_numpy(
                np.asarray(image, np.float32) / 127.5 - 1.0)
        return {"image": image,
                "prompts": entry.get("caption", entry.get("prompt", "")),
                "metadata": entry}
