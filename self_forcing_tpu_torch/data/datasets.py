"""Prompt and image datasets of the inference CLI (port of
``TextDataset`` and ``TextImagePairDataset`` of
``self_forcing_tpu/data/datasets.py``).

The training datasets over the record store are not ported (ROADMAP
Queue A item 7).  PIL is imported when an image is read.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


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
