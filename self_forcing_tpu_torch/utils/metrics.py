"""Metrics logging (port of ``self_forcing_tpu/utils/metrics.py``): a
JSONL file ``<logdir>/metrics.jsonl`` and, when the ``wandb`` package is
importable and configured, wandb as well.  Under several ranks only the
main one (``is_main``) writes; the others' calls do nothing."""
from __future__ import annotations

import json
import os
import time
from typing import Mapping

import numpy as np


def _scalar(v):
    """A number as a Python float: size-1 tensors and arrays as they are,
    larger ones as their mean; anything else unchanged."""
    if hasattr(v, "detach"):
        v = v.detach().float().cpu().numpy()
    size = getattr(v, "size", 1)
    if hasattr(v, "__float__") and size == 1:
        return float(v)
    if size != 1 and hasattr(v, "mean"):
        return float(v.mean())
    return v


class MetricsLogger:
    def __init__(self, logdir: str, disable_wandb: bool = True,
                 wandb_kwargs: Mapping | None = None, is_main: bool = True):
        self.is_main = is_main
        self.logdir = logdir
        self._file = None
        self._wandb = None
        if not is_main:
            return
        os.makedirs(logdir, exist_ok=True)
        self._file = open(os.path.join(logdir, "metrics.jsonl"), "a",
                          buffering=1)
        if not disable_wandb:
            try:
                import wandb
                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except Exception:  # noqa: BLE001
                # missing, or importable but unconfigured (no API key,
                # offline): the JSONL file is the sink either way
                self._wandb = None

    def log_video(self, name: str, video, step: int, fps: int = 16):
        """A decoded video [T, H, W, 3], float in [0, 1] or uint8, written
        as ``<logdir>/videos/<name>_<step>.mp4`` (``utils/video_io.py``)
        and sent to wandb when it is on.  Returns the path (None off the
        main rank)."""
        if not self.is_main:
            return None
        from self_forcing_tpu_torch.utils.video_io import save_video
        video = np.asarray(video)
        if video.dtype != np.uint8:
            video = (np.clip(video, 0.0, 1.0) * 255.0).astype(np.uint8)
        path = os.path.join(self.logdir, "videos", f"{name}_{step:06d}.mp4")
        save_video(video, path, fps=fps)
        if self._wandb is not None:
            self._wandb.log(
                {name: self._wandb.Video(video.transpose(0, 3, 1, 2),
                                         caption=name, fps=fps,
                                         format="mp4")}, step=step)
        return path

    def log(self, metrics: Mapping, step: int | None = None) -> None:
        """One JSON line: the time, each metric as a float (arrays and
        tensors of more than one element as their mean) and the step."""
        if not self.is_main:
            return
        rec = {"ts": round(time.time(), 3),
               **{k: _scalar(v) for k, v in metrics.items()}}
        if step is not None:
            rec["step"] = step
        self._file.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: _scalar(v) for k, v in metrics.items()},
                            step=step)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
