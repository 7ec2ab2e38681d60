"""Video and image files (port of ``self_forcing_tpu/utils/video_io.py``).

``save_video`` writes mp4 through OpenCV's VideoWriter and falls back to
``imageio`` (gif always through ``imageio``); ``save_image`` uses PIL.
Each package is imported when a file is written, never with this module:
the machine that runs the port on the card may have none of them.
"""
from __future__ import annotations

import os

import numpy as np


def save_video(frames, path: str, fps: int = 16) -> str:
    """frames: [T, H, W, 3] uint8 RGB (numpy or a host tensor)."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [T, H, W, 3], got {frames.shape}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".gif"):
        import imageio
        imageio.mimwrite(path, list(frames), fps=fps)
        return path
    try:
        import cv2
        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        if not vw.isOpened():
            raise OSError("cv2 VideoWriter failed to open")
        for f in frames:
            vw.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
        vw.release()
    except (ImportError, OSError):
        import imageio
        imageio.mimwrite(path, list(frames), fps=fps, quality=8)
    return path


def save_image(image, path: str) -> str:
    """image: [H, W, 3] uint8 RGB."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    from PIL import Image
    Image.fromarray(np.asarray(image)).save(path)
    return path


def load_video(path: str, max_frames: int | None = None) -> np.ndarray:
    """-> [T, H, W, 3] uint8 RGB."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise OSError(f"could not open {path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and len(frames) >= max_frames):
            break
        frames.append(frame[..., ::-1])
    cap.release()
    return np.stack(frames)
