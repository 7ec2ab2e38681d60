"""Vision-input plumbing for the Qwen-VL prompt expanders (port of
``self_forcing_tpu/qwen_vl.py``; the reference's vendored qwen-vl-utils,
wan/utils/qwen_vl_utils.py): normalize the image/video entries of a
chat-template message list into model-ready inputs: factor-aligned smart
resizing, multi-source image loading (PIL / path / file:// / http /
base64 data URI), frame-count selection for videos, and the
`process_vision_info` entry point the HF Qwen2.5-VL processor consumes.

Pure host-side preprocessing (PIL + math).  PIL is imported where an
image is opened; video decoding is gated on torchvision being
importable; the list-of-frames path needs only PIL.  An http(s) source
is fetched only when a caller passes one.
"""
from __future__ import annotations

import base64
import math
from io import BytesIO

IMAGE_FACTOR = 28  # ViT patch 14 x spatial merge 2
MIN_PIXELS = 4 * 28 * 28
MAX_PIXELS = 16384 * 28 * 28
MAX_RATIO = 200

VIDEO_MIN_PIXELS = 128 * 28 * 28
VIDEO_MAX_PIXELS = 768 * 28 * 28
VIDEO_TOTAL_PIXELS = 24576 * 28 * 28
FRAME_FACTOR = 2
DEFAULT_FPS = 2.0
FPS_MIN_FRAMES = 4
FPS_MAX_FRAMES = 768


def round_by_factor(n: float, factor: int) -> int:
    return round(n / factor) * factor


def ceil_by_factor(n: float, factor: int) -> int:
    return math.ceil(n / factor) * factor


def floor_by_factor(n: float, factor: int) -> int:
    return math.floor(n / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS,
                 max_pixels: int = MAX_PIXELS) -> tuple[int, int]:
    """Nearest factor-divisible (h, w) preserving aspect ratio with the
    total pixel count clamped to [min_pixels, max_pixels]."""
    if max(height, width) / min(height, width) > MAX_RATIO:
        raise ValueError(
            f"aspect ratio must be < {MAX_RATIO}, got {height}x{width}")
    h = max(factor, round_by_factor(height, factor))
    w = max(factor, round_by_factor(width, factor))
    if h * w > max_pixels:
        scale = math.sqrt(height * width / max_pixels)
        h = floor_by_factor(height / scale, factor)
        w = floor_by_factor(width / scale, factor)
    elif h * w < min_pixels:
        scale = math.sqrt(min_pixels / (height * width))
        h = ceil_by_factor(height * scale, factor)
        w = ceil_by_factor(width * scale, factor)
    return h, w


def _open_image(src):
    """PIL image from a PIL image, local path, file:// URL, http(s) URL,
    or data:image base64 URI."""
    from PIL import Image
    if isinstance(src, Image.Image):
        return src
    if not isinstance(src, str):
        raise ValueError(f"unsupported image input type {type(src)}")
    if src.startswith("data:image"):
        if "base64," not in src:
            raise ValueError("data:image URI must be base64-encoded")
        payload = src.split("base64,", 1)[1]
        return Image.open(BytesIO(base64.b64decode(payload)))
    if src.startswith("file://"):
        return Image.open(src[len("file://"):])
    if src.startswith(("http://", "https://")):
        import urllib.request
        with urllib.request.urlopen(src) as rsp:  # noqa: S310 (opt-in URL)
            return Image.open(BytesIO(rsp.read()))
    return Image.open(src)


def fetch_image(ele: dict, size_factor: int = IMAGE_FACTOR):
    """Load + smart-resize one image entry of a vision message."""
    src = ele.get("image", ele.get("image_url"))
    img = _open_image(src).convert("RGB")
    if "resized_height" in ele and "resized_width" in ele:
        h, w = smart_resize(ele["resized_height"], ele["resized_width"],
                            factor=size_factor)
    else:
        w0, h0 = img.size
        h, w = smart_resize(h0, w0, factor=size_factor,
                            min_pixels=ele.get("min_pixels", MIN_PIXELS),
                            max_pixels=ele.get("max_pixels", MAX_PIXELS))
    return img.resize((w, h))


def smart_nframes(ele: dict, total_frames: int, video_fps: float) -> int:
    """Frame count to sample from a video: explicit `nframes`, else `fps`
    resampling clamped to [min_frames, max_frames]; always a multiple of
    FRAME_FACTOR (temporal patch size)."""
    if "fps" in ele and "nframes" in ele:
        raise ValueError("give either `fps` or `nframes`, not both")
    if "nframes" in ele:
        nframes = round_by_factor(ele["nframes"], FRAME_FACTOR)
    else:
        fps = ele.get("fps", DEFAULT_FPS)
        lo = ceil_by_factor(ele.get("min_frames", FPS_MIN_FRAMES),
                            FRAME_FACTOR)
        hi = floor_by_factor(
            ele.get("max_frames", min(FPS_MAX_FRAMES, total_frames)),
            FRAME_FACTOR)
        nframes = total_frames / video_fps * fps
        nframes = round_by_factor(min(max(nframes, lo), hi), FRAME_FACTOR)
    if not FRAME_FACTOR <= nframes <= total_frames:
        raise ValueError(
            f"nframes must be in [{FRAME_FACTOR}, {total_frames}], "
            f"got {nframes}")
    return nframes


def fetch_video(ele: dict, image_factor: int = IMAGE_FACTOR):
    """Load one video entry: a path (decoded via torchvision, returns a
    float [T, C, H, W] tensor) or an explicit frame list (PIL images,
    padded to a FRAME_FACTOR multiple by repeating the last frame)."""
    src = ele["video"]
    if isinstance(src, (list, tuple)):
        opts = {k: v for k, v in ele.items() if k not in ("type", "video")}
        frames = [fetch_image({"image": f, **opts}, size_factor=image_factor)
                  for f in src]
        want = ceil_by_factor(len(frames), FRAME_FACTOR)
        frames.extend(frames[-1:] * (want - len(frames)))
        return frames

    import torch
    from torchvision import io as tvio
    from torchvision.transforms import functional as TF
    from torchvision.transforms import InterpolationMode

    path = src[len("file://"):] if src.startswith("file://") else src
    video, _audio, info = tvio.read_video(
        path, start_pts=ele.get("video_start", 0.0),
        end_pts=ele.get("video_end"), pts_unit="sec", output_format="TCHW")
    total, fps = video.shape[0], info["video_fps"]
    nframes = smart_nframes(ele, total_frames=total, video_fps=fps)
    idx = torch.linspace(0, total - 1, nframes).round().long()
    video = video[idx]

    h0, w0 = video.shape[2], video.shape[3]
    max_pixels = ele.get("max_pixels", max(
        min(VIDEO_MAX_PIXELS,
            ele.get("total_pixels", VIDEO_TOTAL_PIXELS) / nframes
            * FRAME_FACTOR),
        int(ele.get("min_pixels", VIDEO_MIN_PIXELS) * 1.05)))
    if "resized_height" in ele and "resized_width" in ele:
        h, w = smart_resize(ele["resized_height"], ele["resized_width"],
                            factor=image_factor)
    else:
        h, w = smart_resize(h0, w0, factor=image_factor,
                            min_pixels=ele.get("min_pixels",
                                               VIDEO_MIN_PIXELS),
                            max_pixels=max_pixels)
    return TF.resize(video, [h, w],
                     interpolation=InterpolationMode.BICUBIC,
                     antialias=True).float()


def extract_vision_info(conversations) -> list[dict]:
    """All image/video content entries across one or many conversations."""
    if conversations and isinstance(conversations[0], dict):
        conversations = [conversations]
    infos = []
    for convo in conversations:
        for msg in convo:
            content = msg.get("content")
            if not isinstance(content, list):
                continue
            for ele in content:
                if ("image" in ele or "image_url" in ele or "video" in ele
                        or ele.get("type") in ("image", "image_url",
                                               "video")):
                    infos.append(ele)
    return infos


def process_vision_info(conversations):
    """(images, videos) model inputs for the HF Qwen-VL processor —
    the entry point QwenPromptExpander.extend_with_img feeds."""
    images, videos = [], []
    for info in extract_vision_info(conversations):
        if "image" in info or "image_url" in info:
            images.append(fetch_image(info))
        elif "video" in info:
            videos.append(fetch_video(info))
        else:
            raise ValueError("vision entry needs image, image_url or video")
    return images or None, videos or None
