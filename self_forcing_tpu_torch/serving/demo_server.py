"""Streaming demo app (port of ``self_forcing_tpu/serving/demo_server.py``):
block-by-block generation, each frame pushed to the browser as soon as
it is decoded.

- A generation thread runs the pipeline's ``stream`` and decodes each
  block into uint8 frames.
- A sender thread drains a frame queue and pushes ``frame_ready`` events
  with base64 JPEGs at the client's fps.
- WebSocket events ``start_generation`` / ``stop_generation`` /
  ``set_fps``, and ``/api/status`` JSON with the card's memory
  (``utils/memory.py``).

One-block lookahead: block N's pixels reach the host only after block
N+1's refresh and denoise are queued, so the host's JPEG work overlaps the
card's.  ``.cpu()`` of a CUDA tensor would wait for every kernel queued on
the stream, block N+1's included, so each decoded block is instead copied
``non_blocking`` into pinned host memory right after its decode, behind a
CUDA event, and ``flush_pending`` waits on that event alone.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import queue
import threading
import time

import numpy as np
import torch

from self_forcing_tpu_torch.serving.websocket import (WebSocketConnection,
                                                      make_server)
from self_forcing_tpu_torch.utils.memory import get_hbm_stats


def _encode_jpeg(frame_u8: np.ndarray, quality: int = 85) -> bytes:
    import cv2
    ok, buf = cv2.imencode(".jpg", frame_u8[..., ::-1],
                           [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    if not ok:
        raise RuntimeError("JPEG encode failed")
    return buf.tobytes()


class _HostCopy:
    """A decoded block's uint8 frames on their way into pinned host memory:
    the copy is queued behind the decode, and ``numpy`` waits for it
    alone."""

    def __init__(self, px: torch.Tensor):
        self.host = torch.empty(px.shape, dtype=px.dtype, pin_memory=True)
        self.host.copy_(px, non_blocking=True)
        self.ready = torch.cuda.Event()
        self.ready.record()

    def numpy(self) -> np.ndarray:
        self.ready.synchronize()
        return self.host.numpy()


def _start_fetch(px):
    """Start moving a decoded block to the host (CUDA tensors); anything
    else is fetched when the block is flushed."""
    if isinstance(px, torch.Tensor) and px.is_cuda:
        return _HostCopy(px)
    return px


def _fetch(px) -> np.ndarray:
    if isinstance(px, (_HostCopy, torch.Tensor)):
        return px.numpy()
    return np.asarray(px)


class DemoApp:
    """Wires a CausalInferencePipeline and its chunk decoders to the
    WebSocket transport."""

    def __init__(self, pipeline, encode_text_fn, decode_chunk_fn,
                 latent_shape=(1, 21, 16, 60, 104), fps: float = 6.0,
                 reset_decoder_fn=None, taehv_decoder=None,
                 quantized_params_fn=None, default_taehv: bool = False,
                 default_quantize: bool = False):
        """``decode_chunk_fn``: latents [B, nb, C, h, w] -> uint8 frames
        [T, H, W, 3] (a CUDA tensor, a host tensor or an array);
        ``reset_decoder_fn`` clears its temporal caches at the start of
        every generation.  ``taehv_decoder``: an optional (decode_fn,
        reset_fn) pair for the fast-VAE mode; ``quantized_params_fn``:
        a function building the quantized DiT tree at first use.  Both speed modes are
        toggles of each ``start_generation`` payload; the ``default_*``
        flags hold for requests that do not name them."""
        self.pipeline = pipeline
        self.encode_text = encode_text_fn
        self.decode_chunk = decode_chunk_fn
        self.reset_decoder = reset_decoder_fn
        self._decoders = {"wan": (decode_chunk_fn, reset_decoder_fn)}
        if taehv_decoder is not None:
            self._decoders["taehv"] = tuple(taehv_decoder)
        self._quantized_params_fn = quantized_params_fn
        self._base_params = getattr(pipeline, "params", None)
        self._quantized_params = None
        self.default_taehv = bool(default_taehv)
        self.default_quantize = bool(default_quantize)
        self.active_taehv = self.default_taehv and "taehv" in self._decoders
        self.active_quantize = (self.default_quantize
                                and quantized_params_fn is not None)
        self.latent_shape = tuple(latent_shape)
        self.fps = fps
        self.stop_event = threading.Event()
        self.busy = False
        self._busy_lock = threading.Lock()
        self._owner_conn = None  # the connection that started the active run

    def _apply_toggles(self, data: dict):
        """Per-request speed modes: our key names (taehv / quantize) or the
        reference frontend's (use_taehv / enable_fp8).  Runs between
        generations only: the caller holds the busy claim."""
        want_taehv = bool(data.get(
            "taehv", data.get("use_taehv", self.default_taehv)))
        if want_taehv and "taehv" not in self._decoders:
            want_taehv = False  # no checkpoint loaded at server start
        self.decode_chunk, self.reset_decoder = \
            self._decoders["taehv" if want_taehv else "wan"]
        self.active_taehv = want_taehv

        want_quant = bool(data.get(
            "quantize", data.get("enable_fp8", self.default_quantize)))
        if want_quant and self._quantized_params_fn is None \
                and self._quantized_params is None:
            want_quant = False
        if self._base_params is not None:
            if want_quant:
                if self._quantized_params is None:
                    self._quantized_params = self._quantized_params_fn()
                self.pipeline.params = self._quantized_params
            else:
                self.pipeline.params = self._base_params
            # the quantized mode also switches the attention to the card's
            # demo variant (ops/chip.py: int8-QK on the H100)
            cfg = getattr(self.pipeline, "cfg", None)
            if cfg is not None and hasattr(cfg, "attn_quant"):
                from self_forcing_tpu_torch.ops.chip import chip_defaults
                want_aq = (chip_defaults()["demo_attn_quant"]
                           if want_quant else None)
                if cfg.attn_quant != want_aq:
                    self.pipeline.cfg = dataclasses.replace(
                        cfg, attn_quant=want_aq)
        self.active_quantize = want_quant

    # --------------------------------------------------------- generation
    def _latent_frames_for(self, blocks) -> int:
        """Requested video length in latent frames (the UI's blocks
        slider): [1, 40] blocks on a windowed config, at most the
        configured length on a global one (its KV cache grows with the
        video); the block size comes from the pipeline config."""
        cfg = getattr(self.pipeline, "cfg", None)
        nb = int(getattr(cfg, "num_frame_per_block", 3) or 3)
        default_f = self.latent_shape[1]
        if blocks is None:
            return default_f
        windowed = getattr(cfg, "local_attn_size", -1) != -1
        cap = 40 if windowed else max(1, default_f // nb)
        try:
            b = max(1, min(cap, int(blocks)))
        except (TypeError, ValueError):
            return default_f
        if bool(getattr(cfg, "independent_first_frame", False)):
            return 1 + b * nb
        return b * nb

    # grad mode is thread-local: the generation thread sets its own
    @torch.inference_mode()
    def _generate(self, conn: WebSocketConnection, prompt: str, seed: int,
                  latent_frames: int | None = None):
        self.stop_event.clear()
        if self.reset_decoder is not None:
            self.reset_decoder()
        frame_q: queue.Queue = queue.Queue(maxsize=256)

        def sender():
            idx = 0
            while True:
                item = frame_q.get()
                if item is None:
                    break
                t0 = time.time()
                try:
                    jpg = _encode_jpeg(item)
                    conn.send_event("frame_ready", {
                        "frame_id": idx,
                        "jpeg": base64.b64encode(jpg).decode(),
                    })
                except Exception:  # noqa: BLE001 — a bad frame or encoder
                    # must not kill the drain loop (the generation thread
                    # blocks on the bounded queue if nobody drains it)
                    pass
                idx += 1
                # fps is client-controlled; clamped so set_fps 0 cannot
                # divide by zero
                delay = max(0.0, 1.0 / max(self.fps, 0.1)
                            - (time.time() - t0))
                if delay:
                    time.sleep(delay)
            conn.send_event("generation_complete", {"frames": idx})

        def put_frame(f) -> bool:
            """Bounded put that gives up on stop / disconnect instead of
            blocking forever if the sender died or the client stalled."""
            while not self.stop_event.is_set():
                try:
                    frame_q.put(f, timeout=1.0)
                    return True
                except queue.Full:
                    if not sender_t.is_alive() or not conn.open:
                        return False
            return False

        sender_t = threading.Thread(target=sender, daemon=True)
        sender_t.start()
        t_start = time.time()
        n_blocks = 0
        # block N's pixels, fetched after block N+1's work is queued
        pending = None
        t_block = [time.time()]

        def flush_pending():
            nonlocal pending, n_blocks
            if pending is None:
                return
            frames, pending = _fetch(pending), None
            n_blocks += 1
            now = time.time()
            conn.send_event("block_ready", {
                "block": n_blocks,
                "block_s": round(now - t_block[0], 3),
                "elapsed_s": round(now - t_start, 3)})
            t_block[0] = now
            for f in frames:
                if not put_frame(f):
                    break

        try:
            dev = torch.device(getattr(self.pipeline, "device", "cpu"))
            dtype = getattr(self.pipeline, "dtype", torch.bfloat16)
            context = self.encode_text([prompt])
            if isinstance(context, torch.Tensor):
                context = context.to(dev, dtype)
            g = torch.Generator(device=dev).manual_seed(seed)
            shape = list(self.latent_shape)
            if latent_frames is not None:
                shape[1] = latent_frames
            noise = torch.randn(shape, generator=g, device=dev).to(dtype)
            # progress denominator for the client's progress bar: latent
            # F -> pixel frames under the 4x temporal expansion
            conn.send_event("generation_started", {
                "latent_frames": shape[1],
                "expected_frames": (shape[1] - 1) * 4 + 1,
            })
            t_start = time.time()
            t_block[0] = t_start
            gen = self.pipeline.stream(noise, context, generator=g)
            while not self.stop_event.is_set():
                blk = next(gen, None)
                px = _start_fetch(self.decode_chunk(blk)) \
                    if blk is not None else None
                flush_pending()
                pending = px
                if blk is None:
                    break
        except Exception as e:  # noqa: BLE001 — reported to the client
            # deliver the already-decoded held block before reporting: a
            # failure while queueing block N+1 must not eat block N
            try:
                flush_pending()
            except Exception:  # noqa: BLE001 — the flush itself may fail
                pass           # on a poisoned device; the error wins then
            conn.send_event("error", {"message": str(e)})
        finally:
            try:
                frame_q.put(None, timeout=1.0)
            except queue.Full:
                pass  # sender dead; nothing to signal
            sender_t.join(timeout=30)
            self.busy = False

    # --------------------------------------------------------- transport
    def ws_handler(self, conn: WebSocketConnection):
        while True:
            msg = conn.recv_event()
            if msg is None:
                # stop on disconnect only if this connection owns the
                # active generation: another client dropping (one just
                # refused with 'busy') must not end the run
                if self._owner_conn is conn:
                    self.stop_event.set()
                return
            event, data = msg
            data = data or {}
            if event == "start_generation":
                # claimed here, in the handler thread under the lock: a
                # double click must not start two generations
                with self._busy_lock:
                    if self.busy:
                        claimed = False
                    else:
                        self.busy = True
                        claimed = True
                if not claimed:
                    conn.send_event("error", {"message": "busy"})
                    continue
                self._owner_conn = conn
                try:
                    self._apply_toggles(data)
                    args = (conn, data.get("prompt", ""),
                            int(data.get("seed", 0)),
                            self._latent_frames_for(data.get("blocks")))
                except Exception as e:  # noqa: BLE001 — reported; a
                    # failed toggle (a quantization out of memory) or a
                    # malformed seed must not leave the server busy
                    self.busy = False
                    conn.send_event("error", {"message": str(e)})
                    continue
                threading.Thread(target=self._generate, args=args,
                                 daemon=True).start()
            elif event == "stop_generation":
                self.stop_event.set()
                conn.send_event("generation_stopped", {})
            elif event == "set_fps":
                try:
                    self.fps = max(0.1, float(data.get("fps", self.fps)))
                except (TypeError, ValueError):
                    pass

    def status(self):
        hbm = get_hbm_stats()
        body = json.dumps({
            "busy": self.busy,
            "fps": self.fps,
            "taehv": self.active_taehv,
            "quantize": self.active_quantize,
            "taehv_available": "taehv" in self._decoders,
            "quantize_available": (self._quantized_params_fn is not None
                                   or self._quantized_params is not None),
            "hbm_free_gb": round(
                (hbm["bytes_limit"] - hbm["bytes_in_use"]) / 1024 ** 3, 2),
            "hbm_in_use_gb": round(hbm["bytes_in_use"] / 1024 ** 3, 2),
        }).encode()
        return 200, "application/json", body

    def index(self):
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "templates", "demo.html")
        with open(path, "rb") as f:
            return 200, "text/html", f.read()

    def server(self, host: str = "0.0.0.0", port: int = 5001):
        """The HTTP + WebSocket server of this app, not yet serving (port 0
        binds a free port: ``server.server_address``)."""
        return make_server(host, port,
                           routes={"/": self.index,
                                   "/api/status": self.status},
                           ws_handler=self.ws_handler)

    def serve(self, host: str = "0.0.0.0", port: int = 5001):
        server = self.server(host, port)
        print(f"demo server on http://{host}:{port}", flush=True)
        server.serve_forever()
