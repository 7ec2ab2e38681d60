"""The port's serving layer (``serving/websocket.py``,
``serving/demo_server.py``, ``demo.py``, ``utils/memory.py``) on the CPU,
mirroring tests/test_serving.py where that file needs no reference
checkout: the WebSocket transport (echo, fragmented frames and pings),
``DemoApp`` streaming and refusing a second start while busy, the one-block
lookahead's order, its flush on error, the per-request toggles, the blocks
slider and the progress event.  Across the packages: the JAX and the port
``DemoApp`` driven by one fake pipeline through real sockets give the same
events, counts and JPEG bytes, and the same frame arithmetic; the port's
``build_app`` on ``configs/tiny_test.yaml`` and
``configs/tiny_test_windowed.yaml`` serves as many frames a request as
the app the JAX demo's ``main`` builds.

Every socket read, thread join and server shutdown here has its own
timeout, so a broken server fails its test instead of hanging the run;
servers bind port 0."""
import base64
import contextlib
import json
import os
import socket
import struct
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from self_forcing_tpu_torch import demo as tdemo
from self_forcing_tpu_torch.serving import demo_server as tserver
from self_forcing_tpu_torch.serving.websocket import make_server
from self_forcing_tpu_torch.utils import memory


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module runs: under the suite's six
    workers the default (one a core) oversubscribes the machine, and the
    idle threads' spinning slowed these tests ~20x."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
TIMEOUT = 20.0


# ------------------------------------------------------------- helpers

@contextlib.contextmanager
def serving(server):
    """Serve in a thread; on exit shut down, each step under a timeout."""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        yield server.server_address[1]
    finally:
        stopper = threading.Thread(target=server.shutdown, daemon=True)
        stopper.start()
        stopper.join(TIMEOUT)
        server.server_close()
        t.join(TIMEOUT)
        assert not stopper.is_alive() and not t.is_alive(), \
            "server did not shut down"


def _read_exact(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("server closed the connection")
        buf += chunk
    return buf


def _client_handshake(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    key = base64.b64encode(b"0123456789abcdef").decode()
    s.sendall((f"GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
               f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
               f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += _read_exact(s, 1)
    assert b"101" in resp.split(b"\r\n")[0]
    return s


def _client_send(s, event, data):
    """A masked client text frame, as a browser sends it."""
    payload = json.dumps({"event": event, "data": data}).encode()
    mask = b"\x01\x02\x03\x04"
    n = len(payload)
    if n < 126:
        head = bytes([0x81, 0x80 | n])
    else:
        head = bytes([0x81, 0x80 | 126]) + struct.pack(">H", n)
    masked = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    s.sendall(head + mask + masked)


def _client_recv(s):
    head = _read_exact(s, 2)
    n = head[1] & 0x7F
    if n == 126:
        n = struct.unpack(">H", _read_exact(s, 2))[0]
    elif n == 127:
        n = struct.unpack(">Q", _read_exact(s, 8))[0]
    return json.loads(_read_exact(s, n).decode())


def _until_complete(s, deadline_s=TIMEOUT):
    """Every event up to and including generation_complete."""
    events = []
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        msg = _client_recv(s)
        events.append(msg)
        if msg["event"] == "generation_complete":
            return events
    raise AssertionError(f"no generation_complete: {events}")


def _wait_idle(app):
    deadline = time.time() + TIMEOUT
    while app.busy and time.time() < deadline:
        time.sleep(0.02)
    assert not app.busy


def _echo_handler(conn):
    while True:
        msg = conn.recv_event()
        if msg is None:
            return
        event, data = msg
        conn.send_event("echo_" + event, data)


# ----------------------------------------------------------- websocket

def test_websocket_echo_server():
    def route():
        return 200, "text/plain", b"ok"

    with serving(make_server("127.0.0.1", 0, {"/health": route},
                             _echo_handler)) as port:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/health", timeout=TIMEOUT).read()
        assert body == b"ok"
        s = _client_handshake(port)
        _client_send(s, "ping_me", {"x": 1, "big": "z" * 500})
        msg = _client_recv(s)
        assert msg["event"] == "echo_ping_me"
        assert msg["data"]["x"] == 1
        assert len(msg["data"]["big"]) == 500
        s.close()


def test_websocket_fragmented_and_ping():
    """A text frame with FIN=0 plus a continuation delivers one event; a
    ping between the fragments is answered first."""
    with serving(make_server("127.0.0.1", 0, {}, _echo_handler)) as port:
        s = _client_handshake(port)
        payload = json.dumps({"event": "frag", "data": {"v": 7}}).encode()
        mask = b"\x05\x06\x07\x08"

        def frame(first_byte, chunk):
            masked = bytes(c ^ mask[i % 4] for i, c in enumerate(chunk))
            return bytes([first_byte, 0x80 | len(chunk)]) + mask + masked

        mid = len(payload) // 2
        s.sendall(frame(0x01, payload[:mid]))        # text, FIN=0
        s.sendall(frame(0x89, b"hb"))                # ping, FIN=1
        head = _read_exact(s, 2)
        assert head[0] & 0x0F == 0xA
        assert _read_exact(s, head[1] & 0x7F) == b"hb"
        s.sendall(frame(0x80, payload[mid:]))        # continuation, FIN=1
        msg = _client_recv(s)
        assert msg["event"] == "echo_frag"
        assert msg["data"]["v"] == 7
        s.close()


# ------------------------------------------------------------- DemoApp

def test_demo_app_stream_and_busy():
    """Frames arrive as base64 JPEGs, a second start while busy is
    refused, completion clears busy."""
    started = threading.Event()
    release = threading.Event()

    class FakePipe:
        def stream(self, noise, context, generator=None):
            started.set()
            release.wait(timeout=TIMEOUT)   # hold busy until checked
            for _ in range(2):
                yield torch.zeros(1, 1, 16, 4, 4)

    app = tserver.DemoApp(
        FakePipe(), encode_text_fn=lambda p: torch.zeros(1, 4, 8),
        decode_chunk_fn=lambda blk: torch.zeros(2, 8, 8, 3,
                                                dtype=torch.uint8),
        latent_shape=(1, 2, 16, 4, 4), fps=100.0)
    with serving(make_server("127.0.0.1", 0, {}, app.ws_handler)) as port:
        s = _client_handshake(port)
        _client_send(s, "start_generation", {"prompt": "x", "seed": 0})
        assert started.wait(timeout=TIMEOUT)
        s2 = _client_handshake(port)
        _client_send(s2, "start_generation", {"prompt": "y", "seed": 0})
        msg = _client_recv(s2)
        assert msg["event"] == "error" and msg["data"]["message"] == "busy"
        s2.close()
        release.set()
        events = [m["event"] for m in _until_complete(s)]
        assert "frame_ready" in events and "block_ready" in events
        assert events.count("frame_ready") == 4
        assert events[-1] == "generation_complete"
        _wait_idle(app)
        s.close()


class _FakeConn:
    open = True

    def __init__(self):
        self.events = []

    def send_event(self, event, data):
        self.events.append((event, data))


def test_demo_app_lookahead_overlap():
    """Block N+1's work (generator resume + decode) is queued before block
    N's pixels are fetched; the fetch is the only wait."""
    order = []

    class LazyPixels:
        def __init__(self, i):
            self.i = i

        def __array__(self, dtype=None, copy=None):
            order.append(("fetch", self.i))
            return np.zeros((2, 8, 8, 3), np.uint8)

    class FakePipe:
        def stream(self, noise, context, generator=None):
            for i in range(3):
                order.append(("denoise", i))
                yield i

    def decode(blk):
        order.append(("decode", blk))
        return LazyPixels(blk)

    app = tserver.DemoApp(
        FakePipe(), encode_text_fn=lambda p: torch.zeros(1, 4, 8),
        decode_chunk_fn=decode, latent_shape=(1, 3, 16, 4, 4), fps=100.0)
    conn = _FakeConn()
    app._generate(conn, "prompt", 0)
    fetches = [order.index(("fetch", i)) for i in range(3)]
    assert order.index(("decode", 1)) < fetches[0]
    assert order.index(("denoise", 2)) < fetches[1]
    names = [e for e, _ in conn.events]
    assert names.count("block_ready") == 3
    assert names[-1] == "generation_complete"


def test_demo_app_lookahead_flushes_pending_on_error():
    """A failure while queueing block N+1 still delivers block N before
    the error event."""
    class FakePipe:
        def stream(self, noise, context, generator=None):
            yield 0
            raise RuntimeError("device poof")

    app = tserver.DemoApp(
        FakePipe(), encode_text_fn=lambda p: torch.zeros(1, 4, 8),
        decode_chunk_fn=lambda blk: torch.zeros(2, 8, 8, 3,
                                                dtype=torch.uint8),
        latent_shape=(1, 2, 16, 4, 4), fps=100.0)
    conn = _FakeConn()
    app._generate(conn, "prompt", 0)
    names = [e for e, _ in conn.events]
    assert names.count("block_ready") == 1
    assert names.count("frame_ready") == 2
    assert names.index("block_ready") < names.index("error")
    assert "device poof" in dict(conn.events)["error"]["message"]
    assert not app.busy


def test_demo_app_per_request_toggles():
    """taehv / quantize flipped between generations swap the decoder and
    the parameter tree per request, under both key spellings; the status
    route reports them."""
    used = []

    class FakePipe:
        params = "base"

        def stream(self, noise, context, generator=None):
            used.append(("params", self.params))
            yield torch.zeros(1, 1, 16, 4, 4)

    def decoder(name):
        def decode(blk):
            used.append(("decoder", name))
            return torch.zeros(1, 8, 8, 3, dtype=torch.uint8)
        return decode

    app = tserver.DemoApp(
        FakePipe(), encode_text_fn=lambda p: torch.zeros(1, 4, 8),
        decode_chunk_fn=decoder("wan"), latent_shape=(1, 1, 16, 4, 4),
        fps=100.0, taehv_decoder=(decoder("taehv"), lambda: None),
        quantized_params_fn=lambda: "int8")
    with serving(app.server("127.0.0.1", 0)) as port:
        s = _client_handshake(port)
        for payload in ({}, {"taehv": True, "quantize": True},
                        {"use_taehv": False, "enable_fp8": False}):
            _client_send(s, "start_generation", dict(payload, prompt="p",
                                                     seed=0))
            _until_complete(s)
            _wait_idle(app)
        assert used == [
            ("params", "base"), ("decoder", "wan"),
            ("params", "int8"), ("decoder", "taehv"),
            ("params", "base"), ("decoder", "wan")]
        status = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/api/status", timeout=TIMEOUT).read())
        assert status["taehv_available"] and status["quantize_available"]
        assert status["taehv"] is False and status["quantize"] is False
        assert status["busy"] is False
        assert {"hbm_free_gb", "hbm_in_use_gb"} <= status.keys()
        s.close()


def test_demo_app_failed_toggle_releases_busy():
    """A quantization that raises (out of memory, say) or a malformed seed
    answers an error and leaves the server free for the next request."""
    class FakePipe:
        params = "base"

        def stream(self, noise, context, generator=None):
            yield torch.zeros(1, 1, 16, 4, 4)

    def broken():
        raise RuntimeError("no memory for the quantized tree")

    app = tserver.DemoApp(
        FakePipe(), encode_text_fn=lambda p: torch.zeros(1, 4, 8),
        decode_chunk_fn=lambda blk: torch.zeros(1, 8, 8, 3,
                                                dtype=torch.uint8),
        latent_shape=(1, 1, 16, 4, 4), fps=100.0,
        quantized_params_fn=broken)
    with serving(make_server("127.0.0.1", 0, {}, app.ws_handler)) as port:
        s = _client_handshake(port)
        _client_send(s, "start_generation", {"quantize": True})
        msg = _client_recv(s)
        assert msg["event"] == "error" and "no memory" in \
            msg["data"]["message"]
        assert not app.busy
        _client_send(s, "start_generation", {"seed": "x"})
        msg = _client_recv(s)
        assert msg["event"] == "error" and not app.busy
        _client_send(s, "start_generation", {"quantize": False})
        events = [m["event"] for m in _until_complete(s)]
        assert events.count("frame_ready") == 1
        s.close()


def test_demo_app_blocks_and_progress():
    """start_generation's 'blocks' resizes the noise, and
    generation_started carries the progress denominator; the generation
    thread runs in inference mode (grad mode is thread-local)."""
    seen = []

    class FakePipe:
        class cfg:
            num_frame_per_block = 2
            independent_first_frame = False

        def stream(self, noise, context, generator=None):
            seen.append((tuple(noise.shape), noise.dtype,
                         torch.is_inference_mode_enabled()))
            for _ in range(noise.shape[1] // 2):
                yield torch.zeros(1, 2, 16, 4, 4)

    app = tserver.DemoApp(
        FakePipe(), encode_text_fn=lambda p: torch.zeros(1, 4, 8),
        decode_chunk_fn=lambda blk: torch.zeros(2, 8, 8, 3,
                                                dtype=torch.uint8),
        latent_shape=(1, 6, 16, 4, 4), fps=100.0)
    with serving(make_server("127.0.0.1", 0, {}, app.ws_handler)) as port:
        s = _client_handshake(port)
        _client_send(s, "start_generation",
                     {"prompt": "x", "seed": 0, "blocks": 2})
        events = {}
        for m in _until_complete(s):
            events.setdefault(m["event"], m["data"])
        # blocks 2 x 2 frames a block: 4 latent frames, not the default 6
        assert seen == [((1, 4, 16, 4, 4), torch.bfloat16, True)]
        assert events["generation_started"] == {"latent_frames": 4,
                                                "expected_frames": 13}
        assert events["generation_complete"] == {"frames": 4}
        s.close()


# ---------------------------------------------------- across packages

def _strip_times(msg):
    data = {k: v for k, v in (msg["data"] or {}).items()
            if k not in ("block_s", "elapsed_s")}
    return msg["event"], data


def _run_app(app, requests, timeout=TIMEOUT):
    """Each request through a real socket (``timeout`` s a request and a
    socket read); the events with their timing fields dropped, split into
    the frame events and the others (the sender and generation threads
    interleave them freely)."""
    runs = []
    with serving(make_server("127.0.0.1", 0, {}, app.ws_handler)) as port:
        s = _client_handshake(port)
        s.settimeout(timeout)
        _client_send(s, "set_fps", {"fps": 1000})
        for req in requests:
            _client_send(s, "start_generation", req)
            events = [_strip_times(m) for m in _until_complete(s, timeout)]
            _wait_idle(app)
            runs.append(([e for e in events if e[0] != "frame_ready"],
                         [e for e in events if e[0] == "frame_ready"]))
        s.close()
    return runs


def test_demo_app_matches_jax_app():
    """One fake pipeline (blocks of 2 latent frames) and one seeded
    decoder behind the JAX and the port ``DemoApp``: the same events in
    the same order for each kind, the same frame counts and the same JPEG
    bytes, over a default request, a blocks request and an out-of-range
    one (clamped to the cap)."""
    import jax.numpy as jnp
    from self_forcing_tpu.serving import demo_server as jserver

    frames = np.random.default_rng(0).integers(
        0, 256, (5, 4, 16, 24, 3), np.uint8)

    def make(pkg):
        seen = []

        class FakePipe:
            class cfg:
                num_frame_per_block = 2
                independent_first_frame = False

            def stream(self, noise, context, **kw):
                seen.append(tuple(noise.shape))
                for i in range(noise.shape[1] // 2):
                    yield i

        if pkg == "jax":
            app = jserver.DemoApp(
                FakePipe(), lambda p: jnp.zeros((1, 4, 8)),
                lambda i: jnp.asarray(frames[i]),
                latent_shape=(1, 6, 16, 4, 4), fps=6.0)
        else:
            app = tserver.DemoApp(
                FakePipe(), lambda p: torch.zeros(1, 4, 8),
                lambda i: torch.from_numpy(frames[i]),
                latent_shape=(1, 6, 16, 4, 4), fps=6.0)
        return app, seen

    requests = [{"prompt": "a", "seed": 1}, {"prompt": "b", "seed": 2,
                                              "blocks": 1},
                {"prompt": "c", "seed": 3, "blocks": 99}]
    (japp, jseen), (tapp, tseen) = make("jax"), make("torch")
    jruns, truns = _run_app(japp, requests), _run_app(tapp, requests)
    assert tseen == jseen == [(1, 6, 16, 4, 4), (1, 2, 16, 4, 4),
                              (1, 6, 16, 4, 4)]
    assert truns == jruns
    counts = [len(f) for _, f in truns]
    assert counts == [12, 4, 12]
    assert truns[0][0][-1] == ("generation_complete", {"frames": 12})
    jpg = base64.b64decode(truns[0][1][0][1]["jpeg"])
    assert jpg[:2] == b"\xff\xd8" and jpg == base64.b64decode(
        jruns[0][1][0][1]["jpeg"])


@pytest.mark.parametrize("windowed,iff", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_latent_frames_for_matches_jax(windowed, iff):
    """The blocks slider's clamping (windowed configs up to 40 blocks,
    global ones up to the configured length) and the independent first
    frame, on the same inputs in both packages."""
    from self_forcing_tpu.serving import demo_server as jserver

    class Pipe:
        class cfg:
            num_frame_per_block = 3
            local_attn_size = 12 if windowed else -1
            independent_first_frame = iff

    blocks = (None, 0, 1, 3, 7, 8, 40, 41, "x", "5")
    jax_app, port_app = (
        mod.DemoApp(Pipe(), None, None, latent_shape=(1, 21, 16, 60, 104))
        for mod in (jserver, tserver))
    got = [port_app._latent_frames_for(b) for b in blocks]
    assert got == [jax_app._latent_frames_for(b) for b in blocks]
    cap = 40 if windowed else 7
    assert got[-4] == iff + 3 * cap and got[1] == iff + 3


# ------------------------------------------------------ the demo CLI

def _jax_demo_app(monkeypatch, config):
    """The JAX demo's app, built by its own main (its serve captured)."""
    sys.path.insert(0, REPO)
    try:
        import demo as jdemo
    finally:
        sys.path.remove(REPO)
    from self_forcing_tpu.serving import demo_server as jserver
    apps = []
    monkeypatch.setattr(jserver.DemoApp, "serve",
                        lambda self, host, port: apps.append(self))
    monkeypatch.setattr(sys, "argv", [
        "demo.py", "--config_path", config, "--fps", "1000",
        "--taehv_checkpoint", os.path.join(REPO, "no_such_file.pth")])
    jdemo.main()
    return apps[0]


@pytest.mark.parametrize("config,request_", [
    ("tiny_test.yaml", {"prompt": "a fox", "seed": 3}),
    ("tiny_test_windowed.yaml", {"prompt": "a fox", "seed": 3,
                                 "blocks": 6})])
def test_build_app_serves_tiny_configs(monkeypatch, config, request_):
    """The port's ``build_app`` (from ``parse_args``, as ``main``
    serves) on the CPU: one request through a real socket gives as many
    block and frame events as the JAX demo's app on the same request;
    the windowed config streams past its 4-frame buffer (6 blocks of 1
    frame).  The port also serves a TAEHV + quantized request of the
    same length."""
    args = tdemo.parse_args([
        "--config_path", os.path.join(CONFIGS, config), "--device", "cpu",
        "--fps", "1000", "--taehv_checkpoint",
        os.path.join(REPO, "no_such_file.pth")])
    tapp = tdemo.build_app(args)
    assert tapp.pipeline.device.type == "cpu"
    japp = _jax_demo_app(monkeypatch, os.path.join(CONFIGS, config))
    tquick = dict(request_, taehv=True, quantize=True)
    (tev, tfr), (qev, qfr) = _run_app(tapp, [request_, tquick], 120)
    [(jev, jfr)] = _run_app(japp, [request_], 300)
    assert [e for e, _ in tev] == [e for e, _ in jev] == [e for e, _ in qev]
    assert len(tfr) == len(jfr) == len(qfr) > 0
    assert tev[0] == jev[0]                            # generation_started
    assert tev[-1] == jev[-1] == ("generation_complete",
                                  {"frames": len(jfr)})
    assert tev[0][1]["expected_frames"] == len(tfr)
    windowed = tapp.pipeline.cfg.local_attn_size != -1
    assert windowed == (config == "tiny_test_windowed.yaml")
    if windowed:
        assert tapp.pipeline.compactions > 0
    assert tapp.active_taehv and tapp.active_quantize
    assert tapp.pipeline.cfg.attn_quant == "int8qk"


def test_demo_runs_on_the_card_unless_asked(monkeypatch):
    """Without --device the demo asks for the card and never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        tdemo.build_app(tdemo.parse_args(
            ["--config_path", os.path.join(CONFIGS, "tiny_test.yaml")]))


# -------------------------------------------------------------- memory

def test_hbm_stats_read_the_allocators_live_bytes(monkeypatch):
    """On a card, bytes_in_use is the caching allocator's live tensor
    bytes (the JAX package's meaning), not total - free of the device;
    bytes_limit the card's total, peak_bytes_in_use the allocator's
    peak."""
    gib = 1024 ** 3
    seen = []

    def stat(name, value):
        def fn(device=None):
            seen.append((name, torch.device(device)))
            return value
        return fn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        stat("mem_get_info", (30 * gib, 80 * gib)))
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        stat("memory_allocated", 7 * gib))
    monkeypatch.setattr(torch.cuda, "memory_stats", stat("memory_stats", {
        "allocated_bytes.all.current": 7 * gib,
        "allocated_bytes.all.peak": 12 * gib,
        "reserved_bytes.all.current": 40 * gib}))
    stats = memory.get_hbm_stats()
    assert stats == {"bytes_in_use": 7 * gib, "bytes_limit": 80 * gib,
                     "peak_bytes_in_use": 12 * gib}
    assert {d for _, d in seen} == {torch.device("cuda:0")}
    assert memory.get_free_memory_gb("cuda:1") == 73.0
    assert ("memory_allocated", torch.device("cuda:1")) in seen


def test_memory_helpers_without_a_card(monkeypatch):
    """No CUDA device: zero stats (the JAX package's keys), free memory
    0; the tree helpers move every tensor leaf."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stats = memory.get_hbm_stats()
    assert stats == {"bytes_in_use": 0, "bytes_limit": 0,
                     "peak_bytes_in_use": 0}
    assert memory.get_hbm_stats("cpu") == stats
    assert memory.get_free_memory_gb() == 0.0
    tree = {"a": torch.ones(2), "b": [torch.zeros(1), 3], "c": "x"}
    moved = memory.move_to_device(tree, "cpu")
    assert moved["b"][1] == 3 and moved["c"] == "x"
    assert torch.equal(moved["a"], tree["a"])
    host = memory.offload_to_host(moved)
    assert host["a"].device.type == "cpu" and isinstance(host["b"], list)
