"""Dependency-free WebSocket + HTTP server (RFC 6455) of the demo (port of
``self_forcing_tpu/serving/websocket.py``; standard library only).

An ``http.server`` that upgrades ``/ws`` connections and speaks raw
WebSocket frames.  Events keep SocketIO's JSON shape
{"event": name, "data": {...}}, which ``templates/demo.html`` reads.
"""
from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def encode_frame(payload: bytes, opcode: int = 0x1) -> bytes:
    """Server->client frame (unmasked)."""
    header = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header += bytes([n])
    elif n < 65536:
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    return header + payload


def decode_frame(sock: socket.socket):
    """Read one client frame; returns (opcode, payload, fin) or None on
    EOF."""
    head = _read_exact(sock, 2)
    if head is None:
        return None
    b0, b1 = head
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = b1 & 0x80
    n = b1 & 0x7F
    if n == 126:
        ext = _read_exact(sock, 2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = _read_exact(sock, 8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    mask = b""
    if masked:
        mask = _read_exact(sock, 4)
        if mask is None:
            return None
    payload = _read_exact(sock, n) if n else b""
    if payload is None:
        return None
    if masked:
        payload = bytes(c ^ mask[i % 4] for i, c in enumerate(payload))
    return opcode, payload, fin


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class WebSocketConnection:
    """One upgraded connection; thread-safe send."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._lock = threading.Lock()
        self.open = True

    def send_event(self, event: str, data) -> bool:
        payload = json.dumps({"event": event, "data": data}).encode()
        try:
            with self._lock:
                self.sock.sendall(encode_frame(payload))
            return True
        except OSError:
            self.open = False
            return False

    def recv_event(self):
        """Blocks; returns (event, data) or None when closed.

        Handles RFC 6455 fragmentation (FIN=0 data frames + 0x0
        continuations) so proxied/fragmented client events are not
        silently dropped, and treats a send failure on the pong path as a
        normal close (so callers' stop-on-disconnect logic still runs)."""
        frag = b""
        frag_active = False
        while True:
            frame = decode_frame(self.sock)
            if frame is None:
                self.open = False
                return None
            opcode, payload, fin = frame
            if opcode == 0x8:      # close
                self.open = False
                try:
                    with self._lock:
                        self.sock.sendall(encode_frame(b"", 0x8))
                except OSError:
                    pass
                return None
            if opcode == 0x9:      # ping -> pong
                try:
                    with self._lock:
                        self.sock.sendall(encode_frame(payload, 0xA))
                except OSError:
                    self.open = False
                    return None
                continue
            if opcode == 0xA:      # unsolicited pong
                continue
            if opcode in (0x1, 0x2):
                if not fin:
                    frag, frag_active = payload, True
                    continue
                data = payload
            elif opcode == 0x0 and frag_active:  # continuation
                frag += payload
                if not fin:
                    continue
                data, frag, frag_active = frag, b"", False
            else:
                continue
            try:
                msg = json.loads(data.decode())
                return msg.get("event"), msg.get("data")
            except (ValueError, UnicodeDecodeError):
                continue

    def close(self):
        self.open = False
        try:
            self.sock.close()
        except OSError:
            pass


def make_server(host: str, port: int,
                routes: dict[str, Callable],
                ws_handler: Callable[[WebSocketConnection], None],
                ws_path: str = "/ws") -> ThreadingHTTPServer:
    """routes: {path: fn() -> (status, content_type, body_bytes)}."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == ws_path and \
                    "websocket" in self.headers.get("Upgrade", "").lower():
                key = self.headers.get("Sec-WebSocket-Key", "")
                self.send_response(101, "Switching Protocols")
                self.send_header("Upgrade", "websocket")
                self.send_header("Connection", "Upgrade")
                self.send_header("Sec-WebSocket-Accept", _accept_key(key))
                self.end_headers()
                conn = WebSocketConnection(self.connection)
                try:
                    ws_handler(conn)
                finally:
                    conn.close()
                self.close_connection = True
                return
            fn = routes.get(path)
            if fn is None:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            status, ctype, body = fn()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)
