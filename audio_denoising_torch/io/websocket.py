"""Minimal RFC 6455 WebSocket server-side protocol (stdlib only).

The reference's browser-mic entry point rides streamlit-webrtc/aiortc
(app2.py:479-492); neither exists here, and the capability it provides —
push mic chunks from a browser, get denoised chunks back — needs only a
WebSocket. This module implements the server side of the protocol
(HTTP upgrade handshake, frame encode/decode with client masking, ping/
pong/close) so the serving daemon has zero dependencies.
"""

import base64
import hashlib
import socket
import struct
from typing import Optional, Tuple

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = \
    0x0, 0x1, 0x2, 0x8, 0x9, 0xA

# Frames larger than this are rejected: audio chunks are tens of KB, and a
# client-declared 64-bit length would otherwise let one connection OOM the
# daemon (the handshake header has the same 64 KiB cap).
MAX_FRAME_BYTES = 1 << 20


class Buffered:
    """Socket wrapper that (a) drains pre-read bytes (e.g. a first frame
    the client pipelined behind the upgrade request) before hitting the
    socket and (b) serializes writes — frame sends may come from several
    threads (audio sender, stats replies, pong answers) and an interleaved
    frame corrupts the stream. Satisfies the .recv/.sendall/.settimeout/
    .close surface the frame codec uses."""

    def __init__(self, sock: socket.socket, initial: bytes = b""):
        import threading
        self._sock = sock
        self._buf = bytearray(initial)
        self._wlock = threading.Lock()

    def recv(self, n: int) -> bytes:
        if self._buf:
            out = bytes(self._buf[:n])
            del self._buf[:len(out)]
            return out
        return self._sock.recv(n)

    def sendall(self, data: bytes) -> None:
        with self._wlock:
            self._sock.sendall(data)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        self._sock.close()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise ConnectionError("socket closed")
        buf += part
    return buf


def handshake(sock: socket.socket,
              timeout: Optional[float] = 10.0,
              http_handler=None) -> Optional[Tuple[str, bytes]]:
    """Perform the server side of the HTTP->WS upgrade. Returns
    ``(request_path, leftover_bytes)`` — leftover is anything the client
    pipelined behind the upgrade request (wrap the socket in ``Buffered``
    with it) — or None if the request is not a websocket upgrade.

    ``timeout`` bounds the handshake phase only (cleared on success): a
    client that connects and sends nothing — or dribbles bytes — would
    otherwise pin a daemon thread forever (slowloris).

    ``http_handler(method, path, headers, sock)``: optional hook for plain
    HTTP requests (no upgrade headers) — lets the daemon serve its browser
    client page on the same port. The hook writes the full HTTP response
    itself; handshake then returns None (connection is done)."""
    if timeout is not None:
        sock.settimeout(timeout)
    data = b""
    try:
        while b"\r\n\r\n" not in data:
            part = sock.recv(4096)
            if not part:
                return None
            data += part
            if len(data) > 65536:
                return None
    except socket.timeout:
        return None
    finally:
        if timeout is not None:
            sock.settimeout(None)
    head, leftover = data.split(b"\r\n\r\n", 1)
    head = head.decode("latin-1")
    lines = head.split("\r\n")
    path = lines[0].split(" ")[1] if len(lines[0].split(" ")) > 1 else "/"
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    key = headers.get("sec-websocket-key")
    if key is None or "upgrade" not in headers.get("connection", "").lower():
        if http_handler is not None:
            method = lines[0].split(" ")[0] if lines[0] else ""
            http_handler(method, path, headers, sock)
        else:
            sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
        return None
    if headers.get("sec-websocket-version", "13") != "13":
        # RFC 6455 §4.2.2: unsupported version -> 426 with the versions
        # the server speaks
        sock.sendall(b"HTTP/1.1 426 Upgrade Required\r\n"
                     b"Sec-WebSocket-Version: 13\r\n\r\n")
        return None
    accept = base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()).decode()
    sock.sendall((
        "HTTP/1.1 101 Switching Protocols\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
    return path, leftover


def send_frame(sock: socket.socket, payload: bytes,
               opcode: int = OP_BINARY) -> None:
    """Server frames are unmasked (RFC 6455 §5.1)."""
    n = len(payload)
    header = bytes([0x80 | opcode])
    if n < 126:
        header += bytes([n])
    elif n < (1 << 16):
        header += bytes([126]) + struct.pack(">H", n)
    else:
        header += bytes([127]) + struct.pack(">Q", n)
    sock.sendall(header + payload)


def recv_frame(sock: socket.socket) -> Tuple[bool, int, bytes]:
    """-> (fin, opcode, payload); handles masking and 16/64-bit lengths."""
    b0, b1 = _recv_exact(sock, 2)
    fin = bool(b0 & 0x80)
    opcode = b0 & 0x0F
    masked = b1 & 0x80
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack(">H", _recv_exact(sock, 2))[0]
    elif n == 127:
        n = struct.unpack(">Q", _recv_exact(sock, 8))[0]
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"frame of {n} bytes exceeds cap")
    mask = _recv_exact(sock, 4) if masked else None
    payload = _recv_exact(sock, n) if n else b""
    if mask:
        # vectorized unmask (a per-byte Python loop on the ingest hot
        # path costs ~1e6 interpreted ops/s at serving rates)
        import numpy as _np
        data = _np.frombuffer(payload, _np.uint8)
        m = _np.frombuffer((mask * (len(data) // 4 + 1))[:len(data)],
                           _np.uint8)
        payload = (data ^ m).tobytes()
    return fin, opcode, payload


def recv_message(sock: socket.socket) -> Tuple[int, bytes]:
    """Reassemble fragments; answers pings transparently. Returns
    (OP_TEXT|OP_BINARY|OP_CLOSE, payload)."""
    opcode = None
    buf = b""
    while True:
        fin, op, payload = recv_frame(sock)
        if op == OP_PING:
            send_frame(sock, payload, OP_PONG)
            continue
        if op == OP_PONG:
            continue
        if op == OP_CLOSE:
            return OP_CLOSE, payload
        if op in (OP_TEXT, OP_BINARY):
            opcode = op
            buf = payload
        elif op == OP_CONT:
            buf += payload
        else:
            raise ConnectionError(f"unexpected opcode {op}")
        if fin:
            return opcode, buf
