"""The frame server's wire protocol and its Python client, numpy and sockets only.

Split out of :mod:`.sidecar` so that a client process imports no torch (the
package's ``__init__`` imports it lazily): a load generator of many client
threads stays apart from the one process that owns the card. The protocol
is :mod:`.sidecar`'s, byte-identical to the JAX package's.
"""
from __future__ import annotations

import socket
import struct
from typing import Optional

import numpy as np

MAGIC = b"FSE1"
VERSION = 1
HANDSHAKE = struct.Struct("<4sBBHHB5s")
OP_FRAME = 0x01
OP_DRAIN = 0x02
OP_SHUTDOWN = 0x03
RE_FRAME = 0x81
RE_DRAIN_DONE = 0x82


def _recv_exact(conn: socket.socket, n: int) -> Optional[bytearray]:
    """n bytes, or None at EOF; raises socket.timeout past the socket's
    timeout. A bytearray, so that numpy views of it are writable."""
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            return None
        buf.extend(chunk)
    return buf


class SidecarClient:
    """Python client (replay/testing; emulators use runtime/sidecar_client.c).

    Every receive waits at most ``timeout`` seconds (socket.timeout past it).
    """

    def __init__(self, socket_path: str, timeout: float = 60.0):
        self.sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.sock.settimeout(timeout)
        self.sock.connect(socket_path)
        hs = _recv_exact(self.sock, HANDSHAKE.size)
        magic, ver, depth, h, w, ch, _pad = HANDSHAKE.unpack(hs)
        if magic != MAGIC or ver != VERSION or ch != 4:
            raise RuntimeError(f"bad handshake: {magic} v{ver} ch{ch}")
        self.depth, self.h, self.w = depth, h, w
        self.frame_bytes = h * w * 4
        self._pending = 0  # frames in flight in the server's pipeline

    def _read_frame(self) -> np.ndarray:
        tag = _recv_exact(self.sock, 1)
        if tag is None or tag[0] != RE_FRAME:
            raise RuntimeError(f"expected frame response, got {tag}")
        payload = _recv_exact(self.sock, self.frame_bytes)
        if payload is None:
            raise RuntimeError("server closed the connection mid-frame")
        return np.frombuffer(payload, np.uint8).reshape(self.h, self.w, 4)

    def submit(self, frame: np.ndarray) -> Optional[np.ndarray]:
        """Send one frame; returns an enhanced frame (delayed by `depth`
        during pipelined operation, immediate when depth == 0)."""
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.shape != (self.h, self.w, 4):
            raise ValueError(f"frame must be {(self.h, self.w, 4)}, "
                             f"got {frame.shape}")
        self.sock.sendall(bytes([OP_FRAME]) + frame.tobytes())
        self._pending += 1
        if self.depth == 0 or self._pending > self.depth:
            self._pending -= 1
            return self._read_frame()
        return None

    def drain(self) -> list:
        """Flush in-flight frames; returns them as a list.

        Eager (NOT a generator): the OP_DRAIN send and the protocol state
        update must happen even when the caller ignores the frames — a
        lazy version silently dropped in-flight frames for callers that
        did not iterate. Unknown tags and mid-stream EOF raise instead of
        desynchronizing the stream.
        """
        self.sock.sendall(bytes([OP_DRAIN]))
        frames = []
        while True:
            tag = _recv_exact(self.sock, 1)
            if tag is None:
                raise RuntimeError("server closed the connection mid-drain")
            if tag[0] == RE_DRAIN_DONE:
                return frames
            if tag[0] != RE_FRAME:
                raise RuntimeError(f"unexpected drain response tag {tag[0]}")
            payload = _recv_exact(self.sock, self.frame_bytes)
            if payload is None:
                raise RuntimeError("server closed the connection mid-frame")
            self._pending = max(self._pending - 1, 0)
            frames.append(
                np.frombuffer(payload, np.uint8).reshape(self.h, self.w, 4))

    def shutdown_server(self) -> None:
        self.sock.sendall(bytes([OP_SHUTDOWN]))

    def close(self) -> None:
        self.sock.close()
