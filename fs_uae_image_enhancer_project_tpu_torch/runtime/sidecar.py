"""Emulator-facing enhance sidecar: a resident unix-socket frame server.

Port of ``fs_uae_image_enhancer_project_tpu/runtime/sidecar.py``. One
resident process owns the enhance function (on a card, the fused-stack CUDA
kernel) and serves raw frames over a unix domain socket; the emulator links
only the small C client ``runtime/sidecar_client.c``.

Wire protocol v1, byte-identical to the JAX package's (fixed-geometry raw
frames; all integers little-endian):

    server -> client on connect (16-byte handshake):
        magic   4s  b"FSE1"
        version u8  1
        depth   u8  pipeline depth D (0 = synchronous request/response)
        height  u16
        width   u16
        chans   u8  always 4 (RGBA chunky)
        pad     5s

    client -> server, repeated:
        0x01 + H*W*4 raw bytes   submit one frame
        0x02                     drain: flush all in-flight frames
        0x03                     shutdown the server process

    server -> client:
        0x81 + H*W*4 raw bytes   one enhanced frame
        0x82                     drain complete

The protocol's constants and the Python client live in :mod:`.client`,
which imports no torch; they are re-exported here.

Pipelining: with depth D > 0 the server answers the i-th submitted frame with
enhanced frame i-D (export/streaming.py's FrameStream, on CUDA streams with
pinned host buffers). D = 0 answers every submit at once.

Each client gets its own session thread and pipeline; all sessions share the
one enhance function. An OP_SHUTDOWN from any client stops the server.

Nothing here blocks without a bound: the accept loop polls, every session
socket has a timeout (``client_timeout``; an idle client past it is dropped),
the client's socket has one, and thread joins are bounded.
"""
from __future__ import annotations

import os
import socket
import sys
import threading
import time
from collections import deque
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..export.streaming import FrameStream
from .client import (  # noqa: F401  (the protocol, re-exported)
    HANDSHAKE, MAGIC, OP_DRAIN, OP_FRAME, OP_SHUTDOWN, RE_DRAIN_DONE, RE_FRAME, VERSION,
    SidecarClient, _recv_exact)


class SidecarServer:
    """Owns the enhance fn and serves frames until shutdown."""

    def __init__(
        self,
        enhance_fn: Callable,
        socket_path: str,
        *,
        height: int = 576,
        width: int = 752,
        depth: int = 2,
        max_clients: int = 4,
        verbose: int = 1,
        stats_path: Optional[str] = None,
        device=None,
        client_timeout: float = 600.0,
    ):
        if not 0 <= depth <= 255:
            # handshake encodes depth as one byte; validating here fails
            # fast instead of struct.error at client connect (after minutes
            # of warmup compile, killing the session thread uncleanly)
            raise ValueError("depth must be in [0, 255]")
        if not (1 <= height <= 65535 and 1 <= width <= 65535):
            raise ValueError("height/width must fit the u16 handshake fields")
        if max_clients < 1:
            raise ValueError("max_clients must be >= 1")
        self.fn = enhance_fn
        self.device = resolve_device(device)
        self.client_timeout = client_timeout
        self.socket_path = socket_path
        self.h, self.w = height, width
        self.depth = depth
        self.max_clients = max_clients
        self.frame_bytes = height * width * 4
        self.verbose = verbose
        self._sock: Optional[socket.socket] = None
        self._shutdown = threading.Event()
        self._conns_lock = threading.Lock()
        self._conns: set = set()
        # Server-side per-frame latency (enqueue -> enhanced bytes ready,
        # EXCLUDING socket RTT): the number a local deployment actually gets.
        self.stats_path = stats_path
        self._lat_lock = threading.Lock()
        # Bounded accounting: a 60 fps emulator session is ~5.2M frames/day,
        # so an unbounded per-frame float list is a slow leak. Percentiles
        # come from a recent-window deque; lifetime totals and the artifact
        # histogram accumulate online in O(1) memory.
        self._lat_window: "deque[float]" = deque(maxlen=self.LAT_WINDOW)
        self._lat_count = 0
        self._lat_sum = 0.0
        self._lat_min = float("inf")
        self._lat_max = 0.0
        self._hist_edges = [0.5 * (2 ** (i / 2)) for i in range(24)]
        self._hist_counts = [0] * (len(self._hist_edges) + 1)

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[sidecar] {msg}", flush=True)

    def warmup(self) -> None:
        """Build (the kernels) and first-execution cost up front, not on frame 1.

        Also validates the enhance fn's output contract here — a fn that
        returns the wrong shape/dtype would otherwise sendall() a payload
        whose length differs from the advertised frame_bytes, silently
        desynchronizing every client's fixed-size reads."""
        frame = np.zeros((1, self.h, self.w, 4), np.uint8)
        out = self.fn(torch.from_numpy(frame)).cpu().numpy()
        if out.shape != (1, self.h, self.w, 4) or out.dtype != np.uint8:
            raise ValueError(
                f"enhance_fn must map (1,{self.h},{self.w},4) uint8 -> same; "
                f"got {out.shape} {out.dtype} — serving it would break the "
                "wire protocol's fixed frame size"
            )
        self._log("warmup complete (kernels built and executed)")

    def bind(self) -> None:
        if os.path.exists(self.socket_path):
            # Only steal the path from a DEAD server: connecting to a live
            # unix socket succeeds, to a stale one fails (ECONNREFUSED).
            # Unconditional unlink would orphan a running server (it keeps
            # serving an unreachable socket) and, worse, its exit cleanup
            # would then delete OUR healthy socket.
            probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                probe.settimeout(1.0)
                probe.connect(self.socket_path)
                probe.close()
                raise RuntimeError(
                    f"another sidecar is already serving {self.socket_path}; "
                    "use a different --socket or shut the other one down"
                )
            except (ConnectionRefusedError, socket.timeout, FileNotFoundError):
                probe.close()
                os.unlink(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(self.max_clients)
        # remember which inode we own so exit cleanup never unlinks a
        # NEWER socket another process bound at the same path
        st = os.stat(self.socket_path)
        self._sock_id = (st.st_dev, st.st_ino)
        self._log(f"listening on {self.socket_path} "
                  f"({self.w}x{self.h}, depth {self.depth}, "
                  f"max_clients {self.max_clients})")

    def serve_forever(self) -> None:
        """Accept loop; returns after an OP_SHUTDOWN from any client.

        Each client runs in its own session thread with its own pipeline;
        the enhance fn is shared, so concurrent emulator instances
        time-slice the one card. A
        per-server semaphore caps concurrent sessions at ``max_clients``
        (excess connections queue in the listen backlog).
        """
        if self._sock is None:
            self.bind()
        self._shutdown.clear()
        # A blocked accept() is NOT woken by close() from another thread, so
        # the accept loop polls with a short timeout and re-checks the
        # shutdown flag (same for the session-slot wait).
        self._sock.settimeout(0.2)
        slots = threading.Semaphore(self.max_clients)
        threads = []
        try:
            while not self._shutdown.is_set():
                if not slots.acquire(timeout=0.2):
                    continue
                if self._shutdown.is_set():
                    break
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    slots.release()
                    continue
                except OSError:
                    break  # listening socket closed by a shutdown request
                conn.settimeout(self.client_timeout)
                with self._conns_lock:
                    self._conns.add(conn)
                if self._shutdown.is_set():
                    # closes the race with _request_shutdown: it sets the
                    # flag BEFORE broadcasting SHUT_RDWR over _conns, so a
                    # conn added after that broadcast sees the flag here
                    with self._conns_lock:
                        self._conns.discard(conn)
                    conn.close()
                    slots.release()
                    break

                def session(conn=conn):
                    try:
                        if not self._serve_client(conn):
                            self._request_shutdown()
                    except (ConnectionError, BrokenPipeError, OSError) as e:
                        self._log(f"client error: {e}")
                    finally:
                        with self._conns_lock:
                            self._conns.discard(conn)
                        conn.close()
                        slots.release()

                t = threading.Thread(target=session, daemon=True)
                t.start()
                # keep only live sessions (a long-lived server accepts many
                # reconnects; finished threads must not accumulate)
                threads = [x for x in threads if x.is_alive()]
                threads.append(t)
        finally:
            self._request_shutdown()
            for t in threads:
                t.join(timeout=10)
            self._write_stats()
            self._sock = None
            try:
                st = os.stat(self.socket_path)
                if (st.st_dev, st.st_ino) == getattr(self, "_sock_id", None):
                    os.unlink(self.socket_path)  # still ours — clean up
            except OSError:
                pass

    def _request_shutdown(self) -> None:
        """Stop accepting and unblock every live session's recv."""
        if self._shutdown.is_set():
            return
        self._shutdown.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        with self._conns_lock:
            for c in list(self._conns):
                try:
                    c.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    def _serve_client(self, conn: socket.socket) -> bool:
        """One client session; False means shutdown was requested."""
        conn.sendall(HANDSHAKE.pack(
            MAGIC, VERSION, self.depth, self.h, self.w, 4, b"\0" * 5
        ))
        self._log("client connected")
        stream = FrameStream(self.fn, depth=max(self.depth, 1),
                             device=self.device, frame_shape=(self.h, self.w, 4))
        n_in = n_out = 0
        # FIFO of enqueue timestamps: FrameStream returns outputs in submit
        # order, so the output surfacing now belongs to the OLDEST pending
        # frame. Latency = enqueue -> enhanced bytes in host memory; the
        # socket sendall that follows is deliberately outside the window.
        pending_t0: "deque[float]" = deque()
        lat_ms: list = []

        def answer(out) -> None:
            nonlocal n_out
            if pending_t0:
                lat_ms.append((time.perf_counter() - pending_t0.popleft()) * 1e3)
            conn.sendall(bytes([RE_FRAME]) + out.tobytes())
            n_out += 1
            # a session may last hours: fold its latencies into the
            # server's record every LAT_FLUSH frames, so latency_stats()
            # sees them while the client is connected
            if len(lat_ms) >= self.LAT_FLUSH:
                self._record_latencies(lat_ms)
                lat_ms.clear()

        try:
            while True:
                op = _recv_exact(conn, 1)
                if op is None:
                    break
                if op[0] == OP_FRAME:
                    payload = _recv_exact(conn, self.frame_bytes)
                    if payload is None:
                        break
                    frame = np.frombuffer(payload, np.uint8).reshape(
                        1, self.h, self.w, 4
                    )
                    n_in += 1
                    pending_t0.append(time.perf_counter())
                    if self.depth == 0:
                        answer(self.fn(torch.from_numpy(frame)).cpu().numpy())
                    else:
                        out = stream.submit(frame)
                        if out is not None:
                            answer(out)
                elif op[0] == OP_DRAIN:
                    for out in stream.drain():
                        answer(out)
                    conn.sendall(bytes([RE_DRAIN_DONE]))
                elif op[0] == OP_SHUTDOWN:
                    self._log(f"shutdown requested ({n_in} in / {n_out} out)")
                    return False
                else:
                    self._log(f"bad opcode 0x{op[0]:02x}; closing client")
                    break
        finally:
            # also when the session ends in a socket error or the idle
            # timeout: the frames it served are counted
            self._record_latencies(lat_ms)
        self._log(f"client disconnected ({n_in} in / {n_out} out)")
        return True

    # recent-window size for percentile estimation (~18 min at 60 fps;
    # ~0.5 MB of floats, the memory ceiling regardless of uptime)
    LAT_WINDOW = 65536
    # frames a session serves between folds of its latencies into the
    # record (~17 s at 60 fps)
    LAT_FLUSH = 1024

    def _record_latencies(self, lat_ms: list) -> None:
        if not lat_ms:
            return
        edges = self._hist_edges
        with self._lat_lock:
            self._lat_window.extend(lat_ms)
            self._lat_count += len(lat_ms)
            self._lat_sum += sum(lat_ms)
            self._lat_min = min(self._lat_min, min(lat_ms))
            self._lat_max = max(self._lat_max, max(lat_ms))
            for v in lat_ms:  # 0.5ms..~1.4s log2 buckets, online
                self._hist_counts[
                    next((i for i, e in enumerate(edges) if v < e),
                         len(edges))
                ] += 1

    def latency_stats(self) -> Optional[dict]:
        """Summary of server-side per-frame latency so far: lifetime
        count/mean/min/max plus percentiles over the last LAT_WINDOW
        frames (bounded memory for long-lived servers)."""
        with self._lat_lock:
            lats = sorted(self._lat_window)
            count, total = self._lat_count, self._lat_sum
            lo, hi = self._lat_min, self._lat_max
        if not lats:
            return None

        def pct(p):
            return round(lats[min(int(p / 100 * len(lats)), len(lats) - 1)], 3)

        return {
            "frames": count,
            "percentile_window_frames": len(lats),
            "depth": self.depth,
            "p50_ms": pct(50), "p90_ms": pct(90), "p99_ms": pct(99),
            "min_ms": round(lo, 3), "max_ms": round(hi, 3),
            "mean_ms": round(total / count, 3),
            "definition": ("server-side enqueue->enhanced-bytes-in-host-"
                           "memory per frame, EXCLUDING socket RTT; "
                           "pipelined depths include queueing behind "
                           "in-flight frames; percentiles cover the most "
                           "recent window, count/mean/min/max the lifetime"),
        }

    def _write_stats(self) -> None:
        if not self.stats_path:
            return
        stats = self.latency_stats()
        if stats is None:
            return
        import json

        # committed artifacts carry a histogram, not a raw dump (bounded
        # size); the counts accumulate online in _record_latencies
        with self._lat_lock:
            counts = list(self._hist_counts)
        stats["histogram"] = {
            "edges_ms": [round(e, 3) for e in self._hist_edges],
            "counts": counts,
        }
        # the fused-stack kernel's launches in this process, warm-up
        # included: a load generator in another process reads them here
        from ..ops.cuda import fused_stack as fs

        stats["k1_launches"] = fs.fused_stack.launches
        with open(self.stats_path, "w") as f:
            json.dump(stats, f, indent=1)
        self._log(f"wrote latency stats to {self.stats_path}")


def build_enhance_fn(model: str = "pix_shuffle", weights: Optional[str] = None,
                     device=None):
    """Resolve the enhance fn: the repo's trained ONNX graph for the family
    (``artifacts/model_<model>/<model>.onnx``) unless ``weights`` names one.

    A server silently serving random weights is worse than one that refuses
    to start, so unresolvable models/weights raise instead of falling back;
    ``weights='fresh'`` opts into the fresh-init pix_shuffle explicitly
    (CI/smoke use).
    """
    from ..export.enhance import default_enhance_fn, enhance_from_onnx

    if weights == "fresh":
        fn, _ = default_enhance_fn(device=device)
        return fn
    if weights is None:
        weights = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "artifacts", f"model_{model}", f"{model}.onnx",
        )
        if not os.path.exists(weights):
            raise FileNotFoundError(
                f"no trained ONNX graph found for model {model!r} "
                f"(looked at {weights}); pass --weights <graph.onnx>, "
                "or --weights fresh for an untrained smoke server"
            )
    if not (weights.endswith(".onnx") and os.path.exists(weights)):
        raise ValueError(
            f"--weights must be an existing .onnx graph or 'fresh', "
            f"got {weights!r}"
        )
    return enhance_from_onnx(weights, device=device)


def build_parser():
    """The server's command line."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Resident CUDA enhance sidecar for emulator integration."
    )
    ap.add_argument("--socket", default="/tmp/fsuae_enhance.sock")
    ap.add_argument("--model", default="pix_shuffle")
    ap.add_argument("--weights", default=None,
                    help="ONNX graph to serve (default: the repo's artifact)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu for the plain PyTorch path")
    ap.add_argument("--depth", type=int, default=2,
                    help="pipeline depth; 0 = synchronous")
    ap.add_argument("--max_clients", type=int, default=4,
                    help="concurrent emulator instances served "
                         "(sessions share the one enhance fn)")
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--client_timeout", type=float, default=600.0,
                    help="seconds a client may stay silent before it is dropped")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--stats", default=None, metavar="PATH",
                    help="write a server-side per-frame latency summary + "
                         "histogram JSON here on exit (latency excludes "
                         "socket RTT)")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    fn = build_enhance_fn(args.model, args.weights, device=args.device)
    server = SidecarServer(
        fn, args.socket, height=args.height, width=args.width,
        depth=args.depth, max_clients=args.max_clients,
        verbose=0 if args.quiet else 1, stats_path=args.stats,
        device=args.device, client_timeout=args.client_timeout,
    )
    server.warmup()
    server.bind()
    print(f"SIDECAR_READY {args.socket}", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
