"""The served load: emulator clients at a fixed rate, in an open schedule,
against the port's frame server run as a child process.

Set-up builds the C load generator (``served_client.c``, with ``cc -O2``)
into ``build/port_bench/`` of the checkout, once a source, starts the server
(``server.py``: the port's ``SidecarServer``, its warm-up frame, then it
listens on a unix socket under ``TMPDIR``), makes every client's recording
from the seed and hands it to the generator on its standard input. Each
client then sends a few warm-up frames in a closed loop; set-up ends when
the schedule starts.

The window holds every frame due in the ``--seconds`` after that: client
``c``'s frame ``seq`` is due at ``T0 + phase[c] + seq / rate``. A frame's
latency runs from its due time to the moment its enhanced frame is fully
received, so a stall counts against every frame queued behind it. A frame
whose reply does not come within ``reply_wait_s`` has failed. The
percentiles are taken over all frames of all clients.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from . import compare
from .frames import recording, rng
from .manifest import ROOT
from .offline import print_setup

CLIENT_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "served_client.c")
BUILD_DIR = os.path.join(ROOT, "build", "port_bench")
READY_TIMEOUT_S = 600


def client_binary() -> str:
    """The load generator, built once a source into a fixed directory."""
    with open(CLIENT_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"served_client_{digest}")
    if not os.path.exists(path):
        cc = shutil.which("cc") or shutil.which("gcc")
        if cc is None:
            raise RuntimeError("no C compiler (cc) to build the served cell's load generator")
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        subprocess.run([cc, "-O2", "-pthread", "-o", tmp, CLIENT_SRC], check=True)
        os.replace(tmp, path)
    return path


def socket_path() -> str:
    """A short unix socket path under ``TMPDIR`` (a socket path has at most
    107 bytes), or in the checkout's build directory where that is too long."""
    name = f"pb{os.getpid()}.sock"
    path = os.path.join(tempfile.gettempdir(), name)
    if len(path.encode()) > 100:
        os.makedirs(BUILD_DIR, exist_ok=True)
        path = os.path.relpath(os.path.join(BUILD_DIR, name))
    return path


def server_command() -> list:
    return [sys.executable, "-m", "port_bench.harness.server"]


class Server:
    """The frame server child, from start to its stats at shutdown."""

    def __init__(self, config: dict, traffic: dict, device: str, frame_hw, control: bool = False,
                 trace: bool = False):
        self.dir = tempfile.mkdtemp(prefix="port_bench_")
        self.socket = socket_path()
        self.stats = os.path.join(self.dir, "stats.json")
        self.summary = os.path.join(self.dir, "summary.json")
        cmd = server_command() + [
            "--config", config["name"], "--socket", self.socket, "--device", device,
            "--depth", str(traffic["depth"]), "--max_clients", str(traffic["max_clients"]),
            "--height", str(frame_hw[0]), "--width", str(frame_hw[1]),
            "--stats", self.stats, "--summary", self.summary]
        cmd += (["--control"] if control else []) + (["--trace"] if trace else [])
        self.log = open(os.path.join(self.dir, "server.log"), "w+")
        self.proc = subprocess.Popen(cmd, cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                     stderr=self.log, text=True)
        ready = threading.Event()
        threading.Thread(target=self._wait_ready, args=(ready,), daemon=True).start()
        if not ready.wait(READY_TIMEOUT_S) or self.proc.poll() is not None:
            self.close()
            raise RuntimeError(f"the frame server did not start:\n{self.tail()}")

    def _wait_ready(self, ready: threading.Event) -> None:
        for line in self.proc.stdout:
            if line.strip() == "READY":
                ready.set()
        ready.set()

    def tail(self) -> str:
        self.log.flush()
        self.log.seek(0)
        return self.log.read()[-4000:]

    def trace(self, start_ns: int, length_ns: int) -> None:
        self.proc.stdin.write(f"trace {start_ns} {length_ns}\n")
        self.proc.stdin.flush()

    def close(self) -> dict:
        """Shut the server down (a client's 0x03), wait for it, and return its
        ``--stats`` and summary."""
        import socket

        if self.proc.poll() is None:
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(30)
                    s.connect(self.socket)
                    s.recv(16)
                    s.sendall(b"\x03")
            except OSError:
                pass
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        out = {}
        for key, path in (("server_stats", self.stats), ("summary", self.summary)):
            if os.path.exists(path):
                with open(path) as f:
                    out[key] = json.load(f)
        self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        return out


def schedule(traffic: dict, seed: int, seconds: float):
    """Each client's phase (the traffic's set of phases, in an order drawn
    from the seed), the frames each has due in the window, and the replies
    kept for the comparison, ``[(client, seq)]``, drawn from the seed."""
    r = rng(seed, 2)
    clients = traffic["clients"]
    period = 1e9 / traffic["rate_hz"]
    phases = [int(p * 1e6) for p in r.permutation(traffic["phases_ms"])[:clients]]
    window = int(seconds * 1e9)
    due = [max(0, -(-(window - p) // int(period))) for p in phases]
    keep = []
    for c, n in enumerate(due):
        for seq in sorted(r.choice(n, min(n, traffic["check_frames_per_client"]), replace=False)):
            keep.append((c, int(seq)))
    return phases, due, keep


def run_clients(binary: str, server: Server, traffic: dict, frames: np.ndarray, seconds: float,
                phases, keep, trace_window=None) -> dict:
    """One window of the load generator against ``server``."""
    clients, per = traffic["clients"], traffic["frames_per_client"]
    fbytes = frames[0].nbytes
    words = [f"clients {clients} frames {per} bytes {fbytes}",
             f"period_ns {int(1e9 / traffic['rate_hz'])} window_ns {int(seconds * 1e9)}",
             f"warmup {traffic['warmup_frames']} timeout_s {int(traffic['reply_wait_s'])}",
             f"samples {len(keep)}"] + [str(p) for p in phases] + [f"{c} {s}" for c, s in keep]
    head = " ".join(words) + "\n"
    proc = subprocess.Popen([binary, server.socket], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    writer = threading.Thread(target=_feed, args=(proc, head.encode(), frames), daemon=True)
    writer.start()
    first = proc.stdout.readline().split()
    if len(first) != 2 or first[0] != b"T0":
        proc.kill()
        writer.join()
        proc.stdin = None
        err = proc.communicate()[1].decode(errors="replace")
        raise RuntimeError(f"the load generator did not start its schedule: {err}\n{server.tail()}")
    t0 = int(first[1])
    if trace_window is not None:
        at, length = trace_window
        server.trace(t0 + int(at * 1e9), int(length * 1e9))
    writer.join()
    proc.stdin = None  # the feeder closed it
    rest, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"the load generator failed ({proc.returncode}): {err.decode()}")
    return dict(t0_ns=t0, **_parse(rest, fbytes, frames.shape[1:]))


def _feed(proc, head: bytes, frames: np.ndarray) -> None:
    try:
        proc.stdin.write(head)
        proc.stdin.write(memoryview(np.ascontiguousarray(frames)).cast("B"))
        proc.stdin.close()
    except BrokenPipeError:
        pass


def _parse(data: bytes, fbytes: int, shape) -> dict:
    lines_end = data.index(b"\n")
    _done, n_rec, n_samples = data[:lines_end].split()
    pos = lines_end + 1
    records = []
    for _ in range(int(n_rec)):
        end = data.index(b"\n", pos)
        records.append([int(v) for v in data[pos:end].split()])
        pos = end + 1
    samples = []
    for _ in range(int(n_samples)):
        end = data.index(b"\n", pos)
        _tag, c, seq, ok = data[pos:end].split()
        pos = end + 1
        frame = np.frombuffer(data[pos:pos + fbytes], np.uint8).reshape(shape)
        pos += fbytes
        samples.append((int(c), int(seq), int(ok), frame))
    rec = np.array(records, np.int64).reshape(-1, 6)
    return dict(records=rec, samples=samples)


def latencies_ms(rec: np.ndarray) -> np.ndarray:
    """Due time to reply received, of every frame that was answered."""
    ok = rec[:, 5] == 1
    return (rec[ok, 4] - rec[ok, 2]) / 1e6


def run(cell: dict, args, start: float) -> dict:
    import torch

    config, traffic = cell["config_data"], cell["traffic_data"]
    dev = torch.device(args.device)
    hw = args.frame or (config["frame"]["height"], config["frame"]["width"])
    clients, per = traffic["clients"], traffic["frames_per_client"]
    frames = recording(args.seed, clients * per, hw[0], hw[1], traffic["palette_colours"])
    phases, due, keep = schedule(traffic, args.seed, args.seconds)
    marks = [("start", start), ("torch and frames", time.monotonic())]
    binary = client_binary()
    marks.append(("load generator", time.monotonic()))
    server = Server(config, traffic, args.device, hw, trace=bool(args.trace))
    marks.append(("server ready", time.monotonic()))
    trace_window = None
    if args.trace:
        at = traffic["trace_at"] * args.seconds
        trace_window = (at, min(traffic["trace_seconds"], 0.5 * args.seconds))
    try:
        got = run_clients(binary, server, traffic, frames, args.seconds, phases, keep,
                          trace_window)
    finally:
        child = server.close()
    marks.append(("clients' warm-up", got["t0_ns"] / 1e9))
    print_setup(marks)
    rec = got["records"]
    lat = latencies_ms(rec)
    attempted = int(sum(due))
    failed = attempted - int(len(lat))
    kept = [(c * per + seq % per, frame) for c, seq, ok, frame in got["samples"] if ok]
    summary = child.get("summary", {})
    readings = compare.readings(config, kept, frames, dev)
    checks = compare.checks(config, readings, len(keep))
    stats = child.get("server_stats") or {}
    if dev.type == "cuda":
        checks.update(compare.launch_check(config, stats.get("k1_launches", 0),
                                           stats.get("frames", 0)))
    e2e = {"setup_s": got["t0_ns"] / 1e9 - start}
    if len(lat):
        e2e.update(frame_p50_ms=float(np.percentile(lat, 50)),
                   frame_p95_ms=float(np.percentile(lat, 95)))
    if len(rec):
        late = float(np.max((rec[:, 3] - rec[:, 2]) / 1e6))
        print(f"the load generator sent its frames at most {late:.3f} ms after they were due",
              file=sys.stderr)
    trace = summary.get("trace")
    return dict(e2e=e2e, ctx={"trace": trace, "server_stats": stats},
                checks=checks, attempted=attempted, failed=failed,
                memory_peak_bytes=summary.get("memory_peak_bytes", 0))
