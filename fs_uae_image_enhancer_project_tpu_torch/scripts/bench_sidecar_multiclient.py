"""Multi-client serving benchmark: N concurrent clients on one frame server.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.bench_sidecar_multiclient \\
        [--clients 1 2 4] [--depths 0 2] [--seconds 20] [--height 576 --width 752] \\
        [--out FILE] [--device cpu]

Port of the repo's ``scripts/bench_sidecar_multiclient.py``. Each point
(a depth and a number of clients N) has its own server child, the port's
``runtime/sidecar.py`` with ``--max_clients`` N and ``--stats``, so that the
server's per-frame latency (enqueue to enhanced bytes in host memory,
excluding the socket) is that point's own. All the points' servers start
together and wait; the points are then measured one after another, each
server shut down after its point, which writes its stats. N client threads
each pump the same four seeded frames for ``--seconds`` of wall clock; the
report gives per-client and aggregate fps beside the server's p50/p90/p99
and the server's launches of the fused-stack kernel (K1; one a frame on a
card, with one more for the server's warm-up frame).

At depth 2 one Python client paces the server (each frame waits for the
client's second next frame); more clients show where the server itself
stands.

This process is the client side: it imports no torch (the client is
``runtime.client``, numpy and sockets), so the server child is the one
process on the card. Each client keeps its first answer to each of the four
frames; their digests (sha256) must agree across every client and point.
The report goes to ``--out`` when given and is printed as the last line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from ..runtime.client import SidecarClient
from ..utils.subproc import wait_for_line
from .common import REPO

H, W = 576, 752
N_FRAMES = 4


def client_frames(h: int = H, w: int = W) -> list:
    """The four seeded RGBA frames every client sends, in turn."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (h, w, 4), np.uint8) for _ in range(N_FRAMES)]


def start_server(sock: str, depth: int, max_clients: int, stats: str, device: str,
                 h: int = H, w: int = W) -> subprocess.Popen:
    """A server child on ``sock``; returns once it printed its ready line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar",
           "--socket", sock, "--depth", str(depth), "--max_clients", str(max_clients),
           "--stats", stats, "--device", device, "--height", str(h), "--width", str(w),
           "--quiet"]
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_ready(proc: subprocess.Popen, timeout: float = 600.0) -> None:
    ok, lines = wait_for_line(proc, "SIDECAR_READY", timeout=timeout)
    if not ok:
        proc.kill()
        proc.wait(timeout=30)
        raise RuntimeError("server never ready:\n" + "".join(lines))


def drive_client(sock: str, seconds: float, frames: list, result: dict) -> None:
    try:
        _drive_client(sock, seconds, frames, result)
    except Exception as e:  # recorded, not lost in the thread
        result["error"] = f"{type(e).__name__}: {e}"
        print(f"client failed: {result['error']}", flush=True)


def _drive_client(sock: str, seconds: float, frames: list, result: dict) -> None:
    first = {}  # the first answer to each frame; the k-th answer is frame k's
    answered = 0

    def take(out):
        nonlocal answered
        first.setdefault(answered % len(frames), out)
        answered += 1

    c = SidecarClient(sock)
    try:
        # warm-up: fill the pipeline and take the first answers
        for i in range(c.depth + 1):
            out = c.submit(frames[i % len(frames)])
            if out is not None:
                take(out)
        for out in c.drain():
            take(out)
        sent = c.depth + 1
        got = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            out = c.submit(frames[sent % len(frames)])
            sent += 1
            if out is not None:
                take(out)
                got += 1
        for out in c.drain():
            take(out)
            got += 1
        dt = time.perf_counter() - t0
    finally:
        c.close()
    result.update(fps=got / dt, frames=got, seconds=dt, answered=answered, sent=sent,
                  digests={str(k): hashlib.sha256(v.tobytes()).hexdigest()
                           for k, v in sorted(first.items())})


def measure(sock: str, n_clients: int, seconds: float, frames: list) -> dict:
    results = [dict() for _ in range(n_clients)]
    threads = [threading.Thread(target=drive_client, args=(sock, seconds, frames, results[i]))
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=seconds + 300)
    wall = time.perf_counter() - t0
    ok = [r for r in results if "frames" in r]
    total = sum(r["frames"] for r in ok)
    return {
        "clients": n_clients,
        "clients_failed": n_clients - len(ok),
        "errors": [r["error"] for r in results if "error" in r],
        "per_client_fps": [r["fps"] for r in ok],
        "aggregate_fps": total / wall,
        "total_frames": total,
        "answered_equals_sent": all(r["answered"] == r["sent"] for r in ok),
        "wall_s": wall,
        "digests": [r["digests"] for r in ok],
    }


def shutdown(sock: str, proc: subprocess.Popen) -> int:
    try:
        c = SidecarClient(sock, timeout=30.0)
        c.shutdown_server()
        c.close()
    except OSError:
        proc.kill()
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait(timeout=60)


def run(clients=(1, 2, 4), depths=(0, 2), seconds: float = 20.0, device: str = "cuda",
        h: int = H, w: int = W) -> dict:
    from ..utils.platform import wait_for_bench_lock

    wait_for_bench_lock()
    frames = client_frames(h, w)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        points = [(d, n) for d in depths for n in clients]
        servers = {}
        try:
            for d, n in points:  # all start together; each waits for its point
                sock = os.path.join(tmp, f"d{d}c{n}.sock")
                stats = os.path.join(tmp, f"d{d}c{n}.json")
                servers[d, n] = (sock, stats, start_server(sock, d, n, stats, device, h, w))
            t0 = time.perf_counter()
            for d, n in points:
                wait_ready(servers[d, n][2])
            ready_s = time.perf_counter() - t0
            for d, n in points:
                sock, stats, proc = servers.pop((d, n))
                row = measure(sock, n, seconds, frames)
                row["depth"] = d
                row["server_rc"] = shutdown(sock, proc)
                with open(stats) as f:
                    st = json.load(f)
                row["server_stats"] = {k: st[k] for k in (
                    "frames", "p50_ms", "p90_ms", "p99_ms", "min_ms", "max_ms", "mean_ms",
                    "k1_launches")}
                rows.append(row)
                print(f"depth={d} clients={n}: aggregate {row['aggregate_fps']:.1f} fps, "
                      f"per-client {[round(x, 1) for x in row['per_client_fps']]}, server "
                      f"p50 {st['p50_ms']} ms p99 {st['p99_ms']} ms", flush=True)
        finally:
            for sock, _stats, proc in servers.values():
                proc.kill()
                proc.wait(timeout=60)
    answers = {}
    for row in rows:
        for dig in row["digests"]:
            for k, v in dig.items():
                answers.setdefault(k, set()).add(v)
    report = {
        "harness": "fs_uae_image_enhancer_project_tpu_torch.scripts.bench_sidecar_multiclient",
        "date": time.strftime("%Y-%m-%d"),
        "device": device,
        "geometry": [h, w],
        "seconds_per_point": seconds,
        "servers_ready_s": ready_s,
        "answers_agree": all(len(v) == 1 for v in answers.values())
        and len(answers) == N_FRAMES,
        "answer_digests": {k: sorted(v)[0] for k, v in sorted(answers.items())},
        "rows": [{k: v for k, v in r.items() if k != "digests"} for r in rows],
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="N concurrent clients on one frame server")
    ap.add_argument("--clients", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--depths", type=int, nargs="+", default=[0, 2])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="the servers' device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = run(args.clients, args.depths, args.seconds, args.device, args.height, args.width)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report), flush=True)
    return 0 if report["answers_agree"] and not any(r["clients_failed"] for r in report["rows"]) \
        else 1


if __name__ == "__main__":
    sys.exit(main())
