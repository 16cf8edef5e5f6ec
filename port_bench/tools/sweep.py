"""Served latency against the number of 50 Hz clients, to find the rate the
frame server sustains (its knee) against a served cell's fixed load.

    python3 port_bench/tools/sweep.py --workload conv6.served_1x50 \
        --clients 1 2 4 [--rates 30 50] --seconds 10 [--out FILE]

The workload may be a cell that ``BENCHMARK.json`` does not list, such as
``pix_shuffle.served_1x50``. One server child serves every point
(``max_clients`` the largest count);
each point is one window of the cell's traffic with that many clients at
that rate, their phases spread evenly over the period and each its own
recording. Prints one
JSON line: for each point the frames due, failed, p50 and p95 ms, the
latest send behind its due time and the rate completed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--clients", type=int, nargs="+", required=True)
    ap.add_argument("--rates", type=float, nargs="+", default=None,
                    help="frames a second each client sends (default: the cell's)")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frame", default=None, metavar="HxW")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from port_bench.harness import manifest
    from port_bench.harness import served as sv
    from port_bench.harness.frames import recording

    cell = manifest.cell(manifest.load(), args.workload)
    config = cell["config_data"]
    base = dict(cell["traffic_data"], max_clients=max(args.clients))
    hw = (tuple(int(v) for v in args.frame.split("x")) if args.frame
          else (config["frame"]["height"], config["frame"]["width"]))
    binary = sv.client_binary()
    server = sv.Server(config, base, args.device, hw)
    points = []
    try:
        for n, rate in [(n, r) for n in args.clients for r in (args.rates or [base["rate_hz"]])]:
            traffic = dict(base, clients=n, rate_hz=rate, check_frames_per_client=0,
                           phases_ms=[k * 1e3 / rate / n for k in range(n)])
            frames = recording(args.seed + n, n * traffic["frames_per_client"], hw[0], hw[1],
                               traffic["palette_colours"])
            phases, due, keep = sv.schedule(traffic, args.seed, args.seconds)
            got = sv.run_clients(binary, server, traffic, frames, args.seconds, phases, keep)
            rec = got["records"]
            lat = sv.latencies_ms(rec)
            span = (rec[:, 4].max() - got["t0_ns"]) / 1e9 if len(rec) else 0.0
            points.append(dict(
                clients=n, rate_hz=rate, due=int(sum(due)), failed=int(sum(due) - len(lat)),
                p50_ms=float(np.percentile(lat, 50)) if len(lat) else None,
                p95_ms=float(np.percentile(lat, 95)) if len(lat) else None,
                max_late_ms=float(((rec[:, 3] - rec[:, 2]) / 1e6).max()) if len(rec) else None,
                completed_per_s=len(lat) / span if span > 0 else None))
            print(points[-1], file=sys.stderr, flush=True)
    finally:
        child = server.close()
    line = dict(workload=args.workload, config=config["name"], seconds=args.seconds, points=points,
                server_stats={k: v for k, v in (child.get("server_stats") or {}).items()
                              if k.endswith("_ms") or k == "frames"})
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
