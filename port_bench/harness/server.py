"""The served cell's frame server: the port's ``SidecarServer`` as
``runtime/sidecar.py``'s ``main`` runs it (the enhance of the configuration's
graph, its warm-up frame, bind, serve until a client's shutdown, ``--stats``
at shutdown), plus what the port's ``main`` does not report:

- the device's peak memory, written with ``--summary`` at exit;
- on a ``trace <start_ns> <length_ns>`` line on standard input
  (``time.monotonic_ns()``'s clock), a ``torch.profiler`` slice of that
  window, reduced into the summary at exit.

``--control`` serves the configuration's control in place of the program
(``harness/control.py``). It prints ``READY`` once it listens.

    python3 -m port_bench.harness.server --config conv6 --socket S --depth 0 ...
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def program_enhance(config: dict, device):
    """The program's enhance of the configuration's graph."""
    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import build_enhance_fn

    from .graphs import graph_path

    return build_enhance_fn(config["name"], graph_path(config), device=device)


def _tracer(sl, done: threading.Event, out: dict) -> None:
    """Wait for a ``trace`` line, then profile that window."""
    line = sys.stdin.readline().split()
    if len(line) != 3 or line[0] != "trace":
        done.set()
        return
    start, length = int(line[1]), int(line[2])
    time.sleep(max(start - time.monotonic_ns(), 0) / 1e9)
    sl.start()
    time.sleep(length / 1e9)
    sl.stop()
    out["traced"] = True
    done.set()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--socket", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--depth", type=int, default=0)
    ap.add_argument("--max_clients", type=int, default=4)
    ap.add_argument("--height", type=int, default=576)
    ap.add_argument("--width", type=int, default=752)
    ap.add_argument("--stats", required=True)
    ap.add_argument("--summary", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--trace", action="store_true",
                    help="start the profiler once before listening, for a slice later")
    args = ap.parse_args(argv)

    import torch

    from fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar import SidecarServer

    from . import control, manifest, trace

    config = manifest.config(args.config)
    dev = torch.device(args.device)
    if args.control:
        fn = control.enhance(config, dev, None)
    else:
        fn = program_enhance(config, dev)
    server = SidecarServer(fn, args.socket, height=args.height, width=args.width,
                           depth=args.depth, max_clients=args.max_clients, verbose=0,
                           stats_path=args.stats, device=dev)
    server.warmup()
    server.bind()
    sl = trace.Slice(dev.type == "cuda")
    if args.trace:
        sl.warm()
    done, traced = threading.Event(), {}
    threading.Thread(target=_tracer, args=(sl, done, traced), daemon=True).start()
    print("READY", flush=True)
    server.serve_forever()
    summary = {"memory_peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
               "trace": None}
    if done.wait(timeout=60) and traced:
        summary["trace"] = sl.summary()
    with open(args.summary, "w") as f:
        json.dump(summary, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
