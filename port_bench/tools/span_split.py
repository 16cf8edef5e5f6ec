"""An offline cell's traced slice, its device idle split among the program's
spans (``harness/spans.py``) and the caller.

    python3 port_bench/tools/span_split.py --workload pix_shuffle.offline_b1 \
        --seed 7 --seconds 20 [--device cpu --frame 48x80] [--out FILE]

Sets the cell up as ``run.py --trace 1`` does, runs one window with its
traced slice, and reduces the slice's raw events twice: with
``harness/trace.py`` (what the result line's device metrics read) and with
``harness/spans.py``. Prints one JSON line: the calls traced, the slice's
busy and window seconds, the spans' table and the caller's idle seconds, the
host ms a frame inside ``fse.upload`` and ``fse.enhance``, the idle shares
inside the program and outside it beside the device's idle share (null on
the CPU, whose trace has no device), and the idle gaps by innermost host
event.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frame", default=None, metavar="HxW")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from port_bench.harness import manifest, spans, trace
    from port_bench.harness.frames import recording
    from port_bench.harness.offline import Offline

    cell = manifest.cell(manifest.load(), args.workload)
    config, traffic = cell["config_data"], cell["traffic_data"]
    if traffic["mode"] != "offline":
        raise SystemExit(f"{args.workload} is not an offline cell")
    dev = torch.device(args.device)
    h, w = (tuple(int(v) for v in args.frame.split("x")) if args.frame
            else (config["frame"]["height"], config["frame"]["width"]))
    frames = recording(args.seed, traffic["recording_frames"], h, w, traffic["palette_colours"])
    off = Offline(config, traffic, dev)
    off.warm(frames)
    off.slice.warm()
    rec = off.window(frames, args.seconds, args.seed, trace=True)
    events = off.slice.prof.profiler.kineto_results.events()
    summary, split = rec["trace"], spans.reduce(events)
    got = spans.readings(summary, split, summary["frames"])
    if dev.type != "cuda":  # no device in the trace: the shares of its idle time mean nothing
        got.update(idle_in_program_pct=None, idle_caller_pct=None, device_idle_pct=None)
    line = dict(workload=args.workload, seed=args.seed, device=(
        torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"),
        frames_per_s=rec["frames"] / rec["window_s"],
        calls_traced=summary["frames"] // traffic["batch"], frames_traced=summary["frames"],
        window_s=summary["window_s"], busy_s=summary["busy_s"], **split, **got,
        idle_gaps=trace.top(summary["idle_by_host"]))
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
