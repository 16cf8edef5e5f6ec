"""The compared numbers of a cell over many seeds, for the program and for
its control, to set the limits of ``correct`` from (``configs/<name>.json``'s
``correct``).

    python3 port_bench/tools/readings.py --workload conv6.offline_b8 \
        --seeds 101 102 103 --seconds 3 [--control N] [--out FILE]

Each seed runs the cell's own traffic for a short window through the timed
path and compares what it produced, as a run does. The program is set up
once for all seeds (the server too, in a served cell); with ``--control N``
the configuration's control (``harness/control.py``) runs in the program's
place as well, on the first N seeds. The benchmark's own runs never run the
control. Prints one JSON line, and writes it to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def offline(cell: dict, seeds, seconds: float, device, frame, control: int) -> dict:
    import torch

    from port_bench.harness import compare
    from port_bench.harness import control as ctl
    from port_bench.harness.frames import recording
    from port_bench.harness.offline import Offline

    config, traffic = cell["config_data"], cell["traffic_data"]
    hw = frame or (config["frame"]["height"], config["frame"]["width"])
    out = {}
    for side, side_seeds in [("program", seeds), ("control", seeds[:control])]:
        rows, off = [], None
        for seed in side_seeds:
            frames = recording(seed, traffic["recording_frames"], hw[0], hw[1],
                               traffic["palette_colours"])
            if off is None or side == "control":
                fn = ctl.enhance(config, device, frames) if side == "control" else None
                off = Offline(config, traffic, device, enhance=fn)
            off.warm(frames)
            rec = off.window(frames, seconds, seed)
            got = compare.readings(config, rec["kept"], frames, device)
            rows.append(dict(seed=seed, frames=rec["frames"], **got))
            print(side, rows[-1], file=sys.stderr, flush=True)
        if not rows:
            continue
        del off
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[side] = rows
    return out


def served(cell: dict, seeds, seconds: float, device, frame, control: int) -> dict:
    from port_bench.harness import compare
    from port_bench.harness import served as sv
    from port_bench.harness.frames import recording

    config, traffic = cell["config_data"], cell["traffic_data"]
    hw = frame or (config["frame"]["height"], config["frame"]["width"])
    per = traffic["frames_per_client"]
    binary = sv.client_binary()
    out = {}
    for side, side_seeds in [("program", seeds), ("control", seeds[:control])]:
        if not side_seeds:
            continue
        rows = []
        server = sv.Server(config, traffic, str(device), hw, control=side == "control")
        try:
            for seed in side_seeds:
                frames = recording(seed, traffic["clients"] * per, hw[0], hw[1],
                                   traffic["palette_colours"])
                phases, due, keep = sv.schedule(traffic, seed, seconds)
                got = sv.run_clients(binary, server, traffic, frames, seconds, phases, keep)
                kept = [(c * per + seq % per, f) for c, seq, ok, f in got["samples"] if ok]
                lat = sv.latencies_ms(got["records"])
                rows.append(dict(seed=seed, frames=int(len(lat)), failed=int(sum(due) - len(lat)),
                                 **compare.readings(config, kept, frames, device)))
                print(side, rows[-1], file=sys.stderr, flush=True)
        finally:
            server.close()
        out[side] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, default=0, metavar="N",
                    help="also run the control on the first N seeds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frame", default=None, metavar="HxW")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from port_bench.harness import manifest

    cell = manifest.cell(manifest.load(), args.workload)
    frame = tuple(int(v) for v in args.frame.split("x")) if args.frame else None
    mode = cell["traffic_data"]["mode"]
    fn = offline if mode == "offline" else served
    got = fn(cell, args.seeds, args.seconds, torch.device(args.device), frame, args.control)
    line = dict(workload=args.workload, seconds=args.seconds, **got)
    for side in ("program", "control"):
        for key in ("worst_mae_levels", "worst_rmse_levels", "worst_abs_levels"):
            if side in got:
                vals = [r[key] for r in got[side]]
                line[f"{side}_{key}"] = [min(vals), max(vals)]
    if args.device != "cpu":
        line["device"] = torch.cuda.get_device_name(0)
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
