"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration, traffic mix and per-layer metrics are files
of this folder, found by name. With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a profiled slice of the window. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit); the last lines of standard error are the
same checks.

The run needs as many CUDA cards as the cell asks for, and exits 2 without
them. ``--device cpu`` (with ``--frame HxW`` for a small frame) rehearses a
run on the CPU through the program's plain paths: its line names the CPU and
carries no device metric.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fs_uae_image_enhancer_project_tpu")


def _frame(text: str):
    h, w = text.lower().split("x")
    return int(h), int(w)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda", help="cuda, or cpu to rehearse")
    ap.add_argument("--frame", type=_frame, default=None, metavar="HxW",
                    help="a smaller frame than the configuration's, to rehearse")
    return ap


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, compared
    by whole top-level names."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Every build and kernel cache of the program in fixed directories of
    the checkout: the port's own kernels build under ``build/torch_kernels``."""
    base = os.path.join(ROOT, "build", "port_bench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def device_info(args, chips: int, peak: int, ctx: dict) -> dict:
    import torch

    if args.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": peak}
    trace = ctx.get("trace")
    if args.trace and trace is not None:
        info.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    return info


def main(argv=None) -> int:
    from port_bench.harness import clock

    start = clock.process_start()
    args = build_parser().parse_args(argv)
    from port_bench.harness import compare, manifest, trace

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cache_dirs()
    import torch

    if args.device != "cpu":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has {have}",
                  file=sys.stderr)
            return 2
    mode = cell["traffic_data"]["mode"]
    if mode == "offline":
        from port_bench.harness.offline import run
    elif mode == "served":
        from port_bench.harness.served import run
    else:
        raise ValueError(f"unknown traffic mode {mode!r}")
    out = run(cell, args, start)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    ctx = dict(out["ctx"], config=cell["config_data"], traffic=cell["traffic_data"],
               cuda=args.device != "cpu")
    if args.trace:
        metrics = manifest.read_all(manifest.per_layer(bench, args.workload), ctx)
    else:
        units = {m["name"]: m["unit"] for m in manifest.end_to_end(bench, args.workload)}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in out["e2e"].items() if k in units}
    result = {"correct": out["failed"] == 0 and all(c["ok"] for c in out["checks"].values()),
              "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
              "device": device_info(args, cell["chips"], out["memory_peak_bytes"], ctx)}
    if args.trace and ctx.get("trace") is not None and args.device != "cpu":
        result["breakdown"] = trace.breakdown(ctx["trace"])
    result["checks"] = out["checks"]
    compare.print_checks(out["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
