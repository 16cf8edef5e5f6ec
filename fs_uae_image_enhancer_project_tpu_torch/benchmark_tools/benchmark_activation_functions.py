"""Forward and forward+backward time of every activation in the registry.

Port of the root ``benchmark_tools/benchmark_activation_functions.py`` (the
reference's fwd+bwd over shapes x dtypes): it tells the NAS activation
search what each activation costs. Each activation is timed chained (its
output feeds its next call) with ``utils.profiler.measure_chained``, on CUDA
events on a card.

    python -m fs_uae_image_enhancer_project_tpu_torch.benchmark_tools.\\
        benchmark_activation_functions [--dtype bfloat16] [--duration 1.0] \\
        [--chunk 500] [--names relu mish ...] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..ops.activations import ACTIVATION_NAMES, apply_activation, init_activation

SHAPES = [(1, 576, 752, 3), (1, 288, 376, 36), (1, 288, 376, 72)]
PER_CHANNEL = ("prelu", "biased_relu", "biased_prelu")


def default_names() -> list:
    return [n for n in ACTIVATION_NAMES if n not in ("softmax", "log_softmax")]


def time_fn(fn, x, duration_s: float = 1.0, chunk: int = 500) -> float:
    """µs a call of ``fn`` chained on ``x``."""
    from ..utils.profiler import measure_chained

    return measure_chained(fn, x, warmup=3, duration_s=duration_s, chunk=chunk).ms_per_call * 1e3


def activation_fns(name: str, channels: int, device):
    """(forward, the gradient of the output's fp32 mean with respect to the
    input) of one activation, each mapping a tensor to one of its shape."""
    params = init_activation(name, {"num_parameters": channels} if name in PER_CHANNEL else None,
                             generator=torch.Generator().manual_seed(0), device=device)

    def fwd(t):
        return apply_activation(name, params, t)

    def bwd(t):
        with torch.enable_grad():
            t = t.detach().requires_grad_(True)
            return torch.autograd.grad(apply_activation(name, params, t).float().mean(), t)[0]

    return fwd, bwd


@torch.no_grad()
def activation_table(shapes=SHAPES, names=None, dtype=torch.bfloat16, device=None,
                     duration_s: float = 1.0, chunk: int = 500) -> dict:
    """{"HxWx..": {name: {"fwd_us", "fwd_bwd_us"}}} over ``shapes``."""
    from .. import resolve_device

    dev = resolve_device(device)
    results = {}
    for shape in shapes:
        key = "x".join(map(str, shape))
        results[key] = {}
        x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, shape).astype(np.float32))
        x = x.to(dev, dtype)
        for name in names or default_names():
            fwd, bwd = activation_fns(name, shape[-1], dev)
            results[key][name] = {"fwd_us": round(time_fn(fwd, x, duration_s, chunk), 2),
                                  "fwd_bwd_us": round(time_fn(bwd, x, duration_s, chunk), 2)}
            print(f"{key} {name}: {results[key][name]}", flush=True)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--chunk", type=int, default=500, help="chained calls a timed chunk")
    ap.add_argument("--names", nargs="*", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = activation_table(names=args.names, dtype=getattr(torch, args.dtype),
                               device=args.device, duration_s=args.duration, chunk=args.chunk)
    print(json.dumps({"dtype": args.dtype, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
