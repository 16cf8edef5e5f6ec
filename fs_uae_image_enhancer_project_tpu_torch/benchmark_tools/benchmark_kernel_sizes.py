"""Conv latency and analytic GFLOP over kernel sizes and channels.

Port of the root ``benchmark_tools/benchmark_kernel_sizes.py`` (the
reference's kernel {1,2,3,4,5,7} x channel grid at the deployment shape):
which kernel and channel pairs the card runs at equal cost. NHWC convs,
``SAME`` padding with XLA's split for even kernels (the lower side takes the
smaller half, through an explicit pad), chained with
``utils.profiler.measure_chained`` on CUDA events on a card.

    python -m fs_uae_image_enhancer_project_tpu_torch.benchmark_tools.\\
        benchmark_kernel_sizes [--shape 288 376] [--dtype bfloat16] \\
        [--duration 1.0] [--chunk 200] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from ..ops.conv import conv2d, init_conv, no_tf32

KERNELS = [1, 2, 3, 4, 5, 7]
CHANNELS = [12, 24, 36, 48, 72, 96, 144]


def analytic_gflops(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k / 1e9


def same_pad(k: int):
    """XLA's ``SAME`` split of a kernel's k - 1 padding: (lower, upper)."""
    return (k - 1) // 2, (k - 1) - (k - 1) // 2


def conv_same(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Stride-1 NHWC ``SAME`` conv for any kernel size."""
    k = params["w"].shape[0]
    if k % 2:
        return conv2d(params, x)
    lo, hi = same_pad(k)
    return conv2d(params, F.pad(x, (0, 0, lo, hi, lo, hi)), padding="VALID")


def time_conv(cin, cout, k, h, w, dtype, duration_s=1.0, chunk=200, device=None) -> float:
    """ms a conv, chained (cin == cout) or ping-ponged with a cout -> cin
    conv and halved."""
    from .. import resolve_device
    from ..utils.profiler import measure_chained

    dev = resolve_device(device)
    params = init_conv(cin, cout, k, generator=torch.Generator().manual_seed(0), device=dev)
    params = {n: t.to(dtype) for n, t in params.items()}
    x = torch.zeros((1, h, w, cin), dtype=dtype, device=dev)
    if cin == cout:
        chain = lambda t: conv_same(params, t)  # noqa: E731
    else:
        back = init_conv(cout, cin, k, generator=torch.Generator().manual_seed(1), device=dev)
        back = {n: t.to(dtype) for n, t in back.items()}
        chain = lambda t: conv_same(back, conv_same(params, t))  # noqa: E731
    with torch.no_grad(), no_tf32():
        res = measure_chained(chain, x, warmup=3, duration_s=duration_s, chunk=chunk)
    return res.ms_per_call / (1.0 if cin == cout else 2.0)


def kernel_table(h: int = 288, w: int = 376, dtype=torch.bfloat16, duration_s: float = 1.0,
                 chunk: int = 200, device=None, kernels=KERNELS, channels=CHANNELS) -> list:
    """One row a (kernel, channels): ms, analytic GFLOP, achieved TFLOP/s."""
    rows = []
    for k in kernels:
        for c in channels:
            ms = time_conv(c, c, k, h, w, dtype, duration_s, chunk, device)
            gf = analytic_gflops(h, w, c, c, k)
            rows.append({"kernel": k, "channels": c, "ms": round(ms, 4), "gflops": round(gf, 3),
                         "achieved_tflops": round(gf / ms, 2)})
            print(rows[-1], flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=2, default=[288, 376], metavar=("H", "W"))
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--duration", type=float, default=1.0)
    ap.add_argument("--chunk", type=int, default=200, help="chained calls a timed chunk")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    h, w = args.shape
    rows = kernel_table(h, w, getattr(torch, args.dtype), args.duration, args.chunk, args.device)
    print(json.dumps({"shape": [h, w], "dtype": args.dtype, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
