"""Inverse search: the channel count of each kernel size at equal latency.

Port of the root ``benchmark_tools/benchmark_search_channels.py`` (the
reference's ``benchmark_search_channels.py``): for each kernel size, bisect
for the channel count whose conv time matches a reference conv's, then
scale the counts to a total channel budget (the design tool for
equal-latency multi-kernel paths). Times come from
``benchmark_kernel_sizes.time_conv``.

    python -m fs_uae_image_enhancer_project_tpu_torch.benchmark_tools.\\
        benchmark_search_channels [--reference_kernel 3] \\
        [--reference_channels 36] [--kernels 1 3 5 7] [--budget 72] \\
        [--shape 288 376] [--dtype bfloat16] [--duration 0.5] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .benchmark_kernel_sizes import time_conv


def find_equal_latency_channels(target_ms: float, kernel: int, h: int, w: int, dtype,
                                lo: int = 4, hi: int = 512, duration: float = 0.5,
                                device=None) -> int:
    """Bisect for the channel count (a multiple of 4) whose latency best
    matches ``target_ms``."""
    best_c, best_err = lo, float("inf")
    while lo <= hi:
        mid = (lo + hi) // 2
        mid4 = max(4, (mid // 4) * 4)
        ms = time_conv(mid4, mid4, kernel, h, w, dtype, duration, device=device)
        err = abs(ms - target_ms)
        if err < best_err:
            best_err, best_c = err, mid4
        if ms < target_ms:
            lo = mid + 4
        else:
            hi = mid - 4
    return best_c


def search(reference_kernel: int = 3, reference_channels: int = 36, kernels=(1, 3, 5, 7),
           budget: int = 72, h: int = 288, w: int = 376, dtype=torch.bfloat16,
           duration: float = 0.5, device=None, hi: int = 512) -> dict:
    """The reference conv's ms, each kernel's equal-latency channels, and
    those scaled to ``budget``."""
    target = time_conv(reference_channels, reference_channels, reference_kernel, h, w, dtype,
                       duration, device=device)
    print(f"reference: k={reference_kernel} c={reference_channels} -> {target:.4f} ms",
          flush=True)
    equal = {}
    for k in kernels:
        equal[k] = find_equal_latency_channels(target, k, h, w, dtype, hi=hi, duration=duration,
                                               device=device)
        print(f"k={k}: ~{equal[k]} channels at iso-latency", flush=True)
    total = sum(equal.values())
    scaled = {k: max(4, round(c * budget / total)) for k, c in equal.items()}
    return {"reference_ms": round(target, 4), "iso_latency_channels": equal,
            "scaled_to_budget": scaled, "budget": budget}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reference_kernel", type=int, default=3)
    ap.add_argument("--reference_channels", type=int, default=36)
    ap.add_argument("--kernels", type=int, nargs="*", default=[1, 3, 5, 7])
    ap.add_argument("--budget", type=int, default=72, help="total channel budget to distribute")
    ap.add_argument("--shape", type=int, nargs=2, default=[288, 376])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--duration", type=float, default=0.5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    h, w = args.shape
    out = search(args.reference_kernel, args.reference_channels, args.kernels, args.budget,
                 h, w, getattr(torch, args.dtype), args.duration, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
