"""Answer the lane-packing question on the card with a direct measurement.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.bench_lane_packing

Counterpart of the repo's ``scripts/bench_lane_packing.py``. The fused stack's
convs are GEMMs with N = cout in {12, 36, 72}. Packing P output pixels per
matmul row lifts N to P cout at the cost of (P+2)/(3P)-inflated K
(block-structured weights with zeros). Whether that pays is a property of
the matrix units, so K4 (``ops/cuda/lane_packing.py``) runs the exact GEMM
shapes the kernel would use, per layer class:

    BASELINE (m, 9 cin) x (9 cin, cout)
    PACKED-2 (m/2, 12 cin) x (12 cin, 2 cout)
    PACKED-3 (m/3, 18 cin) x (18 cin, 3 cout)

The same useful output per variant; the packed variants do 1.33x / 2.0x the
multiply-adds, and win only if their time is lower despite that. Each call
runs REPS * grid chained products; the data is the JAX script's
(``default_rng(0)``: per case a ~ N(0, 1) fp32, w ~ N(0, 0.05) as bf16).
Prints ms per call and the raw TFLOP/s (2 m k n REPS grid / time). Runs on
the card unless ``device="cpu"``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .. import resolve_device


@torch.no_grad()
def main(*, duration_s: float = 4.0, warmup: int = 3, chunk=100, grid: int = 64, device=None,
         cases=None) -> list:
    """Print one line a case; return them, one dict a case. ``cases`` is a
    list of (label, variant, m, k, n), the bench's 12 by default."""
    from ..ops.cuda.lane_packing import CASES, M_FULL, REPS, lane_packing_mm
    from ..utils.profiler import measure_chained

    dev = resolve_device(device)
    cases = CASES if cases is None else cases
    rng = np.random.default_rng(0)
    print(f"m_full={M_FULL} reps={REPS} grid={grid}; useful MACs equal per class", flush=True)
    out = []
    for label, variant, m, k, n in cases:
        a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
        w = w.to(torch.bfloat16).to(dev)
        res = measure_chained(lambda t, w=w: lane_packing_mm(t, w, grid)[0], a,
                              warmup=warmup, duration_s=duration_s, chunk=chunk)
        macs = m * k * n * REPS * grid
        tflops = 2 * macs / (res.ms_per_call * 1e-3) / 1e12
        print(f"{label:11s} {variant:9s} ({m:5d},{k:4d})x({k:4d},{n:3d}): "
              f"{res.ms_per_call:7.3f} ms/call  {tflops:5.2f} TFLOPS(raw)", flush=True)
        out.append(dict(label=label, variant=variant, m=m, k=k, n=n, tflops_raw=tflops,
                        **res.to_dict()))
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
