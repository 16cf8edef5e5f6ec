"""Benchmark the fused-stack kernels (K1, K2) against the eager forward.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.bench_fused_stack

Counterpart of the repo's ``scripts/bench_fused_stack.py``. The weights are
the shipped ``artifacts/model_pix_shuffle/pix_shuffle.onnx``; the input is
the JAX script's, ``default_rng(0)`` uniform (1, 576, 752, 3) in fp32. Three
variants of the lightweight forward:

- ``eager bf16``: the eager forward in bf16 (cuDNN's convolutions);
- ``cuda fused``: through K1 (one output pixel per matmul row);
- ``cuda packed-2``: through K2 (two output pixels per matmul row).

First each one's max and mean abs error against the fp32 eager forward (TF32
off), then its ms per call, fps and p50 from ``measure_chained`` (each call
takes the previous output). ``BENCH_FUSED_ONLY=<substring>`` keeps the
variants whose name holds it. Runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")


def variants(params):
    """(name, fn) of the three forwards; each fn maps fp32 (N, H, W, 3) to
    fp32 (N, H, W, 3)."""
    from ..models import pix_shuffle as ps
    from ..ops.cuda.fused_stack import fused_stack_apply
    from ..ops.cuda.fused_stack_packed import fused_stack_packed_apply

    cfg = ps.lightweight_config()
    return [
        ("eager bf16", lambda t: ps.apply_eager(params, t.to(torch.bfloat16), cfg).float()),
        ("cuda fused", lambda t: fused_stack_apply(params, t)),
        ("cuda packed-2", lambda t: fused_stack_packed_apply(params, t)),
    ]


@torch.no_grad()
def main(*, duration_s: float = 12.0, warmup: int = 5, chunk=200, device=None,
         shape=(1, 576, 752, 3), only=None) -> list:
    """Print the errors and times; return them, one dict a variant."""
    from ..export.onnx_import import import_pix_shuffle
    from ..interop import params_from_jax
    from ..models import pix_shuffle as ps
    from ..utils.profiler import measure_chained

    dev = resolve_device(device)
    params = params_from_jax(import_pix_shuffle(ONNX).params, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)).to(dev)
    only = os.environ.get("BENCH_FUSED_ONLY") if only is None else only
    chosen = [(n, f) for n, f in variants(params) if not only or only in n]
    truth = ps.apply_eager(params, x, ps.lightweight_config())  # fp32, TF32 off
    out = []
    for name, fn in chosen:
        err = (fn(x) - truth).abs()
        rec = dict(name=name, max_err=float(err.max()), mean_err=float(err.mean()))
        print(f"{name} vs fp32: max err {rec['max_err']:.2e} mean {rec['mean_err']:.2e}",
              flush=True)
        out.append(rec)
    for rec, (name, fn) in zip(out, chosen):
        res = measure_chained(fn, x, warmup=warmup, duration_s=duration_s, chunk=chunk)
        rec.update(res.to_dict())
        print(f"{name}: {res.ms_per_call:.3f} ms ({res.fps:.1f} fps, p50 {res.p50_ms:.3f})",
              flush=True)
    return out

if __name__ == "__main__":
    main()
    sys.exit(0)
