"""Sweep K4's plans (the lane-packing study) on one card.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.sweep_k4 [--out FILE]

At each of the bench's 12 cases, every plan with 1, 2 or 3 column slices
that the compiled widths allow (``lane_packing.plan_for``): the whole N in
one wgmma, streamed through the ring where W does not fit beside A, or N
split over more CTAs, narrower and resident. Each plan's accumulator error
against the plain version at grid 2 (limit 1e-3 of max|acc|), its compiled
registers, spills and shared memory, and its time a bench call at grid 64
(the median of 20 single calls between CUDA events). The plan each case
ships (``lane_packing.tile_plan``) is marked. ptxas's warnings about wgmma
are printed first: C7520 ("wgmma ... serialized") means a wgmma sits on a
path ptxas cannot prove uniform.

One JSON line a record, ``{"ok": ...}`` last. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .turns_k3_k4 import _events_ms

GRID_CHECK, GRID_TIME = 2, 64
K4_ACC_REL = 1e-3


def sweep(dev) -> list:
    from ..ops.cuda import build
    from ..ops.cuda import lane_packing as k4

    build.load_library()
    warn = [ln.strip() for ln in build.build_info["ptxas"].splitlines()
            if "wgmma" in ln.lower() or "warning" in ln.lower()]
    print(json.dumps({"kernel": "K4", "ptxas_warnings": warn[:20]}), flush=True)
    recs = []
    rng = np.random.default_rng(0)
    for label, variant, m, k, n in k4.CASES:
        a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
        w = w.to(torch.bfloat16).to(dev)
        _, pacc = k4.lane_packing_mm_plain(a, w, GRID_CHECK)
        shipped = k4.tile_plan(m, k, n)
        for ncol in (1, 2, 3):
            try:
                plan = k4.plan_for(m, k, n, ncol)
            except ValueError:
                continue
            img = k4.prepare_weight(w, plan)
            _, acc = k4.launch(a, img, n, plan, k4.REPS * GRID_CHECK)
            ms = _events_ms(lambda: k4.launch(a, img, n, plan, k4.REPS * GRID_TIME))
            rec = dict(kernel="K4", case=f"{label} {variant}", shape=[m, k, n], ncol=ncol,
                       n_per_instruction=plan.nc, ctas=plan.ctas,
                       ring="resident" if plan.resident else "streamed", kc=plan.kc,
                       stages=plan.stages, smem=plan.smem, shipped=plan == shipped,
                       acc_rel=(acc - pacc).abs().max().item() / pacc.abs().max().item(),
                       info=k4.kernel_info(plan, dev), ms=ms,
                       tflops_raw=2.0 * m * k * n * k4.REPS * GRID_TIME / ms / 1e9)
            print(json.dumps(rec), flush=True)
            recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the records to FILE as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_k4: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()
    print(json.dumps({"nvidia_smi": smi}), flush=True)
    recs = sweep(torch.device("cuda"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(nvidia_smi=smi, k4=recs), f, indent=1)
    ok = all(r["acc_rel"] <= K4_ACC_REL and r["info"]["local_bytes"] == 0 for r in recs)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
