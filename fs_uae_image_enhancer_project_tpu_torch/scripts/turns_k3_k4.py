"""Time K3 and K4 against another tree's K3 and K4 on one card, in turns:
the ``turns`` phase of ``chip_smoke.py --parent DIR``, which calls
:func:`main`.

``DIR`` is another checkout of the repo (a parent commit unpacked with ``git
archive`` into ``build/``, which is gitignored). Each tree is timed in a child
process of its own that imports that tree's package (its wrappers, its
kernels, built into its own ``build/``), four times in turns: parent, this
tree, this tree, parent. Every child times the same work:

- K4 (``lane_packing_mm``) at the bench's 12 cases at grid 64, data as the
  bench makes it (``default_rng(0)``: a ~ N(0, 1) fp32, w ~ N(0, 0.05) bf16):
  the median of 20 single calls between CUDA events, after 3 warm-ups;
- K3 (``palette_dither``, palette luminance given) on the inputs in an
  ``.npz`` of ``crops``, ``pal64`` and ``pal256`` (``chip_smoke.py`` writes
  the datagen phase's lores crops and their k-means palettes) in every
  mode: the device time of one call, 3 repeats of 50 calls back to back
  behind a sleep kernel (``utils.profiler.device_times``'s method), median.

Each child also checks its kernels' outputs against its own tree's plain
versions (K4's accumulator within 1e-3 of max|acc|, K3 byte for byte).
:func:`main` returns every visit and a summary by kernel and case: the
parent's and this tree's readings, two visits each. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
GRID = 64
K4_ACC_REL = 1e-3


def _modes():
    from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import (
        BAYER_MATRIX_2X2, BAYER_MATRIX_4X4, BAYER_MATRIX_8X8)

    return [("map", "none", None), ("checker", "checkerboard", None),
            ("bayer2x2", "ordered", BAYER_MATRIX_2X2), ("bayer4x4", "ordered", BAYER_MATRIX_4X4),
            ("bayer8x8", "ordered", BAYER_MATRIX_8X8)]


def _events_ms(fn, n: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _device_ms(fn, n: int = 50, reps: int = 3, preroll_ms: float = 30.0) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(preroll_ms * 2e6))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / n)
    return statistics.median(per)


def child(root: str, inputs: str) -> dict:
    """Time ``root``'s K3 and K4 (run in a process of its own, with ``root``
    first on the path)."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4

    assert os.path.dirname(os.path.abspath(k4.__file__)).startswith(os.path.abspath(root))
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"root": root, "k4": [], "k3": []}
    rng = np.random.default_rng(0)
    for label, variant, m, k, n in k4.CASES:
        a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(dev)
        w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32))
        w = w.to(torch.bfloat16).to(dev)
        ms = _events_ms(lambda: k4.lane_packing_mm(a, w, GRID))
        _, acc = k4.lane_packing_mm(a, w, GRID)
        _, pacc = k4.lane_packing_mm_plain(a, w, GRID)
        rel = ((acc - pacc).abs().max() / pacc.abs().max()).item()
        out["k4"].append(dict(case=f"{label} {variant}", ms=ms, acc_rel=rel))
    data = np.load(inputs)
    x = torch.from_numpy(data["crops"]).to(dev)
    for key in ("pal64", "pal256"):
        pal = torch.from_numpy(data[key]).to(dev)
        lum = k3.palette_luminance(pal)
        for label, method, bayer in _modes():
            got = k3.palette_dither(x, pal, method, bayer, lum)
            same = torch.equal(got, k3.palette_dither_plain(x, pal, method, bayer, lum))
            ms = _device_ms(lambda: k3.palette_dither(x, pal, method, bayer, lum))
            out["k3"].append(dict(case=f"N={pal.shape[1]} {label}", ms=ms, equal_to_plain=same))
    return out


def _visit(root: str, inputs: str) -> dict:
    with tempfile.NamedTemporaryFile("r", suffix=".json") as f:
        subprocess.run([sys.executable, HERE, "--child", root, "--inputs", inputs, "--out",
                        f.name], check=True, timeout=600)
        return json.load(open(f.name))


def main(parent: str, inputs: str) -> dict:
    """Visit parent, this tree, this tree, parent; return every visit and the
    summary."""
    order = [("parent", os.path.abspath(parent)), ("new", REPO), ("new", REPO),
             ("parent", os.path.abspath(parent))]
    visits = [dict(tree=name, **_visit(root, inputs)) for name, root in order]
    summary = {}
    for kern in ("k4", "k3"):
        rows = []
        for i, rec in enumerate(visits[0][kern]):
            by = {t: [v[kern][i]["ms"] for v in visits if v["tree"] == t]
                  for t in ("parent", "new")}
            rows.append(dict(case=rec["case"], parent_ms=by["parent"], new_ms=by["new"],
                             parent_over_new=statistics.median(by["parent"])
                             / statistics.median(by["new"])))
        summary[kern] = rows
    ok = all(r["acc_rel"] <= K4_ACC_REL for v in visits for r in v["k4"]) and all(
        r["equal_to_plain"] for v in visits for r in v["k3"])
    return dict(ok=ok, order=[t for t, _ in order], summary=summary, visits=visits)


if __name__ == "__main__":  # a child: time one tree, write its JSON to --out
    ap = argparse.ArgumentParser(description="one child visit of the turns")
    ap.add_argument("--child", required=True, help="the checkout to time")
    ap.add_argument("--inputs", required=True, help="an .npz of crops, pal64, pal256")
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    with open(args.out, "w") as f:
        json.dump(child(args.child, args.inputs), f)
