"""Exact against approximate sRGB <-> linear transfer curves, fp32 and bf16.

Port of the root ``benchmark_tools/gamma_plot.py`` (the reference's
``gamma_plot.py``): it justifies the ``t**2.2`` approximation used across
the pipeline, with the bf16 error envelope beside the fp32 one. The tables
are functions (:func:`curves`, :func:`errors`); the plot is an SVG written
with the standard library (the card machine has no matplotlib): the curves
in the top row, the approximation's absolute error on a log scale in the
bottom row, against the 1/255 step of an 8-bit value.

    python -m fs_uae_image_enhancer_project_tpu_torch.benchmark_tools.gamma_plot \\
        [--out gamma_curves.svg] [--device cuda]
"""
from __future__ import annotations

import argparse
import html
import math
import sys

import numpy as np
import torch

from ..ops.gamma import (
    linear_to_srgb,
    linear_to_srgb_approx,
    linear_to_srgb_poly,
    srgb_to_linear,
    srgb_to_linear_approx,
    srgb_to_linear_poly,
)

DIRECTIONS = {
    "sRGB -> linear": (srgb_to_linear, srgb_to_linear_approx, srgb_to_linear_poly),
    "linear -> sRGB": (linear_to_srgb, linear_to_srgb_approx, linear_to_srgb_poly),
}
LSB = 1.0 / 255.0


def _grid(n: int, device) -> torch.Tensor:
    from .. import resolve_device

    return torch.from_numpy(np.linspace(0, 1, n, dtype=np.float32)).to(resolve_device(device))


def curves(n: int = 1024, device=None) -> dict:
    """{direction: {"exact", "approx", "poly"}} over ``n`` points of [0, 1]
    in fp32, as numpy arrays."""
    t = _grid(n, device)
    return {d: {k: f(t).cpu().numpy() for k, f in zip(("exact", "approx", "poly"), fns)}
            for d, fns in DIRECTIONS.items()}


def errors(n: int = 1024, device=None) -> dict:
    """{direction: {"fp32", "bf16"}}: |exact(t) - approx(t)| with the
    approximation in fp32 and in bf16 (the exact curve in fp32)."""
    t = _grid(n, device)
    out = {}
    for d, (exact, approx, _poly) in DIRECTIONS.items():
        e = exact(t)
        out[d] = {"fp32": (e - approx(t)).abs().cpu().numpy(),
                  "bf16": (e - approx(t.to(torch.bfloat16)).float()).abs().cpu().numpy()}
    return out


PANEL_W, PANEL_H, MARGIN = 420, 280, 50
STYLES = {"exact": "", "approx": "6,4", "poly": "2,3", "fp32": "", "bf16": "6,4"}
COLORS = {"exact": "#1f77b4", "approx": "#ff7f0e", "poly": "#2ca02c", "fp32": "#1f77b4",
          "bf16": "#d62728"}


def _panel(x0: float, y0: float, title: str, series: dict, log: bool) -> list:
    """One plot: polylines of ``series`` ({label: y array} over t in [0, 1])
    in a box at (x0, y0); a log y axis with ``log``."""
    lo, hi = (math.log10(1e-9), 0.0) if log else (0.0, 1.0)

    def py(v):
        v = math.log10(max(float(v), 1e-9)) if log else float(v)
        return y0 + PANEL_H - (v - lo) / (hi - lo) * PANEL_H

    out = [f'<rect x="{x0}" y="{y0}" width="{PANEL_W}" height="{PANEL_H}" fill="none" '
           'stroke="#444"/>',
           f'<text x="{x0 + PANEL_W / 2}" y="{y0 - 8}" text-anchor="middle" '
           f'font-size="13">{html.escape(title)}</text>']
    for i, (label, ys) in enumerate(series.items()):
        n = len(ys)
        pts = " ".join(f"{x0 + j / (n - 1) * PANEL_W:.1f},{py(v):.1f}" for j, v in enumerate(ys))
        key = label.split(" ")[0]
        dash = f' stroke-dasharray="{STYLES[key]}"' if STYLES.get(key) else ""
        out.append(f'<polyline points="{pts}" fill="none" stroke="{COLORS.get(key, "#777")}"'
                   f'{dash} stroke-width="1.3"/>')
        out.append(f'<text x="{x0 + 8}" y="{y0 + 16 + 14 * i}" font-size="11" '
                   f'fill="{COLORS.get(key, "#777")}">{html.escape(label)}</text>')
    if log:
        out.append(f'<line x1="{x0}" x2="{x0 + PANEL_W}" y1="{py(LSB):.1f}" y2="{py(LSB):.1f}" '
                   'stroke="gray" stroke-width="0.8"/>')
        out.append(f'<text x="{x0 + PANEL_W - 4}" y="{py(LSB) - 4:.1f}" text-anchor="end" '
                   'font-size="10" fill="gray">1/255 (8-bit LSB)</text>')
    return out


def render_svg(n: int = 1024, device=None) -> str:
    """The 2x2 figure as SVG text."""
    cv, er = curves(n, device), errors(n, device)
    width = 2 * (PANEL_W + MARGIN) + MARGIN
    height = 2 * (PANEL_H + MARGIN) + MARGIN
    parts = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" height="{height}" '
             'font-family="sans-serif">', '<rect width="100%" height="100%" fill="white"/>']
    for col, d in enumerate(DIRECTIONS):
        x0 = MARGIN + col * (PANEL_W + MARGIN)
        parts += _panel(x0, MARGIN, d, {"exact piecewise": cv[d]["exact"],
                                        "approx t**2.2": cv[d]["approx"],
                                        "poly cubic": cv[d]["poly"]}, log=False)
        parts += _panel(x0, 2 * MARGIN + PANEL_H, f"{d} abs error",
                        {"fp32 approx err": er[d]["fp32"] + 1e-9,
                         "bf16 approx err": er[d]["bf16"] + 1e-9}, log=True)
    parts.append("</svg>")
    return "\n".join(parts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="gamma_curves.svg")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        f.write(render_svg(device=args.device))
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
