"""Plot the plateau run's validation curve against the SHAPE of the
reference's committed pix_shuffle history.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.plot_training_parity \\
        [--ours CSV] [--ref CSV] [--out_dir DIR]

Port of the repo's ``scripts/plot_training_parity.py``, which imports
neither package: numpy-free, torch-free, matplotlib only. The two curves are
different metrics on different corpora (the reference's pretrained-VGG loss
on its 50k-photo corpus, ours the random-VGG criterion on the generated
corpus), so the comparable quantity is the normalized TRAJECTORY: each curve
is indexed to its own epoch-1 value (two measures of different scale ->
index to a common base, never dual axes).

``--ours`` defaults to ``PARITY_OURS_CSV`` or the round-5 94-epoch
full-criterion curve, ``artifacts/model_pix_shuffle_trained/
training_stats_pix_shuffle.csv``. ``--ref`` defaults to ``PARITY_REF_CSV``;
without either, the reference's curve is the one the committed
``artifacts/training_parity/val_curve_points.json`` holds (the root script
reads it from the reference's checkout). A CSV resumed mid-run repeats
epochs: the last write of an epoch is kept, in file order. Writes
``val_curve_comparison.png`` and the points as ``val_curve_points.json``
into ``--out_dir`` (default: ``training_parity`` under the port's work
directory; the root script writes the repo's ``artifacts/training_parity``).

Where matplotlib does not import, the driver exits 1 before it reads
anything, naming the module on stderr and in its JSON line (the root script
raises ``ImportError`` there). The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO, "build", "work", "training_parity")
OURS = os.path.join(REPO, "artifacts", "model_pix_shuffle_trained",
                    "training_stats_pix_shuffle.csv")
POINTS = os.path.join(REPO, "artifacts", "training_parity", "val_curve_points.json")

# validated categorical palette, light mode
BLUE = "#2a78d6"   # slot 1 -> this framework
ORANGE = "#eb6834"  # slot 2 -> reference
INK = "#3d3d3a"
MUTED = "#8a897f"


def read_curve(path):
    """``[(epoch, validation loss)]`` of a training-stats CSV, by epoch; a
    repeated epoch keeps its LAST write in file order (sorting first would
    keep the stale pre-resume row whenever the resumed epoch improved)."""
    with open(path) as f:
        rows = list(csv.reader(f))
    header, rows = rows[0], rows[1:]
    ei = header.index("Epoch")
    vi = [i for i, h in enumerate(header) if "Validation" in h][0]
    dedup = {}
    for r in rows:
        dedup[int(r[ei])] = float(r[vi])
    return sorted(dedup.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Plot the validation trajectories")
    ap.add_argument("--ours", default=os.environ.get("PARITY_OURS_CSV") or OURS)
    ap.add_argument("--ref", default=os.environ.get("PARITY_REF_CSV"),
                    help="the reference's CSV (default: the committed points' curve)")
    ap.add_argument("--out_dir", default=OUT_DIR)
    args = ap.parse_args(argv)
    try:
        import matplotlib
    except ImportError as e:
        msg = f"plot_training_parity needs matplotlib: {e}"
        print(msg, file=sys.stderr)
        print(json.dumps({"error": msg, "missing_module": "matplotlib"}), flush=True)
        return 1

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ours = read_curve(args.ours)
    if args.ref:
        ref = read_curve(args.ref)
    else:
        with open(POINTS) as f:
            ref = [tuple(p) for p in json.load(f)["reference"]]
    if not ours:
        print("no plateau run data yet", file=sys.stderr)
        print(json.dumps({"error": "no plateau run data yet", "ours": args.ours}), flush=True)
        return 1

    def indexed(pts):
        base = pts[0][1]
        return [e for e, _ in pts], [v / base for _, v in pts]

    xo, yo = indexed(ours)
    xr, yr = indexed(ref)

    fig, ax = plt.subplots(figsize=(8, 4.5), dpi=150)
    ax.plot(xr, yr, color=ORANGE, lw=2, label="reference (pretrained VGG, 50k-photo corpus)")
    ax.plot(xo, yo, color=BLUE, lw=2,
            label="this framework (random-VGG fallback, generated corpus)")
    # selective direct labels: the final point of each curve
    ax.annotate(f"{yr[-1]:.2f}", (xr[-1], yr[-1]), textcoords="offset points",
                xytext=(6, 0), color=INK, fontsize=9)
    ax.annotate(f"{yo[-1]:.2f}", (xo[-1], yo[-1]), textcoords="offset points",
                xytext=(6, 0), color=INK, fontsize=9)
    ax.set_xlabel("epoch", color=INK)
    ax.set_ylabel("validation loss, indexed to epoch 1", color=INK)
    ax.set_title(
        "pix_shuffle validation trajectory — shape comparison\n"
        "(different loss metrics and corpora; curves indexed to their own epoch 1)",
        color=INK, fontsize=11,
    )
    ax.grid(True, color="#e5e4dd", lw=0.8)
    ax.tick_params(colors=MUTED)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(MUTED)
    ax.legend(frameon=False, fontsize=9, labelcolor=INK)
    fig.tight_layout()
    os.makedirs(args.out_dir, exist_ok=True)
    out_png = os.path.join(args.out_dir, "val_curve_comparison.png")
    fig.savefig(out_png)
    plt.close(fig)
    out_points = os.path.join(args.out_dir, "val_curve_points.json")
    with open(out_points, "w") as f:
        json.dump({"ours": ours, "reference": ref}, f, indent=1)
    print(f"wrote {out_png}")
    print(json.dumps({"png": out_png, "points": out_points, "ours_epochs": len(ours),
                      "reference_epochs": len(ref)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
