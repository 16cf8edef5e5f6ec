"""Synthesize the ground-truth scene corpus deterministically.

Port of the repo's ``scripts/make_gt_frames.py``, numpy and PIL only: the
same scenes, flat fills and 32/8 split, and the same PNG bytes from the same
``--seed``. Scenes mix the statistics that matter for upscaling Amiga frame
buffers: smooth gradients (banding and dither recovery), hard-edged UI
geometry and glyph rows (edges), value-noise terrain and starfields
(texture), and palette-limited flat regions.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.make_gt_frames \
        --out DIR [--scenes 24] [--seed 7] [--width 1504 --height 1152] [--split] \
        [--ref_samples DIR]

Files already in ``--out`` are kept, so a rerun writes nothing. The
reference's sample frames (``sample*.png`` of ``--ref_samples``, its
``model/samples`` directory) join the corpus where that directory is given
and exists. The last line of the output is one
JSON object: the files written and kept, and the split's counts.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
from PIL import Image

def _value_noise(rng: np.random.Generator, h: int, w: int, cells: int,
                 octaves: int = 3) -> np.ndarray:
    """Multi-octave value noise in [0,1], float32, via PIL bilinear upsample."""
    out = np.zeros((h, w), np.float32)
    amp, total = 1.0, 0.0
    for o in range(octaves):
        c = min(max(2, cells * (2 ** o)), min(h, w))
        grid = rng.random((c, c), dtype=np.float32)
        img = Image.fromarray((grid * 255).astype(np.uint8)).resize(
            (w, h), Image.BILINEAR)
        out += amp * (np.asarray(img, np.float32) / 255.0)
        total += amp
        amp *= 0.5
    return out / total


def _ramp(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """Smooth 2-3 stop color gradient (sky/backdrop), (h,w,3) float in [0,1]."""
    stops = rng.integers(2, 4)
    colors = rng.random((stops, 3), dtype=np.float32)
    pos = np.sort(np.concatenate([[0.0], rng.random(max(stops - 2, 0)), [1.0]]))
    t = np.linspace(0, 1, h, dtype=np.float32)
    img = np.empty((h, 3), np.float32)
    for c in range(3):
        img[:, c] = np.interp(t, pos, colors[:, c])
    ang = float(rng.uniform(-0.3, 0.3))
    base = np.repeat(img[:, None, :], w, axis=1)
    if abs(ang) > 0.05:  # shear the gradient off-vertical
        shift = (np.arange(w) * ang).astype(int) % h
        for x in range(0, w, 8):  # coarse shear is enough for a backdrop
            base[:, x:x + 8, :] = np.roll(base[:, x:x + 8, :],
                                          int(shift[x]), axis=0)
    return base


def _add_rects(rng: np.random.Generator, img: np.ndarray, n: int,
               glyphs: bool = False) -> None:
    """Hard-edged filled rectangles with 1-2 px contrasting outlines.

    glyphs=True draws rows of small cells, mimicking bitmap text/HUD lines.
    """
    h, w, _ = img.shape
    for _ in range(n):
        if glyphs:
            gw, gh = int(rng.integers(4, 10)), int(rng.integers(6, 12))
            x0 = int(rng.integers(0, w - 40 * gw)) if w > 40 * gw else 0
            y0 = int(rng.integers(0, h - gh - 2))
            fg = rng.random(3, dtype=np.float32)
            cells = int(rng.integers(10, 40))
            for k in range(cells):
                if rng.random() < 0.2:
                    continue  # word gap
                x = x0 + k * (gw + 1)
                if x + gw >= w:
                    break
                mask = rng.random((gh, gw)) < 0.55  # glyph-ish pixel pattern
                img[y0:y0 + gh, x:x + gw][mask] = fg
        else:
            rw = int(rng.integers(20, w // 3))
            rh = int(rng.integers(20, h // 3))
            x0 = int(rng.integers(0, w - rw))
            y0 = int(rng.integers(0, h - rh))
            fill = rng.random(3, dtype=np.float32)
            edge = 1.0 - fill
            img[y0:y0 + rh, x0:x0 + rw] = fill
            t = int(rng.integers(1, 3))
            img[y0:y0 + t, x0:x0 + rw] = edge
            img[y0 + rh - t:y0 + rh, x0:x0 + rw] = edge
            img[y0:y0 + rh, x0:x0 + t] = edge
            img[y0:y0 + rh, x0 + rw - t:x0 + rw] = edge


def _add_discs(rng: np.random.Generator, img: np.ndarray, n: int) -> None:
    """Anti-aliased discs (sprites/planets) with radial shading."""
    h, w, _ = img.shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for _ in range(n):
        r = float(rng.integers(12, min(h, w) // 5))
        cx = float(rng.uniform(r, w - r))
        cy = float(rng.uniform(r, h - r))
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        a = np.clip(r - d, 0.0, 1.0)[..., None]  # 1px AA edge
        shade = np.clip(1.0 - d / (2.0 * r), 0.3, 1.0)[..., None]
        col = rng.random(3, dtype=np.float32)
        img[:] = img * (1 - a) + a * (col * shade)


def _add_stars(rng: np.random.Generator, img: np.ndarray, n: int) -> None:
    h, w, _ = img.shape
    ys = rng.integers(0, h, n)
    xs = rng.integers(0, w, n)
    img[ys, xs] = rng.random((n, 3), dtype=np.float32) * 0.5 + 0.5


def make_scene(seed: int, w: int, h: int) -> np.ndarray:
    """One deterministic scene, uint8 RGB (h, w, 3)."""
    rng = np.random.default_rng(seed)
    kind = seed % 4
    if kind == 0:  # gradient sky + sprites + HUD glyphs
        img = _ramp(rng, h, w)
        _add_discs(rng, img, int(rng.integers(2, 5)))
        _add_rects(rng, img, int(rng.integers(2, 5)))
        _add_rects(rng, img, int(rng.integers(3, 7)), glyphs=True)
    elif kind == 1:  # value-noise terrain + geometry
        noise = _value_noise(rng, h, w, cells=int(rng.integers(3, 8)))
        pal = rng.random((3, 3), dtype=np.float32)
        img = (pal[0][None, None] * noise[..., None]
               + pal[1][None, None] * (1 - noise[..., None]) ** 2
               + pal[2][None, None] * 0.1)
        img = np.clip(img, 0, 1)
        _add_rects(rng, img, int(rng.integers(4, 9)))
    elif kind == 2:  # starfield + discs + glyph rows (space game)
        img = np.zeros((h, w, 3), np.float32)
        img += _ramp(rng, h, w) * 0.15
        _add_stars(rng, img, int(rng.integers(800, 2500)))
        _add_discs(rng, img, int(rng.integers(1, 4)))
        _add_rects(rng, img, int(rng.integers(4, 8)), glyphs=True)
    else:  # UI panel scene: tiled texture + many boxes
        noise = _value_noise(rng, h, w, cells=24, octaves=2)
        base = rng.random(3, dtype=np.float32) * 0.6 + 0.2
        img = base[None, None] * (0.7 + 0.3 * noise[..., None])
        _add_rects(rng, img, int(rng.integers(8, 16)))
        _add_rects(rng, img, int(rng.integers(4, 8)), glyphs=True)
        # interlace-style darkened even lines on a band
        y0 = int(rng.integers(0, h // 2))
        img[y0:y0 + h // 3:2] *= 0.75
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


# 8 deterministic flat fills (flat00..flat07): the RGB cube corners, index
# bits = (R,G,B). Flat regions are the degenerate case the palette/dither
# pipeline must keep exactly (a 1-colour palette); black and white bound the
# gamma curve. bench_generator_e2e / train_vgg_features filter on the
# flat??.png spelling.
FLAT_CORNERS = [(255 * (i >> 2 & 1), 255 * (i >> 1 & 1), 255 * (i & 1))
                for i in range(8)]

# The deterministic 32/8 split of the JAX script: the test split holds back
# the last four scenes, the last two reference samples and the last two
# flats, so that every frame family is on both sides.
TEST_FRAMES = ("scene_020", "scene_021", "scene_022", "scene_023",
               "sample6", "sample7", "flat06", "flat07")


def _write(path: str, make, counts: dict) -> None:
    if os.path.exists(path):
        print(f"keep  {path}")
        counts["kept"] += 1
        return
    make(path)
    print(f"wrote {path}")
    counts["written"] += 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Write the seeded ground-truth corpus")
    ap.add_argument("--out", required=True)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--width", type=int, default=1504)  # 2x Amiga 752x576
    ap.add_argument("--height", type=int, default=1152)
    ap.add_argument("--split", action="store_true",
                    help="also write <out>/train and <out>/test symlink "
                         "trees (32/8, TEST_FRAMES held out)")
    ap.add_argument("--ref_samples", default=None,
                    help="the reference's model/samples directory; its sample*.png are "
                         "copied in where it exists")
    args = ap.parse_args(argv)

    counts = {"written": 0, "kept": 0}
    os.makedirs(args.out, exist_ok=True)
    for i in range(args.scenes):
        def mk(path, i=i):
            arr = make_scene(args.seed * 1000 + i, args.width, args.height)
            Image.fromarray(arr).save(path)

        _write(os.path.join(args.out, f"scene_{i:03d}.png"), mk, counts)

    # the reference's samples join the corpus, so that parity targets and
    # training statistics share a distribution
    samples = bool(args.ref_samples) and os.path.isdir(args.ref_samples)
    if samples:
        for name in sorted(os.listdir(args.ref_samples)):
            if not (name.startswith("sample") and name.endswith(".png")):
                continue
            _write(os.path.join(args.out, name),
                   lambda p, s=os.path.join(args.ref_samples, name): shutil.copyfile(s, p),
                   counts)
    else:
        print(f"NOTE: {args.ref_samples} absent; corpus has no sample*.png")

    for i, rgb in enumerate(FLAT_CORNERS):
        _write(os.path.join(args.out, f"flat{i:02d}.png"),
               lambda p, rgb=rgb: Image.new("RGB", (args.width, args.height), rgb).save(p),
               counts)

    split = None
    if args.split:
        frames = sorted(f for f in os.listdir(args.out) if f.endswith(".png"))
        for part in ("train", "test"):
            os.makedirs(os.path.join(args.out, part), exist_ok=True)
        split = {"train": 0, "test": 0}
        for f in frames:
            part = "test" if os.path.splitext(f)[0] in TEST_FRAMES else "train"
            dst = os.path.join(args.out, part, f)
            if not os.path.lexists(dst):
                os.symlink(os.path.join("..", f), dst)
            split[part] += 1
        print(f"split: {split['train']} train / {split['test']} test")
    print(json.dumps({"out": os.path.abspath(args.out), "seed": args.seed,
                      "size": [args.width, args.height], "reference_samples": samples,
                      **counts, "split": split}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
