"""The port's ground-truth tools against the reference's goldens, as
``tests/test_generator.py`` holds the JAX package's:

- ``datagen.prepare_groundtruth``: ``--max_crop_size`` semantics, the
  mirrored tree and an idempotent re-run; byte-level parity with the
  reference's own tool (``tests/goldens/prepare_goldens.npz``: the ICC->sRGB
  transform, its fallback, palette/RGBA/grayscale conversion, ``thumbnail``
  sizing and resampling);
- ``datagen.rgb444_flat``: the 4096 file names and pixels of the reference's
  swatch generator (``tests/goldens/rgb444_goldens.npz``), and an idempotent
  re-run.
"""
import os

import numpy as np
from PIL import Image

from fs_uae_image_enhancer_project_tpu_torch.datagen import prepare_groundtruth, rgb444_flat

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _write_source(path, w=64, h=48):
    rng = np.random.default_rng(5)
    arr = rng.integers(30, 256, (h, w, 3), dtype=np.uint8)  # non-black
    Image.fromarray(arr).save(path)


def test_prepare_groundtruth_max_crop_size(tmp_path):
    src = tmp_path / "orig" / "sub"
    src.mkdir(parents=True)
    _write_source(str(src / "wide.png"), w=200, h=50)
    _write_source(str(src / "small.png"), w=40, h=30)
    dst = tmp_path / "gt"
    rc = prepare_groundtruth.main([
        "--src", str(tmp_path / "orig"), "--dst", str(dst),
        "--max_crop_size", "100", "40",
    ])
    assert rc == 0
    with Image.open(dst / "sub" / "wide.png") as im:
        assert im.size == (100, 25)  # scale = min(100/200, 40/50) = 0.5
    with Image.open(dst / "sub" / "small.png") as im:
        assert im.size == (40, 30)  # already fits: untouched
    # idempotent: second run skips existing outputs
    assert prepare_groundtruth.main(
        ["--src", str(tmp_path / "orig"), "--dst", str(dst)]) == 0


def test_prepare_groundtruth_matches_reference_golden(tmp_path):
    g = np.load(os.path.join(GOLDENS, "prepare_goldens.npz"))
    src = tmp_path / "src"
    for key in g.files:
        if not key.startswith("in::"):
            continue
        p = src / key[len("in::"):]
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(g[key].tobytes())

    for tag, box in (("plain", None), ("boxed", (376, 288))):
        dst = tmp_path / f"out_{tag}"
        results = prepare_groundtruth.prepare_tree(
            str(src), str(dst), max_dim=box, workers=2, verbose=0)
        assert all(err is None for _p, err in results), results
        expected = {k[len(tag) + 2:] for k in g.files if k.startswith(f"{tag}::")}
        produced = {p.relative_to(dst).as_posix() for p in dst.rglob("*.png")}
        assert expected and produced == expected, (tag, produced ^ expected)
        for rel in sorted(expected):
            with Image.open(dst / rel) as im:
                np.testing.assert_array_equal(np.asarray(im), g[f"{tag}::{rel}"],
                                              err_msg=f"{tag}::{rel}")


def test_rgb444_matches_reference_golden(tmp_path):
    g = np.load(os.path.join(GOLDENS, "rgb444_goldens.npz"))
    dest = tmp_path / "swatches"
    n = rgb444_flat.generate(str(dest), width=4, height=3, verbose=0)
    assert n == 4096
    assert sorted(os.listdir(dest)) == list(g["names"])
    keys = [k for k in g.files if k.startswith("px::")]
    assert keys
    for key in keys:
        with Image.open(dest / key[len("px::"):]) as im:
            np.testing.assert_array_equal(np.asarray(im), g[key], err_msg=key)
    # idempotent: re-run writes nothing new
    assert rgb444_flat.generate(str(dest), width=4, height=3, verbose=0) == 0
