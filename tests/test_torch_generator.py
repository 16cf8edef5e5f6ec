"""The port's dataset generator against the JAX package's, on the CPU.

Both generators run on the same small seeded source tree (two 96x72
gradient-plus-noise images, 48x32 crops, lores, RGB444, palettes 8 and 16,
dithers none, checkerboard, bayer4x4 and floyd-steinberg):

- the PNG trees are byte-identical: the port's device route with
  ``device='cpu'`` (K3's plain version), per crop and batched
  (``device_batch=2``), against the JAX ``pallas`` route, with median-cut
  palettes so that no k-means seed differs; the port's host route against the
  JAX host route;
- the port's own batched and per-crop routes agree byte for byte with
  ``kmeans_torch`` palettes, inline and over a spawned worker pool;
- idempotence, stop at a chunk boundary and resume, batch-level failure
  reporting, the CLI with ``--device cpu``, and the ``cuda`` default raising
  without a card.
"""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fs_uae_image_enhancer_project_tpu.datagen.generator import (
    DatasetGenerator as JaxGenerator,
    GeneratorConfig as JaxConfig,
)
from fs_uae_image_enhancer_project_tpu_torch.datagen import device_batch as db
from fs_uae_image_enhancer_project_tpu_torch.datagen import generator as gen_mod
from fs_uae_image_enhancer_project_tpu_torch.datagen.generator import (
    DatasetGenerator,
    GeneratorConfig,
)
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3


def _write_sources(src, n=2, w=96, h=72):
    rng = np.random.default_rng(11)
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], axis=-1)
        arr = np.clip(base + rng.normal(0, 24, (h, w, 3)) + 30, 1, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(src, f"img_{i}.png"))


def _kw(tmp_path, out, **kw):
    d = dict(
        train_images=[str(tmp_path / "src")],
        dest_dir=str(tmp_path / out),
        crop_w=48, crop_h=32,
        resolutions=("lores",),
        colorspaces=("RGB444",),
        palettes=(8, 16),
        dithers=("none", "checkerboard", "bayer4x4", "floyd-steinberg"),
        rotations=(0,),
        downscales=(100,),
        palette_algorithm="median_cut",
        workers=1,
        cache_dir=str(tmp_path / ("cache_" + out)),
        verbose=0,
    )
    d.update(kw)
    return d


def _cfg(tmp_path, out, **kw):
    return GeneratorConfig(**_kw(tmp_path, out, **{"device": "cpu", "quantize_backend": "device",
                                                   **kw}))


def _tree(root):
    out = {}
    for r, _d, files in os.walk(root):
        for f in files:
            with open(os.path.join(r, f), "rb") as fh:
                out[os.path.relpath(os.path.join(r, f), root)] = fh.read()
    return out


def _assert_same_tree(a, b):
    assert set(a) == set(b)
    assert [k for k in a if a[k] != b[k]] == []


@pytest.fixture
def source_tree(tmp_path):
    (tmp_path / "src").mkdir()
    _write_sources(str(tmp_path / "src"))
    return tmp_path


@pytest.mark.parametrize("device_batch", [0, 2])
def test_device_route_trees_equal_the_jax_pallas_route(source_tree, device_batch):
    jax_cfg = JaxConfig(**_kw(source_tree, "jax", quantize_backend="pallas"))
    assert JaxGenerator(jax_cfg).run()["missing"] == 0
    cfg = _cfg(source_tree, "port", device_batch=device_batch)
    assert cfg.quantize_backend == "device"
    stats = DatasetGenerator(cfg).run()
    assert stats["missing"] == 0 and stats["generated_this_run"] == stats["expected"]
    port = _tree(cfg.dest_dir)
    assert len(port) == 72
    _assert_same_tree(port, _tree(jax_cfg.dest_dir))


def test_host_route_tree_equals_the_jax_host_route(source_tree):
    jax_cfg = JaxConfig(**_kw(source_tree, "jax_np", quantize_backend="numpy",
                              dithers=("none", "bayer8x8", "atkinson")))
    assert JaxGenerator(jax_cfg).run()["missing"] == 0
    cfg = _cfg(source_tree, "port_np", quantize_backend="numpy",
               dithers=("none", "bayer8x8", "atkinson"))
    assert DatasetGenerator(cfg).run()["missing"] == 0
    _assert_same_tree(_tree(cfg.dest_dir), _tree(jax_cfg.dest_dir))


@pytest.mark.parametrize("workers", [1, 2])
def test_kmeans_torch_batched_equals_per_crop(source_tree, workers):
    per = _cfg(source_tree, f"km_pc{workers}", palette_algorithm="kmeans_torch",
               workers=workers)
    bat = _cfg(source_tree, "km_bt", palette_algorithm="kmeans_torch", device_batch=3)
    before = k3.palette_dither.launches
    for cfg in (per, bat):
        assert DatasetGenerator(cfg).run()["missing"] == 0
    # the wrapper counts launches of the CUDA kernel only, never the plain path
    assert k3.palette_dither.launches == before
    _assert_same_tree(_tree(per.dest_dir), _tree(bat.dest_dir))


def test_batched_run_is_idempotent(source_tree):
    cfg = _cfg(source_tree, "idem", device_batch=4)
    assert DatasetGenerator(cfg).run()["missing"] == 0
    s2 = DatasetGenerator(cfg).run()
    assert s2["generated_this_run"] == 0 and s2["missing"] == 0


def test_batch_level_failure_reports_every_member(source_tree, monkeypatch):
    """A device-call failure inside a (style, chunk) batch surfaces as a
    per-job error for every member and does not abort the run."""
    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(db, "generate_palettes_kmeans_torch_batch", boom)
    cfg = _cfg(source_tree, "fail", palette_algorithm="kmeans_torch", device_batch=4)
    stats = DatasetGenerator(cfg).run()
    out = _tree(cfg.dest_dir)
    assert stats["missing"] > 0 and not stats["stopped"]
    assert any("floyd" in k for k in out), "scalar-fallback dithers should still generate"
    assert any(os.path.basename(k).startswith("target_") for k in out)
    assert not any("bayer4x4" in k or "checkerboard" in k for k in out)


def test_batched_stop_at_chunk_boundary_then_resume(source_tree, monkeypatch):
    full_cfg = _cfg(source_tree, "stop_full", device_batch=2)
    assert DatasetGenerator(full_cfg).run()["missing"] == 0
    full = _tree(full_cfg.dest_dir)

    orig = db.run_styled_jobs_batched

    def tripping(jobs, batch_size, report, should_stop=lambda: False):
        polls = {"n": 0}

        def trip():
            polls["n"] += 1
            return polls["n"] > 1  # the first chunk runs, the second poll stops

        return orig(jobs, batch_size, report, should_stop=trip)

    part_cfg = _cfg(source_tree, "stop_part", device_batch=2)
    monkeypatch.setattr(db, "run_styled_jobs_batched", tripping)
    s_part = DatasetGenerator(part_cfg).run()
    assert s_part["missing"] > 0 and len(_tree(part_cfg.dest_dir)) < len(full)
    monkeypatch.setattr(db, "run_styled_jobs_batched", orig)
    assert DatasetGenerator(part_cfg).run()["missing"] == 0
    _assert_same_tree(_tree(part_cfg.dest_dir), full)


def test_cli_with_device_cpu(source_tree, capsys):
    dest = source_tree / "cli"
    rc = gen_mod.main([
        "--train_images", str(source_tree / "src"), "--dest_dir", str(dest),
        "--crop_size", "48", "32", "--palette", "8", "16",
        "--dither", "none", "checkerboard", "bayer4x4", "floyd-steinberg",
        "--palette_algorithm", "median_cut", "--quantize_backend", "device",
        "--device_batch", "2", "--device", "cpu",
        "--workers", "1", "--cache_dir", str(source_tree / "cache_cli"), "--verbose", "0",
    ])
    assert rc == 0
    # the last line is the run's summary with K3's launches (none on the CPU)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    api = _cfg(source_tree, "api", device_batch=2)
    stats = DatasetGenerator(api).run()
    assert stats["missing"] == 0 and last == dict(stats, k3_launches=0)
    _assert_same_tree(_tree(str(dest)), _tree(api.dest_dir))


def test_config_defaults_to_cuda_and_raises_without_a_card(source_tree):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GeneratorConfig(**_kw(source_tree, "nocard"))
    with pytest.raises(ValueError):
        GeneratorConfig(**_kw(source_tree, "badbackend", device="cpu",
                              quantize_backend="pallas"))
