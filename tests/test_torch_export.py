"""The port's ONNX import, enhance, export, runner and export CLI against the
JAX package's, on the CPU.

- import: for every shipped ``artifacts/model_*/*.onnx`` (eleven graphs,
  the heavy and fp16 pix_shuffle ones included), ``import_any`` gives JAX's
  kind, residual layers, crop, exponents and ReLU order, with equal arrays;
- enhance: ``enhance_from_onnx`` for the six graphs of the other families on
  seeded frames at a window the U-Net takes (48x80 with its crop of 16):
  fp32 within one level of JAX's and equal in at least 99.9% of the values;
  bf16 at least 50 dB from JAX's bf16, or no further than JAX's bf16 is from
  JAX's fp32; the same bar on one full 576x752 frame;
- export: the port's exporter writes the JAX exporter's bytes for the same
  numpy parameters (every family, fp16 and fp32), and re-exporting each
  shipped graph of the six gives the shipped file's bytes;
- the numpy runner gives JAX's runner's output;
- the export CLI on a port checkpoint (``--device cpu``) writes a graph both
  importers read back to the checkpoint's (fused) weights;
- the frame server resolves and serves every family;
- ``onnx_dump`` and ``onnx_svg`` give JAX's text and SVG for every shipped
  graph; ``raw_runner`` gives JAX's frame within 50 dB.
"""
import glob
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from conftest import psnr
from fs_uae_image_enhancer_project_tpu.export import enhance as jax_enhance
from fs_uae_image_enhancer_project_tpu.export import onnx_export as jax_export
from fs_uae_image_enhancer_project_tpu.export import onnx_import as jax_import
from fs_uae_image_enhancer_project_tpu.export import onnx_runner as jax_runner
from fs_uae_image_enhancer_project_tpu.models import conv_stack as jax_conv_stack
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.utils.subproc import wait_for_line
from fs_uae_image_enhancer_project_tpu_torch.export import cli, onnx_export, onnx_import
from fs_uae_image_enhancer_project_tpu_torch.export import enhance as tor_enhance
from fs_uae_image_enhancer_project_tpu_torch.export import onnx_runner
from fs_uae_image_enhancer_project_tpu_torch.interop import params_to_numpy
from fs_uae_image_enhancer_project_tpu_torch.models import conv_stack, get_model
from fs_uae_image_enhancer_project_tpu_torch.runtime import sidecar

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = sorted(os.path.relpath(p, REPO)
                   for p in glob.glob(os.path.join(REPO, "artifacts", "model_*", "*.onnx")))
FAMILIES = ["conv3", "conv3_heavy", "conv5", "conv5_heavy", "conv6", "residual_unet"]
# 48 rows, 64 columns after the U-Net's crop of 16: both divisible by 2^3
WINDOW = (2, 48, 80, 4)


def _artifact(family):
    return os.path.join(REPO, "artifacts", f"model_{family}", f"{family}.onnx")


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _assert_trees_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_trees_equal(got[k], v)
        else:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], v)


def test_eleven_artifacts_are_shipped():
    assert len(ARTIFACTS) == 11


@pytest.mark.parametrize("path", ARTIFACTS)
def test_import_any_equals_jax(path):
    want = jax_import.import_any(os.path.join(REPO, path))
    got = onnx_import.import_any(os.path.join(REPO, path))
    for field in ("kind", "num_conv_layers", "residual_layers", "has_gamma", "crop_left",
                  "srgb_to_linear_exponent", "linear_to_srgb_exponent",
                  "relu_before_residual_add"):
        assert getattr(got, field) == getattr(want, field), field
    _assert_trees_equal(got.params, want.params)


@pytest.mark.parametrize("family", FAMILIES)
def test_enhance_fp32_matches_jax(family):
    fr = _frames(WINDOW, seed=1)
    want = np.asarray(jax_enhance.enhance_from_onnx(
        _artifact(family), compute_dtype=jnp.float32, donate=False)(jnp.asarray(fr)))
    got = tor_enhance.enhance_from_onnx(_artifact(family), device="cpu",
                                        compute_dtype=torch.float32)(fr).numpy()
    assert got.shape == fr.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got[..., 3], 255)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1
    assert (d == 0).mean() >= 0.999


@pytest.mark.parametrize("family", FAMILIES)
def test_enhance_bf16_matches_jax(family):
    fr = _frames(WINDOW, seed=2)
    jfn = jax_enhance.enhance_from_onnx
    want16 = np.asarray(jfn(_artifact(family), donate=False)(jnp.asarray(fr)))
    want32 = np.asarray(jfn(_artifact(family), compute_dtype=jnp.float32,
                            donate=False)(jnp.asarray(fr)))
    got = tor_enhance.enhance_from_onnx(_artifact(family), device="cpu")(fr).numpy()
    jax_margin = psnr(want16, want32)  # JAX's own bf16 against its fp32
    assert psnr(got, want16) >= min(50.0, jax_margin), (psnr(got, want16), jax_margin)


@pytest.mark.parametrize("family", FAMILIES)
def test_enhance_bf16_full_frame_matches_jax(family):
    """The deployed bf16 enhance of one full 576x752 frame, port against JAX,
    at the bar of the window test above. With this frame JAX's own bf16 is
    52.96 dB (conv3_heavy) or more from its fp32, so every family is held to
    50 dB: none falls to the min() branch."""
    fr = _frames((1, 576, 752, 4), seed=3)
    jfn = jax_enhance.enhance_from_onnx
    want16 = np.asarray(jfn(_artifact(family), donate=False)(jnp.asarray(fr)))
    want32 = np.asarray(jfn(_artifact(family), compute_dtype=jnp.float32,
                            donate=False)(jnp.asarray(fr)))
    got = tor_enhance.enhance_from_onnx(_artifact(family), device="cpu")(fr).numpy()
    assert got.shape == fr.shape and got.dtype == np.uint8
    jax_margin = psnr(want16, want32)
    assert jax_margin >= 50.0, (family, jax_margin)
    assert psnr(got, want16) >= min(50.0, jax_margin), (psnr(got, want16), jax_margin)


def test_enhance_refuses_the_graphs_jax_refuses():
    for path in ARTIFACTS:
        try:
            jax_enhance.enhance_from_onnx(os.path.join(REPO, path), donate=False)
        except ValueError:
            with pytest.raises(ValueError, match="lightweight"):
                tor_enhance.enhance_from_onnx(os.path.join(REPO, path), device="cpu")
            assert "pix_shuffle_heavy" in path
        else:
            tor_enhance.enhance_from_onnx(os.path.join(REPO, path), device="cpu")


def test_unet_structure_mismatch_raises(tmp_path):
    """A U-Net graph that matches neither variant's init is refused."""
    tree = params_to_numpy(get_model("residual_unet").init(
        torch.Generator().manual_seed(0), device="cpu"))
    del tree["enc1_block0"]["proj"]
    path = str(tmp_path / "unet.onnx")
    onnx_export.export_residual_unet_onnx(tree, get_model("residual_unet").config, path,
                                          frame_h=32, frame_w=48)
    with pytest.raises(ValueError, match="matches no residual_unet variant"):
        tor_enhance.enhance_from_onnx(path, device="cpu")


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _jax_params(name, seed=0):
    jm = jax_model(name)
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(seed)))


def _export_both(name, fp16, tmp_path, **kw):
    jm, tree = _jax_params(name)
    if name in ("conv3", "conv5"):
        tree = jax.tree_util.tree_map(np.asarray, jax_conv_stack.fuse(tree, jm.config))
    exporter = {"pix_shuffle": "export_pix_shuffle_onnx", "conv3": "export_conv_stack_onnx",
                "conv5": "export_conv_stack_onnx", "conv6": "export_conv6_onnx",
                "residual_unet": "export_residual_unet_onnx"}[name]
    a, b = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    getattr(jax_export, exporter)(tree, jm.config, a, fp16=fp16, **kw)
    getattr(onnx_export, exporter)(tree, get_model(name).config, b, fp16=fp16, **kw)
    return open(a, "rb").read(), open(b, "rb").read()


@pytest.mark.parametrize("fp16", [True, False], ids=["fp16", "fp32"])
@pytest.mark.parametrize("name,kw", [
    ("pix_shuffle", {}), ("pix_shuffle", {"crop_left": 0}), ("conv3", {}),
    ("conv5", {"relu_before_residual_add": True}), ("conv6", {}), ("residual_unet", {}),
])
def test_export_is_byte_identical_to_jax(name, kw, fp16, tmp_path):
    want, got = _export_both(name, fp16, tmp_path, **kw)
    assert len(got) > 1000 and got == want


@pytest.mark.parametrize("family", FAMILIES)
def test_reexport_of_a_shipped_graph_is_the_shipped_file(family, tmp_path):
    """The imported weights written back by the port's exporter, at the
    graph's own precision and wrapper (chip_smoke.reexport), are the shipped
    file byte for byte: the JAX exporter wrote all six."""
    out = cs.reexport(_artifact(family), str(tmp_path / "re.onnx"))
    assert open(out, "rb").read() == open(_artifact(family), "rb").read()


def test_runner_matches_jax_runner(tmp_path):
    jm, tree = _jax_params("conv6", seed=4)
    path = str(tmp_path / "conv6.onnx")
    onnx_export.export_conv6_onnx(tree, jm.config, path, fp16=True, frame_h=24, frame_w=32)
    fr = _frames((1, 24, 32, 4), seed=9)
    got = onnx_runner.run_model(path, {"input_rgba_chunky": fr})
    want = jax_runner.run_model(path, {"input_rgba_chunky": fr})
    assert list(got) == list(want) == ["output_rgba_uint8_chunky"]
    np.testing.assert_array_equal(got["output_rgba_uint8_chunky"],
                                  want["output_rgba_uint8_chunky"])
    outs = onnx_runner.verify_onnx_model(path, verbose=0)
    assert outs["output_rgba_uint8_chunky"].shape == (1, 24, 32, 4)


# ---------------------------------------------------------------------------
# the export CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["conv5", "conv6"])
def test_cli_exports_a_port_checkpoint(name, tmp_path, capsys):
    from fs_uae_image_enhancer_project_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer)
    from fs_uae_image_enhancer_project_tpu_torch.train.trainer import save_checkpoint

    m = get_model(name)
    params = m.init(torch.Generator().manual_seed(3), device="cpu")
    if name == "conv5":  # batchnorm stats away from their defaults
        for i in range(1, 6):
            params[f"bn{i}"]["mean"].uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(i))
            params[f"bn{i}"]["var"].uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(i))
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, init_train_state(params, make_optimizer(),
                                           has_batchnorm=name == "conv5"))
    out = str(tmp_path / f"{name}.onnx")
    rc = cli.main(["--checkpoint", ckpt, "--model_type", name, "--output", out,
                   "--device", "cpu"])
    printed = capsys.readouterr().out
    assert rc == 0, printed
    assert "cross-check PSNR" in printed
    want = params_to_numpy(conv_stack.fuse(params, m.config) if name == "conv5" else params)
    want16 = jax.tree_util.tree_map(lambda a: a.astype(np.float16).astype(np.float32), want)
    for imp in (onnx_import.import_any(out), jax_import.import_any(out)):
        # parameter-free slots carry no initializer
        _assert_trees_equal(imp.params, {k: v for k, v in want16.items() if v})


def test_cli_offers_no_stablehlo(tmp_path, capsys):
    """The name dates from before the port had the route. ``--stablehlo``
    now writes the port's torch.export program (.pt2) with JAX's per-family
    semantics: for pix_shuffle (its crop of 16) and conv3 (fused, sRGB, no
    crop) the reloaded 576x752 program gives the checkpoint's enhance byte
    for byte on a seeded frame."""
    from fs_uae_image_enhancer_project_tpu_torch.export.stablehlo import (
        artifact_meta, load_enhance)
    from fs_uae_image_enhancer_project_tpu_torch.parallel.train_step import (
        init_train_state, make_optimizer)
    from fs_uae_image_enhancer_project_tpu_torch.train.trainer import save_checkpoint

    frame = _frames((1, 576, 752, 4), seed=12)
    for name in ("pix_shuffle", "conv3"):
        m = get_model(name)
        params = m.init(torch.Generator().manual_seed(3), device="cpu")
        ckpt, pt2 = str(tmp_path / f"{name}_ckpt"), str(tmp_path / f"{name}.pt2")
        save_checkpoint(ckpt, init_train_state(params, make_optimizer(),
                                               has_batchnorm=name == "conv3"))
        rc = cli.main(["--checkpoint", ckpt, "--model_type", name, "--output",
                       str(tmp_path / f"{name}.onnx"), "--stablehlo", pt2, "--skip_verify",
                       "--device", "cpu"])
        printed = capsys.readouterr().out
        assert rc == 0 and f"wrote {pt2}" in printed, printed
        assert artifact_meta(pt2) == {"device": "cpu", "shape": [1, 576, 752, 4]}
        if name == "conv3":
            fused = conv_stack.fuse(params, m.config)
            enhance = tor_enhance.make_enhance_fn(
                lambda p, x: conv_stack.apply_fused(p, x, m.config), fused, crop_left=0,
                srgb_domain=True, device="cpu")
        else:
            enhance = tor_enhance.make_enhance_fn(m.apply, params, crop_left=16, device="cpu")
        got = load_enhance(pt2, device="cpu")(frame)
        assert torch.equal(got, enhance(frame))
        assert bool((got[:, :, :16, :3] == 0).all()) == (name == "pix_shuffle")


# ---------------------------------------------------------------------------
# the frame server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_sidecar_resolves_every_family(family):
    fn = sidecar.build_enhance_fn(model=family, device="cpu")
    fr = _frames((1, 32, 48, 4), seed=5)
    want = tor_enhance.enhance_from_onnx(_artifact(family), device="cpu")(fr)
    assert torch.equal(fn(fr), want)


def test_sidecar_process_serves_conv3_heavy(tmp_path):
    sock = str(tmp_path / "s.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar",
         "--socket", sock, "--model", "conv3_heavy", "--device", "cpu", "--depth", "0",
         "--height", "32", "--width", "48", "--quiet"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        ready, lines = wait_for_line(proc, "SIDECAR_READY", timeout=120)
        assert ready, lines
        client = sidecar.SidecarClient(sock, timeout=60.0)
        try:
            fr = _frames((32, 48, 4), seed=6)
            got = client.submit(fr)
            if got is None:
                (got,) = client.drain()
            client.shutdown_server()
        finally:
            client.close()
        want = tor_enhance.enhance_from_onnx(_artifact("conv3_heavy"), device="cpu")(fr[None])
        np.testing.assert_array_equal(got, want[0].numpy())
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# chip_smoke.py's families phase, rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_families_phase_on_the_cpu(monkeypatch):
    """The phase at a 48x80 frame (the CPU's own fp32 stands for the
    card's): every check passes, the re-exports are the shipped files, the
    U-Net is served byte-equal, no kernel of the repo is launched, and the
    timing rows carry GFLOP and a share of peak (CPU times, never device
    times)."""
    import statistics

    def median_ms(fn, n=50, warmup=10):  # CUDA events need a card
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    monkeypatch.setattr(cs, "median_ms", median_ms)
    monkeypatch.setattr(cs, "device_ms", lambda fn, n=50: {"ms": median_ms(fn)})
    cpu = torch.device("cpu")
    rec = cs.families(cpu, frame_hw=(48, 80), window=32, serve_frames=3)
    cs.check_families(rec)
    assert sorted(rec["families"]) == sorted(cs.FAMILIES)
    assert rec["served"] == dict(model="residual_unet", depth=2, frames=3, joined=True,
                                 byte_equal=True)
    assert rec["families"]["residual_unet"]["crop_left"] == 16
    assert rec["families"]["conv3"]["kind"] == "conv_stack"
    # the convolutions' GFLOP of a 48x80 frame: conv3 is 3->32->64->3, 3x3
    want = 2 * 9 * (3 * 32 + 32 * 64 + 64 * 3) * 48 * 80 / 1e9
    assert rec["families"]["conv3"]["gflop"] == pytest.approx(want)
    rows = cs.family_timing(cpu, rec["fns"], rec["frame"],
                            {k: r["gflop"] for k, r in rec["families"].items()})
    assert [r["family"] for r in rows] == list(cs.FAMILIES)
    for r in rows:
        assert r["bound_ms"] > 0 and r["share_of_peak"] > 0
        assert r["profiled_kernel_ms"] is None  # no device: no device time


# ---------------------------------------------------------------------------
# the ONNX text dump, the SVG render and the raw-frame runner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ARTIFACTS)
def test_onnx_dump_and_svg_equal_jax(path, tmp_path):
    """Every shipped graph: the text dump (whole and cut at 5 nodes) and the
    SVG equal JAX's, character for character."""
    from fs_uae_image_enhancer_project_tpu.export import onnx_dump as jax_dump
    from fs_uae_image_enhancer_project_tpu.export import onnx_svg as jax_svg
    from fs_uae_image_enhancer_project_tpu_torch.export import onnx_dump, onnx_svg

    full = os.path.join(REPO, path)
    for max_nodes in (None, 5):
        assert onnx_dump.dump(full, max_nodes) == jax_dump.dump(full, max_nodes)
    got = onnx_svg.render_file(full, str(tmp_path / "port.svg"))
    want = jax_svg.render_file(full, str(tmp_path / "jax.svg"))
    with open(got) as a, open(want) as b:
        text = a.read()
        assert text == b.read()
    assert text.startswith("<svg") and "Conv" in text and text.endswith("</svg>")


def test_onnx_tools_command_lines(tmp_path, capsys):
    from fs_uae_image_enhancer_project_tpu_torch.export import onnx_dump, onnx_svg

    path = _artifact("conv3")
    assert onnx_dump.main([path, "--max_nodes", "2"]) == 0
    out = capsys.readouterr().out
    assert out.startswith(f"model: {path}") and "more)" in out
    svg = str(tmp_path / "g.svg")
    assert onnx_svg.main([path, "--out", svg]) == 0
    assert capsys.readouterr().out.strip() == svg and os.path.getsize(svg) > 1000


def test_raw_runner_matches_jax(tmp_path, capsys):
    """A seeded 752x576 raw RGBA dump through the shipped pix_shuffle graph:
    the port's PNG on the CPU within the >= 50 dB contract of JAX's (the
    alpha equal), the PNG holds the returned frame, a wrong byte count and
    a model neither .onnx nor .pt2 raise, and a .pt2 program of the graph
    gives the .onnx route's PNG."""
    from PIL import Image

    from fs_uae_image_enhancer_project_tpu.export import raw_runner as jax_raw
    from fs_uae_image_enhancer_project_tpu_torch.export import raw_runner

    frame = _frames((576, 752, 4), seed=3)
    raw = str(tmp_path / "frame.raw")
    frame.tofile(raw)
    np.testing.assert_array_equal(raw_runner.load_raw_rgba(raw)[0], frame)
    onnx = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")
    png = str(tmp_path / "port.png")
    assert raw_runner.main(["--model", onnx, "--raw", raw, "--out", png, "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    got = np.asarray(Image.open(png))
    want = jax_raw.run_inference(onnx, raw, str(tmp_path / "jax.png"), verbose=0)[0]
    assert got.shape == want.shape == (576, 752, 4) and got.dtype == np.uint8
    assert psnr(got[..., :3], want[..., :3]) >= 50.0
    np.testing.assert_array_equal(got[..., 3], want[..., 3])
    again = raw_runner.run_inference(onnx, raw, str(tmp_path / "again.png"), verbose=0,
                                     device="cpu")
    np.testing.assert_array_equal(again[0], got)
    with pytest.raises(ValueError, match="bytes, expected"):
        raw_runner.load_raw_rgba(raw, width=96, height=64)
    with pytest.raises(ValueError, match=r"\.onnx graphs and \.pt2 torch\.export programs"):
        raw_runner.run_inference(str(tmp_path / "enhance.jaxexport"), raw, png, device="cpu")
    # the second route: a .pt2 program of the same graph gives the .onnx route's frame
    from fs_uae_image_enhancer_project_tpu_torch.export.stablehlo import export_enhance

    pt2 = export_enhance(tor_enhance.enhance_from_onnx(onnx, device="cpu"),
                         str(tmp_path / "pix_shuffle.pt2"), device="cpu")
    assert raw_runner.main(["--model", pt2, "--raw", raw, "--out", png, "--device", "cpu"]) == 0
    np.testing.assert_array_equal(np.asarray(Image.open(png)), again[0])
