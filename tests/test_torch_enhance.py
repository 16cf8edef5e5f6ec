"""The port's enhance slice against the JAX package's, on the CPU.

ONNX import of the shipped artifact (arrays equal), make_enhance_fn in fp32
(<= 1 LSB, >= 50 dB) and bf16 (>= 50 dB), the whole slice on a full
576x752 frame (>= 50 dB, README's contract), the entry points' device rules,
and the import rule: the port and chip_smoke.py import neither jax nor the
JAX package.
"""
import ast
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conftest import psnr
from fs_uae_image_enhancer_project_tpu.export import enhance as jax_enhance
from fs_uae_image_enhancer_project_tpu.export import onnx_import as jax_import
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu_torch.export import enhance as tor_enhance
from fs_uae_image_enhancer_project_tpu_torch.export import onnx_import as tor_import
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda.fused_stack import fused_stack_apply_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")
PORT = os.path.join(REPO, "fs_uae_image_enhancer_project_tpu_torch")


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_onnx_import_equals_jax_import():
    want = jax_import.import_pix_shuffle(ONNX)
    got = tor_import.import_pix_shuffle(ONNX)
    assert got.kind == want.kind == "pix_shuffle"
    assert got.crop_left == want.crop_left == 0
    assert got.srgb_to_linear_exponent == want.srgb_to_linear_exponent
    assert got.linear_to_srgb_exponent == want.linear_to_srgb_exponent
    assert got.linear_to_srgb_exponent == pytest.approx(0.4546, abs=1e-4)
    assert got.num_conv_layers == want.num_conv_layers == 7
    assert sorted(got.params) == sorted(want.params)
    for slot, leaves in want.params.items():
        assert sorted(got.params[slot]) == sorted(leaves)
        for leaf, arr in leaves.items():
            assert got.params[slot][leaf].dtype == np.float32
            np.testing.assert_array_equal(got.params[slot][leaf], arr)


def test_artifact_kind_routes_other_families_to_later_slices():
    """Every shipped graph routes to its family's importer, as the JAX
    package's ``import_any`` routes it, and ``enhance_from_onnx`` builds
    its enhance fn on that family's model (the heavy pix_shuffle graphs,
    which JAX refuses too, aside)."""
    import glob

    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_proto import load_model

    paths = sorted(glob.glob(os.path.join(REPO, "artifacts", "model_*", "*.onnx")))
    assert len(paths) == 11
    kinds = {}
    for path in paths:
        kind = tor_import.artifact_kind(load_model(path))
        assert kind == tor_import.import_any(path).kind == jax_import.import_any(path).kind
        kinds[os.path.basename(path)] = kind
        if "pix_shuffle_heavy" in path:
            with pytest.raises(ValueError, match="lightweight"):
                tor_enhance.enhance_from_onnx(path, device="cpu")
            continue
        fn = tor_enhance.enhance_from_onnx(path, device="cpu")
        out = fn(_frames((1, 16, 32, 4), seed=len(kinds)))
        assert out.shape == (1, 16, 32, 4) and out.dtype == torch.uint8
    assert kinds["conv3.onnx"] == kinds["conv5_heavy.onnx"] == "conv_stack"
    assert kinds["conv6.onnx"] == "conv6"
    assert kinds["residual_unet.onnx"] == "residual_unet"
    assert kinds["pix_shuffle.onnx"] == "pix_shuffle"


def _both(crop_left, compute_dtype_jax, compute_dtype_torch, seed=0):
    jm = jax_model("pix_shuffle")
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(seed)))
    jfn = jax_enhance.make_enhance_fn(jm.apply, tree, crop_left=crop_left,
                                      compute_dtype=compute_dtype_jax, donate=False)
    m = get_model("pix_shuffle")
    tfn = tor_enhance.make_enhance_fn(m.apply, params_from_jax(tree, device="cpu"),
                                      crop_left=crop_left,
                                      compute_dtype=compute_dtype_torch, device="cpu")
    return jfn, tfn


@pytest.mark.parametrize("crop_left", [16, 0])
def test_make_enhance_fn_fp32_matches_jax(crop_left):
    jfn, tfn = _both(crop_left, jnp.float32, torch.float32)
    fr = _frames((2, 48, 80, 4), seed=crop_left)
    want = np.asarray(jfn(jnp.asarray(fr)))
    got = tfn(fr).numpy()
    assert got.shape == fr.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert psnr(got, want) >= 50.0
    np.testing.assert_array_equal(got[..., 3], 255)
    np.testing.assert_array_equal(got[:, :, :crop_left, :3], 0)


def test_make_enhance_fn_bf16_matches_jax():
    jfn, tfn = _both(16, jnp.bfloat16, torch.bfloat16, seed=1)
    fr = _frames((1, 64, 96, 4), seed=5)
    assert psnr(tfn(fr).numpy(), np.asarray(jfn(jnp.asarray(fr)))) >= 50.0


def test_make_enhance_fn_rejects_bad_frames():
    _, tfn = _both(0, jnp.float32, torch.float32)
    with pytest.raises(ValueError):
        tfn(np.zeros((1, 8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        tfn(np.zeros((1, 8, 8, 4), np.float32))


@pytest.mark.parametrize("stack", ["model", "k1_plain"])
def test_whole_slice_full_frame_matches_jax(stack):
    """enhance_from_onnx on one 576x752 frame, port vs JAX, >= 50 dB. "model"
    is the port's CPU path (eager forward); "k1_plain" swaps in the plain
    version of the fused-stack kernel, the function the card runs."""
    fr = _frames((1, 576, 752, 4), seed=11)
    want = np.asarray(jax_enhance.enhance_from_onnx(ONNX, donate=False)(jnp.asarray(fr)))
    if stack == "model":
        fn = tor_enhance.enhance_from_onnx(ONNX, device="cpu")
    else:
        imp = tor_import.import_pix_shuffle(ONNX)
        fn = tor_enhance.make_enhance_fn(
            fused_stack_apply_plain, params_from_jax(imp.params, device="cpu"),
            crop_left=imp.crop_left, srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
            linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device="cpu")
    got = fn(fr).numpy()
    assert got.shape == (1, 576, 752, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got[..., 3], 255)
    assert psnr(got, want) >= 50.0


def test_default_enhance_fn_is_seeded():
    fn, params = tor_enhance.default_enhance_fn(seed=3, device="cpu", crop_left=0)
    _, again = tor_enhance.default_enhance_fn(seed=3, device="cpu")
    assert torch.equal(params["conv1"]["w"], again["conv1"]["w"])
    out = fn(_frames((1, 16, 24, 4)))
    assert out.shape == (1, 16, 24, 4) and out.dtype == torch.uint8


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from fs_uae_image_enhancer_project_tpu_torch import resolve_device
    from fs_uae_image_enhancer_project_tpu_torch.runtime import sidecar

    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tor_enhance.enhance_from_onnx(ONNX)
    with pytest.raises(RuntimeError, match="CUDA"):
        tor_enhance.default_enhance_fn()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_model("pix_shuffle").init()
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        sidecar.build_enhance_fn()


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


# the kernel benches' slice: its modules are among those checked
NEW_MODULES = ("utils.profiler", "utils.threefry", "ops.cuda.fused_stack_packed",
               "ops.cuda.lane_packing", "scripts.bench_fused_stack", "scripts.bench_lane_packing",
               "losses.vgg", "losses.perceptual", "losses.ssim", "models.conv_stack",
               "data.dataset", "parallel.train_step", "train.trainer", "train.cli",
               "utils.subproc", "runtime.sidecar_replay", "models.summary", "models.benchmark",
               "parallel.mesh", "parallel.spatial", "parallel.inference", "parallel.dryrun",
               "datagen.rgb444_flat", "datagen.prepare_groundtruth", "nas.search",
               "nas.fps_cache", "nas.studies", "nas.prune_failed", "nas.visualize",
               "losses.vgg_selftrain", "export.onnx_dump", "export.onnx_svg",
               "export.raw_runner", "export.stablehlo", "export.quantized", "export.qat",
               "utils.platform", "scripts.bench_int8_qat",
               "benchmark_tools.benchmark_activation_functions",
               "benchmark_tools.benchmark_kernel_sizes",
               "benchmark_tools.benchmark_search_channels", "benchmark_tools.gamma_plot",
               "runtime.client", "scripts.common", "scripts.make_gt_frames",
               "scripts.bench_generator_e2e", "scripts.bench_sidecar_multiclient",
               "scripts.bench_families", "scripts.bench_conv6_latency",
               "scripts.eval_headtohead", "scripts.precompile", "scripts.build_artifacts",
               "scripts.probe_fp32_grad", "train.gradcheck", "scripts.train_psh_long",
               "scripts.train_psh_heavy_long", "scripts.training_parity_study",
               "scripts.plot_training_parity", "scripts.train_nas_winner",
               "scripts.train_vgg_features", "scripts.nas_demo_r2",
               "scripts.convert_vgg16_weights", "scripts.probe_transfer_retention")


def test_port_chip_smoke_and_card_tests_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "test_torch_cuda.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for new in NEW_MODULES:
        assert os.path.join(PORT, *new.split(".")) + ".py" in files, new
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top != "jax" and top != "jaxlib", (path, mod)
            assert top != "fs_uae_image_enhancer_project_tpu", (path, mod)
            if path.startswith(PORT):  # nor the root harness or the root scripts/
                assert top not in ("chip_smoke", "scripts", "bench"), (path, mod)
    code = (
        "import importlib, pkgutil, sys\n"
        "import fs_uae_image_enhancer_project_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'fs_uae_image_enhancer_project_tpu')]\n"
        "assert not bad, bad\n"
        f"need = {NEW_MODULES!r}\n"
        "assert all(p.__name__ + '.' + n in sys.modules for n in need)\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_port_recipes_name_no_jax_package_or_root_script():
    """The port's run recipes start the port's modules through ``$PYTHON``
    (``python3`` by default) and name nothing of the JAX package and no root
    ``scripts/`` file."""
    recipes = sorted(glob.glob(os.path.join(PORT, "recipes", "*.sh")))
    root = sorted(glob.glob(os.path.join(REPO, "recipes", "*.sh")))
    assert [os.path.basename(r) for r in recipes] == [os.path.basename(r) for r in root]
    assert len(recipes) == 14
    for path in recipes:
        with open(path) as f:
            text = f.read()
        assert "fs_uae_image_enhancer_project_tpu." not in text, path
        assert not re.search(r"(^|[\s\"'/.])scripts/", text), path
        assert "jax" not in text.lower(), path
        runs = re.findall(r'"\$\{PYTHON:-python3\}" -m (\S+)', text)
        assert runs and all(m.startswith("fs_uae_image_enhancer_project_tpu_torch.")
                            for m in runs), path
        assert not re.search(r"(^|\s)python3? ", text, re.M), path


def test_chip_smoke_fails_without_a_card():
    """No card: exit non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
