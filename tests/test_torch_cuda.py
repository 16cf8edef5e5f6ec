"""The port on a CUDA card: K1 and K3 against their plain versions, the
enhance path, the frame stream, and the generator's device stage. Every test
here needs a card (marker ``gpu``) and skips without one. It imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: K1 within 6e-3 max and 6e-4 mean abs of the plain version's fp32
result (the kernel's approximate transcendentals and bf16 intermediates);
the enhanced frame within 50 dB of the same path with the plain stack;
K3 and the k-means palettes equal to their plain versions byte for byte.
"""
import os

import numpy as np
import pytest
import torch

from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import (
    BAYER_MATRIX_2X2, BAYER_MATRIX_4X4, BAYER_MATRIX_8X8)
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import (
    enhance_from_onnx, make_enhance_fn)
from fs_uae_image_enhancer_project_tpu_torch.export.streaming import FrameStream
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _params(device):
    return get_model("pix_shuffle").init(torch.Generator().manual_seed(0), device=device)


@pytest.mark.parametrize("h2,w2", [(288, 376), (288, 368), (10, 14), (17, 33), (1, 1)])
def test_kernel_matches_plain(cuda, h2, w2):
    sw = fs.prepare_weights(_params(cuda), cuda)
    u = torch.rand(h2, w2, 12, generator=torch.Generator().manual_seed(0))
    u = u.to(torch.bfloat16).to(cuda)
    before = fs.fused_stack.launches
    y = fs.fused_stack(u, sw).float()
    torch.cuda.synchronize()
    assert fs.fused_stack.launches == before + 1
    err = (y - fs.fused_stack_plain(u, sw, out_fp32=True)).abs()
    assert float(err.max()) <= 6e-3 and float(err.mean()) <= 6e-4


def test_kernel_is_deterministic_and_leaves_input_alone(cuda):
    sw = fs.prepare_weights(_params(cuda), cuda)
    u = torch.rand(40, 56, 12, generator=torch.Generator().manual_seed(1))
    u = u.to(torch.bfloat16).to(cuda)
    keep = u.clone()
    a, b = fs.fused_stack(u, sw), fs.fused_stack(u, sw)
    assert torch.equal(a, b) and torch.equal(u, keep)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    sw = fs.prepare_weights(_params(cuda), cuda)
    with pytest.raises(ValueError):
        fs.fused_stack(torch.zeros(8, 8, 12, device=cuda), sw)  # fp32
    with pytest.raises(ValueError):
        fs.fused_stack(torch.zeros(8, 16, 12, dtype=torch.bfloat16, device=cuda)[:, ::2], sw)
    with pytest.raises(ValueError):
        fs.fused_stack(torch.zeros(8, 8, 12, dtype=torch.bfloat16, device=cuda),
                       fs.prepare_weights(_params("cpu"), "cpu"))
    heavy = get_model("pix_shuffle", "heavyweight")
    with pytest.raises(ValueError):
        heavy.apply(heavy.init(device=cuda), torch.zeros(1, 16, 16, 3, device=cuda))


def test_enhance_runs_the_kernel_and_matches_the_plain_stack(cuda):
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax

    frames = np.random.default_rng(0).integers(0, 256, (1, 576, 752, 4), dtype=np.uint8)
    before = fs.fused_stack.launches
    out = enhance_from_onnx(ONNX, device=cuda)(frames).cpu().numpy()
    assert fs.fused_stack.launches == before + 1
    imp = import_pix_shuffle(ONNX)
    plain = make_enhance_fn(
        fs.fused_stack_apply_plain, params_from_jax(imp.params, device=cuda),
        crop_left=imp.crop_left, srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
        linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=cuda)(frames)
    mse = np.mean((out.astype(np.float64) - plain.cpu().numpy()) ** 2)
    assert out.shape == (1, 576, 752, 4) and (out[..., 3] == 255).all()
    assert 10 * np.log10(255.0**2 / max(mse, 1e-12)) >= 50.0


@pytest.mark.parametrize("depth", [1, 2])
def test_frame_stream_on_cuda_streams(cuda, depth):
    fn = enhance_from_onnx(ONNX, device=cuda)
    frames = np.random.default_rng(1).integers(0, 256, (4, 576, 752, 4), dtype=np.uint8)
    stream = FrameStream(fn, depth=depth, device=cuda)
    outs = [stream.submit(f) for f in frames]
    assert all(o is None for o in outs[:depth])
    outs = [o for o in outs if o is not None] + list(stream.drain())
    assert len(outs) == 4
    for f, o in zip(frames, outs):
        np.testing.assert_array_equal(o, fn(f[None]).cpu().numpy())


K3_MODES = [("none", None), ("checkerboard", None), ("ordered", BAYER_MATRIX_2X2),
            ("ordered", BAYER_MATRIX_4X4), ("ordered", BAYER_MATRIX_8X8)]


def _k3_inputs(b, h, w, n, seed):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    imgs[::2] = imgs[::2] // 16 * 16  # every other crop on the RGB444 grid
    pals = rng.integers(0, 256, (b, n, 3), dtype=np.uint8)
    imgs[:, 0, :2] = pals[:, :2]  # pixels that sit on a palette colour
    return torch.from_numpy(imgs), torch.from_numpy(pals)


@pytest.mark.parametrize("n", [2, 32, 256, 1024])
@pytest.mark.parametrize("mode", range(len(K3_MODES)))
def test_k3_matches_plain_byte_for_byte(cuda, n, mode):
    method, bayer = K3_MODES[mode]
    # 4 lores crops (188x144) and a crop whose pixel count is not a multiple
    # of the kernel's 256-pixel block (37 x 29 = 1073)
    for shape in ((4, 144, 188), (1, 29, 37)):
        imgs, pals = _k3_inputs(*shape, n, seed=n + mode)
        imgs, pals = imgs.to(cuda), pals.to(cuda)
        before = k3.palette_dither.launches
        got = k3.palette_dither(imgs, pals, method, bayer)
        torch.cuda.synchronize()
        assert k3.palette_dither.launches == before + 1
        want = k3.palette_dither_plain(imgs, pals, method, bayer)
        assert torch.equal(got, want), int((got != want).any(-1).sum())
        cpu = k3.palette_dither_plain(imgs.cpu(), pals.cpu(), method, bayer)
        assert torch.equal(got.cpu(), cpu)


def test_k3_refuses_what_the_kernel_does_not_take(cuda):
    imgs, pals = _k3_inputs(2, 8, 8, 16, seed=0)
    imgs, pals = imgs.to(cuda), pals.to(cuda)
    with pytest.raises(ValueError):
        k3.palette_dither(imgs.float(), pals)  # float pixels: plain version only
    with pytest.raises(ValueError):
        k3.palette_dither(imgs[:, :, ::2], pals)  # not contiguous
    with pytest.raises(ValueError):
        k3.palette_dither(imgs, pals.cpu())
    with pytest.raises(ValueError):
        k3.palette_dither(imgs, pals[:, :1])


def test_kmeans_on_the_card_equals_the_cpu(cuda):
    from fs_uae_image_enhancer_project_tpu_torch.datagen.quantize import (
        generate_palettes_kmeans_torch_batch)

    rng = np.random.default_rng(0)
    stacks = (rng.integers(0, 16, (4, 144 * 188, 3)) * 16).astype(np.float32)
    for k in (64, 256):
        got = generate_palettes_kmeans_torch_batch(stacks, k, device=cuda)
        want = generate_palettes_kmeans_torch_batch(stacks, k, device="cpu")
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


def test_device_batched_stage_on_the_card(cuda):
    from fs_uae_image_enhancer_project_tpu_torch.datagen.device_batch import (
        style_batch_on_device)

    rng = np.random.default_rng(1)
    arrs = rng.integers(0, 256, (3, 144, 188, 3), dtype=np.uint8)
    before = k3.palette_dither.launches
    got = style_batch_on_device(arrs, 64, "ordered", BAYER_MATRIX_4X4, "kmeans_torch", cuda)
    assert k3.palette_dither.launches == before + 1
    want = style_batch_on_device(arrs, 64, "ordered", BAYER_MATRIX_4X4, "kmeans_torch", "cpu")
    np.testing.assert_array_equal(got, want)
