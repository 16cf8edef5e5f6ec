"""The port on a CUDA card: K1 against its plain version, the enhance path
and the frame stream. Every test here needs a card (marker ``gpu``) and skips
without one. It imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: K1 within 6e-3 max and 6e-4 mean abs of the plain version's fp32
result (the kernel's approximate transcendentals and bf16 intermediates);
the enhanced frame within 50 dB of the same path with the plain stack.
"""
import os

import numpy as np
import pytest
import torch

from fs_uae_image_enhancer_project_tpu_torch.export.enhance import (
    enhance_from_onnx, make_enhance_fn)
from fs_uae_image_enhancer_project_tpu_torch.export.streaming import FrameStream
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
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
