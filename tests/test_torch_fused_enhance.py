"""K1's enhance entry on the CPU (``ops/cuda/fused_enhance.py``): its two
tables against ``export/enhance.py``'s prologue and epilogue, its load and
store index maps against pixel (un)shuffle, its plain version byte-equal to
the composition it replaces, and its route (the kernel on a card, the
composition under ``torch.export`` and on the CPU). The kernel itself runs
only on a card: tests/test_torch_cuda.py holds it to the composition there.
"""
import os

import numpy as np
import pytest
import torch

from fs_uae_image_enhancer_project_tpu_torch.export.enhance import (
    enhance_from_onnx, make_enhance_fn, to_model_input, to_uint8)
from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_enhance as fe
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
from fs_uae_image_enhancer_project_tpu_torch.ops.pixel_shuffle import (
    pixel_shuffle, pixel_unshuffle)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = os.path.join(REPO, "artifacts")
ONNX = os.path.join(ARTIFACTS, "model_pix_shuffle", "pix_shuffle.onnx")


@pytest.fixture(scope="module")
def shipped():
    imp = import_pix_shuffle(ONNX)
    gamma = dict(srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
                 linear_to_srgb_exponent=imp.linear_to_srgb_exponent)
    return params_from_jax(imp.params, device="cpu"), gamma


def _frames(n, h=48, w=80, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 4), dtype=np.uint8)


def test_the_prologue_table_is_the_prologue_of_every_byte(shipped):
    _, gamma = shipped
    t = fe.make_tables("cpu", **gamma)
    assert t.lut_in.dtype == torch.bfloat16 and t.lut_in.shape == (256,)
    # every byte in every colour and at many positions of a frame
    frames = torch.from_numpy(np.stack([np.roll(np.arange(256, dtype=np.uint8), s)
                                        for s in range(12)]).reshape(1, 4, 768, 1))
    frames = frames.expand(1, 4, 768, 3)
    want = to_model_input(frames, exponent=gamma["srgb_to_linear_exponent"])
    assert torch.equal(t.lut_in[frames.long()], want)
    assert t.lut_in[0] == 0 and t.lut_in[255] == 1


@pytest.mark.parametrize("srgb_domain", [False, True])
def test_the_epilogue_table_is_relu_and_the_epilogue_of_every_bf16(shipped, srgb_domain):
    _, gamma = shipped
    t = fe.make_tables("cpu", srgb_domain=srgb_domain, **gamma)
    assert t.lut_out.dtype == torch.uint8 and t.lut_out.shape == (1 << 16,)
    bits = torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(np.int16))
    v = bits.view(torch.bfloat16).reshape(16, 64, 64)  # a frame-like shape
    want = to_uint8(torch.relu(v), srgb_domain=srgb_domain,
                    exponent=gamma["linear_to_srgb_exponent"])
    assert torch.equal(t.lut_out.reshape(16, 64, 64), want)
    finite = torch.isfinite(v.float()).reshape(-1)
    negative = (v.float() < 0).reshape(-1) & finite
    assert (t.lut_out[negative] == 0).all()  # relu
    one = int(torch.tensor(1.0, dtype=torch.bfloat16).view(torch.int16)) & 0xFFFF
    assert t.lut_out[one] == 255


@pytest.mark.parametrize("crop", [0, 16])
def test_the_load_map_is_pixel_unshuffle_of_the_cropped_frame(crop):
    frames = torch.from_numpy(_frames(2, seed=1))
    h2, w2 = 48 // 2, (80 - crop) // 2
    r, col, c = fe.unshuffle_map(h2, w2, crop)
    want = pixel_unshuffle(frames[:, :, crop:, :3], 2)
    assert torch.equal(frames[:, r, col, c], want)


@pytest.mark.parametrize("crop", [0, 16])
def test_the_store_map_is_pixel_shuffle(crop):
    y = torch.rand(2, 24, (80 - crop) // 2, 12, generator=torch.Generator().manual_seed(2))
    r, col, k = fe.shuffle_map(48, 80, crop)
    assert torch.equal(y[:, r, col, k], pixel_shuffle(y, 2))


@pytest.mark.parametrize("crop", [0, 16])
def test_the_plain_version_writes_the_crop_strip_and_alpha(shipped, crop):
    params, gamma = shipped
    t = fe.make_tables("cpu", **gamma)
    out = fe.fused_enhance_plain(torch.from_numpy(_frames(1, seed=3)), t,
                                 fs.prepare_weights(params, "cpu"), crop)
    assert out.shape == (1, 48, 80, 4) and out.dtype == torch.uint8
    assert (out[:, :, :crop, :3] == 0).all() and (out[..., 3] == 255).all()


@pytest.mark.parametrize("crop", [0, 16])
@pytest.mark.parametrize("batch", [1, 3])
def test_the_fused_path_equals_the_composition_over_the_plain_stack(shipped, batch, crop):
    """The kernel's function (tables, index maps, K1's plain version) is the
    composition's, byte for byte."""
    params, gamma = shipped
    fn = fe.make_fused_enhance_fn(params, crop_left=crop, device="cpu", **gamma)
    assert isinstance(fn, fe.FusedEnhance)
    frames = _frames(batch, seed=4 + batch)
    want = make_enhance_fn(fs.fused_stack_apply_plain, params, crop_left=crop, device="cpu",
                           **gamma)(frames)
    assert torch.equal(fn.fused(frames), want)


def test_on_the_cpu_a_call_is_the_composition(shipped):
    params, gamma = shipped
    fn = fe.make_fused_enhance_fn(params, crop_left=16, device="cpu", **gamma)
    frames = _frames(2, seed=6)
    want = make_enhance_fn(get_model("pix_shuffle").apply, params, crop_left=16, device="cpu",
                           **gamma)(frames)
    assert torch.equal(fn(frames), want)


def test_under_tracing_a_call_is_the_composition(shipped):
    """With the route set as on a card, a call outside a trace takes the
    fused path and ``torch.export`` traces the composition."""
    params, gamma = shipped
    fn = fe.make_fused_enhance_fn(params, crop_left=0, device="cpu", **gamma)
    taken = []

    def fused(frames):
        taken.append(frames.shape)
        return torch.zeros_like(frames)

    fn.on_card, fn.fused = True, fused
    frames = torch.from_numpy(_frames(1, seed=7))
    fn(frames)
    assert taken == [frames.shape]

    class Enhance(torch.nn.Module):
        def forward(self, x):
            return fn(x)

    program = torch.export.export(Enhance(), (frames,), strict=False)
    assert taken == [frames.shape]
    assert torch.equal(program.module()(frames), fn.composition(frames))


def test_a_fused_call_checks_its_frames(shipped):
    params, gamma = shipped
    fn = fe.make_fused_enhance_fn(params, crop_left=16, device="cpu", **gamma)
    for bad in (np.zeros((1, 48, 80, 3), np.uint8), np.zeros((1, 47, 80, 4), np.uint8),
                np.zeros((1, 48, 81, 4), np.uint8), np.zeros((1, 48, 16, 4), np.uint8),
                np.zeros((48, 80, 4), np.uint8), np.zeros((1, 48, 80, 4), np.float32)):
        with pytest.raises(ValueError):
            fn.fused(bad)


def test_what_the_entry_does_not_take_stays_the_composition(shipped):
    params, gamma = shipped
    for kw in (dict(compute_dtype=torch.float32), dict(crop_left=15)):
        fn = fe.make_fused_enhance_fn(params, device="cpu", **gamma, **kw)
        assert not isinstance(fn, fe.FusedEnhance) and callable(fn)


def test_enhance_from_onnx_routes_pix_shuffle_to_the_fused_path():
    assert isinstance(enhance_from_onnx(ONNX, device="cpu"), fe.FusedEnhance)
    assert not isinstance(enhance_from_onnx(ONNX, device="cpu", compute_dtype=torch.float32),
                          fe.FusedEnhance)
    conv6 = enhance_from_onnx(os.path.join(ARTIFACTS, "model_conv6", "conv6.onnx"), device="cpu")
    assert not isinstance(conv6, fe.FusedEnhance)
    assert conv6.__qualname__.startswith("make_enhance_fn")
