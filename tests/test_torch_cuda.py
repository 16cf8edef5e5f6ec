"""The port on a CUDA card: K1, K2, K3 and K4 against their plain versions,
the forward's route by config and dtype, the enhance path (K1's enhance entry
byte-equal to K1's bf16 entry with the eager glue), the frame stream,
the generator's device stage, the pinned prefetch and the train step (which
never launches K1). Every test
here needs a card (marker ``gpu``) and skips without one. It imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: K1 and K2 within 6e-3 max and 6e-4 mean abs of their plain
versions' fp32 results (the kernels' approximate transcendentals and bf16
intermediates); K4's accumulator within 1e-3 of its largest value and its
output within 1e-6 (mma sums in another order than the plain product);
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
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_enhance as fe
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4

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
        fs.fused_stack_apply(heavy.init(device=cuda), torch.zeros(1, 16, 16, 3, device=cuda),
                             cfg=heavy.config)
    with pytest.raises(ValueError):  # the lightweight bf16 route: K1 takes even H and W
        get_model("pix_shuffle").apply(_params(cuda), torch.zeros(1, 15, 16, 3, device=cuda,
                                                                  dtype=torch.bfloat16))


@pytest.mark.parametrize("entry,pk", [("fse_fused_stack", 1), ("fse_fused_stack_packed", 2),
                                      ("fse_fused_stack_u8", 1)])
def test_compiled_kernel_follows_the_plan(cuda, entry, pk):
    """The compiled kernel's tile, threads, shared memory and ring are those
    of ops/cuda/fused_stack_plan.py, which the CPU tests check."""
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_plan as plan

    info = fs.kernel_info(entry, cuda)
    assert info["dynamic_smem"] == plan.smem_bytes(pk) <= plan.SMEM_LIMIT
    assert (info["tile_rows"], info["tile_cols"]) == plan.TILE
    assert info["threads"] == 32 * plan.NWARPS
    assert info["ring3_bytes"] == plan.smem(pk)["ring3"][1]


@pytest.mark.parametrize("h2,w2", [(288, 376), (288, 368), (10, 14), (17, 33), (1, 1)])
def test_k2_matches_plain(cuda, h2, w2):
    sw = k2.prepare_weights(_params(cuda), cuda)
    u = torch.rand(h2, w2, 12, generator=torch.Generator().manual_seed(2))
    u = u.to(torch.bfloat16).to(cuda)
    before = k2.fused_stack_packed.launches
    y = k2.fused_stack_packed(u, sw).float()
    torch.cuda.synchronize()
    assert k2.fused_stack_packed.launches == before + 1
    err = (y - k2.fused_stack_packed_plain(u, sw, out_fp32=True)).abs()
    assert float(err.max()) <= 6e-3 and float(err.mean()) <= 6e-4


def test_k2_is_deterministic_and_takes_a_batch(cuda):
    sw = k2.prepare_weights(_params(cuda), cuda)
    u = torch.rand(2, 40, 56, 12, generator=torch.Generator().manual_seed(3))
    u = u.to(torch.bfloat16).to(cuda)
    keep = u.clone()
    a, b = k2.fused_stack_packed(u, sw), k2.fused_stack_packed(u, sw)
    assert torch.equal(a, b) and torch.equal(u, keep)
    assert torch.equal(a[1], k2.fused_stack_packed(u[1].contiguous(), sw))
    with pytest.raises(ValueError):
        k2.fused_stack_packed(u.float(), sw)


@pytest.mark.parametrize("m,k,n", [(9216, 648, 72), (3072, 1296, 216), (100, 50, 9)])
def test_k4_accumulator_matches_plain(cuda, m, k, n):
    rng = np.random.default_rng(m)
    a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32)).to(torch.bfloat16)
    w = w.to(cuda)
    before = k4.lane_packing_mm.launches
    o, acc = k4.lane_packing_mm(a, w, 3)
    torch.cuda.synchronize()
    assert k4.lane_packing_mm.launches == before + 1
    po, pacc = k4.lane_packing_mm_plain(a, w, 3)
    assert float((acc - pacc).abs().max()) <= 1e-3 * float(pacc.abs().max())
    assert float((o - po).abs().max()) <= 1e-6
    o2, acc2 = k4.lane_packing_mm(a, w, 3)
    assert torch.equal(o, o2) and torch.equal(acc, acc2)


@pytest.mark.parametrize("case", k4.CASES, ids=[f"{c[0]}-{c[1]}" for c in k4.CASES])
def test_k4_every_case_matches_plain(cuda, case):
    """The bench's 12 cases at grid 2, each through its plan (resident or
    streamed ring, its wgmma N)."""
    _l, _v, m, k, n = case
    rng = np.random.default_rng(k + n)
    a = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.normal(0, 0.05, (k, n)).astype(np.float32)).to(torch.bfloat16)
    o, acc = k4.lane_packing_mm(a, w.to(cuda), 2)
    po, pacc = k4.lane_packing_mm_plain(a, w.to(cuda), 2)
    assert float((acc - pacc).abs().max()) <= 1e-3 * float(pacc.abs().max())
    assert float((o - po).abs().max()) <= 1e-6


def test_k4_instantiations_do_not_spill_and_follow_the_plan(cuda):
    for nc in k4.WIDTHS:
        info = k4.kernel_info(k4.TilePlan(1, nc, 1, 1, 1, 1, True, 0), cuda)
        assert info["local_bytes"] == 0 and info["threads"] == k4.THREADS, (nc, info)
        assert info["chains"] == k4.WIDTHS[nc]
    for case in k4.CASES:
        plan = k4.tile_plan(*case[2:])
        info = k4.kernel_info(plan, cuda)
        assert info["dynamic_smem"] == plan.smem <= k4.SMEM_LIMIT, (case, info)


def test_heavyweight_runs_on_the_card_through_the_eager_forward(cuda):
    heavy = get_model("pix_shuffle", "heavyweight")
    params = heavy.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand(2, 32, 48, 3, generator=torch.Generator().manual_seed(4))
    want = heavy.apply(params, x)
    on_card = {k: {kk: vv.to(cuda) for kk, vv in v.items()} for k, v in params.items()}
    before = fs.fused_stack.launches
    got = heavy.apply(on_card, x.to(cuda)).cpu()
    assert fs.fused_stack.launches == before
    assert float((got - want).abs().max()) <= 1e-4  # fp32 on both, TF32 off


def test_a_batch_of_two_through_k1_equals_two_frames(cuda):
    m = get_model("pix_shuffle")
    params = _params(cuda)
    x = torch.rand(2, 64, 96, 3, generator=torch.Generator().manual_seed(5)).to(cuda)
    x = x.to(torch.bfloat16)
    before = fs.fused_stack.launches
    both = m.apply(params, x)
    assert fs.fused_stack.launches == before + 1
    assert torch.equal(both[0:1], m.apply(params, x[0:1]))
    assert torch.equal(both[1:2], m.apply(params, x[1:2]))


def test_fp32_enhance_does_not_run_k1(cuda):
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax

    frames = np.random.default_rng(2).integers(0, 256, (2, 576, 752, 4), dtype=np.uint8)
    fn = enhance_from_onnx(ONNX, device=cuda, compute_dtype=torch.float32)
    before = fs.fused_stack.launches
    out = fn(frames).cpu().numpy()
    assert fs.fused_stack.launches == before
    imp = import_pix_shuffle(ONNX)
    cpu = make_enhance_fn(get_model("pix_shuffle").apply, params_from_jax(imp.params, device="cpu"),
                          crop_left=imp.crop_left, compute_dtype=torch.float32,
                          srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
                          linear_to_srgb_exponent=imp.linear_to_srgb_exponent,
                          device="cpu")(frames).numpy()
    assert np.abs(out.astype(int) - cpu.astype(int)).max() <= 1  # fp32 on both: truncation LSB


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


def _shipped_pair(device, crop):
    """The shipped pix_shuffle graph's weights at ``crop``: K1's enhance
    entry, and the composition it replaces (K1's bf16 entry with the eager
    prologue, unshuffle, shuffle, add, relu and epilogue)."""
    from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax

    imp = import_pix_shuffle(ONNX)
    params = params_from_jax(imp.params, device=device)
    kw = dict(crop_left=crop, srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
              linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=device)
    return (fe.make_fused_enhance_fn(params, **kw),
            make_enhance_fn(get_model("pix_shuffle").apply, params, **kw))


@pytest.mark.parametrize("crop", [0, 16])
@pytest.mark.parametrize("batch", [1, 2, 8])
def test_fused_enhance_is_byte_equal_to_the_composition(cuda, batch, crop):
    fused, composition = _shipped_pair(cuda, crop)
    assert isinstance(fused, fe.FusedEnhance)
    frames = np.random.default_rng(0).integers(0, 256, (8, 576, 752, 4), dtype=np.uint8)
    for i in range(0, 8, batch):
        got = fused(frames[i:i + batch])
        assert got.is_cuda and got.shape == (batch, 576, 752, 4)
        assert torch.equal(got, composition(frames[i:i + batch]))


@pytest.mark.parametrize("crop", [0, 16])
def test_fused_enhance_is_byte_equal_on_a_ragged_frame(cuda, crop):
    """Neither half-res side a multiple of K1's 16x14 tile, frames already on
    the card."""
    fused, composition = _shipped_pair(cuda, crop)
    frames = np.random.default_rng(1).integers(0, 256, (3, 98, 190, 4), dtype=np.uint8)
    frames = torch.from_numpy(frames).to(cuda)
    assert torch.equal(fused(frames), composition(frames))


def test_fused_enhance_counts_one_launch_a_call(cuda):
    fused, _ = _shipped_pair(cuda, 0)
    frames = np.random.default_rng(2).integers(0, 256, (2, 96, 128, 4), dtype=np.uint8)
    before, before_u8 = fs.fused_stack.launches, fs.fused_stack.u8_launches
    for _ in range(3):
        fused(frames)
    assert fs.fused_stack.launches == before + 3
    assert fs.fused_stack.u8_launches == before_u8 + 3


def test_fused_enhance_runs_no_other_kernel(cuda):
    """One call on device frames is one kernel, K1's enhance entry: no glue,
    no copy."""
    from torch.profiler import ProfilerActivity, profile

    fused, _ = _shipped_pair(cuda, 16)
    frames = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, (1, 576, 752, 4), dtype=np.uint8)).to(cuda)
    fused(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused(frames)
        torch.cuda.synchronize()
    on_device = [e.name for e in prof.events()  # the spans' own marks aside
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.name.startswith("fse.")]
    assert len(on_device) == 1 and "stack_kernel_u8" in on_device[0], on_device


def test_fused_enhance_refuses_what_the_kernel_does_not_take(cuda):
    fused, _ = _shipped_pair(cuda, 16)
    with pytest.raises(ValueError):
        fused(np.zeros((1, 96, 128, 3), np.uint8))  # no alpha
    with pytest.raises(ValueError):
        fused(np.zeros((1, 95, 128, 4), np.uint8))  # odd height
    with pytest.raises(ValueError):
        fused(np.zeros((1, 96, 129, 4), np.uint8))  # odd width after the crop
    with pytest.raises(ValueError):
        fused(np.zeros((1, 96, 128, 4), np.float32))


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


@pytest.mark.parametrize("mode", range(len(K3_MODES)))
def test_k3_several_pixels_a_thread_on_a_ragged_crop(cuda, mode):
    """A crop whose pixel count divides by neither the CTA's threads, nor
    the pixels a thread, nor the pixels a CTA: the masked tail is right."""
    info = k3.kernel_info(cuda)
    assert info["pixels_per_thread"] > 1 and info["local_bytes"] == 0
    block, pix = info["threads"], info["pixels_per_thread"]
    h, w = 31, 41  # 1271 pixels
    assert (h * w) % block and (h * w) % pix and (h * w) % (block * pix)
    method, bayer = K3_MODES[mode]
    imgs, pals = _k3_inputs(2, h, w, 37, seed=40 + mode)
    imgs, pals = imgs.to(cuda), pals.to(cuda)
    got = k3.palette_dither(imgs, pals, method, bayer)
    torch.cuda.synchronize()
    assert torch.equal(got, k3.palette_dither_plain(imgs, pals, method, bayer))


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


def test_pinned_prefetch_delivers_the_batches_on_the_card(cuda):
    """device_prefetch on a card: pinned buffers, a side-stream copy and an
    event; the batches arrive on the card byte for byte, and closing early
    retires the producer."""
    import threading
    import time

    from fs_uae_image_enhancer_project_tpu_torch.data import device_prefetch

    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, (1, 288, 376, 3), dtype=np.uint8),
                rng.integers(0, 256, (1, 288, 376, 3), dtype=np.uint8)) for _ in range(6)]
    got = list(device_prefetch(iter(batches), size=2, device=cuda))
    assert len(got) == 6
    for (a, b), (x, y) in zip(batches, got):
        assert x.is_cuda and y.is_cuda
        assert np.array_equal(x.cpu().numpy(), a) and np.array_equal(y.cpu().numpy(), b)
    n_before = threading.active_count()
    gen = device_prefetch(iter(batches * 20), size=2, device=cuda)
    next(gen)
    gen.close()
    deadline = time.time() + 30
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before


def test_train_step_on_the_card_never_launches_k1(cuda):
    """A bf16 train step of the lightweight pix_shuffle on the card: every
    parameter gets a finite gradient and K1 is not launched (its output has
    no gradient); the same weights' bf16 forward through apply launches it."""
    import dataclasses

    from fs_uae_image_enhancer_project_tpu_torch.losses import build_criterion
    from fs_uae_image_enhancer_project_tpu_torch.models import train_apply
    from fs_uae_image_enhancer_project_tpu_torch.parallel import train_step as ts

    m = get_model("pix_shuffle")
    loss = dataclasses.replace(m.loss, vgg_weight=0.0)
    state = ts.init_train_state(_params(cuda), ts.make_optimizer())
    step = ts.make_train_step(train_apply(m), build_criterion(loss, device=cuda))
    x = torch.rand(2, 1, 32, 48, 3, generator=torch.Generator().manual_seed(0)).to(cuda)
    before = fs.fused_stack.launches
    state, loss_t = step(state, x, x.flip(-2))
    torch.cuda.synchronize()
    assert fs.fused_stack.launches == before
    assert torch.isfinite(loss_t)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in ts.leaves(state.params))
    with torch.no_grad():
        m.apply(state.params, x[0].to(torch.bfloat16))
    assert fs.fused_stack.launches == before + 1


def test_custom_op_launches_k1_and_counts(cuda):
    """K1 as ``torch.ops.fse.fused_stack``: the same output as the direct
    wrapper, one launch a call, a strided input made contiguous, and a
    wrong dtype raises (no fallback)."""
    sw = fs.prepare_weights(_params(cuda), cuda)
    u = torch.rand(2, 40, 56, 12, generator=torch.Generator().manual_seed(6))
    u = u.to(torch.bfloat16).to(cuda)
    before = fs.fused_stack.launches
    got = torch.ops.fse.fused_stack(u, *sw.frags, sw.prm)
    assert fs.fused_stack.launches == before + 1
    assert torch.equal(got, fs.fused_stack(u, sw))
    strided = u.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert torch.equal(torch.ops.fse.fused_stack(strided, *sw.frags, sw.prm), got)
    with pytest.raises(ValueError):
        torch.ops.fse.fused_stack(u.float(), *sw.frags, sw.prm)


def test_exported_enhance_runs_k1_once_a_call(cuda, tmp_path):
    from fs_uae_image_enhancer_project_tpu_torch.export.stablehlo import (
        export_enhance, load_enhance, stablehlo_text)

    enhance = enhance_from_onnx(ONNX, device=cuda)
    path = export_enhance(enhance, str(tmp_path / "ps.pt2"), frame_h=96, frame_w=128,
                          device=cuda)
    loaded = load_enhance(path, device=cuda)
    frames = np.random.default_rng(8).integers(0, 256, (3, 96, 128, 4), dtype=np.uint8)
    before = fs.fused_stack.launches
    got = [loaded(frames[i:i + 1]) for i in range(3)]
    assert fs.fused_stack.launches == before + 3
    for i in range(3):
        assert torch.equal(got[i], enhance(frames[i:i + 1]))
    text = stablehlo_text(enhance, frame_h=96, frame_w=128, device=cuda)
    assert text.count("torch.ops.fse.fused_stack.default(") == 1
    with pytest.raises(ValueError, match="exported on cuda"):
        load_enhance(path, device="cpu")


def test_qconv_accumulators_equal_the_cpu(cuda):
    from fs_uae_image_enhancer_project_tpu_torch.export import quantized as q

    rng = np.random.default_rng(9)
    # im2col rows (680, 10, 42, 408) that are not multiples of 32, at K = 32,
    # 328, 112 and 2304: cuBLASLt refuses 680 x 32 and 42 x 112 unpadded
    for cin, cout, h, w in ((3, 192, 40, 17), (36, 36, 2, 5), (12, 36, 6, 7), (256, 3, 24, 17)):
        xq = torch.from_numpy(rng.integers(-127, 128, (1, h, w, cin), dtype=np.int8))
        w_q = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout), dtype=np.int8))
        got = q.qconv_acc(w_q.to(cuda), xq.to(cuda))
        assert got.is_cuda and torch.equal(got.cpu(), q.qconv_acc(w_q, xq))
