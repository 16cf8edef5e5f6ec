"""The port's residual U-Net against the benchmark's plain reference on the
CPU, on seeded random weights at small base widths: the forward in fp32, the
uint8 enhance in bf16 (``make_enhance_fn``) with the fp8-operand control
failing the same limit, and the forward's spans and counter.

The reference is ``port_bench/reference/residual_unet.py``'s frozen
forward (plain torch, NCHW, fp32 with TF32 off), which imports nothing of
the port; the uint8 comparison reads the same weights from a graph that the
port's exporter writes, as the benchmark's reference does."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fs_uae_image_enhancer_project_tpu_torch.export.enhance import make_enhance_fn
from fs_uae_image_enhancer_project_tpu_torch.export.onnx_export import export_residual_unet_onnx
from fs_uae_image_enhancer_project_tpu_torch.models import residual_unet
from fs_uae_image_enhancer_project_tpu_torch.models.configs import ResidualUNetConfig
from port_bench.reference import residual_unet as ref_unet
from port_bench.reference.common import Conv, Reference, differences

# the two published structures (models/residual_unet.py), at small base widths
STRUCTURES = {
    "lightweight": dict(unet_depth=3, blocks_per_level=1, internal_block_channels_ratio=1.5),
    "heavyweight": dict(unet_depth=4, blocks_per_level=4, internal_block_channels_ratio=1.5),
}
BASE = 16
SEEDS = (3, 2**31 + 11)
CROP = 16
FRAME = (64, 96 + CROP)  # the model sees 64x96, divisible by 32
UNET_SPANS = ("fse.unet.encoder", "fse.unet.bottleneck", "fse.unet.decoder")

# fp32: the two sides order each convolution's sums differently (NHWC against
# NCHW) and part by a few float32 roundings of outputs of order 1 (at most
# 2.4e-7 on these seeds): 1e-4 leaves room for another CPU's kernels.
FP32_ATOL = 1e-4
# uint8 through the same wrapper in fp32: a last-bit difference can move a
# value across a level's boundary before the truncation to uint8: one level.
FP32_LEVELS = 1
# bf16 against fp32, the worst frame's mean absolute difference in levels:
# the port rounds every activation to bf16 (8 bits of mantissa), which moves
# a byte by 0 or 1 levels, mostly 0 (0.08-0.14 on these seeds). The
# fp8-operand control (3 bits) moves most bytes by several (0.82-1.85).
BF16_MAE_LEVELS = 0.5


def _config(structure):
    return ResidualUNetConfig(base_channels=BASE, **STRUCTURES[structure])


def _params(cfg, seed):
    return residual_unet.init(cfg, torch.Generator().manual_seed(seed % 2**63), device="cpu")


def _reference_weights(params, prefix=""):
    """The port's HWIO tree as the reference's ``<layer>.weight`` (OIHW) and
    ``<layer>.bias`` initializers."""
    out = {}
    for key, node in params.items():
        name = f"{prefix}{key}"
        if "w" in node:
            out[f"{name}.weight"] = node["w"].permute(3, 2, 0, 1).contiguous()
            out[f"{name}.bias"] = node["b"]
        elif node:
            out.update(_reference_weights(node, f"{name}."))
    return out


def _frames(seed, n=2):
    # pixel-doubled blocks of a small palette, as the benchmark's recordings
    rng = np.random.default_rng(seed)
    palette = rng.integers(0, 256, (32, 3), dtype=np.uint8)
    h, w = FRAME
    idx = rng.integers(0, 32, (n, h // 2, w // 2))
    rgb = palette[idx].repeat(2, axis=1).repeat(2, axis=2)
    return np.concatenate([rgb, np.full((n, h, w, 1), 255, np.uint8)], axis=-1)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_the_fp32_forward_is_the_references(structure, seed):
    cfg = _config(structure)
    params = _params(cfg, seed)
    x = torch.rand((2, *FRAME[:1], FRAME[1] - CROP, 3), generator=torch.Generator().manual_seed(5))
    port = residual_unet.apply(params, x, cfg)
    weights = _reference_weights(params)
    assert ref_unet.structure(weights) == (cfg.unet_depth, cfg.blocks_per_level)
    ref = ref_unet.forward(weights, Conv(weights), x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert port.dtype == ref.dtype == torch.float32 and port.shape == ref.shape
    assert float(ref.abs().max()) > 0.1  # a live output, not a ReLU's zeros
    torch.testing.assert_close(port, ref, atol=FP32_ATOL, rtol=0)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """``(structure, seed)``: the port's params and the graph its exporter
    writes from them at the frame with its crop."""
    out = {}
    root = tmp_path_factory.mktemp("unet_graphs")
    for structure in STRUCTURES:
        cfg = _config(structure)
        for seed in SEEDS:
            params = _params(cfg, seed)
            path = str(root / f"{structure}-{seed}.onnx")
            export_residual_unet_onnx(_numpy(params), cfg, path, crop_left=CROP,
                                      frame_h=FRAME[0], frame_w=FRAME[1])
            out[structure, seed] = (cfg, params, path)
    return out


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy() for k, v in tree.items()}


def _reference(path, precision="fp32"):
    return Reference({"name": "residual_unet", "wrapper": {"crop_left": CROP}}, path, "cpu",
                     precision)


def _enhance(cfg, params, dtype):
    return make_enhance_fn(lambda p, x: residual_unet.apply(p, x, cfg), params,
                           crop_left=CROP, compute_dtype=dtype, device="cpu")


def _worst(a, b, key):
    return max(differences(x, y)[key] for x, y in zip(a, b))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_the_fp32_enhance_is_the_references_to_a_level(graphs, structure, seed):
    cfg, params, path = graphs[structure, seed]
    frames = _frames(seed)
    ref = _reference(path)(frames).numpy()
    port = _enhance(cfg, params, torch.float32)(frames).numpy()
    assert _worst(port, ref, "max") <= FP32_LEVELS


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_the_bf16_enhance_passes_the_limit_and_the_fp8_control_fails_it(graphs, structure, seed):
    cfg, params, path = graphs[structure, seed]
    frames = _frames(seed)
    ref = _reference(path)(frames).numpy()
    colour = ref[:, :, CROP:, :3]
    # the comparison is not blind: a random network's last ReLU zeroes part
    # of its output, but a good share of the colour bytes is neither 0 nor 255
    assert np.mean((colour > 0) & (colour < 255)) > 0.25
    port = _enhance(cfg, params, torch.bfloat16)(frames).numpy()
    control = _reference(path, "fp8")(frames).numpy()
    assert 0 < _worst(port, ref, "mae") <= BF16_MAE_LEVELS
    assert _worst(control, ref, "mae") > BF16_MAE_LEVELS


def _unet_events(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name().startswith("fse.")]
    return sorted(events, key=lambda t: t[1])


@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_the_forward_opens_its_three_spans_in_order_inside_the_model_span(graphs, structure):
    cfg, params, _ = graphs[structure, SEEDS[0]]
    enhance = _enhance(cfg, params, torch.bfloat16)
    frames = _frames(0, n=1)
    enhance(frames)
    got = _unet_events(lambda: enhance(frames))
    names = [n for n, _, _ in got]
    for name in UNET_SPANS:
        assert names.count(name) == 1, names
    (_, ma, mb), = [t for t in got if t[0] == "fse.enhance.model"]
    inner = [t for t in got if t[0] in UNET_SPANS]
    assert [n for n, _, _ in inner] == list(UNET_SPANS)
    assert all(ma <= s and e <= mb for _, s, e in inner)
    assert all(e1 <= s2 for (_, _, e1), (_, s2, _) in zip(inner, inner[1:]))


@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_the_forward_counter_counts_one_per_call(graphs, structure):
    cfg, params, _ = graphs[structure, SEEDS[0]]
    enhance = _enhance(cfg, params, torch.bfloat16)
    frames = _frames(1, n=2)
    before = residual_unet.apply.forwards
    for _ in range(3):
        enhance(frames)
    assert residual_unet.apply.forwards - before == 3
    with profile(activities=[ProfilerActivity.CPU]):  # the same with a profiler on
        residual_unet.apply(params, torch.zeros((1, 16, 16, 3)), cfg)
    assert residual_unet.apply.forwards - before == 4
