"""The port's datagen/quantize.py against the JAX package's, on the CPU.

- the copied host functions (grid quantization, median-cut, octree, the
  numpy MAP/checkerboard/ordered dithers, error diffusion, the entry point on
  the numpy backend): equal arrays;
- the torch k-means (``kmeans_torch``) handed the JAX first index: palettes
  equal to ``generate_palettes_kmeans_jax_batch``'s exactly, at K = 8, 64 and
  256 on RGB444 grid-quantized lores crops; its default seeded draw is
  deterministic; its per-crop and batched forms agree;
- ``reduce_color_depth_and_dither(backend='device', device='cpu')`` (K3's
  plain version) equal to the JAX ``backend='pallas'`` result byte for byte,
  for median-cut and octree palettes.
"""
import numpy as np
import pytest
import torch

import jax

from fs_uae_image_enhancer_project_tpu.datagen import quantize as jq
from fs_uae_image_enhancer_project_tpu_torch.datagen import quantize as tq
from fs_uae_image_enhancer_project_tpu_torch.runtime import native as tnative


def _crop(h, w, seed):
    """A smooth gradient plus noise: many unique colours, like the
    generator's source crops."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], -1)
    return np.clip(base + rng.normal(0, 24, (h, w, 3)) + 30, 1, 255).astype(np.uint8)


def _jax_first_index(seed, n):
    return int(jax.random.randint(jax.random.key(seed), (), 0, n))


def test_constants_are_copied():
    for name in ("BAYER_MATRIX_2X2", "BAYER_MATRIX_4X4", "BAYER_MATRIX_8X8"):
        np.testing.assert_array_equal(getattr(tq, name), getattr(jq, name))
    assert tq.DIFFUSION_MAPS == jq.DIFFUSION_MAPS
    assert tq.VALID_COLOR_SPACES == jq.VALID_COLOR_SPACES
    assert tq.VALID_PALETTE_SIZES == jq.VALID_PALETTE_SIZES
    assert tq.valid_dither_methods() == jq.valid_dither_methods()
    assert tq.VALID_PALETTE_ALGORITHMS == ["kmeans", "kmeans_torch", "median_cut", "octree"]


@pytest.mark.parametrize("cs", ["RGB888", "RGB444", "RGB555", "RGB565", "RGB666"])
def test_grid_quantize_equal(cs):
    img = _crop(24, 32, 0)
    np.testing.assert_array_equal(tq.grid_quantize(img, cs), jq.grid_quantize(img, cs))


@pytest.mark.parametrize("algo", ["median_cut", "octree"])
@pytest.mark.parametrize("n", [4, 16, 64])
def test_host_palettes_equal(algo, n):
    img = _crop(36, 48, n)
    name = f"generate_palette_{algo}"
    np.testing.assert_array_equal(getattr(tq, name)(img, n), getattr(jq, name)(img, n))


@pytest.mark.parametrize("method", ["map", "checkerboard", "bayer2", "bayer4", "bayer8"])
def test_host_dithers_equal(method):
    img = _crop(24, 32, 1).astype(np.float64)
    pal = np.random.default_rng(2).integers(0, 256, (16, 3)).astype(np.uint8)
    if method == "map":
        got, want = tq.map_to_palette(img, pal), jq.map_to_palette(img, pal)
    elif method == "checkerboard":
        got, want = tq.checkerboard_dither(img, pal), jq.checkerboard_dither(img, pal)
    else:
        bayer = getattr(tq, f"BAYER_MATRIX_{method[-1]}X{method[-1]}")
        got, want = tq.ordered_dither(img, pal, bayer), jq.ordered_dither(img, pal, bayer)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method", ["floyd-steinberg", "atkinson"])
def test_error_diffusion_equal(method):
    img = _crop(12, 16, 3).astype(np.float64)
    pal = np.random.default_rng(4).integers(0, 256, (8, 3)).astype(np.float64)
    want = jq.error_diffusion_dither_numpy(img, jq.DIFFUSION_MAPS[method], pal)
    np.testing.assert_array_equal(
        tq.error_diffusion_dither_numpy(img, tq.DIFFUSION_MAPS[method], pal), want)
    # the host C++ route (numpy when g++ is missing) gives the same array
    np.testing.assert_array_equal(tq.error_diffusion_dither(img, method, pal), want)


def test_native_library_builds_into_the_build_tree():
    if not tnative.available():
        pytest.skip("g++ is not available")
    assert "build/torch_kernels/native" in tnative._BUILD_DIR.replace("\\", "/")


@pytest.mark.parametrize("cs,pal,alg,dither", [
    ("RGB444", 16, "median_cut", "floyd-steinberg"),
    ("RGB444", 32, "octree", "bayer4x4"),
    ("RGB565", 16, "median_cut", "checkerboard"),
    ("RGB888", 64, "median_cut", "none"),
    ("RGB666", None, "median_cut", "none"),
    ("RGB444", 256, "median_cut", "bayer8x8"),
])
def test_entry_point_numpy_backend_equal(cs, pal, alg, dither):
    img = _crop(24, 32, 5)
    kw = dict(color_space=cs, target_palette_size=pal, dithering_method=dither,
              palette_algorithm=alg)
    np.testing.assert_array_equal(
        tq.reduce_color_depth_and_dither(img, backend="numpy", **kw),
        jq.reduce_color_depth_and_dither(img, backend="numpy", **kw))


@pytest.mark.parametrize("alg", ["median_cut", "octree"])
@pytest.mark.parametrize("dither", ["none", "checkerboard", "bayer2x2", "bayer4x4", "bayer8x8",
                                    "floyd-steinberg"])
def test_entry_point_device_backend_equals_pallas(alg, dither):
    img = _crop(36, 48, 6)
    kw = dict(color_space="RGB444", target_palette_size=32, dithering_method=dither,
              palette_algorithm=alg)
    got = tq.reduce_color_depth_and_dither(img, backend="device", device="cpu", **kw)
    want = jq.reduce_color_depth_and_dither(img, backend="pallas", **kw)
    np.testing.assert_array_equal(got, want)


def _stacks(h, w, b=2):
    return np.stack([jq.grid_quantize(_crop(h, w, s), "RGB444").reshape(-1, 3)
                     for s in range(b)]).astype(np.float32)


@pytest.mark.parametrize("k,h,w", [(8, 72, 94), (64, 72, 94), (256, 144, 188)])
def test_kmeans_torch_equals_jax_given_the_first_index(k, h, w):
    stacks = _stacks(h, w)
    first = _jax_first_index(42, stacks.shape[1])
    got = tq.generate_palettes_kmeans_torch_batch(stacks, k, first_index=first, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2, k, 3)
    np.testing.assert_array_equal(got.numpy(), jq.generate_palettes_kmeans_jax_batch(stacks, k))


def test_kmeans_torch_default_draw_is_deterministic():
    stacks = _stacks(24, 32)
    a = tq.generate_palettes_kmeans_torch_batch(stacks, 16, device="cpu")
    b = tq.generate_palettes_kmeans_torch_batch(stacks, 16, device="cpu")
    assert torch.equal(a, b)
    first = int(torch.randint(0, stacks.shape[1], (), generator=torch.Generator().manual_seed(42)))
    c = tq.generate_palettes_kmeans_torch_batch(stacks, 16, first_index=first, device="cpu")
    assert torch.equal(a, c)
    with pytest.raises(ValueError):
        tq.generate_palettes_kmeans_torch_batch(stacks, 16, first_index=stacks.shape[1],
                                                device="cpu")


def test_kmeans_torch_per_crop_equals_batched():
    stacks = _stacks(36, 48, b=3)
    batched = tq.generate_palettes_kmeans_torch_batch(stacks, 32, device="cpu").numpy()
    for i in range(3):
        one = tq.generate_palette_kmeans_torch(stacks[i], 32, device="cpu")
        assert isinstance(one, np.ndarray)
        np.testing.assert_array_equal(one, batched[i])


def test_kmeans_torch_chunked_lloyd_step_is_the_same(monkeypatch):
    """The Lloyd step's distance matrix is cut into pixel chunks to bound its
    memory; the chunking must not change an assignment."""
    stacks = _stacks(36, 48)
    whole = tq.generate_palettes_kmeans_torch_batch(stacks, 16, device="cpu")
    monkeypatch.setattr(tq, "_KMEANS_CHUNK", 2 * 16 * 100)
    assert torch.equal(whole, tq.generate_palettes_kmeans_torch_batch(stacks, 16, device="cpu"))


def test_entry_point_with_kmeans_torch_palette():
    img = _crop(24, 32, 7)
    pixels = tq.grid_quantize(img, "RGB444").reshape(-1, 3).astype(np.float32)
    pal = tq.generate_palette_kmeans_torch(pixels, 16, device="cpu")
    want = tq.map_to_palette(img.astype(np.float64), pal)
    got = tq.reduce_color_depth_and_dither(img, "RGB444", 16, "none", "kmeans_torch",
                                           backend="numpy", device="cpu")
    np.testing.assert_array_equal(got, want)


def test_entry_point_rejects_unknown_backend_and_algorithm():
    img = _crop(8, 8, 8)
    with pytest.raises(ValueError):
        tq.reduce_color_depth_and_dither(img, "RGB444", 16, backend="pallas")
    with pytest.raises(ValueError):
        tq.reduce_color_depth_and_dither(img, "RGB444", 16, palette_algorithm="kmeans_jax")
    with pytest.raises(ValueError):
        tq.reduce_color_depth_and_dither(img, "RGB444", dithering_method="checkerboard")
