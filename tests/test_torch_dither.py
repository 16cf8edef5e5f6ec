"""K3's plain version against the Pallas dither kernel, and its wrapper's rules.

On the CPU the port's dither wrapper takes its plain version; the JAX side
runs the Pallas kernel in interpret mode. Tolerances:

- integer-valued pixels (what the generator feeds: uint8 crops): byte for
  byte, against the Pallas kernel per crop and batched with per-crop
  palettes, and against the reference's ``cb_*``/``od_bayer*`` goldens;
- non-integer float pixels (``uniform(0, 255)``): >= 0.98 of pixels equal,
  the JAX package's own bound (tests/test_pallas_dither.py), since the Pallas
  kernel's |x|^2 - 2x.p + |p|^2 distances round differently from the direct
  form at near-ties.

The CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds it
to the plain version there.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.datagen.quantize import (
    BAYER_MATRIX_2X2,
    BAYER_MATRIX_4X4,
    BAYER_MATRIX_8X8,
)
from fs_uae_image_enhancer_project_tpu.ops.pallas.dither import (
    pallas_palette_dither,
    pallas_palette_dither_batch_per_palette,
)
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import dither as k3

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "dither_goldens.npz")
BAYERS = {2: BAYER_MATRIX_2X2, 4: BAYER_MATRIX_4X4, 8: BAYER_MATRIX_8X8}
MODES = [("none", None), ("checkerboard", None), ("ordered", 2), ("ordered", 4),
         ("ordered", 8)]


def _crops(seed, b, h, w):
    """Integer-valued seeded crops: half raw uint8 noise, half a RGB444-grid
    gradient with noise (the generator's kind of input)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], -1)
    out = []
    for i in range(b):
        if i % 2:
            out.append(rng.integers(0, 256, (h, w, 3)))
        else:
            g = np.clip(base + rng.normal(0, 24, base.shape) + 30, 0, 255)
            out.append(np.floor(g / 16) * 16)
    return np.stack(out).astype(np.uint8)


def _plain(imgs, pals, method, bayer):
    return k3.palette_dither(torch.from_numpy(imgs), torch.from_numpy(pals), method,
                             bayer).numpy()


@pytest.mark.parametrize("method,m", MODES)
@pytest.mark.parametrize("n,b,h,w", [(2, 3, 24, 32), (16, 2, 48, 64), (256, 2, 40, 52),
                                     (1024, 2, 24, 32)])
def test_plain_equals_pallas_byte_for_byte(n, b, h, w, method, m):
    imgs = _crops(n, b, h, w)
    pals = np.random.default_rng(n + 1).integers(0, 256, (b, n, 3)).astype(np.uint8)
    # some pixels sit exactly on a palette colour (the d1 == 0 rule)
    k = min(n, 4)
    imgs[:, 0, :k] = pals[:, :k]
    bayer = BAYERS.get(m)
    got = _plain(imgs, pals, method, bayer)
    want = pallas_palette_dither_batch_per_palette(imgs.astype(np.float32), pals, method, bayer)
    np.testing.assert_array_equal(got, want)
    one = pallas_palette_dither(imgs[1].astype(np.float32), pals[1], method, bayer)
    np.testing.assert_array_equal(got[1], one)


@pytest.fixture(scope="module")
def goldens():
    return np.load(GOLDENS)


@pytest.mark.parametrize("n", [2, 16, 64])
@pytest.mark.parametrize("m", [None, 2, 4, 8])
def test_plain_matches_reference_goldens(goldens, n, m):
    img, pal = goldens["img"], goldens[f"pal{n}"]
    if m is None:
        got = _plain(img[None], pal[None], "checkerboard", None)[0]
        want = goldens[f"cb_pal{n}"]
    else:
        got = _plain(img[None], pal[None], "ordered", BAYERS[m])[0]
        want = goldens[f"od_bayer{m}_pal{n}"]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("method,m", [("none", None), ("checkerboard", None), ("ordered", 2),
                                      ("ordered", 4)])
def test_plain_on_float_pixels_within_the_jax_bound(method, m):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (24, 32, 3)).astype(np.float32)
    pal = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    got = k3.palette_dither_plain(torch.from_numpy(img)[None], torch.from_numpy(pal)[None],
                                  method, BAYERS.get(m))[0].numpy()
    want = pallas_palette_dither(img, pal, method, BAYERS.get(m))
    assert float((got == want).all(-1).mean()) >= 0.98
    assert (got.reshape(-1, 1, 3) == pal[None]).all(-1).any(-1).all()


@pytest.mark.parametrize("method,m", MODES)
def test_exact_palette_colors_stay_fixed(method, m):
    pal = np.random.default_rng(3).integers(0, 256, (1, 16, 3)).astype(np.uint8)
    img = np.broadcast_to(pal[:, 3], (1, 8, 8, 3)).copy()
    np.testing.assert_array_equal(_plain(img, pal, method, BAYERS.get(m)), img)


def test_pixel_luminance_is_the_pallas_kernels():
    """The Pallas kernel's r*L0 + g*L1 + b*L2 as XLA compiles it equals the
    plain version's fma(b, L2, fma(r, L0, g*L1)) bit for bit, on all 2^24
    uint8 colours (in 16 slices of red)."""
    f = jax.jit(lambda x: x[:, 0] * 0.2126 + x[:, 1] * 0.7152 + x[:, 2] * 0.0722)
    v = np.arange(256, dtype=np.float32)
    g, b = np.meshgrid(v, v, indexing="ij")
    for r0 in range(0, 256, 16):
        r = np.repeat(np.arange(r0, r0 + 16, dtype=np.float32), 256 * 256)
        px = np.stack([r, np.tile(g.ravel(), 16), np.tile(b.ravel(), 16)], 1)
        want = np.asarray(f(jnp.asarray(px)))
        got = k3._pixel_luminance(torch.from_numpy(px)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_palette_luminance_is_the_jax_wrappers():
    pals = np.random.default_rng(1).integers(0, 256, (3, 256, 3)).astype(np.uint8)
    want = pals.astype(np.float32) @ np.asarray(k3.LUMA, np.float32)
    got = k3.palette_luminance(torch.from_numpy(pals)).numpy()
    np.testing.assert_array_equal(got, want)


def _bad_calls():
    img = torch.zeros(1, 4, 4, 3, dtype=torch.uint8)
    pal = torch.zeros(1, 8, 3, dtype=torch.uint8)
    return {
        "one colour": (img, pal[:, :1], "none", None),
        "1025 colours": (img, torch.zeros(1, 1025, 3, dtype=torch.uint8), "none", None),
        "ordered without bayer": (img, pal, "ordered", None),
        "bad bayer": (img, pal, "ordered", np.zeros((3, 3), np.int32)),
        "int32 image": (img.to(torch.int32), pal, "none", None),
        "float palette": (img, pal.float(), "none", None),
        "batch mismatch": (img, torch.zeros(2, 8, 3, dtype=torch.uint8), "none", None),
        "not nhwc": (img[..., :2], pal, "none", None),
        "unknown method": (img, pal, "floyd-steinberg", None),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrapper_raises(case):
    with pytest.raises(ValueError):
        k3.palette_dither(*_bad_calls()[case])


def test_cpu_tensor_never_touches_the_library(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path loaded the CUDA library")

    monkeypatch.setattr(build, "load_library", refuse)
    before = k3.palette_dither.launches
    imgs = _crops(5, 2, 8, 8)
    pals = np.random.default_rng(5).integers(0, 256, (2, 4, 3)).astype(np.uint8)
    out = _plain(imgs, pals, "ordered", BAYER_MATRIX_4X4)
    assert out.shape == imgs.shape and out.dtype == np.uint8
    assert k3.palette_dither.launches == before


INT32 = (-(2 ** 31), 2 ** 31 - 1)


def _key_search(x, pal):
    """The kernel's integer-key search in numpy int64 (csrc/dither.cu): key
    1024 (|p_j|^2 - 2 x.p_j) + j; k1 = min(k1, key), k2 = min(k2, max(k1,
    key)) over j in order; i = key & 1023, d1 = |x|^2 + (k1 >> 10). Returns
    (i1, i2, d1) and the keys' (min, max)."""
    x = x.astype(np.int64)  # (P, 3)
    pal = pal.astype(np.int64)  # (N, 3)
    big = np.iinfo(np.int32).max
    k1 = np.full(len(x), big, np.int64)
    k2 = k1.copy()
    lo, hi = big, -big
    for j, p in enumerate(pal):
        key = (1024 * int(p @ p) + j) - ((x @ p) << 11)
        lo, hi = min(lo, int(key.min())), max(hi, int(key.max()))
        k2 = np.minimum(k2, np.maximum(k1, key))
        k1 = np.minimum(k1, key)
    d1 = (x * x).sum(1) + (k1 >> 10)
    return (k1 & 1023, k2 & 1023, d1), (lo, hi)


@pytest.mark.parametrize("n", [2, 3, 1024])
def test_integer_key_search_is_the_plain_search(n):
    """On seeded pixels and palettes with duplicate colours and pixels that
    sit on a colour, the key search gives the plain version's (i1, i2, d1):
    the nearest, the nearest other index (ties to the lowest index, the
    Pallas kernel's strict '<'), and the nearest distance."""
    rng = np.random.default_rng(n)
    pal = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    pal[n // 2] = pal[0]  # a duplicate colour (for n = 2, the same colour twice)
    pal[-1] = pal[1 % n]
    x = np.concatenate([rng.integers(0, 256, (600, 3)), pal[:, :], pal[:1] // 2,
                        np.array([[0, 0, 0], [255, 255, 255]])]).astype(np.uint8)
    (i1, i2, d1), (lo, hi) = _key_search(x, pal)
    w1, wd1, w2 = k3.nearest_two(torch.from_numpy(x)[None].float(), torch.from_numpy(pal)[None])
    assert np.array_equal(i1, w1[0].numpy()) and np.array_equal(i2, w2[0].numpy())
    assert np.array_equal(d1, wd1[0].numpy().astype(np.int64))
    assert INT32[0] <= lo and hi <= INT32[1]
    assert (d1 == 0).sum() >= n  # every colour's own pixel


def test_integer_keys_stay_within_int32_at_both_extremes():
    """The smallest key (x = p = 255) and the largest (x = 0, p = 255,
    j = 1023) are int32, and so is the kernel's 2048 x.p term."""
    (_, _, d1), (lo, _) = _key_search(np.full((1, 3), 255), np.full((2, 3), 255))
    assert lo == 1024 * (3 * 255 ** 2 - 2 * 3 * 255 ** 2) and d1[0] == 0
    pal = np.zeros((1024, 3), np.int64)
    pal[1023] = 255
    _, (_, hi) = _key_search(np.zeros((1, 3)), pal)
    assert hi == 1024 * 3 * 255 ** 2 + 1023
    assert INT32[0] <= lo and hi <= INT32[1] and (3 * 255 ** 2) << 11 <= INT32[1]


def test_kernel_ops_count():
    imgs = torch.zeros(16, 144, 188, 3, dtype=torch.uint8)
    pals = torch.zeros(16, 256, 3, dtype=torch.uint8)
    assert k3.kernel_ops(imgs, pals, "none") == 16 * 27072 * 256 * 9
    assert k3.kernel_ops(imgs, pals, "ordered") == 16 * 27072 * 256 * 10
