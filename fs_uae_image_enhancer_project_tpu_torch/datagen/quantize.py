"""Colour-depth reduction, palette generation and dithering.

The port's copy of the JAX package's ``datagen/quantize.py`` (itself the
counterpart of reference ``dataset_generator/quantize.py``), with the same
algorithm surface and validation behaviour:

- palette algorithms: k-means (sklearn for exact reference parity,
  quantize.py:486-489; plus a batched torch Lloyd's variant on the card,
  ``kmeans_torch``), median-cut (quantize.py:8-39), octree (quantize.py:42-60);
- grid quantization for RGB444/555/565/666 (quantize.py:461-474, :509-522);
- dithers: nearest mapping, checkerboard two-nearest-colour
  (quantize.py:136-229) and Bayer 2x2/4x4/8x8 ordered via luminance
  interpolation (quantize.py:232-331) in numpy on the host, or through the
  CUDA kernel K3 (``ops/cuda/dither.py``) with ``backend='device'``;
  serpentine error diffusion with 6 diffusion maps (quantize.py:84-134,
  :362-390) — inherently sequential, on the host in C++ (``runtime/native.py``)
  with a pure-numpy fallback;
- entry point :func:`reduce_color_depth_and_dither` with the reference's
  exact argument validation and ValueError surface (quantize.py:395-450).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..utils.threefry import randint

# ---------------------------------------------------------------------------
# Dither matrices and diffusion maps (public constants, quantize.py:334-390)
# ---------------------------------------------------------------------------

BAYER_MATRIX_2X2 = np.array([[0, 2], [3, 1]], dtype=np.int32)

BAYER_MATRIX_4X4 = np.array(
    [[0, 8, 2, 10], [12, 4, 14, 6], [3, 11, 1, 9], [15, 7, 13, 5]], dtype=np.int32
)

BAYER_MATRIX_8X8 = np.array(
    [
        [0, 32, 8, 40, 2, 34, 10, 42],
        [48, 16, 56, 24, 50, 18, 58, 26],
        [12, 44, 4, 36, 14, 46, 6, 38],
        [60, 28, 52, 20, 62, 30, 54, 22],
        [3, 35, 11, 43, 1, 33, 9, 41],
        [51, 19, 59, 27, 49, 17, 57, 25],
        [15, 47, 7, 39, 13, 45, 5, 37],
        [63, 31, 55, 23, 61, 29, 53, 21],
    ],
    dtype=np.int32,
)

DIFFUSION_MAPS = {
    "floyd-steinberg": [
        (1, 0, 7 / 16),
        (-1, 1, 3 / 16), (0, 1, 5 / 16), (1, 1, 1 / 16),
    ],
    "atkinson": [
        (1, 0, 1 / 8), (2, 0, 1 / 8),
        (-1, 1, 1 / 8), (0, 1, 1 / 8), (1, 1, 1 / 8),
        (0, 2, 1 / 8),
    ],
    "sierra2": [
        (1, 0, 4 / 16), (2, 0, 3 / 16),
        (-2, 1, 1 / 16), (-1, 1, 2 / 16), (0, 1, 3 / 16), (1, 1, 2 / 16),
        (2, 1, 1 / 16),
    ],
    "stucki": [
        (1, 0, 8 / 42), (2, 0, 4 / 42),
        (-2, 1, 2 / 42), (-1, 1, 4 / 42), (0, 1, 8 / 42), (1, 1, 4 / 42),
        (2, 1, 2 / 42),
        (-2, 2, 1 / 42), (-1, 2, 2 / 42), (0, 2, 4 / 42), (1, 2, 2 / 42),
        (2, 2, 1 / 42),
    ],
    "burkes": [
        (1, 0, 8 / 32), (2, 0, 4 / 32),
        (-2, 1, 2 / 32), (-1, 1, 4 / 32), (0, 1, 8 / 32), (1, 1, 4 / 32),
        (2, 1, 2 / 32),
    ],
    "sierra3": [
        (1, 0, 5 / 32), (2, 0, 3 / 32),
        (-2, 1, 2 / 32), (-1, 1, 4 / 32), (0, 1, 5 / 32), (1, 1, 4 / 32),
        (2, 1, 2 / 32),
        (-1, 2, 2 / 32), (0, 2, 3 / 32), (1, 2, 2 / 32),
    ],
}

VALID_COLOR_SPACES = ["RGB888", "RGB565", "RGB444", "RGB555", "RGB666"]
VALID_PALETTE_SIZES = [None, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
VALID_PALETTE_ALGORITHMS = ["kmeans", "kmeans_torch", "median_cut", "octree"]
VALID_BACKENDS = ["numpy", "device"]


def valid_dither_methods():
    return ["none", "checkerboard", "bayer2x2", "bayer4x4", "bayer8x8"] + list(
        DIFFUSION_MAPS.keys()
    )


# ---------------------------------------------------------------------------
# Grid quantization
# ---------------------------------------------------------------------------

def grid_quantize(image: np.ndarray, color_space: str) -> np.ndarray:
    """Quantize uint8 RGB to the target grid, returned as float64 values on
    the 0..255 grid (reference quantize.py:461-474 semantics: floor to the
    low-bits-cleared level)."""
    x = image.astype(np.float64)
    if color_space == "RGB888":
        return x
    if color_space == "RGB444":
        return np.floor(x / 16) * 16
    if color_space == "RGB666":
        return np.floor(x / 4) * 4
    if color_space == "RGB555":
        return np.floor(x / 8) * 8
    if color_space == "RGB565":
        out = x.copy()
        out[..., 0] = np.floor(x[..., 0] / 8) * 8
        out[..., 1] = np.floor(x[..., 1] / 4) * 4
        out[..., 2] = np.floor(x[..., 2] / 8) * 8
        return out
    raise ValueError(f"color_space must be one of {VALID_COLOR_SPACES}.")


# ---------------------------------------------------------------------------
# Palette generation
# ---------------------------------------------------------------------------

def generate_palette_median_cut(image_np: np.ndarray, num_colors: int) -> np.ndarray:
    """Median-cut: recursively split the box with the largest RGB volume at
    the median of its longest axis; palette = per-box mean colours.

    Pixels stay in the input's uint8 dtype (reference quantize.py:8-39): the
    unstable column argsort's tie order is dtype-dependent, and equal-valued
    pixels landing on either side of the median boundary change the per-box
    means — byte parity requires sorting the same dtype the reference sorts.
    """
    pixels = image_np.reshape(-1, 3)
    boxes = [pixels]

    def volume(box):
        return float(np.prod(box.max(axis=0) - box.min(axis=0)))

    while len(boxes) < num_colors:
        boxes.sort(key=volume, reverse=True)
        box = boxes.pop(0)
        if len(box) < 2:
            boxes.append(box)
            break
        axis = int(np.argmax(box.max(axis=0) - box.min(axis=0)))
        order = box[:, axis].argsort()
        half = len(box) // 2
        boxes.extend([box[order[:half]], box[order[half:]]])
    return np.array([b.mean(axis=0) for b in boxes if len(b)], dtype=np.uint8)


def generate_palette_octree(image_np: np.ndarray, num_colors: int) -> np.ndarray:
    """Octree-style palette: bucket by high bits, keep the most-populous
    buckets (reference quantize.py:42-60). The bucket colour is the shared
    bit-shifted QUANTIZED value — the reference accumulates quantized pixels,
    so every bucket member is identical and the mean IS that value. Ties
    between equal-count buckets break by first-seen order, matching the
    reference's stable sort over dict-insertion order."""
    pixels = image_np.reshape(-1, 3)
    shift = 8 - int(np.log2(num_colors) / 3)
    shift = max(0, min(6, shift))
    quantized = (pixels >> shift) << shift
    keys = (
        quantized[:, 0].astype(np.int64) << 16
    ) | (quantized[:, 1].astype(np.int64) << 8) | quantized[:, 2].astype(np.int64)
    uniq, first_idx, counts = np.unique(keys, return_index=True, return_counts=True)
    if len(uniq) > num_colors:
        keep = np.lexsort((first_idx, -counts))[:num_colors]
    else:
        keep = np.argsort(first_idx)
    return quantized[first_idx[keep]].astype(np.uint8)


def generate_palette_kmeans_sklearn(
    pixels: np.ndarray, num_colors: int, random_state: int = 42
) -> np.ndarray:
    """sklearn KMeans with the reference's exact settings
    (quantize.py:486-489: random_state=42, n_init='auto')."""
    from sklearn.cluster import KMeans

    km = KMeans(n_clusters=num_colors, random_state=random_state, n_init="auto")
    km.fit(pixels)
    return km.cluster_centers_.astype(np.uint8)


# elements per chunk of a Lloyd step's (B, pixels, K) distance matrix: bounds
# its memory (B=16, 27,072 pixels, K=256 is 111 M elements, 443 MB per tensor)
_KMEANS_CHUNK = 1 << 24


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared RGB distance of broadcast (..., 3) operands, channel by channel
    as (dr*dr + dg*dg) + db*db in separate fp32 ops."""
    out = None
    for ch in range(3):
        d = a[..., ch] - b[..., ch]
        d = d.mul_(d)
        out = d if out is None else out.add_(d)
    return out


def _kmeans_torch(pts: torch.Tensor, num_colors: int, iters: int, first: int) -> torch.Tensor:
    """Greedy seeding then Lloyd steps on (B, N, 3) fp32 points; returns
    (B, num_colors, 3) fp32 centres. The counterpart of the JAX package's
    ``_kmeans_jax_fn`` core, step for step: the first centre is point
    ``first`` of every crop; each further centre is the point farthest from
    the centres so far (``argmax``: first index); the centre list comes out
    newest first with the first centre last (the JAX ``roll`` order). A Lloyd
    step assigns each point to its nearest centre (``argmin``: first index)
    and moves each centre to its points' mean; an empty centre stays."""
    b, n, _ = pts.shape
    rows = torch.arange(b, device=pts.device)
    c = pts[:, first]
    picked = [c]
    dists = _sqdist(pts, c[:, None, :])
    for _ in range(num_colors - 1):
        c = pts[rows, dists.argmax(dim=1)]
        picked.append(c)
        dists = torch.minimum(dists, _sqdist(pts, c[:, None, :]))
    centers = torch.stack(picked[::-1], dim=1)

    assign = torch.empty(b, n, dtype=torch.long, device=pts.device)
    step = max(1, _KMEANS_CHUNK // (b * num_colors))
    ones = torch.ones(b, n, dtype=torch.float64, device=pts.device)
    pts64 = pts.to(torch.float64)
    for _ in range(iters):
        for lo in range(0, n, step):
            d = _sqdist(pts[:, lo:lo + step, None, :], centers[:, None, :, :])
            assign[:, lo:lo + step] = d.argmin(dim=2)
        # integer-valued sums, exact in float64 in any order (atomics on a
        # card); the mean is then taken in fp32, as the JAX step takes it
        counts = torch.zeros(b, num_colors, dtype=torch.float64, device=pts.device)
        counts.scatter_add_(1, assign, ones)
        sums = torch.zeros(b, num_colors, 3, dtype=torch.float64, device=pts.device)
        sums.scatter_add_(1, assign[..., None].expand(b, n, 3), pts64)
        counts = counts.to(torch.float32)[..., None]
        mean = sums.to(torch.float32) / counts.clamp(min=1.0)
        centers = torch.where(counts > 0, mean, centers)
    return centers


def _first_index(n: int, seed: int, first_index: Optional[int]) -> int:
    if first_index is not None:
        if not 0 <= first_index < n:
            raise ValueError(f"first_index {first_index} is outside 0..{n - 1}")
        return int(first_index)
    return randint(seed, n)


def generate_palettes_kmeans_torch_batch(
    pixel_stacks, num_colors: int, iters: int = 25, seed: int = 42,
    first_index: Optional[int] = None, device=None,
) -> torch.Tensor:
    """Batched k-means palettes: (B, N, 3) pixel stacks (numpy or tensor) ->
    (B, num_colors, 3) uint8 palettes, as a tensor on ``device`` (default
    ``cuda``), in one call. The counterpart of the JAX package's
    ``generate_palettes_kmeans_jax_batch``; every crop starts from the same
    first index, as the JAX vmap shares one key.

    ``first_index`` is the index of the first centre. Without it the index
    is the JAX package's draw, ``jax.random.randint(jax.random.key(seed), (),
    0, N)``, computed without jax (``utils.threefry.randint``), so the
    palettes are the JAX ones. Centres are
    clipped to [0, 255] and truncated to uint8, as the JAX function does.
    This is plain tensor code, not a kernel.
    """
    dev = resolve_device(device)
    pts = torch.as_tensor(pixel_stacks).to(dev, torch.float32)
    if pts.dim() != 3 or pts.shape[2] != 3 or pts.shape[1] < 1:
        raise ValueError(f"pixel stacks must be (B, N, 3), got {tuple(pts.shape)}")
    first = _first_index(pts.shape[1], seed, first_index)
    centers = _kmeans_torch(pts, num_colors, iters, first)
    return centers.clamp(0, 255).to(torch.uint8)


def generate_palette_kmeans_torch(
    pixels, num_colors: int, iters: int = 25, seed: int = 42,
    first_index: Optional[int] = None, device=None,
) -> np.ndarray:
    """One crop's k-means palette: (N, 3) pixels -> (num_colors, 3) uint8
    numpy, computed on ``device`` (default ``cuda``). Equal to row 0 of
    :func:`generate_palettes_kmeans_torch_batch` on the same pixels."""
    pts = torch.as_tensor(pixels)[None]
    pal = generate_palettes_kmeans_torch_batch(pts, num_colors, iters, seed, first_index, device)
    return pal[0].cpu().numpy()


# ---------------------------------------------------------------------------
# Vectorized dither kernels (numpy; the device route is ops/cuda/dither.py)
# ---------------------------------------------------------------------------

# pixels per chunk in the palette distance search: bounds peak memory at
# ~CHUNK * N * 8 B (a full (H*W, 4096) float64 matrix would be gigabytes per
# generator worker — the reference's numba kernels are O(N) per pixel)
_DIST_CHUNK = 16384


def map_to_palette(image_float: np.ndarray, palette_u8: np.ndarray) -> np.ndarray:
    """Nearest-palette mapping, no dithering (quantize.py:523-530)."""
    pix = image_float.reshape(-1, 3)
    pal = palette_u8.astype(np.float64)
    labels = np.empty(len(pix), np.int64)
    for lo in range(0, len(pix), _DIST_CHUNK):
        chunk = pix[lo : lo + _DIST_CHUNK]
        d = ((chunk[:, None, :] - pal[None]) ** 2).sum(-1)
        labels[lo : lo + _DIST_CHUNK] = np.argmin(d, axis=1)
    return palette_u8[labels].reshape(image_float.shape).astype(np.uint8)


def _two_nearest(image_float: np.ndarray, palette_f: np.ndarray):
    """Indices + squared distances of the two nearest palette colours
    (chunked: memory stays bounded for 4096-colour palettes)."""
    pix = image_float.reshape(-1, 3)
    n = len(pix)
    idx1 = np.empty(n, np.int64)
    d1 = np.empty(n, np.float64)
    idx2 = np.empty(n, np.int64)
    d2 = np.empty(n, np.float64)
    for lo in range(0, n, _DIST_CHUNK):
        chunk = pix[lo : lo + _DIST_CHUNK]
        d = ((chunk[:, None, :] - palette_f[None]) ** 2).sum(-1)
        rows = np.arange(len(chunk))
        i1 = np.argmin(d, axis=1)
        idx1[lo : lo + _DIST_CHUNK] = i1
        d1[lo : lo + _DIST_CHUNK] = d[rows, i1]
        d[rows, i1] = np.inf
        i2 = np.argmin(d, axis=1)
        idx2[lo : lo + _DIST_CHUNK] = i2
        d2[lo : lo + _DIST_CHUNK] = d[rows, i2]
    return idx1, d1, idx2, d2


def checkerboard_dither(image_float: np.ndarray, palette_u8: np.ndarray) -> np.ndarray:
    """Two-nearest-colour checkerboard (quantize.py:136-229): alternate the
    two closest palette colours on a checker pattern; exact matches always
    take the nearest."""
    h, w, _ = image_float.shape
    n = palette_u8.shape[0]
    if n == 0:
        return np.zeros((h, w, 3), np.uint8)
    if n == 1:
        return np.broadcast_to(palette_u8[0], (h, w, 3)).astype(np.uint8).copy()
    pal_f = palette_u8.astype(np.float64)
    idx1, d1, idx2, _ = _two_nearest(image_float, pal_f)
    yy, xx = np.mgrid[0:h, 0:w]
    checker = ((xx + yy) % 2 == 0).reshape(-1)
    chosen = np.where(d1 == 0.0, idx1, np.where(checker, idx1, idx2))
    return palette_u8[chosen].reshape(h, w, 3).astype(np.uint8)


_LUMA = np.array([0.2126, 0.7152, 0.0722])


def ordered_dither(
    image_float: np.ndarray, palette_u8: np.ndarray, bayer: np.ndarray
) -> np.ndarray:
    """Bayer ordered dither via luminance interpolation between the two
    nearest palette colours (quantize.py:232-331)."""
    h, w, _ = image_float.shape
    n = palette_u8.shape[0]
    if n == 0:
        return np.zeros((h, w, 3), np.uint8)
    if n == 1:
        return np.broadcast_to(palette_u8[0], (h, w, 3)).astype(np.uint8).copy()
    pal_f = palette_u8.astype(np.float64)
    idx1, d1, idx2, _ = _two_nearest(image_float, pal_f)
    lum_pix = image_float.reshape(-1, 3) @ _LUMA
    pal_lum = pal_f @ _LUMA
    lum1, lum2 = pal_lum[idx1], pal_lum[idx2]
    # idx1 must be the darker of the pair (quantize.py:305-309)
    swap = lum1 > lum2
    lo_idx = np.where(swap, idx2, idx1)
    hi_idx = np.where(swap, idx1, idx2)
    lo, hi = np.where(swap, lum2, lum1), np.where(swap, lum1, lum2)
    denom = hi - lo
    frac = np.where(np.abs(denom) < 1e-6, 0.0, (lum_pix - lo) / np.where(denom == 0, 1, denom))
    frac = np.clip(frac, 0.0, 1.0)
    m = bayer.shape[0]
    thresh_map = bayer.astype(np.float64) / (m * m)
    yy, xx = np.mgrid[0:h, 0:w]
    thresh = thresh_map[yy % m, xx % m].reshape(-1)
    chosen = np.where(frac > thresh, hi_idx, lo_idx)
    chosen = np.where(d1 == 0.0, idx1, chosen)
    return palette_u8[chosen].reshape(h, w, 3).astype(np.uint8)


def error_diffusion_dither_numpy(
    image_float: np.ndarray, diff_map, palette_f: np.ndarray
) -> np.ndarray:
    """Serpentine error diffusion, pure-numpy reference implementation
    (quantize.py:84-134 semantics: snake rows, mirrored dx on odd rows,
    future-pixel-only diffusion, clamp to [0,255] after each deposit).
    Modifies and returns a float64 copy. Slow; the C++ kernel in
    runtime/dither.cc is the production path."""
    img = image_float.astype(np.float64).copy()
    h, w, _ = img.shape
    for y in range(h):
        forward = y % 2 == 0
        xs = range(w) if forward else range(w - 1, -1, -1)
        for x in xs:
            px = img[y, x]
            d = ((palette_f - px) ** 2).sum(1)
            ci = int(np.argmin(d))
            closest = palette_f[ci]
            err = px - closest
            img[y, x] = closest
            if not err.any():
                continue
            for dx, dy, wgt in diff_map:
                edx = dx if forward else -dx
                nx, ny = x + edx, y + dy
                if 0 <= ny < h and 0 <= nx < w:
                    if ny > y or (ny == y and ((forward and nx > x) or (not forward and nx < x))):
                        img[ny, nx] = np.clip(img[ny, nx] + err * wgt, 0.0, 255.0)
    return img


def error_diffusion_dither(
    image_float: np.ndarray, method: str, palette_f: np.ndarray
) -> np.ndarray:
    """Dispatch to the native C++ kernel when available, numpy otherwise."""
    from ..runtime import native

    diff_map = DIFFUSION_MAPS[method]
    if native.available():
        return native.error_diffusion(image_float, diff_map, palette_f)
    return error_diffusion_dither_numpy(image_float, diff_map, palette_f)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def _device_dither(img: np.ndarray, palette_u8: np.ndarray, method: str, bayer,
                   device) -> np.ndarray:
    """One crop through K3's wrapper on ``device`` (the plain version on the CPU)."""
    from ..ops.cuda.dither import palette_dither

    dev = resolve_device(device)
    x = torch.from_numpy(np.array(img, np.uint8)).to(dev)[None]  # a copy: PIL arrays are read-only
    pal = torch.from_numpy(np.array(palette_u8, np.uint8)).to(dev)[None]
    return palette_dither(x, pal, method, bayer)[0].cpu().numpy()


def reduce_color_depth_and_dither(
    image_np: np.ndarray,
    color_space: str,
    target_palette_size: Optional[int] = None,
    dithering_method: str = "none",
    palette_algorithm: str = "kmeans",
    verbose: int = 0,
    backend: str = "numpy",
    device=None,
) -> np.ndarray:
    """Reduce colour depth of an RGB888 image, optionally generate a palette,
    optionally dither. Same surface, validation and semantics as the
    reference entry point (quantize.py:395-600).

    ``backend='device'`` runs the vectorizable dither families (nearest
    mapping, checkerboard, Bayer ordered) through K3 on ``device`` (default
    ``cuda``; on the CPU, its plain version); ``'numpy'`` is the host path.
    ``palette_algorithm='kmeans_torch'`` computes the palette on ``device``
    with either backend. Error diffusion always runs on the host (native
    C++/numpy).
    """
    if image_np.ndim != 3 or image_np.shape[2] != 3 or image_np.dtype != np.uint8:
        raise ValueError(
            "Input image must be a 3-channel (RGB) NumPy array of type uint8."
        )
    if color_space not in VALID_COLOR_SPACES:
        raise ValueError(f"color_space must be one of {VALID_COLOR_SPACES}.")
    if target_palette_size not in VALID_PALETTE_SIZES:
        raise ValueError(f"target_palette_size must be one of {VALID_PALETTE_SIZES}.")
    methods = valid_dither_methods()
    if dithering_method not in methods:
        raise ValueError(f"dithering_method must be one of {methods}.")
    if palette_algorithm not in VALID_PALETTE_ALGORITHMS:
        raise ValueError(
            f"palette_algorithm must be one of {VALID_PALETTE_ALGORITHMS}."
        )
    if backend not in VALID_BACKENDS:
        raise ValueError(f"backend must be one of {VALID_BACKENDS}.")
    if dithering_method != "none" and target_palette_size is None:
        raise ValueError(
            f"Dithering method '{dithering_method}' requires 'target_palette_size' "
            "to be specified."
        )

    palette_u8 = None
    palette_f = None
    if target_palette_size is not None:
        # palette source pixels come from the grid-quantized image
        # (quantize.py:458-474)
        pixels = grid_quantize(image_np, color_space).reshape(-1, 3)
        unique_colors = np.unique(pixels, axis=0)
        n_clusters = min(target_palette_size, len(unique_colors))
        if n_clusters == 0:
            palette_u8 = np.zeros((1, 3), np.uint8)
        elif n_clusters < target_palette_size:
            palette_u8 = unique_colors.astype(np.uint8)
        elif palette_algorithm == "kmeans":
            palette_u8 = generate_palette_kmeans_sklearn(pixels, n_clusters)
        elif palette_algorithm == "kmeans_torch":
            palette_u8 = generate_palette_kmeans_torch(
                pixels.astype(np.float32), n_clusters, device=device)
        elif palette_algorithm == "median_cut":
            palette_u8 = generate_palette_median_cut(image_np, n_clusters)
        elif palette_algorithm == "octree":
            palette_u8 = generate_palette_octree(image_np, n_clusters)
        palette_f = palette_u8.astype(np.float64)

    img_f = image_np.astype(np.float64)
    use_device = backend == "device" and palette_u8 is not None and (
        2 <= palette_u8.shape[0] <= 1024
    )

    if dithering_method == "none":
        if target_palette_size is None:
            if color_space == "RGB888":
                return image_np.copy()
            return np.clip(grid_quantize(image_np, color_space), 0, 255).astype(np.uint8)
        if use_device:
            return _device_dither(image_np, palette_u8, "none", None, device)
        return map_to_palette(img_f, palette_u8)

    if dithering_method == "checkerboard":
        if use_device:
            return _device_dither(image_np, palette_u8, "checkerboard", None, device)
        # native C++ kernel when available (same dispatch pattern as error
        # diffusion; byte-identical to numpy — tests/test_quantize.py)
        from ..runtime import native

        if native.available() and palette_u8.shape[0] >= 2:
            return native.checkerboard(img_f, palette_u8)
        return checkerboard_dither(img_f, palette_u8)

    if dithering_method.startswith("bayer"):
        bayer = {
            "bayer2x2": BAYER_MATRIX_2X2,
            "bayer4x4": BAYER_MATRIX_4X4,
            "bayer8x8": BAYER_MATRIX_8X8,
        }[dithering_method]
        if use_device:
            return _device_dither(image_np, palette_u8, "ordered", bayer, device)
        return ordered_dither(img_f, palette_u8, bayer)

    # error diffusion
    out = error_diffusion_dither(img_f, dithering_method, palette_f)
    return np.clip(out, 0, 255).astype(np.uint8)
