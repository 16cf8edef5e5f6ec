"""Host-side image geometry + Amiga display simulation.

Counterpart of reference ``dataset_generator/util.py``: black-ratio crop
rejection (util.py:64-103), crop with black padding and negative coords
(util.py:105-158), supersampled anti-aliased rotation (util.py:160-191),
LANCZOS downscaling (util.py:193-227), and the Amiga resolution styles
(util.py:284-350): quantization happens at the *low* resolution between
``pre_apply_resolution_style`` (BICUBIC downsample) and
``post_apply_resolution_style`` (NEAREST upsample).
"""
from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
from PIL import Image, ImageOps

SUPPORTED_RESOLUTION_STYLES = ["lores", "hires", "lores_laced", "hires_laced"]


def is_pure_black(img: Image.Image) -> bool:
    if img.mode != "RGB":
        img = img.convert("RGB")
    return all(mx == 0 for _mn, mx in img.getextrema())


def should_discard_by_black_ratio(img: Image.Image, threshold: float = 0.75) -> bool:
    """Reject crops that are >= threshold pure black (util.py:64-103)."""
    arr = np.asarray(img.convert("RGB") if img.mode != "RGB" else img)
    black = np.all(arr == 0, axis=-1)
    return float(black.mean()) >= threshold


def get_crop_and_pad(
    img: Image.Image, crop_x: int, crop_y: int, crop_w: int, crop_h: int
) -> Image.Image:
    """Crop (crop_w, crop_h) at possibly-negative (crop_x, crop_y), padding
    out-of-bounds regions with black (util.py:105-158)."""
    iw, ih = img.size
    pad_l = max(0, -crop_x)
    pad_t = max(0, -crop_y)
    pad_r = max(0, crop_x + crop_w - iw)
    pad_b = max(0, crop_y + crop_h - ih)
    if pad_l or pad_t or pad_r or pad_b:
        img = ImageOps.expand(img, border=(pad_l, pad_t, pad_r, pad_b), fill=(0, 0, 0))
    x1, y1 = crop_x + pad_l, crop_y + pad_t
    out = img.crop((x1, y1, x1 + crop_w, y1 + crop_h))
    if out.size != (crop_w, crop_h):
        warnings.warn(f"crop produced {out.size}, expected {(crop_w, crop_h)}")
        return Image.new("RGB", (crop_w, crop_h), (0, 0, 0))
    return out


def apply_rotation(
    img: Image.Image, angle_degrees: int, supersample_factor: int = 2,
    resample=Image.Resampling.BICUBIC,
) -> Image.Image:
    """Anti-aliased rotation: upsample, NEAREST-rotate, downsample
    (util.py:160-191). Returns a copy when angle % 360 == 0."""
    if supersample_factor < 1:
        raise ValueError("supersample_factor must be >= 1")
    if angle_degrees % 360 == 0:
        return img.copy()
    w, h = img.size
    if supersample_factor > 1:
        big = img.resize((w * supersample_factor, h * supersample_factor), resample)
        rot = big.rotate(angle_degrees, resample=Image.Resampling.NEAREST)
        return rot.resize((w, h), resample)
    return img.rotate(angle_degrees, resample=resample)


def apply_downscaling(img: Image.Image, percentage: int) -> Image.Image:
    """LANCZOS downscale to percentage% of the original (util.py:193-227)."""
    if percentage <= 0 or percentage >= 100:
        warnings.warn(
            f"Invalid downscale percentage {percentage}%. Must be > 0 and < 100."
        )
        return img.copy()
    w, h = img.size
    tw = max(1, int(w * percentage / 100.0))
    th = max(1, int(h * percentage / 100.0))
    if (tw, th) == (w, h):
        return img.copy()
    return img.resize((tw, th), Image.Resampling.LANCZOS)


def pre_apply_resolution_style(img: Image.Image, style: str) -> Image.Image:
    """Downsample to the style's physical resolution (util.py:284-316):
    lores W/2,H/2; lores_laced W/2,H; hires W,H/2; hires_laced identity."""
    if style not in SUPPORTED_RESOLUTION_STYLES:
        warnings.warn(f"Unknown resolution style '{style}'.")
        return img.copy()
    w, h = img.size
    r = Image.Resampling.BICUBIC
    if style == "lores":
        return img.resize((w // 2, h // 2), r)
    if style == "lores_laced":
        return img.resize((w // 2, h), r)
    if style == "hires":
        return img.resize((w, h // 2), r)
    return img.copy()  # hires_laced


def post_apply_resolution_style(img: Image.Image, style: str) -> Image.Image:
    """NEAREST-upsample back to the crop size (util.py:318-350)."""
    if style not in SUPPORTED_RESOLUTION_STYLES:
        warnings.warn(f"Unknown resolution style '{style}'.")
        return img.copy()
    w, h = img.size
    r = Image.Resampling.NEAREST
    if style == "lores":
        return img.resize((w * 2, h * 2), r)
    if style == "lores_laced":
        return img.resize((w * 2, h), r)
    if style == "hires":
        return img.resize((w, h * 2), r)
    return img.copy()  # hires_laced


def calculate_grid_coords(
    img_w: int, img_h: int, crop_w: int, crop_h: int,
    overlap_percentage: float = 0.20,
) -> list[Tuple[int, int]]:
    """Centered overlapping crop grid; 80% step (generator.py:68-117).
    Coordinates may be negative (padding handles the borders)."""
    import math

    if crop_w <= 0 or crop_h <= 0 or img_w <= 0 or img_h <= 0:
        return []
    step_x = max(1, int(crop_w * (1.0 - overlap_percentage)))
    step_y = max(1, int(crop_h * (1.0 - overlap_percentage)))
    nx = max(1, math.ceil(img_w / step_x))
    ny = max(1, math.ceil(img_h / step_y))
    total_w = (nx - 1) * step_x + crop_w
    total_h = (ny - 1) * step_y + crop_h
    off_x = (total_w - img_w) // 2
    off_y = (total_h - img_h) // 2
    return [
        (i * step_x - off_x, j * step_y - off_y)
        for i in range(nx)
        for j in range(ny)
    ]
