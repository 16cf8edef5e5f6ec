"""K3: palette dithering of a batch of crops, each onto its own palette.

Counterpart of ``fs_uae_image_enhancer_project_tpu/ops/pallas/dither.py``
(``_dither_kernel`` at line 49, through ``pallas_palette_dither`` and
``pallas_palette_dither_batch_per_palette``). The kernel
(``csrc/dither.cu``) maps uint8 crops ``(B, H, W, 3)`` and uint8 palettes
``(B, N, 3)``, 2 <= N <= 1024, to uint8 ``(B, H, W, 3)``: per pixel the
nearest and second-nearest palette colours (ties to the lowest index), then
MAP, CHECKER or ORDERED (fp32 Bayer compare), then the chosen colour. It is
bound by the N distance evaluations per pixel on the CUDA cores (the source
note counts them); its design is one thread per pixel with the palette in
shared memory and one pass that keeps the best two.

- :func:`palette_dither` is the kernel's wrapper. A CUDA tensor launches the
  kernel (or raises); a CPU tensor takes :func:`palette_dither_plain`. Its
  launches are counted in ``palette_dither.launches``.
- :func:`palette_dither_plain` is the same function in eager torch, on any
  device, in the kernel's order of operations (separate torch ops, so no
  contraction). It also takes float32 pixels, which the kernel does not.
- :func:`palette_luminance` computes the palettes' luminance as the JAX
  wrapper does, with numpy on the host: the kernel takes it as an input.

Equality with the Pallas kernel: byte for byte on integer-valued pixels. For
non-integer float pixels the Pallas kernel's |x|^2 - 2x.p + |p|^2 distances
round differently from the direct form here, and near-ties can go the other
way (the JAX package's own bound for such inputs is a 0.98 pixel match).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

LUMA = (0.2126, 0.7152, 0.0722)
MODE_MAP, MODE_CHECKER, MODE_ORDERED = 0, 1, 2
MODES = {"none": MODE_MAP, "checkerboard": MODE_CHECKER, "ordered": MODE_ORDERED}
MAX_COLORS = 1024
# pixel-colour pairs per chunk of the plain version's distance matrix
_PLAIN_CHUNK = 1 << 22


def palette_luminance(palettes: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) uint8 -> (B, N) fp32 luminance, on the palettes' device.

    Computed as the JAX wrapper computes it (``pal_f @ LUMA`` in numpy
    float32, ``ops/pallas/dither.py:287``), so that the two packages see the
    same palette luminance. numpy's product goes through the host's BLAS,
    whose rounding order is its own (it depends on the library and on the
    array's size) and differs from any one fixed formula in the last bit for
    some colours; a fixed formula in the kernel would let the ORDERED choice
    flip where frac sits within that bit of a Bayer threshold.
    """
    pal = palettes.detach().to("cpu").numpy().astype(np.float32)
    lum = pal @ np.asarray(LUMA, np.float32)
    return torch.from_numpy(np.ascontiguousarray(lum)).to(palettes.device)


def _mode(method: str, bayer) -> int:
    if method not in MODES:
        raise ValueError(f"method must be one of {sorted(MODES)}, got {method!r}")
    mode = MODES[method]
    if mode == MODE_ORDERED:
        if bayer is None:
            raise ValueError("ordered dithering needs a bayer matrix")
        m = np.asarray(bayer).shape
        if len(m) != 2 or m[0] != m[1] or m[0] not in (2, 4, 8):
            raise ValueError(f"the bayer matrix must be 2x2, 4x4 or 8x8, got {m}")
    return mode


def _check(images: torch.Tensor, palettes: torch.Tensor, pal_lum: Optional[torch.Tensor]):
    if images.dim() != 4 or images.shape[3] != 3 or min(images.shape[:3]) < 1:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    if images.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"images must be uint8 (or float32 on the CPU), got {images.dtype}")
    if palettes.dim() != 3 or palettes.shape[2] != 3 or palettes.shape[0] != images.shape[0]:
        raise ValueError(
            f"palettes must be (B, N, 3) with B = {images.shape[0]}, got {tuple(palettes.shape)}")
    if palettes.dtype != torch.uint8:
        raise ValueError(f"palettes must be uint8, got {palettes.dtype}")
    n = palettes.shape[1]
    if n < 2 or n > MAX_COLORS:
        raise ValueError(f"palette dithering takes 2..{MAX_COLORS} colours, got {n}")
    if palettes.device != images.device:
        raise ValueError("images and palettes must be on one device")
    if pal_lum is not None and (pal_lum.dtype != torch.float32
                                or tuple(pal_lum.shape) != tuple(palettes.shape[:2])
                                or pal_lum.device != images.device):
        raise ValueError("pal_lum must be (B, N) float32 on the images' device")


def _threshold_map(bayer, h: int, w: int, device) -> torch.Tensor:
    """(H, W) fp32 Bayer thresholds bayer / (m * m), as numpy's fp32 division."""
    b = np.asarray(bayer)
    norm = b.astype(np.float32) / np.float32(b.shape[0] * b.shape[0])
    yy, xx = np.mgrid[0:h, 0:w]
    return torch.from_numpy(np.ascontiguousarray(norm[yy % b.shape[0], xx % b.shape[0]])).to(device)


def _pixel_luminance(x: torch.Tensor) -> torch.Tensor:
    """fma(b, L2, fma(r, L0, g * L1)) in fp32, the kernel's formula. Each fma
    is one rounding: its product and sum are exact in float64 for pixel
    values that are integers in [0, 255] (for other floats it can differ from
    a true fma in the last bit)."""
    f32, f64 = torch.float32, torch.float64
    l0, l1, l2 = (float(np.float32(v)) for v in LUMA)  # the fp32 weights, exactly
    t = x[..., 1] * torch.tensor(l1, dtype=f32, device=x.device)  # fp32, one rounding
    t = (x[..., 0].to(f64) * l0 + t.to(f64)).to(f32)
    return (x[..., 2].to(f64) * l2 + t.to(f64)).to(f32)


def palette_dither_plain(images: torch.Tensor, palettes: torch.Tensor, method: str = "none",
                         bayer=None, pal_lum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's function in eager torch, on any device: (B, H, W, 3) uint8 or
    float32 pixels and (B, N, 3) uint8 palettes -> (B, H, W, 3) uint8."""
    mode = _mode(method, bayer)
    _check(images, palettes, pal_lum)
    b, h, w, _ = images.shape
    n = palettes.shape[1]
    dev = images.device
    x = images.reshape(b, h * w, 3).to(torch.float32)
    pal = palettes.to(torch.float32)
    i1s, d1s, i2s = [], [], []
    step = max(1, _PLAIN_CHUNK // (b * n))
    for lo in range(0, h * w, step):
        xc = x[:, lo:lo + step]
        diff = xc[:, :, None, :] - pal[:, None, :, :]
        sq = diff * diff
        d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]  # (B, chunk, N)
        i1 = d.argmin(dim=2, keepdim=True)  # first index of the minimum
        d1s.append(d.gather(2, i1)[..., 0])
        i1s.append(i1[..., 0])
        if mode != MODE_MAP:
            i2s.append(d.scatter(2, i1, float("inf")).argmin(dim=2))
    i1, d1 = torch.cat(i1s, 1), torch.cat(d1s, 1)
    chosen = i1
    if mode != MODE_MAP:
        i2 = torch.cat(i2s, 1)
        yy, xx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                indexing="ij")
        if mode == MODE_CHECKER:
            alt = torch.where(((xx + yy) % 2 == 0).reshape(1, -1), i1, i2)
        else:
            lum_pal = palette_luminance(palettes) if pal_lum is None else pal_lum
            lum = _pixel_luminance(x)
            l1, l2 = lum_pal.gather(1, i1), lum_pal.gather(1, i2)
            swap = l1 > l2
            lo_i, hi_i = torch.where(swap, i2, i1), torch.where(swap, i1, i2)
            lo, hi = torch.minimum(l1, l2), torch.maximum(l1, l2)
            den = hi - lo
            safe = torch.where(den == 0, torch.ones_like(den), den)
            frac = torch.where(den.abs() < 1e-6, torch.zeros_like(den),
                               (lum - lo) / safe)
            frac = frac.clamp(0.0, 1.0)
            thresh = _threshold_map(bayer, h, w, dev).reshape(1, -1)
            alt = torch.where(frac > thresh, hi_i, lo_i)
        chosen = torch.where(d1 == 0, i1, alt)
    out = palettes.gather(1, chosen[..., None].expand(b, h * w, 3))
    return out.reshape(b, h, w, 3)


def palette_dither(images: torch.Tensor, palettes: torch.Tensor, method: str = "none",
                   bayer=None, pal_lum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3's wrapper: (B, H, W, 3) uint8 crops, (B, N, 3) uint8 palettes ->
    (B, H, W, 3) uint8. ``method`` is 'none', 'checkerboard' or 'ordered'
    (with a 2x2, 4x4 or 8x8 ``bayer``). ``pal_lum`` is the palettes'
    luminance, computed by :func:`palette_luminance` when not given.

    A CUDA tensor launches the kernel on the current stream (no synchronise,
    no allocation inside the kernel); a CPU tensor takes the plain version.
    """
    if images.device.type == "cpu":
        return palette_dither_plain(images, palettes, method, bayer, pal_lum)
    mode = _mode(method, bayer)
    _check(images, palettes, pal_lum)
    if images.device.type != "cuda":
        raise ValueError(f"palette_dither runs on cuda or cpu, got {images.device}")
    if images.dtype != torch.uint8:
        raise ValueError(f"the kernel takes uint8 images, got {images.dtype}")
    if not images.is_contiguous() or not palettes.is_contiguous():
        raise ValueError("palette_dither takes contiguous images and palettes")
    lum = palette_luminance(palettes) if pal_lum is None else pal_lum.contiguous()
    b, h, w, _ = images.shape
    if mode == MODE_ORDERED:
        bay = np.ascontiguousarray(np.asarray(bayer), dtype=np.int32)
        bay_m, bay_ptr = bay.shape[0], bay.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    else:
        bay_m, bay_ptr = 0, None
    from .build import load_library

    lib = load_library()
    out = torch.empty_like(images)
    rc = lib.fse_palette_dither(
        images.data_ptr(), palettes.data_ptr(), lum.data_ptr(), out.data_ptr(),
        b, h, w, palettes.shape[1], mode, bay_m, bay_ptr, images.device.index,
        torch.cuda.current_stream(images.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"palette_dither kernel launch failed: CUDA error {rc}")
    palette_dither.launches += 1
    return out


palette_dither.launches = 0


def kernel_ops(images: torch.Tensor, palettes: torch.Tensor, method: str) -> float:
    """fp32 operations K3 does on these inputs: N distance evaluations per
    pixel at 8 flops (3 sub, 1 mul, 2 fma) plus 1 compare (MAP) or 2 (the
    two-nearest search). The per-pixel epilogue is left out."""
    b, h, w, _ = images.shape
    per_pair = 9 if MODES[method] == MODE_MAP else 10
    return float(b * h * w * palettes.shape[1] * per_pair)
