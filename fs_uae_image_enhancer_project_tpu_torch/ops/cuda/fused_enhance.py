"""A whole pix_shuffle enhance call as one launch of K1: uint8 RGBA frames
in, uint8 RGBA frames out.

``make_enhance_fn`` over the lightweight pix_shuffle model runs, around K1,
an eager prologue (crop, ``/255``, ``pow``, bf16), the model's unshuffle,
bf16 copy, shuffle, residual add and relu, and an eager epilogue (``pow``,
``x255``, clip, uint8, the crop strip, alpha): some 20 launches and
intermediates a call. K1's enhance entry (``stack_kernel_u8`` in
``csrc/fused_enhance.cu``) does all of it in its load and store, through two
tables that this module makes on the card from ``export/enhance.py``'s own
prologue and epilogue:

- ``lut_in``: 256 bf16, the prologue's value of each input byte;
- ``lut_out``: 65,536 uint8, relu and the epilogue of each bf16 bit
  pattern of ``x + y``.

Both ends are elementwise, so the kernel's frames equal the eager
composition's byte for byte: the same bf16 input, the same K1 arithmetic,
the same bf16 add, the same epilogue.

- :func:`make_fused_enhance_fn` builds the enhance (:class:`FusedEnhance`)
  that ``export/enhance.py``'s ``enhance_from_onnx`` returns for the
  lightweight pix_shuffle graph.
- :func:`fused_enhance_plain` is the kernel's function in eager torch
  (its load and store index maps, :func:`unshuffle_map` and
  :func:`shuffle_map`, around K1's plain version): the CPU tests hold it to
  the composition.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ... import CROP_LEFT, resolve_device
from ...export.enhance import frames_on, make_enhance_fn, to_model_input, to_uint8
from ...models import get_model
from ...utils.profiler import span
from .fused_stack import (StackWeights, apply_stack, fused_stack, fused_stack_plain,
                          prepare_weights)


class Tables(NamedTuple):
    """The prologue's table (256 bf16) and the epilogue's (65,536 uint8)."""

    lut_in: torch.Tensor
    lut_out: torch.Tensor


def make_tables(device, *, srgb_domain: bool = False, srgb_to_linear_exponent: float = 2.2,
                linear_to_srgb_exponent: float = 1.0 / 2.2) -> Tables:
    """Run ``export/enhance.py``'s prologue over every byte and relu and its
    epilogue over every bf16 bit pattern, on ``device``."""
    lut_in = to_model_input(torch.arange(256, dtype=torch.uint8, device=device),
                            srgb_domain=srgb_domain, exponent=srgb_to_linear_exponent)
    patterns = torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(np.int16))
    v = torch.relu(patterns.to(device).view(torch.bfloat16))
    lut_out = to_uint8(v, srgb_domain=srgb_domain, exponent=linear_to_srgb_exponent)
    return Tables(lut_in.contiguous(), lut_out.contiguous())


def unshuffle_map(h2: int, w2: int, crop: int):
    """The kernel's load as index tensors, each broadcast to ``(h2, w2,
    12)``: channel ``c*4 + ry*2 + rx`` of half-res pixel ``(iy, ix)`` reads
    colour ``c`` of full-res pixel ``(2 iy + ry, crop + 2 ix + rx)``.
    Returns (row, column, colour)."""
    k = torch.arange(12)
    c, ry, rx = k // 4, (k // 2) % 2, k % 2
    iy, ix = torch.arange(h2).view(-1, 1, 1), torch.arange(w2).view(1, -1, 1)
    return 2 * iy + ry, crop + 2 * ix + rx, c


def shuffle_map(h: int, w: int, crop: int):
    """The kernel's store as index tensors, each broadcast to ``(h, w -
    crop, 3)``: colour ``c`` of full-res pixel ``(r, crop + col)`` reads
    channel ``c*4 + (r % 2)*2 + col % 2`` of half-res pixel ``(r // 2, col //
    2)``. Returns (row, column, channel)."""
    r, col = torch.arange(h).view(-1, 1, 1), torch.arange(w - crop).view(1, -1, 1)
    c = torch.arange(3)
    return r // 2, col // 2, c * 4 + (r % 2) * 2 + col % 2


def fused_enhance_plain(frames: torch.Tensor, tables: Tables, sw: StackWeights,
                        crop: int) -> torch.Tensor:
    """K1's enhance entry in eager torch, on any device: (N, H, W, 4) uint8
    -> (N, H, W, 4) uint8, with the stack's plain version in K1's place."""
    n, h, w, _ = frames.shape
    idx = frames.long()
    r, col, c = unshuffle_map(h // 2, (w - crop) // 2, crop)
    u = tables.lut_in[idx[:, r, col, c]].contiguous()
    y = fused_stack_plain(u, sw)
    r, col, k = shuffle_map(h, w, crop)
    x = tables.lut_in[idx[:, :, crop:, :3]]
    v = (x.float() + y[:, r, col, k].float()).to(torch.bfloat16)
    out = torch.empty((n, h, w, 4), dtype=torch.uint8, device=frames.device)
    out[:, :, :crop, :3] = 0
    out[:, :, crop:, :3] = tables.lut_out[v.view(torch.int16).long() & 0xFFFF]
    out[..., 3] = 255
    return out


class FusedEnhance:
    """``enhance(frames_u8) -> frames_u8`` for the lightweight pix_shuffle
    graph, ``make_enhance_fn``'s contract.

    On a card each call is :meth:`fused`: the upload of host frames, the
    check, the output's allocation and one launch of K1's enhance entry,
    counted in ``fused_stack.launches`` and ``fused_stack.u8_launches``.
    While ``torch.export`` or ``torch.compile`` traces it, and on the CPU,
    it is ``composition``: ``make_enhance_fn`` over the model's forward, the
    eager glue around K1 (or the eager forward), as before this entry.
    """

    def __init__(self, composition, device: torch.device, crop: int, tables: Tables,
                 sw: StackWeights):
        self.composition = composition
        self.device = device
        self.on_card = device.type == "cuda"
        self.crop = crop
        self.tables = tables
        self.sw = sw
        if self.on_card:
            from .build import load_library

            self._lib = load_library()
            rc = self._lib.fse_fused_stack_u8_init(device.index)
            if rc != 0:
                raise RuntimeError(f"fse_fused_stack_u8_init failed: CUDA error {rc}")
            self._weights = (tables.lut_in.data_ptr(), tables.lut_out.data_ptr(),
                             *(t.data_ptr() for t in sw.frags), sw.prm.data_ptr())

    def __call__(self, frames) -> torch.Tensor:
        if self.on_card and not torch.compiler.is_compiling():
            return self.fused(frames)
        return self.composition(frames)

    def fused(self, frames) -> torch.Tensor:
        """One call through K1's enhance entry (its plain version for frames
        on the CPU)."""
        with span("fse.enhance"):
            frames = self._checked(frames_on(frames, self.device))
            out = torch.empty(frames.shape, dtype=torch.uint8, device=frames.device)
            with span("fse.enhance.model"):
                if frames.is_cuda:
                    self._launch(frames, out)
                else:
                    out.copy_(fused_enhance_plain(frames, self.tables, self.sw, self.crop))
            return out

    def _checked(self, frames: torch.Tensor) -> torch.Tensor:
        if frames.dtype != torch.uint8 or frames.dim() != 4 or frames.shape[-1] != 4:
            raise ValueError("enhance expects uint8 RGBA NHWC frames, got "
                             f"{frames.dtype} {tuple(frames.shape)}")
        n, h, w, _ = frames.shape
        if h < 2 or h % 2 or w - self.crop < 2 or (w - self.crop) % 2 or not 1 <= n <= 65535:
            raise ValueError(f"the fused enhance takes 1 to 65535 frames of even height and "
                             f"an even width of at least 2 after the crop of {self.crop}, got "
                             f"{tuple(frames.shape)}")
        frames = frames.contiguous()
        if frames.data_ptr() % 8:
            raise ValueError("the fused enhance takes 8-byte aligned frames")
        return frames

    def _launch(self, frames: torch.Tensor, out: torch.Tensor) -> None:
        n, h, w, _ = frames.shape
        rc = self._lib.fse_fused_stack_u8(
            frames.data_ptr(), out.data_ptr(), *self._weights, n, h, w, self.crop,
            self.device.index, torch.cuda.current_stream(self.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fse_fused_stack_u8 kernel launch failed: CUDA error {rc}")
        fused_stack.launches += 1
        fused_stack.u8_launches += 1


def make_fused_enhance_fn(params, *, crop_left: int = CROP_LEFT, compute_dtype=torch.bfloat16,
                          srgb_domain: bool = False, srgb_to_linear_exponent: float = 2.2,
                          linear_to_srgb_exponent: float = 1.0 / 2.2, device=None):
    """``make_enhance_fn`` over the lightweight pix_shuffle model, with the
    same arguments: a :class:`FusedEnhance` where K1's enhance entry takes
    the contract (bf16 compute, an even crop), else ``make_enhance_fn``'s
    enhance. ``params`` are the model's own, on ``device``; K1's weights and
    the tables are made from them once, here, and the composition on a card
    (K1's bf16 entry, under a trace) takes the same weights."""
    dev = resolve_device(device)
    contract = dict(crop_left=crop_left, compute_dtype=compute_dtype, srgb_domain=srgb_domain,
                    srgb_to_linear_exponent=srgb_to_linear_exponent,
                    linear_to_srgb_exponent=linear_to_srgb_exponent)
    model_apply = get_model("pix_shuffle").apply
    if compute_dtype != torch.bfloat16 or crop_left % 2:
        return make_enhance_fn(model_apply, params, device=dev, **contract)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    sw = prepare_weights(params, dev)
    if dev.type == "cuda":
        def model_apply(p, x):  # the model's bf16 route on a card, on the weights made here
            return apply_stack(fused_stack, lambda _p, _dev: sw, p, x, None)
    tables = make_tables(dev, srgb_domain=srgb_domain,
                         srgb_to_linear_exponent=srgb_to_linear_exponent,
                         linear_to_srgb_exponent=linear_to_srgb_exponent)
    composition = make_enhance_fn(model_apply, params, device=dev, **contract)
    return FusedEnhance(composition, dev, crop_left, tables, sw)
