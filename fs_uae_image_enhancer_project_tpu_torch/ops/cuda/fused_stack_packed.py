"""K2: the lightweight pix_shuffle conv stack with pair-packed GEMMs.

Counterpart of ``fs_uae_image_enhancer_project_tpu/ops/pallas/
fused_stack_packed.py`` (``_stack_kernel`` via ``_run_stack``, entry
``fused_stack_packed_apply``). It computes K1's function, with two output
pixels per matmul row: each conv is a product of [A|O] windows (columns
2t-1..2t+2 of 3 rows, 12 cin values) with the pair-packed weights of
:func:`pack_conv_weight`, (12 cin, 2 cout). The kernel
(``csrc/fused_stack_packed.cu``) keeps K1's per-pixel buffers, tile and halo
scheme and changes only the GEMM's shape and weights; the wrapper contract
is K1's:

- :func:`fused_stack_packed` is the kernel's wrapper, (H2, W2, 12) or
  (N, H2, W2, 12) bf16 -> the same shape. A CUDA tensor launches the kernel
  (or raises); a CPU tensor takes :func:`fused_stack_packed_plain`. Its
  launches are counted in ``fused_stack_packed.launches``.
- :func:`fused_stack_packed_plain` is the same function in eager torch, in
  the pair-packed form: the [A|O] windows built from the bf16-rounded
  layers and multiplied by the packed weights in fp32, with K1's bf16
  rounding points and exact activations. So the CPU tests check the packing
  layout itself against the Pallas kernel.
- :func:`prepare_weights` lays the packed weights out in mma.sync B-fragment
  order; the biases and activation parameters are K1's vector.

As for K1 there is no ``fallback``: a config other than the lightweight one,
or a shape the kernel does not take, raises ``ValueError``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .fused_stack import (LAYERS, Params, StackWeights, _prm, apply_stack, cached, check_input,
                          conv_weights, fragments, launch_stack, param_vector, stack_plain)


def pack_conv_weight(w: np.ndarray) -> np.ndarray:
    """(3,3,cin,cout) -> (12*cin, 2*cout) packed-pair im2col weights (a copy
    of the Pallas wrapper's ``_pack_conv_weight``).

    Operand layout: for dy in 0..2, the window pair [A = O[t-1] (cols 2t-1,
    2t), B = O[t] (cols 2t+1, 2t+2)], each group's lanes being (pair_offset,
    cin). Output columns (p, cout) with p=0 -> col 2t, p=1 -> col 2t+1. Tap
    (dy, dx) of output col c reads input col c-1+dx:
        p=0: dx0 -> (A,0)  dx1 -> (A,1)  dx2 -> (B,0)
        p=1: dx0 -> (A,1)  dx1 -> (B,0)  dx2 -> (B,1)
    The (A,0,p=1) and (B,1,p=0) blocks are structural zeros (25% of K).
    """
    _, _, cin, cout = w.shape
    w2 = np.zeros((3, 2, 2, cin, 2, cout), np.float32)  # dy,u,xoff,cin,p,cout
    for dy in range(3):
        w2[dy, 0, 0, :, 0, :] = w[dy, 0]  # A0 -> p0 dx0
        w2[dy, 0, 1, :, 0, :] = w[dy, 1]  # A1 -> p0 dx1
        w2[dy, 1, 0, :, 0, :] = w[dy, 2]  # B0 -> p0 dx2
        w2[dy, 0, 1, :, 1, :] = w[dy, 0]  # A1 -> p1 dx0
        w2[dy, 1, 0, :, 1, :] = w[dy, 1]  # B0 -> p1 dx1
        w2[dy, 1, 1, :, 1, :] = w[dy, 2]  # B1 -> p1 dx2
    return w2.reshape(12 * cin, 2 * cout)


def _packed_sources(w: torch.Tensor, sources):
    """The packed (12 cin, 2 cout) fp32 matrix of each source's slice of the
    HWIO weight ``w`` (layer 6 has two sources, l1 and l5, as the Pallas
    kernel's w6a and w6b)."""
    out, c0 = [], 0
    for cin, _ in sources:
        out.append(torch.from_numpy(pack_conv_weight(w[:, :, c0:c0 + cin, :].numpy())))
        c0 += cin
    return out


def prepare_weights(params: Params, device) -> StackWeights:
    """Lay out the lightweight model's parameters for K2 and its plain
    version, on ``device``: per layer the B fragments of the (K, 2 cout)
    matrix whose rows run over the 12 taps (dy, column) of each source, cin
    padded to K1's chunks of 8; the packed matrices, bf16-rounded, for the
    plain version (one per source); K1's parameter vector."""
    frags, plain = [], []
    for (_name, sources, cout, _cp), w in zip(LAYERS, conv_weights(params)):
        packed = _packed_sources(w, sources)
        rows = [F.pad(m.reshape(12, cin, 2 * cout), (0, 0, 0, cin_pad - cin)).reshape(-1, 2 * cout)
                for m, (cin, cin_pad) in zip(packed, sources)]
        frags.append(fragments(torch.cat(rows)))
        plain.append(tuple(m.to(torch.bfloat16).float() for m in packed))
    return StackWeights(
        tuple(f.to(device) for f in frags),
        tuple(tuple(m.to(device) for m in p) for p in plain),
        param_vector(params).to(device),
    )


prepare_weights_cached = cached(prepare_weights)


def packed_conv(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """A 3x3 SAME conv (no bias) in the pair-packed form: x (N, C, H, W)
    fp32, wp (12 C, 2 Co) -> (N, Co, H, W) fp32.

    With the columns padded by one on the left and G[t] the group of padded
    columns (2t, 2t+1), output pair t (image columns 2t, 2t+1) reads
    [A | O][t] = [G[t] | G[t+1]] (image columns 2t-1..2t+2) of rows y-1..y+1:
    a (12 C)-long row against the packed weights."""
    n, c, h, w = x.shape
    wq = (w + 1) // 2
    xp = F.pad(x, (1, 2 * wq + 1 - w, 1, 1)).permute(0, 2, 3, 1)  # (N, H+2, 2wq+2, C)
    g = xp.reshape(n, h + 2, wq + 1, 2 * c)
    ao = torch.cat([g[:, :, :-1], g[:, :, 1:]], dim=3)  # [A | O]: (N, H+2, wq, 4C)
    win = torch.cat([ao[:, dy:dy + h] for dy in range(3)], dim=3)  # (N, H, wq, 12C)
    y = (win.reshape(-1, 12 * c) @ wp).reshape(n, h, 2 * wq, -1)[:, :, :w]
    return y.permute(0, 3, 1, 2)


def fused_stack_packed_plain(u: torch.Tensor, sw: StackWeights, *,
                             out_fp32: bool = False) -> torch.Tensor:
    """K2's function in eager torch, on any device: :func:`stack_plain` with
    :func:`packed_conv` products in fp32 on the bf16-rounded packed weights
    (layer 6 as the sum of its l1 and l5 products). On a card, set
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (the default) for a
    full-fp32 reference."""
    def conv(i, *srcs):
        y = sum(packed_conv(s, m) for s, m in zip(srcs, sw.plain[i]))
        b = _prm(sw.prm, f"b{i + 1}")[:y.shape[1]]
        return y + b.view(1, -1, 1, 1)

    return stack_plain(u, sw.prm, conv, out_fp32=out_fp32)


def fused_stack_packed(u: torch.Tensor, sw: StackWeights) -> torch.Tensor:
    """K2's wrapper: (H2, W2, 12) or (N, H2, W2, 12) bf16 -> the same shape.

    A CUDA tensor launches the kernel on the current stream (no synchronise,
    no allocation inside the kernel; one launch for the whole batch); a CPU
    tensor takes the plain version.
    """
    if u.device.type == "cpu":
        return fused_stack_packed_plain(u, sw)
    if u.device.type != "cuda":
        raise ValueError(f"fused_stack_packed runs on cuda or cpu, got {u.device}")
    check_input(u, sw, "fused_stack_packed")
    out = launch_stack("fse_fused_stack_packed", u, sw)
    fused_stack_packed.launches += 1
    return out


fused_stack_packed.launches = 0


def fused_stack_packed_apply(params: Params, x: torch.Tensor, *, cfg=None) -> torch.Tensor:
    """Drop-in for ``models.pix_shuffle.apply`` (lightweight config) through
    K2: (N, H, W, 3) linear float -> (N, H, W, 3), bf16 compute, through the
    kernel on a CUDA tensor and its plain version on a CPU tensor."""
    return apply_stack(fused_stack_packed, prepare_weights_cached, params, x, cfg)


def fused_stack_packed_apply_plain(params: Params, x: torch.Tensor, *, cfg=None) -> torch.Tensor:
    """:func:`fused_stack_packed_apply` with the plain version on any device:
    the reference the kernel is held against on the card."""
    return apply_stack(fused_stack_packed_plain, prepare_weights_cached, params, x, cfg)
