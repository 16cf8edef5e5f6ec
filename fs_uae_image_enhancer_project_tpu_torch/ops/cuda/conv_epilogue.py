"""The pass after a convolution as one CUDA kernel: the bias, an activation,
a residual add and an activation, in place on the convolution's output (NHWC,
or the NCHW memory cuDNN writes for an input whose strides are no NHWC
tensor's).

``csrc/conv_epilogue.cu`` (namespace ``fse_epilogue``) computes, on ``y``
with ``C = y.shape[-1]`` channels,

    y = post(r + pre(y + b))

where ``b`` is the convolution's fp32 bias, ``pre`` and ``post`` are each
``"identity"`` or ``"relu"``, and ``r`` is an optional residual, optionally
plus an fp32 bias of its own (a projection's raw output and its bias). It
keeps the roundings of the eager chain in ``y``'s dtype: the bias rounded to
it, each add in fp32 rounded to it, as ATen's bf16 ``add_`` and the JAX
package give. It replaces no TPU kernel: XLA fuses these adds on the TPU.

- :func:`conv_epilogue` is the wrapper. A CUDA tensor launches the kernel on
  the current stream (or raises); a CPU tensor takes the plain version.
  Launches are counted in ``conv_epilogue.launches``.
- :func:`epilogue_plain` is the same function in eager torch, and
  ``ops/conv.py`` ``conv2d``'s eager chain: the bias added in place to the
  fresh output, then the activation, the residual add and the activation,
  each an ATen op in the input's dtype.
- :func:`refusal` says why the kernel would not take a set of operands;
  :func:`conv_epilogue` raises with it.
- :func:`ptxas_report` reads the kernels' registers and spills from the
  build's ptxas log.
"""
from __future__ import annotations

import re
from typing import Optional

import torch

ACTIVATIONS = ("identity", "relu")
# the mode's bits, as csrc/conv_epilogue.cu's
PRE, POST, BIAS, RES, RES_BIAS = 1, 2, 4, 8, 16
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNEL = "fse_epilogue"


def _act(name: str, t: torch.Tensor) -> torch.Tensor:
    if name == "relu":
        return torch.relu(t)
    if name == "identity":
        return t
    raise ValueError(f"the epilogue's activations are {ACTIVATIONS}, got {name!r}")


def mode_of(b, pre: str, post: str, residual, residual_bias) -> int:
    """The kernel's mode bits for these operands, 0 where there is nothing
    to do; raises on an activation it does not have or a residual bias
    without a residual."""
    for name in (pre, post):
        if name not in ACTIVATIONS:
            raise ValueError(f"the epilogue's activations are {ACTIVATIONS}, got {name!r}")
    if residual_bias is not None and residual is None:
        raise ValueError("a residual bias needs a residual")
    return ((PRE if pre == "relu" else 0) | (POST if post == "relu" else 0)
            | (BIAS if b is not None else 0) | (RES if residual is not None else 0)
            | (RES_BIAS if residual_bias is not None else 0))


def epilogue_plain(y: torch.Tensor, b: Optional[torch.Tensor] = None, *, pre: str = "identity",
                   post: str = "identity", residual: Optional[torch.Tensor] = None,
                   residual_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in eager torch, on any device: ``y`` gets the
    bias in place (``y`` is the convolution's fresh output); the rest returns
    new tensors, so autograd can record it."""
    mode_of(b, pre, post, residual, residual_bias)
    if b is not None:
        y = y.add_(b.to(y.dtype))
    y = _act(pre, y)
    if residual is not None:
        if residual_bias is not None:
            residual = residual + residual_bias.to(y.dtype)
        y = residual + y
    return _act(post, y)


def _span(t: torch.Tensor):
    start = t.data_ptr()
    return start, start + t.numel() * t.element_size()


def _dense(t: torch.Tensor) -> bool:
    """Every element at an offset of its own and no gaps between them: the
    storage of a contiguous tensor with its axes in some order."""
    expected = 1
    for size, stride in sorted(((n, st) for n, st in zip(t.shape, t.stride()) if n != 1),
                               key=lambda p: p[1]):
        if stride != expected:
            return False
        expected *= size
    return True


def channel_stride(y: torch.Tensor) -> int:
    """The kernel's ``inner`` for a dense ``y``: the element at offset ``i``
    is in channel ``(i // inner) % C``. 1 where the channels are innermost
    (NHWC, the vectorized path), ``H * W`` where cuDNN wrote NCHW."""
    return 1 if y.shape[-1] == 1 else y.stride(-1)


def refusal(y: torch.Tensor, b: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            residual_bias: Optional[torch.Tensor] = None) -> Optional[str]:
    """Why the kernel does not take these operands, or ``None`` if it does:
    ``y`` bf16 or fp32 on a card, dense (NHWC, or the NCHW cuDNN writes for
    an input whose strides are no NHWC tensor's) and 16-byte aligned; the biases contiguous
    fp32 ``(C,)`` vectors and the residual laid out as ``y``, not overlapping
    it, all on ``y``'s device."""
    if y.device.type != "cuda":
        return f"runs on a card, got {y.device}"
    if y.dtype not in _DTYPES:
        return f"takes bf16 or fp32, got {y.dtype}"
    if y.dim() < 1 or not _dense(y) or y.data_ptr() % 16:
        return (f"takes a dense, 16-byte aligned output, got shape {tuple(y.shape)}, strides "
                f"{y.stride()} at {y.data_ptr() % 16} bytes past 16")
    c = y.shape[-1]
    for name, v in (("bias", b), ("residual bias", residual_bias)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (c,)
                              or not v.is_contiguous() or v.device != y.device):
            return f"takes the {name} as a contiguous fp32 ({c},) vector on {y.device}"
    if residual is not None:
        if (residual.shape != y.shape or residual.dtype != y.dtype or residual.device != y.device
                or residual.stride() != y.stride() or residual.data_ptr() % 16):
            return ("takes a 16-byte aligned residual of the output's shape, dtype and "
                    "strides")
        (y0, y1), (r0, r1) = _span(y), _span(residual)
        if r0 < y1 and y0 < r1:
            return "takes a residual that does not overlap the output"
    return None


def conv_epilogue(y: torch.Tensor, b: Optional[torch.Tensor] = None, *, pre: str = "identity",
                  post: str = "identity", residual: Optional[torch.Tensor] = None,
                  residual_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``post(residual + residual_bias + pre(y + b))`` with the eager chain's
    roundings. On a card: in place on ``y``, one launch on the current
    stream (none when there is nothing to do or ``y`` is empty), ``y``
    returned; raises ``ValueError`` on operands the kernel does not take
    (:func:`refusal`). On the CPU: :func:`epilogue_plain`."""
    mode = mode_of(b, pre, post, residual, residual_bias)
    if y.device.type == "cpu":
        return epilogue_plain(y, b, pre=pre, post=post, residual=residual,
                              residual_bias=residual_bias)
    if mode == 0:
        return y
    why = refusal(y, b, residual, residual_bias)
    if why is not None:
        raise ValueError(f"conv_epilogue {why}")
    if y.numel() == 0:
        return y
    from .build import load_library

    rc = load_library().fse_epilogue_launch(
        y.data_ptr(), None if residual is None else residual.data_ptr(),
        None if b is None else b.data_ptr(),
        None if residual_bias is None else residual_bias.data_ptr(),
        y.numel(), y.shape[-1], channel_stride(y), _DTYPES[y.dtype], mode, y.device.index,
        torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fse_epilogue_launch failed: CUDA error {rc}")
    conv_epilogue.launches += 1
    return y


conv_epilogue.launches = 0


def ptxas_report(log: str) -> dict:
    """The epilogue kernels' instantiations in a ptxas ``-v`` log: how many,
    the most registers a thread any of them uses, and their spill bytes
    (stores and loads, summed)."""
    kernels, regs, spills, entry = 0, 0, 0, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            kernels += KERNEL in entry
            continue
        if entry is None or KERNEL not in entry:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills += int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = max(regs, int(m.group(1)))
    return dict(kernels=kernels, max_registers=regs, spill_bytes=spills)
