"""The enhance as a deployable ``torch.export`` program.

Port of ``fs_uae_image_enhancer_project_tpu/export/stablehlo.py``; the
module keeps that name so that a reader finds the counterpart, but the
artifact is a ``torch.export`` program (``.pt2``, written by
``torch.export.save``), not StableHLO. Like the JAX artifact it holds the
whole uint8 RGBA -> uint8 RGBA enhance at one static shape with its weights
inside (lifted constants): loading it needs no ONNX file.

- :func:`export_enhance` traces an enhance function (``make_enhance_fn``'s,
  ``enhance_from_onnx``'s) on a ``(batch, frame_h, frame_w, 4)`` uint8 frame
  on ``device`` and writes the program. The lightweight pix_shuffle model's
  fused stack is recorded as the custom op ``torch.ops.fse.fused_stack``
  (``ops/cuda/fused_stack.py``): the exported program launches the same
  hand-written kernel K1 as the served path on a card, and the plain version
  on the CPU.
- :func:`load_enhance` reads it back as ``enhance(frames) -> uint8 tensor``.
  The device is baked into the graph (the output buffer is made on it), so
  an artifact runs on the device type it was exported on, and loading it for
  another raises ``ValueError``; so does a file that is not such an artifact
  (a JAX ``jax.export`` artifact among them).
- :func:`stablehlo_text` is the exported program's printed graph.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Callable

import torch

from .. import FRAME_H, FRAME_W, resolve_device

# the extra file that marks an artifact of this module: its device and shape
META = "fse_enhance.json"


class _Enhance(torch.nn.Module):
    """An enhance function as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return self.fn(frames)


def _export(enhance_fn: Callable, frame_h: int, frame_w: int, batch: int, device):
    dev = resolve_device(device)
    example = torch.zeros((batch, frame_h, frame_w, 4), dtype=torch.uint8, device=dev)
    with torch.no_grad():
        # one eager call fills the fused stack's prepared-weight cache, so the
        # program holds the prepared weights as constants instead of
        # re-deriving them on every call
        enhance_fn(example)
        program = torch.export.export(_Enhance(enhance_fn), (example,), strict=False)
    return program, dev


def export_enhance(
    enhance_fn: Callable,
    out_path: str,
    *,
    frame_h: int = FRAME_H,
    frame_w: int = FRAME_W,
    batch: int = 1,
    device=None,
) -> str:
    """Export ``enhance_fn`` for uint8 ``(batch, frame_h, frame_w, 4)`` frames
    on ``device`` (default ``cuda``; the device the enhance was built for) and
    write it to ``out_path`` (a temporary name, then ``os.replace``)."""
    program, dev = _export(enhance_fn, frame_h, frame_w, batch, device)
    meta = dict(device=dev.type, shape=[batch, frame_h, frame_w, 4])
    out_dir = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out_dir, prefix=".tmp-", suffix=".pt2")
    os.close(fd)
    try:
        torch.export.save(program, tmp, extra_files={META: json.dumps(meta)})
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out_path


def artifact_meta(path: str) -> dict:
    """The device and shape an artifact was exported for; ``ValueError`` for
    a file that is not one."""
    meta = None
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            names = [n for n in z.namelist() if n.endswith("/" + META) or n == META]
            if names:
                meta = json.loads(z.read(names[0]))
    if meta is None:
        raise ValueError(
            f"{path} is not a torch.export (.pt2) enhance artifact of the port "
            "(export.stablehlo.export_enhance). A jax.export artifact of the JAX "
            "package loads only with fs_uae_image_enhancer_project_tpu.export."
            "stablehlo.load_enhance; an .onnx graph loads with "
            "export.enhance.enhance_from_onnx")
    return meta


def load_enhance(path: str, *, device=None):
    """Read an artifact of :func:`export_enhance` back as ``enhance(frames) ->
    uint8 tensor`` on ``device`` (default ``cuda``). Frames may be numpy
    arrays or tensors of the exported shape; they are moved to the device."""
    meta = artifact_meta(path)
    want = torch.device("cuda" if device is None else device)
    if want.type != meta["device"]:
        raise ValueError(
            f"{path} was exported on {meta['device']} and runs there only (the device "
            f"is baked into the program); asked for {want.type}: export it again there")
    dev = resolve_device(want)
    from ..ops.conv import no_tf32
    from ..ops.cuda import fused_stack  # noqa: F401  registers torch.ops.fse.fused_stack

    module = torch.export.load(path).module()

    @torch.no_grad()
    def enhance(frames) -> torch.Tensor:
        frames = torch.as_tensor(frames).to(dev, non_blocking=True)
        with no_tf32():
            return module(frames)

    return enhance


def stablehlo_text(enhance_fn: Callable, *, frame_h: int = FRAME_H, frame_w: int = FRAME_W,
                   batch: int = 1, device=None) -> str:
    """The exported program's printed graph (inspection and tests): the
    ``torch.export`` counterpart of the JAX package's StableHLO text."""
    program, _ = _export(enhance_fn, frame_h, frame_w, batch, device)
    return str(program)
