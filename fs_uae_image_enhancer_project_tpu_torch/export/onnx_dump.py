"""Textual ONNX graph dump.

Port of ``fs_uae_image_enhancer_project_tpu/export/onnx_dump.py``, the
counterpart of the reference's vendored Samsung ONE utility
(convertion_tools/external/onnx-dump.py), on the port's own codec
(``onnx_proto``): prints graph inputs/outputs, initializers with
shapes/dtypes, and every node with its attributes. numpy only.

    python -m fs_uae_image_enhancer_project_tpu_torch.export.onnx_dump MODEL.onnx
"""
from __future__ import annotations

import sys

from .onnx_proto import DTYPE_TO_NUMPY, load_model


def dump(path: str, max_nodes: int | None = None) -> str:
    m = load_model(path)
    g = m.graph
    lines = [
        f"model: {path}",
        f"  producer: {m.producer_name!r}  ir_version: {m.ir_version}  opset: {m.opset}",
        f"graph: {g.name!r}  nodes: {len(g.nodes)}  initializers: {len(g.initializers)}",
        "inputs:",
    ]
    for vi in g.inputs:
        dt = DTYPE_TO_NUMPY.get(vi.elem_type, vi.elem_type)
        lines.append(f"  {vi.name}: {getattr(dt, '__name__', dt)} {list(vi.shape)}")
    lines.append("outputs:")
    for vi in g.outputs:
        dt = DTYPE_TO_NUMPY.get(vi.elem_type, vi.elem_type)
        lines.append(f"  {vi.name}: {getattr(dt, '__name__', dt)} {list(vi.shape)}")
    lines.append("initializers:")
    for name, t in sorted(g.initializers.items()):
        dt = DTYPE_TO_NUMPY.get(t.data_type, t.data_type)
        lines.append(f"  {name}: {getattr(dt, '__name__', dt)} {list(t.dims)}")
    lines.append("nodes:")
    for i, n in enumerate(g.nodes):
        if max_nodes is not None and i >= max_nodes:
            lines.append(f"  ... ({len(g.nodes) - i} more)")
            break
        attrs = ", ".join(f"{k}={a.value!r}" for k, a in sorted(n.attributes.items()))
        lines.append(
            f"  [{i}] {n.op_type}({', '.join(n.inputs)}) -> "
            f"{', '.join(n.outputs)}"
            + (f"  {{{attrs}}}" if attrs else "")
        )
    return "\n".join(lines)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Dump an ONNX model as text")
    ap.add_argument("model")
    ap.add_argument("--max_nodes", type=int, default=None)
    args = ap.parse_args(argv)
    try:
        print(dump(args.model, args.max_nodes))
    except BrokenPipeError:  # e.g. piped into `head`
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
