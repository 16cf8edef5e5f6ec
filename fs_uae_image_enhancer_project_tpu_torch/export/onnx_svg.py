"""Render an ONNX graph as a layered SVG.

Port of ``fs_uae_image_enhancer_project_tpu/export/onnx_svg.py``. The
reference ships a rendered ``*.onnx.svg`` next to every artifact; this
produces the equivalent without graphviz, on the port's own codec
(``onnx_proto``) and ``html``: a longest-path layering of the DAG, ops as
boxes coloured by category, initializer-fed inputs annotated with their
shapes.

    python -m fs_uae_image_enhancer_project_tpu_torch.export.onnx_svg MODEL.onnx [--out F]
"""
from __future__ import annotations

import html
from collections import defaultdict
from typing import Dict, List

from .onnx_proto import Graph, load_model

_CATEGORY_COLORS = {
    "Conv": "#4f86c6",
    "PRelu": "#8fb96a", "Relu": "#8fb96a", "LeakyRelu": "#8fb96a",
    "Sigmoid": "#8fb96a", "Tanh": "#8fb96a", "Softplus": "#8fb96a",
    "Elu": "#8fb96a", "Gelu": "#8fb96a", "Clip": "#8fb96a",
    "Add": "#d6a84f", "Sub": "#d6a84f", "Mul": "#d6a84f", "Div": "#d6a84f",
    "Pow": "#d6a84f", "Exp": "#d6a84f", "Sin": "#d6a84f",
    "Concat": "#b07fc7", "Reshape": "#b07fc7", "Transpose": "#b07fc7",
    "Slice": "#b07fc7", "Pad": "#b07fc7", "DepthToSpace": "#b07fc7",
    "Cast": "#9e9e9e",
}
_DEFAULT_COLOR = "#cccccc"

NODE_W, NODE_H, GAP_X, GAP_Y = 150, 34, 26, 56


def _layer_assignment(graph: Graph) -> List[int]:
    """Longest-path layering over the node DAG."""
    producer: Dict[str, int] = {}
    for i, n in enumerate(graph.nodes):
        for o in n.outputs:
            producer[o] = i
    layers = [0] * len(graph.nodes)
    for i, n in enumerate(graph.nodes):
        deps = [producer[x] for x in n.inputs if x in producer]
        layers[i] = 1 + max((layers[d] for d in deps), default=-1)
    return layers


def render_svg(graph: Graph, title: str = "") -> str:
    layers = _layer_assignment(graph)
    by_layer: Dict[int, List[int]] = defaultdict(list)
    for i, l in enumerate(layers):
        by_layer[l].append(i)
    n_layers = max(by_layer) + 1 if by_layer else 0
    max_row = max((len(v) for v in by_layer.values()), default=1)

    width = max_row * (NODE_W + GAP_X) + GAP_X
    height = n_layers * (NODE_H + GAP_Y) + 120

    pos: Dict[int, tuple] = {}
    for l, idxs in by_layer.items():
        row_w = len(idxs) * (NODE_W + GAP_X)
        x0 = (width - row_w) / 2 + GAP_X / 2
        for k, i in enumerate(sorted(idxs)):
            pos[i] = (x0 + k * (NODE_W + GAP_X), 60 + l * (NODE_H + GAP_Y))

    producer: Dict[str, int] = {}
    for i, n in enumerate(graph.nodes):
        for o in n.outputs:
            producer[o] = i

    parts = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" font-family="monospace" font-size="11">',
        f'<rect width="{width}" height="{height}" fill="white"/>',
        f'<text x="{width / 2}" y="24" text-anchor="middle" font-size="15">'
        f"{html.escape(title)}</text>",
    ]
    # edges first (under nodes)
    for i, n in enumerate(graph.nodes):
        x1, y1 = pos[i]
        for inp in n.inputs:
            if inp in producer:
                x0, y0 = pos[producer[inp]]
                parts.append(
                    f'<line x1="{x0 + NODE_W / 2}" y1="{y0 + NODE_H}" '
                    f'x2="{x1 + NODE_W / 2}" y2="{y1}" stroke="#888" '
                    'stroke-width="1"/>'
                )
    # io summary
    ins = ", ".join(
        f"{v.name}{list(v.shape)}" for v in graph.inputs
    )
    outs = ", ".join(f"{v.name}{list(v.shape)}" for v in graph.outputs)
    parts.append(
        f'<text x="{width / 2}" y="42" text-anchor="middle" fill="#555">'
        f"in: {html.escape(ins)} &#8594; out: {html.escape(outs)}</text>"
    )
    # nodes
    for i, n in enumerate(graph.nodes):
        x, y = pos[i]
        color = _CATEGORY_COLORS.get(n.op_type, _DEFAULT_COLOR)
        label = n.op_type
        # annotate convs with their weight shape
        for inp in n.inputs:
            t = graph.initializers.get(inp)
            if t is not None and inp.endswith("weight"):
                label += f" {list(t.dims)}"
                break
        parts.append(
            f'<g><rect x="{x}" y="{y}" width="{NODE_W}" height="{NODE_H}" '
            f'rx="6" fill="{color}" stroke="#444"/>'
            f'<text x="{x + NODE_W / 2}" y="{y + 21}" text-anchor="middle" '
            f'fill="white">{html.escape(label[:24])}</text></g>'
        )
    parts.append("</svg>")
    return "\n".join(parts)


def render_file(onnx_path: str, svg_path: str | None = None) -> str:
    m = load_model(onnx_path)
    svg = render_svg(m.graph, title=onnx_path.rsplit("/", 1)[-1])
    out = svg_path or onnx_path + ".svg"
    with open(out, "w") as f:
        f.write(svg)
    return out


def main(argv=None) -> int:
    import argparse
    import sys

    ap = argparse.ArgumentParser(description="Render an ONNX graph to SVG")
    ap.add_argument("model")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    print(render_file(args.model, args.out))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
