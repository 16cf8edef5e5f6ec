"""Model summary printer.

Port of ``fs_uae_image_enhancer_project_tpu/models/summary.py``, the
counterpart of the reference trainer's torchsummary/torchviz usage
(train.py:11-12): a per-leaf parameter table with shapes, counts and byte
sizes, plus total/trainable breakdown. It walks the port's nested parameter
dicts of tensors and prints the JAX package's text, line for line, for the
same parameters (a dtype prints as numpy names it: ``float32``).
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch


def _walk(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_walk(tree[k], f"{prefix}{k}." if prefix else f"{k}."))
        return out
    return [(prefix.rstrip("."), tree)]


def summarize(params: Any, title: str = "model") -> str:
    """Render a parameter table; returns the string (also usable in logs)."""
    rows = []
    total = 0
    buffers = 0
    for name, leaf in _walk(params):
        t = torch.as_tensor(leaf)
        n = int(t.numel())
        total += n
        is_buffer = name.endswith((".mean", ".var"))
        if is_buffer:
            buffers += n
        rows.append(
            (name, "x".join(map(str, t.shape)) or "scalar", n,
             str(t.dtype).removeprefix("torch."), "buffer" if is_buffer else "param")
        )
    w_name = max((len(r[0]) for r in rows), default=4) + 2
    lines = [f"== {title} ==",
             f"{'name':<{w_name}}{'shape':<16}{'count':>10}  dtype      kind"]
    for name, shape, n, dtype, kind in rows:
        lines.append(f"{name:<{w_name}}{shape:<16}{n:>10,}  {dtype:<9}  {kind}")
    lines.append(
        f"total {total:,} ({total * 4 / 1e6:.2f} MB fp32, "
        f"{total * 2 / 1e6:.2f} MB bf16); trainable {total - buffers:,}; "
        f"buffers {buffers:,}"
    )
    return "\n".join(lines)


def print_summary(params: Any, title: str = "model") -> None:
    print(summarize(params, title))
