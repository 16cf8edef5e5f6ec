"""Minimal ONNX graph executor (numpy).

The port's own copy of ``fs_uae_image_enhancer_project_tpu/export/onnx_runner.py``:
the export path's verification runs the emitted graph on a random uint8
frame, as the reference ran it under ONNX Runtime. This module interprets
the op subset of the shipped artifacts and of the exporter:

Transpose Slice Cast Div Mul Add Sub Pow Exp Sin Tanh Sigmoid Softplus Relu
LeakyRelu Elu Gelu PRelu Clip Concat Reshape Pad Conv DepthToSpace(CRD/DCR)
Softmax LogSoftmax Erf.

Conv is stride-1 NCHW with explicit pads, accumulated a kernel tap at a time
with einsum: enough for verification runs, and it runs the shipped graphs
themselves as the ONNX reference.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .onnx_proto import DTYPE_TO_NUMPY, Graph, Model, load_model


def _conv(x: np.ndarray, w: np.ndarray, b, pads, strides) -> np.ndarray:
    n, cin, h, wdt = x.shape
    cout, cin2, kh, kw = w.shape
    assert cin == cin2, f"conv channel mismatch {cin} vs {cin2}"
    pt, pl, pb, pr = pads
    xp = np.pad(x, ((0, 0), (0, 0), (pt, pb), (pl, pr)))
    sh, sw = strides
    oh = (h + pt + pb - kh) // sh + 1
    ow = (wdt + pl + pr - kw) // sw + 1
    # accumulate per kernel tap: avoids materializing the full im2col tensor
    y = np.zeros((n, cout, oh, ow), np.float32)
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, :, i : i + oh * sh : sh, j : j + ow * sw : sw]
            y += np.einsum("nchw,oc->nohw", patch, w[:, :, i, j], optimize=True)
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y


def _depth_to_space(x: np.ndarray, bs: int, mode: str) -> np.ndarray:
    n, c, h, w = x.shape
    co = c // (bs * bs)
    if mode == "CRD":
        t = x.reshape(n, co, bs, bs, h, w)
        t = t.transpose(0, 1, 4, 2, 5, 3)
    else:  # DCR
        t = x.reshape(n, bs, bs, co, h, w)
        t = t.transpose(0, 3, 4, 1, 5, 2)
    return t.reshape(n, co, h * bs, w * bs)


def _gelu(x):
    from math import sqrt

    from scipy.special import erf

    return 0.5 * x * (1.0 + erf(x / sqrt(2.0)))


def run_graph(graph: Graph, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    env: Dict[str, np.ndarray] = {
        name: t.to_numpy() for name, t in graph.initializers.items()
    }
    env.update(feeds)

    for node in graph.nodes:
        op = node.op_type
        ins = [env[i] if i else None for i in node.inputs]
        a = ins[0]
        if op == "Transpose":
            out = np.transpose(a, node.attr("perm"))
        elif op == "Reshape":
            shape = [int(s) for s in ins[1]]
            out = a.reshape(shape)
        elif op == "Slice":
            starts = [int(v) for v in ins[1]]
            ends = [int(v) for v in ins[2]]
            axes = (
                [int(v) for v in ins[3]]
                if len(ins) > 3 and ins[3] is not None
                else list(range(len(starts)))
            )
            steps = (
                [int(v) for v in ins[4]]
                if len(ins) > 4 and ins[4] is not None
                else [1] * len(starts)
            )
            sl = [slice(None)] * a.ndim
            for s, e, ax, st in zip(starts, ends, axes, steps):
                # ONNX uses INT_MAX/INT_MIN sentinels for open-ended slices
                s_ = None if abs(s) >= 2**31 - 1 else s
                e_ = None if abs(e) >= 2**31 - 1 else e
                sl[ax] = slice(s_, e_, st)
            out = a[tuple(sl)]
        elif op == "Cast":
            out = a.astype(DTYPE_TO_NUMPY[node.attr("to")])
        elif op == "Div":
            out = a / ins[1]
        elif op == "Mul":
            out = ins[0] * ins[1]
        elif op == "Add":
            out = ins[0] + ins[1]
        elif op == "Sub":
            out = ins[0] - ins[1]
        elif op == "Pow":
            out = np.power(a, ins[1])
        elif op == "Exp":
            out = np.exp(a)
        elif op == "Sin":
            out = np.sin(a)
        elif op == "Tanh":
            out = np.tanh(a)
        elif op == "Sigmoid":
            with np.errstate(over="ignore"):
                # full sigmoid in fp32, ONE cast at the end (casting the
                # denominator first would run the division in fp16)
                out = (1.0 / (1.0 + np.exp(-a.astype(np.float32)))).astype(
                    a.dtype
                )
        elif op == "Softplus":
            xf = a.astype(np.float32)
            out = np.logaddexp(0.0, xf).astype(a.dtype)
        elif op in ("Softmax", "LogSoftmax"):
            axis = node.attr("axis", -1)
            xf = a.astype(np.float32)
            xf = xf - np.max(xf, axis=axis, keepdims=True)
            e = np.exp(xf)
            s = np.sum(e, axis=axis, keepdims=True)
            out = (e / s if op == "Softmax"
                   else xf - np.log(s)).astype(a.dtype)
        elif op == "Relu":
            out = np.maximum(a, 0)
        elif op == "LeakyRelu":
            alpha = node.attr("alpha", 0.01)
            out = np.where(a >= 0, a, alpha * a)
        elif op == "Elu":
            alpha = node.attr("alpha", 1.0)
            out = np.where(a >= 0, a, alpha * (np.exp(a) - 1)).astype(a.dtype)
        elif op == "Gelu":
            out = _gelu(a.astype(np.float32)).astype(a.dtype)
        elif op == "Erf":
            from scipy.special import erf

            out = erf(a.astype(np.float32)).astype(a.dtype)
        elif op == "PRelu":
            slope = ins[1]
            out = np.where(a >= 0, a, slope * a)
        elif op == "Clip":
            lo = ins[1] if len(ins) > 1 else None
            hi = ins[2] if len(ins) > 2 else None
            out = np.clip(a, lo, hi)
        elif op == "Concat":
            out = np.concatenate(ins, axis=node.attr("axis"))
        elif op == "Pad":
            pads = [int(v) for v in ins[1]]
            value = ins[2] if len(ins) > 2 and ins[2] is not None else 0
            nd = a.ndim
            pairs = [(pads[i], pads[i + nd]) for i in range(nd)]
            out = np.pad(a, pairs, constant_values=np.asarray(value).item())
        elif op == "Conv":
            w = ins[1]
            b = ins[2] if len(ins) > 2 else None
            pads4 = node.attr("pads", [0, 0, 0, 0])
            strides = node.attr("strides", [1, 1])
            # this runner is the project's parity truth: refuse attributes
            # it would otherwise silently ignore (dilated/auto-padded convs
            # would compute a different function without any error)
            dil = node.attr("dilations", [1, 1])
            if any(d != 1 for d in dil):
                raise NotImplementedError(f"Conv dilations={dil}")
            ap = node.attr("auto_pad", "NOTSET")
            if ap != "NOTSET":
                raise NotImplementedError(f"Conv auto_pad={ap!r}")
            ks = node.attr("kernel_shape")
            if ks is not None and tuple(ks) != tuple(w.shape[2:]):
                raise NotImplementedError(
                    f"Conv kernel_shape={ks} != weight spatial {w.shape[2:]}"
                )
            out = _conv(
                a.astype(np.float32), w.astype(np.float32),
                None if b is None else b.astype(np.float32),
                pads4, strides,
            ).astype(a.dtype)
        elif op == "DepthToSpace":
            out = _depth_to_space(a, node.attr("blocksize"), node.attr("mode", "DCR"))
        else:
            raise NotImplementedError(f"op {op} not supported by the runner")
        for o in node.outputs:
            env[o] = out
    return {v.name: env[v.name] for v in graph.outputs}


def run_model(path_or_model, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    model = (
        path_or_model
        if isinstance(path_or_model, Model)
        else load_model(path_or_model)
    )
    return run_graph(model.graph, feeds)


def verify_onnx_model(path: str, verbose: int = 1) -> Dict[str, np.ndarray]:
    """Run the artifact on a random uint8 frame and sanity-check the output
    contract (torch2onnx.py:125-181 semantics)."""
    model = load_model(path)
    g = model.graph
    feeds = {}
    for vi in g.inputs:
        shape = tuple(int(d) for d in vi.shape)
        feeds[vi.name] = np.random.default_rng(0).integers(
            0, 256, shape, dtype=np.uint8
        )
    outs = run_model(model, feeds)
    for vi in g.outputs:
        out = outs[vi.name]
        if verbose:
            print(f"output {vi.name}: shape={out.shape} dtype={out.dtype}")
        expected = tuple(int(d) for d in vi.shape)
        if tuple(out.shape) != expected:
            raise ValueError(f"output shape {out.shape} != declared {expected}")
    return outs
