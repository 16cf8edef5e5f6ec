"""Import the shipped ONNX artifacts into parameter dicts.

Port of ``fs_uae_image_enhancer_project_tpu/export/onnx_import.py``: one
importer a family (:func:`import_pix_shuffle`, :func:`import_conv_stack`,
:func:`import_native` for conv6 and the U-Net) and :func:`import_any`, which
routes a graph to its importer. The result is the JAX package's nested dict
of numpy arrays (conv weights OIHW -> HWIO, fp16 -> fp32);
:func:`..interop.params_from_jax` turns it into tensors.

Shipped-artifact quirks kept here:
- ``pix_shuffle.onnx`` runs at full 752 width (crop 0): it predates the
  crop-16 nodes of the reference's exporter.
- Its linear->sRGB exponent is the fp16-rounded 0.4546, not 1/2.2.
- biased_prelu slopes are exported anonymously; they are bound through the
  PRelu node whose outputs are scoped ``/l{i}_act{j}/...``.
- conv3/conv5 graphs carry fused conv+BN weights; the deployed conv5 graph
  has no final sigmoid and applies ReLU before the residual adds, and the
  conv graphs are sRGB-domain (no gamma pow in the wrapper).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .onnx_proto import Model, load_model

Params = Dict[str, dict]

# graphs emitted by the JAX package's own exporter carry the family in the
# graph name (conv6 has no DepthToSpace and the unet has one, so shape-based
# dispatch alone would misroute both)
_NATIVE_GRAPH_KINDS = {
    "fs_uae_enhance_conv6": "conv6",
    "fs_uae_enhance_unet": "residual_unet",
}


@dataclass
class ImportedModel:
    kind: str  # 'pix_shuffle' | 'conv_stack' | 'conv6' | 'residual_unet'
    params: Params
    num_conv_layers: int
    residual_layers: tuple = ()
    # the wrapper contract observed in the graph
    has_gamma: bool = False
    linear_to_srgb_exponent: float = 0.4546
    srgb_to_linear_exponent: float = 2.2
    relu_before_residual_add: bool = False
    crop_left: int = 0  # width crop observed in the input wrapper
    source: str = ""


def artifact_kind(model: Model) -> str:
    """The model family of an enhance graph: 'pix_shuffle', 'conv6',
    'residual_unet' or 'conv_stack' (the JAX package's ``import_any`` rules)."""
    kind = _NATIVE_GRAPH_KINDS.get(model.graph.name)
    if kind is not None:
        return kind
    if any(n.op_type == "DepthToSpace" for n in model.graph.nodes):
        return "pix_shuffle"
    return "conv_stack"


def _conv_to_hwio(arr: np.ndarray) -> np.ndarray:
    return np.transpose(arr.astype(np.float32), (2, 3, 1, 0))


def _f32(arr: np.ndarray) -> np.ndarray:
    return np.asarray(arr, dtype=np.float32)


def _bind_prelu_slopes(model: Model) -> Dict[str, np.ndarray]:
    """Map act-slot scope (e.g. 'l2_act4') -> PRelu slope vector."""
    slopes: Dict[str, np.ndarray] = {}
    inits = model.graph.initializers
    for n in model.graph.nodes:
        if n.op_type != "PRelu":
            continue
        scope = None
        for out in n.outputs:
            # torch scopes: '/l2_act4/prelu/PRelu_output_0';
            # the JAX package's exporter: 'l2_act4_out'
            m = re.search(r"/(l\d+_act\d+)/", out) or re.match(
                r"(l\d+_act\d+)_out$", out
            )
            if m:
                scope = m.group(1)
                break
        if scope is None:
            continue
        w_name = n.inputs[1]
        if w_name in inits:
            slopes[scope] = _f32(inits[w_name].to_numpy()).reshape(-1)
    return slopes


def import_pix_shuffle(path: str, model: Model = None) -> ImportedModel:
    """Load a pix_shuffle ONNX graph into a pix_shuffle parameter dict.

    ``model`` (optional) skips re-parsing when the caller already decoded
    the file.
    """
    model = model if model is not None else load_model(path)
    inits = model.graph.initializers
    params: Params = {}
    n_convs = 0
    for name, t in inits.items():
        m = re.fullmatch(r"conv(\d+)\.weight", name)
        if m:
            li = int(m.group(1))
            n_convs = max(n_convs, li)
            params.setdefault(f"conv{li}", {})["w"] = _conv_to_hwio(t.to_numpy())
        m = re.fullmatch(r"conv(\d+)\.bias", name)
        if m:
            params.setdefault(f"conv{int(m.group(1))}", {})["b"] = _f32(t.to_numpy())
        # torch naming 'skipN_proj_conv.weight'; the JAX exporter 'skipN_proj.weight'
        m = re.fullmatch(r"skip(\d)_proj(?:_conv)?\.weight", name)
        if m:
            params[f"skip{m.group(1)}_proj"] = {"w": _conv_to_hwio(t.to_numpy())}
        # sinlu a/b, biased_(p)relu bias/slope
        m = re.fullmatch(r"(l\d+_act\d+)\.([ab]|bias|slope)", name)
        if m:
            slot, leaf = m.group(1), m.group(2)
            params.setdefault(slot, {})[leaf] = _f32(t.to_numpy()).reshape(-1)
    for slot, slope in _bind_prelu_slopes(model).items():
        params.setdefault(slot, {})["slope"] = slope
    exps = _gamma_exponents(model)
    return ImportedModel(
        kind="pix_shuffle",
        params=params,
        num_conv_layers=n_convs,
        has_gamma=exps is not None,
        srgb_to_linear_exponent=exps[0] if exps else 2.2,
        linear_to_srgb_exponent=exps[1] if exps else 0.4546,
        crop_left=_detect_crop_left(model),
        source=path,
    )


def _detect_crop_left(model: Model) -> int:
    """Width crop in the input wrapper: a second Slice on axis 3 with a
    nonzero start before the first Conv."""
    inits = model.graph.initializers
    for n in model.graph.nodes:
        if n.op_type == "Conv":
            break
        if n.op_type != "Slice" or len(n.inputs) < 4:
            continue
        try:
            starts = inits[n.inputs[1]].to_numpy()
            axes = inits[n.inputs[3]].to_numpy()
        except KeyError:
            continue
        if len(axes) == 1 and int(axes[0]) == 3 and int(starts[0]) > 0:
            return int(starts[0])
    return 0


def _gamma_exponents(model: Model):
    inits = model.graph.initializers
    s2l = inits.get("gamma_srgb_to_linear_exponent")
    l2s = inits.get("gamma_linear_to_srgb_exponent")
    if s2l is None or l2s is None:
        return None
    return float(s2l.to_numpy()), float(l2s.to_numpy())


def import_conv_stack(path: str, model: Model = None) -> ImportedModel:
    """Load a conv3/conv5 graph (fused conv+BN) into fused parameters. The
    residual adds are found by walking the graph: an Add whose two inputs
    both descend from convs (through Relus or earlier Adds)."""
    model = model if model is not None else load_model(path)
    params: Params = {}
    n_convs = 0
    for name, t in model.graph.initializers.items():
        m = re.fullmatch(r"conv(\d+)(?:\.0)?\.(weight|bias)", name)
        if not m:
            continue
        li = int(m.group(1))
        n_convs = max(n_convs, li)
        arr = t.to_numpy()
        if m.group(2) == "weight":
            params.setdefault(f"conv{li}", {})["w"] = _conv_to_hwio(arr)
        else:
            params.setdefault(f"conv{li}", {})["b"] = _f32(arr)
    residual: List[int] = []
    conv_out_of: Dict[str, int] = {}
    conv_idx = 0
    for n in model.graph.nodes:
        if n.op_type == "Conv":
            conv_idx += 1
            conv_out_of[n.outputs[0]] = conv_idx
        elif n.op_type == "Relu":
            conv_out_of[n.outputs[0]] = conv_out_of.get(n.inputs[0], 0)
        elif n.op_type == "Add" and len(n.inputs) == 2:
            ids = [conv_out_of.get(i, 0) for i in n.inputs]
            if all(ids):
                residual.append(max(ids) - 1)  # 0-based layer index of the add
                conv_out_of[n.outputs[0]] = max(ids)
    exps = _gamma_exponents(model)
    return ImportedModel(
        kind="conv_stack",
        params=params,
        num_conv_layers=n_convs,
        residual_layers=tuple(residual),
        has_gamma=exps is not None,
        relu_before_residual_add=True,  # the fused graphs' semantics (module doc)
        source=path,
    )


def import_native(path: str, kind: str, model: Model = None) -> ImportedModel:
    """Import a graph written by the exporter (``export.onnx_export``) into a
    nested dict. The exporter names every initializer after the flattened
    parameter dict (dotted keys, then '.weight'/'.bias' for convs and
    '.a'/'.b'/'.bias'/'.slope' for activations), so the inverse collects the
    leaves and un-flattens on dots. Wrapper constants never carry those
    suffixes."""
    model = model if model is not None else load_model(path)
    flat: Dict[str, dict] = {}
    for name, t in model.graph.initializers.items():
        m = re.fullmatch(r"(.+)\.(weight|bias|a|b|slope)", name)
        if not m:
            continue
        key, leaf = m.group(1), m.group(2)
        arr = t.to_numpy()
        if leaf == "weight":
            if arr.ndim != 4:
                continue
            flat.setdefault(key, {})["w"] = _conv_to_hwio(arr)
        elif leaf == "bias" and arr.ndim == 1:
            flat.setdefault(key, {})["b"] = _f32(arr)
        else:
            # activation leaves are written per channel as (-1, 1, 1) or scalar
            flat.setdefault(key, {})[leaf] = _f32(arr).reshape(-1)
    params: Params = {}
    for key, leaves in flat.items():
        node = params
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaves
    exps = _gamma_exponents(model)
    return ImportedModel(
        kind=kind,
        params=params,
        num_conv_layers=0,
        has_gamma=exps is not None,
        srgb_to_linear_exponent=exps[0] if exps else 2.2,
        linear_to_srgb_exponent=exps[1] if exps else 1.0 / 2.2,
        crop_left=_detect_crop_left(model),
        source=path,
    )


def import_any(path: str) -> ImportedModel:
    """Parse ``path`` once and import it with its family's importer
    (:func:`artifact_kind`)."""
    model = load_model(path)
    kind = artifact_kind(model)
    if kind in ("conv6", "residual_unet"):
        return import_native(path, kind, model=model)
    if kind == "pix_shuffle":
        return import_pix_shuffle(path, model=model)
    return import_conv_stack(path, model=model)
