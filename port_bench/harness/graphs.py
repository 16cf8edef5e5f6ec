"""The graph a configuration runs: a file of the tree, or one made from a seed.

A configuration gives exactly one of:

- ``graph``: the path of an ONNX graph in the checkout (a shipped artifact);
- ``graph_from_seed``: ``{"family", "variant", "seed", "dtype"}``, for a
  variant that ships no graph. The benchmark draws its convolutions' weights
  from the seed (``reference/seeded.py``, over the configuration's
  ``layers``), checks that they are that variant's, and the program's own
  exporter for the family (``export/onnx_export.py``, whose graphs the
  shipped ones are) writes them as a graph at the configuration's frame size
  and crop, in ``dtype``.

A written graph lies at ``build/port_bench/graphs/<name>-<seed>-<dtype>.onnx``
in the checkout, written under a temporary name and renamed; a file already
there is used as it is.
"""
from __future__ import annotations

import os

from ..reference import seeded
from .manifest import ROOT

GRAPHS = os.path.join("build", "port_bench", "graphs")


def _exporters() -> dict:
    """family: the program's exporter. The draw makes convolutions only, so
    a family with activation parameters (pix_shuffle, conv6) cannot be
    drawn, and no other family has a plain reference yet."""
    from fs_uae_image_enhancer_project_tpu_torch.export import onnx_export as ox

    return {"residual_unet": ox.export_residual_unet_onnx}


def graph_path(config: dict, root: str = ROOT) -> str:
    """The path of the configuration's graph in the checkout at ``root``,
    written first where it is made from a seed and not there yet."""
    shipped, spec = config.get("graph"), config.get("graph_from_seed")
    if (shipped is None) == (spec is None):
        raise ValueError(f"configuration {config['name']!r} must give exactly one of "
                         "'graph' and 'graph_from_seed'")
    if shipped is not None:
        return os.path.join(root, shipped)
    path = os.path.join(root, GRAPHS, f"{config['name']}-{spec['seed']}-{spec['dtype']}.onnx")
    if not os.path.exists(path):
        _write(config, path)
    return path


def _program_params(config: dict, weights: dict):
    """The drawn ``weights`` in the program's parameter tree (HWIO numpy
    convolutions) for the spec's family and variant, and the model's config.
    Raises where the configuration's layers are not that variant's
    convolutions, or the variant has parameters other than convolutions."""
    import torch

    from fs_uae_image_enhancer_project_tpu_torch.models import get_model

    spec = config["graph_from_seed"]
    model = get_model(spec["family"], spec["variant"])
    with torch.device("meta"):
        shapes = model.init(device="meta")
    left = dict(weights)

    def fill(node: dict, path: str) -> dict:
        if "w" in node:
            w, b = left.pop(f"{path}.weight", None), left.pop(f"{path}.bias", None)
            want = tuple(node["w"].shape)
            if w is None or b is None or tuple(w.permute(2, 3, 1, 0).shape) != want:
                raise ValueError(f"layer {path!r} of {config['name']!r} is not the "
                                 f"{spec['family']} {spec['variant']}'s {want} convolution")
            return {"w": w.permute(2, 3, 1, 0).numpy(), "b": b.numpy()}
        out = {}
        for key, sub in node.items():
            if not isinstance(sub, dict):
                raise ValueError(f"{path}.{key} of the {spec['family']} is no convolution: "
                                 "a graph from a seed draws convolutions only")
            out[key] = fill(sub, f"{path}.{key}" if path else key)
        return out

    params = fill(shapes, "")
    if left:
        raise ValueError(f"layers of {config['name']!r} that the {spec['family']} "
                         f"{spec['variant']} does not have: {sorted(left)[:4]}")
    return params, model.config


def _write(config: dict, path: str) -> None:
    """Write the configuration's graph from its seed to ``path``."""
    spec = config["graph_from_seed"]
    export = _exporters()[spec["family"]]
    params, model_config = _program_params(config, seeded.weights(config))
    frame = config["frame"]
    kw = dict(crop_left=config["wrapper"]["crop_left"], fp16=spec["dtype"] == "float16",
              frame_h=frame["height"], frame_w=frame["width"])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        export(params, model_config, tmp, **kw)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
