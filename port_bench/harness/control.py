"""The control of each configuration: what runs in the program's place to
show that the comparison fails one precision below the configuration's
bfloat16.

- ``program_int8``: the program's own int8 path (``export/quantized.py``:
  int8 weights per output channel, int8 conv inputs with static scales from
  a calibration pass over four of the recording's frames), switched on in
  place of the bf16 enhance;
- ``reference_fp8``: the plain reference with every convolution's input
  and weight rounded to float8 e4m3 (the program has no such path).
"""
from __future__ import annotations

import numpy as np

from .compare import reference
from .graphs import graph_path


def enhance(config: dict, device, frames):
    """The control's uint8 enhance on ``device`` for ``config``; ``frames``,
    the recording, calibrates the int8 path (the fp8 reference takes none)."""
    kind = config["control"]
    if kind == "reference_fp8":
        return reference(config, device, "fp8")
    if kind == "program_int8":
        import torch

        from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_any
        from fs_uae_image_enhancer_project_tpu_torch.export.quantized import make_quantized_enhance
        from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
        from fs_uae_image_enhancer_project_tpu_torch.models import get_model

        imp = import_any(graph_path(config))
        cal = [(f[..., :3].astype(np.float32) / 255.0) ** imp.srgb_to_linear_exponent
               for f in frames[:4]]
        return make_quantized_enhance(
            params_from_jax(imp.params, device=device), get_model("pix_shuffle").config, cal,
            compute_dtype=torch.bfloat16, crop_left=imp.crop_left,
            srgb_to_linear_exponent=imp.srgb_to_linear_exponent,
            linear_to_srgb_exponent=imp.linear_to_srgb_exponent, device=device)
    raise ValueError(f"unknown control {kind!r}")
