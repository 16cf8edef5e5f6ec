"""Parameters between the JAX package and the port.

The port keeps the JAX package's parameter layout: the same nested dict keys
and HWIO conv weights. So the bridge is a conversion of leaves: numpy arrays
(``np.asarray`` of each JAX leaf) to fp32 tensors and back. Tests use it to
run both packages on the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def params_from_jax(tree, device=None):
    """Nested dict of numpy arrays (the JAX pytree, HWIO) -> nested dict of
    fp32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(dev)

    return conv(tree)


def params_to_numpy(params):
    """The reverse of :func:`params_from_jax`: tensors -> fp32 numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().to("cpu", torch.float32).numpy()
