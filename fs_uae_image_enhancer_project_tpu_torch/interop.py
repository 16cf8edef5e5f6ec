"""Parameters between the JAX package and the port.

The port keeps the JAX package's parameter layout: the same nested dict keys
and HWIO conv weights. So the bridge is a conversion of leaves: numpy arrays
(``np.asarray`` of each JAX leaf) to fp32 tensors and back. Tests use it to
run both packages on the same weights.

Seeds do not cross: ``jax.random`` and ``torch.Generator`` give different
numbers from one seed. Where the port must draw what the JAX package draws,
it computes JAX's draw itself. The k-means palettes are the one case so far:
the JAX package starts from point
``jax.random.randint(jax.random.key(seed), (), 0, N)`` of each crop, and the
port's ``datagen.quantize.generate_palettes_kmeans_torch_batch`` computes the
same index with ``utils.threefry.randint`` (or takes it as ``first_index``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device


def params_from_jax(tree, device=None):
    """Nested dicts and lists of numpy arrays (the JAX pytree, HWIO; VGG's
    parameters are a list of dicts) -> the same nesting of fp32 tensors on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.from_numpy(np.array(node, np.float32)).to(dev)

    return conv(tree)


def params_to_numpy(params):
    """The reverse of :func:`params_from_jax`: tensors -> fp32 numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().to("cpu", torch.float32).numpy()
