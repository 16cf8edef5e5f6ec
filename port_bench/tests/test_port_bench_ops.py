"""The operation and byte counts of ``harness/ops.py`` for layers at several
resolutions: by hand, and against a count of the convolutions that a
network's forward runs (``F.conv2d`` hooked, on the meta device)."""
import contextlib

import pytest
import torch
import torch.nn.functional as F

from port_bench.harness import ops
from port_bench.reference.pix_shuffle import shuffle, unshuffle
from port_bench.tests import unet


@contextlib.contextmanager
def counted_convs():
    """Every ``F.conv2d`` call's operations (2 x multiply-adds, from the
    weight's and the output's shapes) while the block runs."""
    calls = []
    plain = F.conv2d

    def hooked(x, w, *args, **kwargs):
        y = plain(x, w, *args, **kwargs)
        calls.append(2 * w[0].numel() * y.shape[0] * y.shape[1] * y.shape[2] * y.shape[3])
        return y

    F.conv2d = hooked
    try:
        yield calls
    finally:
        F.conv2d = plain


def _config(layers, height=8, width=12, dtype="bfloat16"):
    return {"resolution": {"height": height, "width": width}, "compute_dtype": dtype,
            "layers": layers}


def test_two_resolutions_by_hand():
    layers = [{"name": "a", "cin": 12, "cout": 16, "k": 3, "height": 4, "width": 6},
              {"name": "b", "cin": 16, "cout": 3, "k": 1}]
    cfg = _config(layers)
    macs = 9 * 12 * 16 * 4 * 6 + 1 * 16 * 3 * 8 * 12
    assert ops.flop_per_frame(cfg) == 2.0 * macs
    weights = 9 * 12 * 16 + 16 + 16 * 3 + 3
    assert ops.bytes_per_frame(cfg) == 2 * (4 * 6 * 12 + 8 * 12 * 3 + weights)
    assert ops.bytes_per_frame(_config(layers, dtype="float32")) == 4 * (
        4 * 6 * 12 + 8 * 12 * 3 + weights)


def test_a_layer_without_its_own_resolution_is_at_the_configurations():
    layer = {"name": "a", "cin": 4, "cout": 8, "k": 3}
    assert ops.flop_per_frame(_config([layer])) == ops.flop_per_frame(
        _config([dict(layer, height=8, width=12)])) == 2.0 * 9 * 4 * 8 * 8 * 12


def _toy_forward(w, x):
    """Unshuffle, a 3x3 conv at each of two levels, shuffle back, concat the
    input, a 1x1 conv at the top."""
    h = F.conv2d(unshuffle(x), w["l1"], padding=1)
    h2 = F.conv2d(unshuffle(h), w["l2"], padding=1)
    h = torch.cat([h, shuffle(h2)], dim=1)
    return F.conv2d(torch.cat([shuffle(h), x], dim=1), w["top"])


def test_a_toy_network_is_counted_as_its_forward_runs():
    height, width = 32, 48
    layers = [
        {"name": "l1", "cin": 12, "cout": 16, "k": 3, "height": 16, "width": 24},
        {"name": "l2", "cin": 64, "cout": 32, "k": 3, "height": 8, "width": 12},
        {"name": "top", "cin": 9, "cout": 3, "k": 1, "height": 32, "width": 48},
    ]
    w = {l["name"]: torch.empty(l["cout"], l["cin"], l["k"], l["k"], device="meta")
         for l in layers}
    with counted_convs() as calls:
        _toy_forward(w, torch.empty(2, 3, height, width, device="meta"))
    assert len(calls) == 3
    assert ops.flop_per_frame(_config(layers, height, width)) == sum(calls) / 2


@pytest.mark.parametrize("variant,gflop", [("lightweight", 79.1), ("heavyweight", 1750.7)])
def test_unet_listing_is_counted_as_the_ports_forward_runs(variant, gflop):
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model

    height, width = 576, 736
    model = get_model("residual_unet", variant)
    with torch.device("meta"):
        params = model.init(device="meta")
    with counted_convs() as calls:
        model.apply(params, torch.empty(1, height, width, 3, device="meta"))
    layers = unet.listing(variant, height, width)
    assert len(layers) == len(calls)
    cfg = _config(layers, height, width)
    assert ops.flop_per_frame(cfg) == sum(calls)
    assert round(ops.flop_per_frame(cfg) / 1e9, 1) == gflop
    # the stem's 12-channel input at half resolution, the 3 channels out at full
    first, last = layers[0], layers[-1]
    assert (first["name"], first["cin"], first["height"]) == ("stem", 12, height // 2)
    assert (last["name"], last["cout"], last["height"]) == ("dec_final", 3, height)
    weights = sum(p.numel() for p in _leaves(params))
    assert ops.bytes_per_frame(cfg) == 2 * (height * width * 6 + weights)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else [v]
