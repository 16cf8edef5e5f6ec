"""The residual U-Net as a configuration of the benchmark lists it, for the
tests: its convolutions, each at its own output resolution, from the port's
``init`` shapes on the meta device; and a configuration whose graph is made
from a seed."""
import re

import torch

from port_bench.harness import ops

FRAME = {"height": 576, "width": 752, "channels": 4}
CROP = 16


def listing(variant: str, height: int, width: int) -> list:
    """Every convolution of the variant in the forward's order, named as its
    graph names it, with the output ``height`` and ``width`` of its level
    for a ``height`` x ``width`` model input."""
    from fs_uae_image_enhancer_project_tpu_torch.models import get_model

    model = get_model("residual_unet", variant)
    depth = model.config.unet_depth
    with torch.device("meta"):
        params = model.init(device="meta")
    layers = []
    for top, node in params.items():
        # halvings of the input: the stem's and encoder level d's d + 1, the
        # bottleneck's depth, decoder stage i's depth - 1 - i, dec_final's 0
        m = re.match(r"(enc|dec)(\d+)_block", top)
        if top == "stem":
            level = 1
        elif top == "dec_final":
            level = 0
        elif top.startswith("bottleneck"):
            level = depth
        elif m.group(1) == "enc":
            level = int(m.group(2)) + 1
        else:
            level = depth - 1 - int(m.group(2))
        convs = {top: node} if "w" in node else {
            f"{top}.{k}": v for k, v in node.items() if "w" in v}
        for name, conv in convs.items():
            kh, _kw, cin, cout = conv["w"].shape
            layers.append({"name": name, "cin": cin, "cout": cout, "k": kh,
                           "height": height >> level, "width": width >> level})
    return layers


def config(variant: str = "lightweight", seed: int = 7, dtype: str = "float32",
           name: str = "residual_unet") -> dict:
    """A U-Net configuration whose graph is made from ``seed``, counted at
    the deployed 576x736 (the frame after its crop)."""
    cfg = {
        "name": name,
        "graph_from_seed": {"family": "residual_unet", "variant": variant, "seed": seed,
                            "dtype": dtype},
        "frame": dict(FRAME),
        "wrapper": {"crop_left": CROP},
        "compute_dtype": "bfloat16",
        "resolution": {"height": FRAME["height"], "width": FRAME["width"] - CROP},
        "layers": listing(variant, FRAME["height"], FRAME["width"] - CROP),
        "main_layer": {"name": "residual U-Net forward, cuDNN's convolutions",
                       "kernels": [], "launch_counter": "fs_uae_image_enhancer_project_tpu_torch."
                       "ops.cuda.fused_stack:fused_stack.launches",
                       "launches_per_call_at_most": 0},
        "correct": {"worst_mae_levels": 0.5},
        "flop_function": "port_bench.harness.ops:flop_per_frame",
    }
    cfg["flop_per_frame"] = ops.flop_per_frame(cfg)
    cfg["bytes_per_frame"] = ops.bytes_per_frame(cfg)
    return cfg
