"""One-time VGG16 weight conversion: torchvision -> the NHWC npz asset.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.convert_vgg16_weights \\
        [--out assets/vgg16_features.npz]

Port of the repo's ``scripts/convert_vgg16_weights.py``, a thin driver over
``losses.vgg.convert_torchvision_state_dict``: torchvision's ImageNet VGG16
features (``VGG16_Weights.IMAGENET1K_FEATURES``), each conv's OIHW weight
made HWIO, written where ``vgg.init_vgg16`` looks first. Run it where
torchvision and its weights are; without torchvision it exits 1 with the
root script's message. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Convert torchvision's VGG16 features")
    ap.add_argument("--out", default="assets/vgg16_features.npz")
    args = ap.parse_args(argv)
    try:
        import torchvision.models as tvm
    except ImportError:
        msg = "torchvision is required (run on a machine that has it)"
        print(msg, file=sys.stderr)
        print(json.dumps({"error": msg, "missing_module": "torchvision"}), flush=True)
        return 1

    from ..losses import vgg

    model = tvm.vgg16(weights=tvm.VGG16_Weights.IMAGENET1K_FEATURES)
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    vgg.convert_torchvision_state_dict(state, args.out)
    print(f"wrote {args.out}")
    print(json.dumps({"out": args.out, "convs": len(vgg.conv_indices())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
