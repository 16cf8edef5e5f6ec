"""Generate all 4096 flat RGB444 colour swatch PNGs (376x288) for palette
coverage — counterpart of reference
``dataset_generator/rgb444_flat_image_generator.py``.

The port's own copy of ``fs_uae_image_enhancer_project_tpu/datagen/
rgb444_flat.py`` (host code, PIL only)."""
from __future__ import annotations

import os
import sys


def generate(dest_dir: str, width: int = 376, height: int = 288, verbose: int = 1) -> int:
    from PIL import Image

    os.makedirs(dest_dir, exist_ok=True)
    count = 0
    for r4 in range(16):
        for g4 in range(16):
            for b4 in range(16):
                r, g, b = r4 * 17, g4 * 17, b4 * 17  # 0x0->0x00 ... 0xF->0xFF
                # the reference spells lowercase hex with a trailing '0'
                # (rgb444_flat_image_generator.py:17-22) — pinned byte-level
                # by tests/goldens/rgb444_goldens.npz
                name = f"rgb444_{r4:x}{g4:x}{b4:x}0.png"
                path = os.path.join(dest_dir, name)
                if os.path.exists(path):
                    continue
                Image.new("RGB", (width, height), (r, g, b)).save(path)
                count += 1
    if verbose:
        print(f"generated {count} swatches in {dest_dir}")
    return count


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="RGB444 flat swatch generator")
    ap.add_argument("--dest", required=True)
    ap.add_argument("--size", type=int, nargs=2, default=[376, 288])
    args = ap.parse_args(argv)
    generate(args.dest, args.size[0], args.size[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
