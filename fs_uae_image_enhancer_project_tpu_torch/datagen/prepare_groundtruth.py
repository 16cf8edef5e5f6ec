"""Ground-truth normalization: arbitrary source images -> sRGB PNGs.

Counterpart of reference ``dataset_generator/prepare_groundtruth.py``:
applies embedded ICC profiles to convert to sRGB (prepare_groundtruth.py:
16-29), optional aspect-preserving downsize (:32-35), writes a mirrored
directory tree, thread pool for I/O parallelism (:77-81).

The port's own copy of ``fs_uae_image_enhancer_project_tpu/datagen/
prepare_groundtruth.py`` (host code, PIL's ``ImageCms``).
"""
from __future__ import annotations

import io
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

SUPPORTED_EXTS = (
    ".jpg", ".jpeg", ".png", ".webp", ".avif", ".bmp", ".tif", ".tiff",
    ".gif",  # the reference accepts GIFs too (prepare_groundtruth.py:9)
)


def process_image(
    src_path: str,
    dst_path: str,
    max_dim: Optional[int] = None,
) -> Tuple[str, Optional[str]]:
    """Convert one image to sRGB PNG, honouring an embedded ICC profile."""
    from PIL import Image, ImageCms

    try:
        with Image.open(src_path) as img:
            icc = img.info.get("icc_profile")
            if icc:
                try:
                    src_profile = ImageCms.ImageCmsProfile(io.BytesIO(icc))
                    dst_profile = ImageCms.createProfile("sRGB")
                    img = ImageCms.profileToProfile(
                        img, src_profile, dst_profile, outputMode="RGB"
                    )
                except Exception:
                    img = img.convert("RGB")
            else:
                img = img.convert("RGB")
            if max_dim is not None:
                # Scalar max_dim -> fit within a square box; (W, H) pair ->
                # fit within that box. PIL ``thumbnail`` exactly as the
                # reference (prepare_groundtruth.py:31-35): its round-half-up
                # size math and reducing_gap resampling differ byte-level
                # from a plain LANCZOS resize (pinned by
                # tests/goldens/prepare_goldens.npz).
                box = (max_dim, max_dim) if isinstance(max_dim, int) else max_dim
                w, h = img.size
                if w > box[0] or h > box[1]:
                    img.thumbnail(box, Image.Resampling.LANCZOS)
            os.makedirs(os.path.dirname(dst_path), exist_ok=True)
            img.save(dst_path, format="PNG")
        return dst_path, None
    except Exception as e:
        return dst_path, f"{type(e).__name__}: {e}"


def prepare_tree(
    src_dir: str,
    dst_dir: str,
    max_dim: Optional[int] = None,
    workers: int = 32,
    verbose: int = 1,
) -> List[Tuple[str, Optional[str]]]:
    jobs = []
    for root, _dirs, files in os.walk(src_dir):
        rel = os.path.relpath(root, src_dir)
        for f in sorted(files):
            if not f.lower().endswith(SUPPORTED_EXTS):
                continue
            stem = os.path.splitext(f)[0]
            dst = os.path.join(dst_dir, rel, stem + ".png")
            if os.path.exists(dst):
                continue  # idempotent
            jobs.append((os.path.join(root, f), dst))
    results = []
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for path, err in ex.map(lambda j: process_image(*j, max_dim=max_dim), jobs):
            results.append((path, err))
            if err and verbose:
                print(f"ERROR {path}: {err}")
    if verbose:
        ok = sum(1 for _p, e in results if e is None)
        print(f"prepared {ok}/{len(results)} images -> {dst_dir}")
    return results


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Normalize sources to sRGB PNGs")
    ap.add_argument("--src", required=True)
    ap.add_argument("--dst", required=True)
    ap.add_argument("--max_dim", type=int, default=None,
                    help="fit within a max_dim x max_dim box")
    ap.add_argument("--max_crop_size", type=int, nargs=2, default=None,
                    metavar=("WIDTH", "HEIGHT"),
                    help="fit within WIDTH x HEIGHT (the reference's flag "
                         "spelling, prepare_groundtruth.py:56-58)")
    ap.add_argument("--workers", type=int, default=32)
    args = ap.parse_args(argv)
    max_size = tuple(args.max_crop_size) if args.max_crop_size else args.max_dim
    results = prepare_tree(args.src, args.dst, max_size, args.workers)
    return 0 if all(e is None for _p, e in results) else 1


if __name__ == "__main__":
    sys.exit(main())
