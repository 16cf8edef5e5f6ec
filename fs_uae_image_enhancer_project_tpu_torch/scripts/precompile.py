"""Seed the kernel cache for the deployed enhance, so that a frame server's
first frame does not pay nvcc.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.precompile \\
        [--onnx FILE] [--shapes 576x752 ...] [--out FILE] [--device cpu]

Port of the repo's ``scripts/precompile.py``, which seeds XLA's persistent
compile cache. The port's counterpart of that cache is the hash-keyed
library that ``ops/cuda/build.py`` builds under ``build/torch_kernels``: this
builds every kernel into it (one nvcc a source, in parallel) and reports the
build's seconds. Then, for each ``--shapes`` entry, it runs one enhance frame
(``--onnx``, default the shipped pix_shuffle graph) in two fresh processes
and reports each one's first-frame ms: ``cold``, with an empty kernel cache
of its own (what a server pays without this step), and ``warm``, with the
seeded cache. The report is printed as the last line (also to ``--out``).
On ``--device cpu`` nothing is built (the plain versions need no nvcc).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from .common import ARTIFACTS, REPO

DEFAULT_ONNX = os.path.join(ARTIFACTS, "model_pix_shuffle", "pix_shuffle.onnx")

# one first frame in a fresh process: argv = cache dir ("" = the default),
# graph, device, height, width
FIRST_FRAME = """
import json, sys, time
t0 = time.perf_counter()
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build, fused_stack as fs
if sys.argv[1]:
    build.BUILD_ROOT = sys.argv[1]
import torch
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
dev = torch.device(sys.argv[3])
enhance = enhance_from_onnx(sys.argv[2], device=dev)
frame = torch.zeros((1, int(sys.argv[4]), int(sys.argv[5]), 4), dtype=torch.uint8, device=dev)
t1 = time.perf_counter()
out = enhance(frame).cpu()
t2 = time.perf_counter()
print(json.dumps(dict(first_frame_ms=(t2 - t1) * 1e3, process_to_first_frame_s=t2 - t0,
                      built=build.build_info.get("built"),
                      build_s=build.build_info.get("seconds"), k1_launches=fs.fused_stack.launches,
                      shape=list(out.shape))))
"""


def first_frame(onnx: str, device: str, h: int, w: int, cache_dir: str = "") -> dict:
    """One enhance frame in a fresh process; its report line."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run([sys.executable, "-c", FIRST_FRAME, cache_dir, onnx, device,
                           str(h), str(w)], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"first-frame child failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def run(onnx: str = DEFAULT_ONNX, shapes=("576x752",), device: str = "cuda") -> dict:
    from .. import resolve_device

    dev = resolve_device(device)
    report = {"harness": "fs_uae_image_enhancer_project_tpu_torch.scripts.precompile",
              "onnx": onnx, "device": str(dev), "build": None, "shapes": []}
    if dev.type == "cuda":
        import torch

        from ..ops.cuda import build

        t0 = time.perf_counter()
        build.load_library()
        report["build"] = dict(seconds=build.build_info["seconds"],
                               built=build.build_info["built"],
                               load_s=time.perf_counter() - t0,
                               library=os.path.relpath(build.build_info["path"], REPO))
        report["card"] = torch.cuda.get_device_name(0)
    for spec in shapes:
        h, w = (int(v) for v in spec.split("x"))
        with tempfile.TemporaryDirectory() as empty:
            cold = first_frame(onnx, str(dev), h, w, cache_dir=empty)
        warm = first_frame(onnx, str(dev), h, w)
        row = {"shape": [h, w], "cold": cold, "warm": warm}
        print(f"{h}x{w}: first frame cold {cold['first_frame_ms']:.1f} ms "
              f"(built {cold['built']}), warm {warm['first_frame_ms']:.1f} ms "
              f"(built {warm['built']})", flush=True)
        report["shapes"].append(row)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Seed the kernel cache for the enhance")
    ap.add_argument("--onnx", default=DEFAULT_ONNX, help="the graph whose enhance to run")
    ap.add_argument("--shapes", nargs="+", default=["576x752"], metavar="HxW",
                    help="frame shapes to run a first frame at")
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report = run(args.onnx, args.shapes, args.device)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
