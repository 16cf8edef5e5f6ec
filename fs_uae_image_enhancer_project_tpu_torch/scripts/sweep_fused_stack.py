"""Sweep the fused-stack kernels' designs (K1 and K2) on one card.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.sweep_fused_stack \\
        [--tiles 16x14,16x16] [--parent DIR] [--check-only] [--out FILE]

Each variant is a build of the kernel library: the package's kernels at
each output tile (``-DFSE_TILE_H=.. -DFSE_TILE_W=..``; the first tile listed
is taken as the shipped one and built without defines), and, with
``--parent``, the kernels of another source tree (a parent commit's
``ops/cuda/csrc``, unpacked with ``git archive``), whose C interface is the
same. The builds run in parallel. The input is the served path's: the first
seeded 576x752 frame of ``chip_smoke.py`` (``default_rng(0)``), crop 0,
/255 and pow 2.2, unshuffled to 288x376x12 bf16, with the shipped weights
(``artifacts/model_pix_shuffle/pix_shuffle.onnx``). For each variant, K1 and
K2:

- the max and mean abs error against the plain version's fp32 result (TF32
  off), at 288x376 and at 290x375 (neither a multiple of any tile swept),
  whether a batch of 3 frames in one launch equals three launches, and
  whether the 288x376 output equals the first variant's bit for bit;
- the compiled kernel's registers, local memory (spills) and shared memory
  where the library reports them (``<entry>_info``), else the ptxas lines;
- CTAs and waves over 132 SMs, and the weight bytes a CTA reads from global
  memory, worked out from the design's loops;
- unless ``--check-only``: the device time of one call
  (``utils.profiler.device_times``: 3 repeats of 50 back-to-back calls, their
  median, min and max), the variants visited in turns (the list, then the
  list reversed), so that the parent is timed first and last.

One JSON line a variant, and all of them to ``--out`` if given. Needs a
card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ONNX = os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")
PARENT_TILE = (16, 16)  # the first design's tile


def parent_weight_bytes_per_cta(pk: int) -> int:
    """Weight bytes a CTA of the first design read from global memory: every
    warp job (one m-tile of a 16x16 tile's region) read its layer's whole
    (K, N) fragment array with ``__ldg``."""
    from ..ops.cuda import fused_stack_plan as plan

    total = 0
    for ly in plan.layers(pk):
        _, mtiles, _, _ = plan.geometry(pk, ly.out, PARENT_TILE)
        total += mtiles * ly.weight_bytes
    return total


def frame_input(dev, crop_left: int, exponent: float) -> torch.Tensor:
    """The served path's K1 input for chip_smoke.py's first seeded frame."""
    from ..ops.pixel_shuffle import pixel_unshuffle

    frames = np.random.default_rng(0).integers(0, 256, (8, 576, 752, 4), dtype=np.uint8)
    x = torch.from_numpy(frames[0, :, crop_left:, :3]).to(dev).float() / 255.0
    return pixel_unshuffle((x ** exponent)[None], 2)[0].to(torch.bfloat16).contiguous()


def errors(y: torch.Tensor, ref: torch.Tensor) -> dict:
    err = (y.float() - ref).abs()
    return dict(max_abs=err.max().item(), mean_abs=err.mean().item(),
                finite=bool(torch.isfinite(y.float()).all()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tiles", default="16x14,16x16", help="output tiles RxC, shipped first")
    ap.add_argument("--parent", default=None, help="another kernel source tree (csrc)")
    ap.add_argument("--check-only", action="store_true", help="build and check, no timing")
    ap.add_argument("--out", default=None, help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep_fused_stack: needs a CUDA card", file=sys.stderr)
        return 2

    from ..export.onnx_import import import_pix_shuffle
    from ..interop import params_from_jax
    from ..ops.cuda import build
    from ..ops.cuda import fused_stack as fs
    from ..ops.cuda import fused_stack_packed as k2
    from ..ops.cuda import fused_stack_plan as plan
    from ..utils.profiler import device_times

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30).stdout.strip()

    tiles = [tuple(int(v) for v in t.split("x")) for t in args.tiles.split(",")]
    variants = []  # (name, csrc, defines, tile, weight bytes a CTA by pk)
    if args.parent:
        variants.append(("parent", os.path.abspath(args.parent), (), PARENT_TILE,
                         {pk: parent_weight_bytes_per_cta(pk) for pk in (1, 2)}))
    for i, (th, tw) in enumerate(tiles):
        defines = () if i == 0 else (f"FSE_TILE_H={th}", f"FSE_TILE_W={tw}")
        variants.append((f"tile {th}x{tw}", None, defines, (th, tw),
                         {pk: plan.weight_bytes_per_cta(pk) for pk in (1, 2)}))

    def build_one(v):
        path = build.library_path(v[1] or build.CSRC, v[2])
        return build.build(path, v[1] or build.CSRC, v[2])["seconds"] if not os.path.exists(
            path) else 0.0

    with ThreadPoolExecutor(len(variants)) as ex:
        build_s = list(ex.map(build_one, variants))
    libs = [build.load_library(v[1], v[2]) for v in variants]

    imp = import_pix_shuffle(ONNX)
    params = params_from_jax(imp.params, device=dev)
    forms = {1: ("fse_fused_stack", fs.prepare_weights(params, dev), fs.fused_stack_plain),
             2: ("fse_fused_stack_packed", k2.prepare_weights(params, dev),
                 k2.fused_stack_packed_plain)}
    u = frame_input(dev, imp.crop_left, imp.srgb_to_linear_exponent)
    gen = torch.Generator().manual_seed(7)
    odd = (torch.rand(290, 375, 12, generator=gen) ** 2.2).to(torch.bfloat16).to(dev)
    trio = (torch.rand(3, 40, 58, 12, generator=gen) ** 2.2).to(torch.bfloat16).to(dev)
    refs = {pk: (plain(u, sw, out_fp32=True), plain(odd, sw, out_fp32=True))
            for pk, (_, sw, plain) in forms.items()}

    recs, first = [], {}
    for (name, csrc, defines, tile, wbytes), lib, secs in zip(variants, libs, build_s):
        key = (os.path.abspath(csrc or build.CSRC), tuple(defines))
        gx, gy = plan.grid(*u.shape[:2], tile)
        rec = dict(variant=name, tile=list(tile), ctas=gx * gy,
                   waves=plan.waves(*u.shape[:2], tile=tile), nvidia_smi=smi,
                   build_seconds=secs,
                   ptxas=[ln.strip() for ln in build.infos[key]["ptxas"].splitlines()
                          if "stack_kernel" in ln or "registers" in ln or "spill" in ln][:12])
        for pk, (entry, sw, _) in forms.items():
            run = lambda x, e=entry, s=sw, lb=lib: fs.launch_stack(e, x, s, lb)  # noqa: E731
            one_by_one = torch.stack([run(trio[i].contiguous()) for i in range(3)])
            y = run(u)
            first.setdefault(pk, y)
            r = dict(frame=errors(y, refs[pk][0]), odd_290x375=errors(run(odd), refs[pk][1]),
                     equal_to_first_variant=bool(torch.equal(y, first[pk])),
                     batch3_equals_frames=bool(torch.equal(run(trio), one_by_one)),
                     weight_bytes_per_cta=wbytes[pk], times=[])
            if hasattr(lib, entry + "_info"):
                r["info"] = fs.kernel_info(entry, dev, lib)
            rec[f"k{pk}"] = r
        torch.cuda.synchronize()
        recs.append(rec)

    if not args.check_only:
        order = list(range(len(variants)))
        for i in order + order[::-1]:
            for pk, (entry, sw, _) in forms.items():
                t = device_times(lambda: fs.launch_stack(entry, u, sw, libs[i]))
                recs[i][f"k{pk}"]["times"].append(t)

    for rec in recs:
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(recs, f, indent=1)
    ok = all(rec[k]["frame"]["max_abs"] <= 6e-3 and rec[k]["frame"]["mean_abs"] <= 6e-4
             and rec[k]["odd_290x375"]["max_abs"] <= 6e-3 and rec[k]["batch3_equals_frames"]
             for rec in recs for k in ("k1", "k2"))
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
