"""Why the card's fp32 train-step gradient leaves an fp64 one, batch by batch.

    python -m fs_uae_image_enhancer_project_tpu_torch.scripts.probe_fp32_grad \\
        [--batches 80] [--cpu_batches 32] [--out FILE]

The probe behind the fp32 gradient check of ``chip_smoke.py``'s ``train``
phase (``train/gradcheck.py``). It makes the datagen phase's tree (two
seeded 1504x1152 images through the generator's batched device route),
takes its pairs in sorted path order, two a batch, and runs the lightweight
pix_shuffle's train step from the trainer's seeded weights on the card:

- the input transform (``batch_transform``: ``/255``, ``** 2.2`` in fp32)
  on the card against the CPU, for each of the 256 uint8 values;
- for each of the first ``--batches`` batches: the fp32 step on the card
  with its kinks recorded (``gradcheck.kink_mode``), the fp64 step on the
  card replaying them, and the plain fp64 step on the card, with the kinks
  whose branch differs from the fp32 step's counted by kind; each leaf's
  distance from either reference, relative to its max |g|, and from the
  replay relative to the check's scale (a conv bias's or an activation
  parameter's terms, ``gradcheck.contribution_mode``);
- for the first ``--cpu_batches``: the fp32 and fp64 steps on the CPU too,
  and the check the replay replaced, with the CPU's fp64 step as its
  reference (a leaf fails when the card is over 1e-3 from the CPU's fp32 and
  over 1e-3 plus twice the CPU's own distance from the CPU's fp64).

One JSON line a batch, then a summary line, also written to ``--out``.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REL = 1e-3  # the check's bound (chip_smoke.py's TRAIN_GRAD_REL)
CROP = (376, 288)


def make_tree(dest: str, device: str = "cuda") -> None:
    """The datagen phase's batched tree: two seeded 1504x1152 frames, lores
    376x288 crops (8 an image), RGB444, palettes 64 and 256, five dithers."""
    from PIL import Image

    from ..datagen.generator import DatasetGenerator, GeneratorConfig
    from .common import gradient_noise

    src = dest + "_src"
    os.makedirs(src)
    for i in range(2):
        Image.fromarray(gradient_noise(1152, 1504, seed=10 + i, sigma=48.0)).save(
            os.path.join(src, f"img_{i}.png"))
    DatasetGenerator(GeneratorConfig(
        train_images=[src], dest_dir=dest, crop_w=CROP[0], crop_h=CROP[1],
        resolutions=("lores",), colorspaces=("RGB444",), palettes=(64, 256),
        dithers=("none", "checkerboard", "bayer2x2", "bayer4x4", "bayer8x8"),
        palette_algorithm="kmeans_torch", quantize_backend="device",
        max_crops_per_image=8, workers=1, cache_dir=dest + "_cache", verbose=0,
        device=device, device_batch=16)).run()


def run(batches: int = 80, cpu_batches: int = 32, device: str = "cuda") -> dict:
    """The probe on ``device`` (``cpu`` rehearses it: the "card" is the CPU)."""
    import torch

    from ..data import batch_transform, gather_all_samples_from_directory
    from ..models import get_model
    from ..train import gradcheck as gc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, cpu = torch.device(device), torch.device("cpu")
    m = get_model("pix_shuffle")
    weights = {k: {n: t.detach() for n, t in v.items()}
               for k, v in m.init(torch.Generator().manual_seed(0), device="cpu").items()}
    names = gc.leaf_names(weights)
    values = torch.arange(256, dtype=torch.uint8)
    to_float = batch_transform(True)
    differ = (to_float(values) != to_float(values.to(dev)).cpu()).nonzero().flatten().tolist()
    out = {"transform_values_differing": len(differ), "values": differ, "batches": []}

    def rel(a, b, sums=None):
        """Each leaf's distance relative to its max |g|, or with ``sums`` to
        the check's scale (a broadcast leaf's terms, ``gradcheck``)."""
        sums = sums or [None] * len(names)
        return {n: float((x - t).abs().max()) / float((t if s is None else s).abs().max())
                for n, x, t, s in zip(names, a, b, sums)}

    def worst(d):
        n = max(d, key=d.get)
        return [n, d[n]]

    with tempfile.TemporaryDirectory() as tmp:
        tree = os.path.join(tmp, "tree")
        make_tree(tree, device)
        pairs = gather_all_samples_from_directory(tree, CROP, verbose=0)
        styled = sorted(os.path.relpath(a, tree) for a, _ in pairs)
        for bi in range(min(batches, len(styled) // 2)):
            t0 = time.perf_counter()
            paths = tuple(styled[2 * bi:2 * bi + 2])
            lr_b, hr_b = gc.load_batch(tree, paths)
            dec32, dec64, sums = [], [], []
            _, g32 = gc.fp32_step(m, weights, lr_b, hr_b, dev, dec32)
            _, g64r, replayed = gc.fp64_step(m, weights, lr_b, hr_b, dev, dec32, sums)
            with gc.kink_mode(dec64, replay=False):
                _, g64, _ = gc.fp64_step(m, weights, lr_b, hr_b, dev)
            flips: dict = {}
            for (kind, _shape, a), (_, _, b) in zip(dec32, dec64):
                flips[kind] = flips.get(kind, 0) + int((a != b).sum())
            r = dict(batch=bi, pairs=list(paths), kinks=len(dec32), replayed=replayed,
                     vs_replay=worst(rel(g32, g64r, sums)),
                     vs_replay_of_max_g=worst(rel(g32, g64r)), vs_plain_fp64=worst(rel(g32, g64)),
                     flips=flips)
            if bi < cpu_batches:
                _, gcpu = gc.fp32_step(m, weights, lr_b, hr_b, cpu)
                _, gc64, _ = gc.fp64_step(m, weights, lr_b, hr_b, cpu)
                dev_cpu, dev_c64, cpu_c64 = rel(g32, gcpu), rel(g32, gc64), rel(gcpu, gc64)
                r.update(fp64_card_vs_cpu=worst(rel(g64, gc64)), cpu_vs_cpu_fp64=worst(cpu_c64),
                         cpu_reference_check_fails=sorted(
                             n for n in names if dev_cpu[n] > REL
                             and dev_c64[n] > REL + 2 * cpu_c64[n]))
            r["seconds"] = time.perf_counter() - t0
            out["batches"].append(r)
            print(json.dumps(r), flush=True)
    b = out["batches"]
    cpu_rows = [r for r in b if "cpu_reference_check_fails" in r]
    out["summary"] = dict(
        batches=len(b), over_bound_vs_replay=sum(r["vs_replay"][1] > REL for r in b),
        worst_vs_replay=max(r["vs_replay"][1] for r in b),
        over_bound_vs_plain_fp64=sum(r["vs_plain_fp64"][1] > REL for r in b),
        worst_vs_plain_fp64=max(r["vs_plain_fp64"][1] for r in b),
        flips={k: sum(r["flips"].get(k, 0) for r in b) for k in
               sorted({k for r in b for k in r["flips"]})},
        cpu_batches=len(cpu_rows),
        cpu_reference_check_failing_batches=[r["batch"] for r in cpu_rows if r["cpu_reference_check_fails"]],
        worst_fp64_card_vs_cpu=max((r["fp64_card_vs_cpu"] for r in cpu_rows),
                                   key=lambda w: w[1], default=None),
        card=torch.cuda.get_device_name(0) if dev.type == "cuda" else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="The card's fp32 train-step gradient against fp64")
    ap.add_argument("--batches", type=int, default=80)
    ap.add_argument("--cpu_batches", type=int, default=32)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    out = run(args.batches, args.cpu_batches)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out["summary"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
