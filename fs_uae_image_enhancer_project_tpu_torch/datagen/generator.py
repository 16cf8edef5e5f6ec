"""The idempotent dataset generator.

Counterpart of reference ``dataset_generator/generator.py`` (the 1.7k-line
orchestrator). The core idea is preserved — build the full cartesian spec
space, diff it against what already exists on disk, generate only the delta —
so a crashed or killed run resumes by re-running the same command
(generator.py:1157-1275). Re-designed around a small Spec dataclass and a
clean phase pipeline:

1. discover ground-truth images per split          (_load_image_paths)
2. scan valid crop locations (cached, threaded)    (_scan_ground_truth)
3. build the full valid spec set                   (_build_specs)
4. scan + validate the output directory            (_scan_output)
5. delete invalid/orphaned files                   (_cleanup_invalid)
6. compute the generate/keep/delete delta          (_plan)
7. generate targets then styled files (processes)  (_generate)
8. final summary                                   (summary)

SIGINT sets a stop flag checked at every phase boundary and between work
items (generator.py:597-606 semantics). Filenames use the shared codec in
``data/codec.py``.

The port of the JAX package's ``datagen/generator.py``: the same spec diff,
idempotence, orphan cleanup, SIGINT boundaries, quotas and CLI spelling. The
styled phase's host route (``quantize_backend='numpy'``) is the default, as
in the JAX package; the device route (``'device'``, opt-in as ``'pallas'`` is
there) runs the palette dither through the CUDA kernel K3 on ``device``
(default ``cuda``), per crop or, with ``device_batch > 0``, batched per
(style combo, spec chunk) in :mod:`.device_batch`.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
import signal
import sys
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from .. import resolve_device
from ..data.codec import construct_filename, parse_generated_filename
from .cache import ScanCache
from .quantize import VALID_BACKENDS, VALID_COLOR_SPACES, valid_dither_methods
from .util_img import (
    SUPPORTED_RESOLUTION_STYLES,
    apply_downscaling,
    apply_rotation,
    calculate_grid_coords,
    get_crop_and_pad,
    post_apply_resolution_style,
    pre_apply_resolution_style,
    should_discard_by_black_ratio,
)

_stop_requested = False


def _sigint_handler(_sig, _frm):
    global _stop_requested
    _stop_requested = True
    print("\nStop requested — finishing in-flight work, then exiting cleanly.")


@dataclass(frozen=True)
class StyleCombo:
    resolution: str
    colorspace: str  # 'RGB444' etc.
    palette: Optional[int]  # None = no palette reduction
    dither: str


@dataclass(frozen=True)
class CropSpec:
    split: str  # 'train' | 'test'
    image_path: str
    image_base: str  # subdirectory name (image filename without ext)
    crop_x: int
    crop_y: int
    scale_perc: int  # 0 (reference spelling) or 100 = no downscale
    rot_deg: int

    def params(self) -> dict:
        return {
            "crop_x": self.crop_x,
            "crop_y": self.crop_y,
            "scale_perc": self.scale_perc,
            "rot_deg": self.rot_deg,
        }


@dataclass
class GeneratorConfig:
    train_images: Sequence[str] = ()
    test_images: Sequence[str] = ()
    dest_dir: str = "generated"
    crop_w: int = 376
    crop_h: int = 288
    resolutions: Sequence[str] = ("lores",)
    colorspaces: Sequence[str] = ("RGB444",)
    palettes: Sequence[Optional[int]] = (32,)  # 0/None = no palette
    dithers: Sequence[str] = ("none",)
    rotations: Sequence[int] = (0,)
    # percent; 0 = none (the reference's spelling — its --downscale
    # default is 0 and filenames encode s0; 100 is accepted as an alias
    # and canonicalized to 0 so pre-existing s100 corpora keep matching)
    downscales: Sequence[int] = (0,)
    # crop grid: 'tile' = the reference's live scan (non-overlapping
    # crop-sized tiling from the origin, generator.py:209-211); 'overlap' =
    # the centered 20%-overlap grid (reference generator.py:68-117 — dead
    # code upstream, kept as an opt-in because it yields ~1.5x more crops)
    grid: str = "tile"
    palette_algorithm: str = "kmeans"
    # 'numpy' (default, as in the JAX package: the host route, multi-process
    # friendly) or 'device' (opt-in, as 'pallas' is in the JAX package: K3
    # for the vectorizable dither families, on ``device``; best with
    # workers=1 or device_batch>0, one process owning the card). The two
    # routes agree on most pixels, not all, so a corpus is made with one
    quantize_backend: str = "numpy"
    # >0 with quantize_backend='device': run the styled phase in-process in
    # spec-chunks of this size — ONE batched device call per (style, chunk)
    # for palettes and dithering instead of one per crop, with base-crop
    # preparation shared across style combos (datagen/device_batch)
    device_batch: int = 0
    # where kmeans_torch and K3 run: None means 'cuda', which raises without
    # a card; 'cpu' runs their plain versions
    device: Optional[str] = None
    black_ratio_threshold: float = 0.75
    max_crops_per_image: Optional[int] = None  # quota per (image, rot, ds)
    # per-split quotas on unique target crops, 0/None = unlimited
    # (reference --train_num_crops/--test_num_crops, generator.py:1157-1275;
    # shrink-on-rerun falls out of the spec-diff orphan cleanup)
    train_num_crops: Optional[int] = None
    test_num_crops: Optional[int] = None
    workers: int = max(1, (os.cpu_count() or 2) - 1)
    cache_dir: str = ".scan_cache"
    assume_yes: bool = True  # non-interactive delete of invalid files
    # opt-in for deleting more than half of a non-trivial destination
    # (mass-orphan guard in _cleanup_orphans)
    force_delete_orphans: bool = False
    verbose: int = 1

    def __post_init__(self):
        # Reference downscale/rotation semantics (generator.py:671-690):
        # the no-op entries are ALWAYS part of the spec space (valid_
        # downscales/valid_rotations are seeded with 0), out-of-range
        # downscales warn and are ignored, rotations are taken mod 360.
        # 100 is accepted as an alias of 0 (this repo's historical
        # no-downscale spelling).
        import warnings as _warnings

        if self.quantize_backend not in VALID_BACKENDS:
            raise ValueError(
                f"quantize_backend must be one of {VALID_BACKENDS}, "
                f"got {self.quantize_backend!r}")
        self.device = str(resolve_device(self.device))
        ds = [0]
        for d in self.downscales:
            d = 0 if d == 100 else d
            if d == 0:
                continue
            if not 0 < d < 100:
                _warnings.warn(
                    f"Invalid downscale percentage ignored: {d}. "
                    "Must be an integer > 0 and < 100.")
                continue
            ds.append(d)
        self.downscales = tuple(sorted(set(ds)))
        self.rotations = tuple(sorted({0} | {r % 360 for r in self.rotations}))
        # Reference dither semantics (generator.py:743-768): names are
        # case-insensitive, unsupported entries WARN and are skipped, and an
        # empty/all-invalid list defaults to no-dither rather than erroring.
        valid = set(valid_dither_methods())
        dits = []
        for d in self.dithers:
            d = str(d).lower()
            if d not in valid:
                _warnings.warn(
                    f"Unsupported dithering method ignored: '{d}'. "
                    f"Supported: {sorted(valid)}.")
                continue
            dits.append(d)
        self.dithers = tuple(sorted(set(dits))) or ("none",)

    def style_combos(self) -> List[StyleCombo]:
        combos: List[StyleCombo] = []
        seen = set()

        def _add(res, cs, pal, dit):
            # the reference collects characteristics in a SET; the pal-None
            # checkerboard->none conversion can produce duplicates
            key = (res, cs, pal, dit)
            if key not in seen:
                seen.add(key)
                combos.append(StyleCombo(res, cs, pal, dit))

        for res in self.resolutions:
            if res not in SUPPORTED_RESOLUTION_STYLES:
                raise ValueError(f"unknown resolution style {res}")
            for cs in self.colorspaces:
                if cs not in VALID_COLOR_SPACES:
                    raise ValueError(f"unknown colorspace {cs}")
                if not self.palettes:
                    # Case A (reference generator.py:784-795): --palette
                    # absent -> exactly ONE non-palette combo per colorspace;
                    # 'none' wins over 'checkerboard', any other dither
                    # yields nothing (pinned byte-level by goldens runs A/C)
                    if "none" in self.dithers:
                        _add(res, cs, None, "none")
                    elif "checkerboard" in self.dithers:
                        _add(res, cs, None, "checkerboard")
                    continue
                # Case B (reference generator.py:797-831): product over
                # palettes x dithers; a pal-0/None entry converts
                # checkerboard to the 'none' combo and filters every other
                # dither ("dithering requires a palette")
                for pal in self.palettes:
                    pal_n = None if not pal else int(pal)
                    for dit in self.dithers:
                        if pal_n is None:
                            if dit in ("none", "checkerboard"):
                                _add(res, cs, None, "none")
                            continue
                        _add(res, cs, pal_n, dit)
        if not combos:
            # reference generator.py:816 raises before touching disk —
            # proceeding would orphan-delete every styled file in dest
            raise ValueError(
                "No valid style characteristics combinations were "
                "generated from arguments.")
        return combos


# ---------------------------------------------------------------------------
# Worker functions (top-level: picklable for ProcessPoolExecutor)
# ---------------------------------------------------------------------------

def _prepare_base(image_path: str, rot: int, scale: int, crop, crop_w, crop_h):
    from PIL import Image

    with Image.open(image_path) as img:
        img = img.convert("RGB")
        img = apply_rotation(img, rot, supersample_factor=2)
        if 0 < scale < 100:  # 0 and 100 both mean no downscale
            img = apply_downscaling(img, scale)
        return get_crop_and_pad(img, crop[0], crop[1], crop_w, crop_h)


def save_target_worker(args) -> Tuple[str, Optional[str]]:
    """Generate one target (ground-truth) crop PNG (generator.py:229-283)."""
    spec_d, crop_w, crop_h, out_path = args
    try:
        crop = _prepare_base(
            spec_d["image_path"], spec_d["rot_deg"], spec_d["scale_perc"],
            (spec_d["crop_x"], spec_d["crop_y"]), crop_w, crop_h,
        )
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        crop.save(out_path)
        return out_path, None
    except Exception as e:
        return out_path, f"{type(e).__name__}: {e}"


def save_styled_worker(args) -> Tuple[str, Optional[str]]:
    """Generate one styled crop PNG: rotate -> downscale -> crop -> pre-style
    -> quantize/dither -> post-style -> save (generator.py:381-537)."""
    import numpy as np
    from PIL import Image

    from .quantize import reduce_color_depth_and_dither

    spec_d, combo_d, crop_w, crop_h, palette_algorithm, backend, device, out_path = args
    try:
        crop = _prepare_base(
            spec_d["image_path"], spec_d["rot_deg"], spec_d["scale_perc"],
            (spec_d["crop_x"], spec_d["crop_y"]), crop_w, crop_h,
        )
        low = pre_apply_resolution_style(crop, combo_d["resolution"])
        arr = np.asarray(low, dtype=np.uint8)
        out = reduce_color_depth_and_dither(
            arr,
            color_space=combo_d["colorspace"],
            target_palette_size=combo_d["palette"],
            dithering_method=combo_d["dither"],
            palette_algorithm=palette_algorithm,
            verbose=0,
            backend=backend,
            device=device,
        )
        styled = post_apply_resolution_style(
            Image.fromarray(out), combo_d["resolution"]
        )
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        styled.save(out_path)
        return out_path, None
    except Exception as e:
        return out_path, f"{type(e).__name__}: {e}"


def scan_image_task(args) -> List[Tuple[int, int]]:
    """Find valid crop coordinates for one (image, rot, ds): NEAREST-rotate
    (fast scan), downscale, grid coords, black-ratio filter
    (generator.py:161-227). grid='tile' reproduces the reference's live
    scan exactly (crop-sized steps from the origin, y-outer order);
    'overlap' is the centered 20%-overlap grid."""
    from PIL import Image

    image_path, rot, scale, crop_w, crop_h, threshold, grid = args
    with Image.open(image_path) as img:
        img = img.convert("RGB")
        if rot % 360:
            img = img.rotate(rot, resample=Image.Resampling.NEAREST)
        if 0 < scale < 100:
            img = apply_downscaling(img, scale)
        w, h = img.size
        if grid == "overlap":
            coords = calculate_grid_coords(w, h, crop_w, crop_h)
        else:
            coords = [(x, y) for y in range(0, h - crop_h + 1, crop_h)
                      for x in range(0, w - crop_w + 1, crop_w)]
        valid = []
        for (x, y) in coords:
            crop = get_crop_and_pad(img, x, y, crop_w, crop_h)
            if not should_discard_by_black_ratio(crop, threshold):
                valid.append((x, y))
        return valid


# ---------------------------------------------------------------------------
# The orchestrator
# ---------------------------------------------------------------------------

class DatasetGenerator:
    def __init__(self, cfg: GeneratorConfig):
        self.cfg = cfg
        self.cache = ScanCache(cfg.cache_dir)
        self.combos = cfg.style_combos()
        self._log(1, f"{len(self.combos)} style combinations active")

    def _log(self, level: int, msg: str) -> None:
        if self.cfg.verbose >= level:
            print(msg, flush=True)

    # -- phase 1 -----------------------------------------------------------
    def _load_image_paths(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {"train": [], "test": []}
        for split, roots in (("train", self.cfg.train_images),
                             ("test", self.cfg.test_images)):
            for root in roots:
                if os.path.isfile(root):
                    out[split].append(root)
                    continue
                for r, _d, files in os.walk(root):
                    for f in sorted(files):
                        if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")):
                            out[split].append(os.path.join(r, f))
        self._log(1, f"found {len(out['train'])} train / {len(out['test'])} test images")
        return out

    # -- phase 2 -----------------------------------------------------------
    def _scan_ground_truth(self, images: Dict[str, List[str]]) -> List[CropSpec]:
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        specs: List[CropSpec] = []
        tasks = []
        # output dirs are keyed by image_base (filename stem); two
        # same-named source images in different subdirectories must not
        # collide into one output dir (which would dict-overwrite one
        # image's expected files with the other's — silent corruption).
        # Disambiguate deterministically (path hash), so collision-free
        # corpora keep plain stems and stay diff-idempotent.
        import hashlib

        base_of: Dict[tuple, str] = {}
        for split, paths in images.items():
            claimed: Dict[str, str] = {}  # base -> path that owns it
            for p in sorted(paths):
                stem = os.path.splitext(os.path.basename(p))[0]
                base = stem
                if claimed.get(base, p) != p:
                    digest = hashlib.md5(p.encode()).hexdigest()[:8]
                    base = f"{stem}_{digest}"
                claimed[base] = p
                base_of[(split, p)] = base
        for split, paths in images.items():
            for p in paths:
                for rot in cfg.rotations:
                    for ds in cfg.downscales:
                        tasks.append((split, p, rot, ds))

        def run_one(t):
            split, p, rot, ds = t
            key = ScanCache.make_key(p, rot, ds, cfg.grid, cfg.crop_w,
                                     cfg.crop_h, cfg.black_ratio_threshold)
            cached = self.cache.get(key, p)
            if cached is None:
                cached = scan_image_task(
                    (p, rot, ds, cfg.crop_w, cfg.crop_h,
                     cfg.black_ratio_threshold, cfg.grid)
                )
                self.cache.put(key, p, cached)
            return t, cached

        with ThreadPoolExecutor(max_workers=cfg.workers) as ex:
            for (split, p, rot, ds), coords in ex.map(run_one, tasks):
                if _stop_requested:
                    break
                if cfg.max_crops_per_image is not None:
                    coords = coords[: cfg.max_crops_per_image]
                base = base_of[(split, p)]
                for (x, y) in coords:
                    specs.append(CropSpec(split, p, base, x, y, ds, rot))
        self._log(1, f"scan: {len(specs)} valid crop locations")
        return specs

    def _target_rel(self, s: CropSpec) -> str:
        return os.path.normpath(
            os.path.join(
                s.split, s.image_base, construct_filename(s.params(), is_target=True)
            )
        )

    def _apply_split_quotas(
        self, specs: List[CropSpec], existing: Dict[str, str]
    ) -> List[CropSpec]:
        """Keep at most N unique target crops per split.

        Anchored to disk like the reference quota logic
        (generator.py:1215-1265): crops whose targets already exist are kept
        first (no churn when re-running over a built dataset), and only the
        shortfall is filled — deterministically via a seeded shuffle so fills
        are spread across source images. Warns when a quota cannot be met
        (reference generator.py:1388-1390)."""
        import random
        import warnings

        quotas = {"train": self.cfg.train_num_crops, "test": self.cfg.test_num_crops}
        for split, quota in quotas.items():
            if quota is not None and quota < 0:
                raise ValueError(f"--{split}_num_crops cannot be negative.")
        if not any(quotas.values()):
            return specs
        out: List[CropSpec] = []
        for split in ("train", "test"):
            split_specs = [s for s in specs if s.split == split]
            quota = quotas.get(split)
            if not quota:
                out.extend(split_specs)
                continue
            if len(split_specs) < quota:
                warnings.warn(
                    f"Cannot meet requested quota: only {len(split_specs)} valid "
                    f"{split} crops exist (requested {quota})."
                )
                out.extend(split_specs)
                continue
            if len(split_specs) == quota:
                out.extend(split_specs)
                continue
            on_disk = [s for s in split_specs if self._target_rel(s) in existing]
            missing = [s for s in split_specs if self._target_rel(s) not in existing]
            keep = on_disk[:quota]
            if len(keep) < quota:
                order = sorted(
                    missing,
                    key=lambda s: (s.image_base, s.rot_deg, s.scale_perc,
                                   s.crop_x, s.crop_y),
                )
                random.Random(1234).shuffle(order)
                keep.extend(order[: quota - len(keep)])
            self._log(
                1,
                f"quota: keeping {len(keep)} {split} crops "
                f"({len(on_disk)} already on disk, "
                f"{len(split_specs) - len(keep)} dropped)",
            )
            out.extend(keep)
        return out

    # -- phases 3-4 ----------------------------------------------------------
    def _expected_files(self, specs: List[CropSpec]) -> Dict[str, tuple]:
        """Map of expected relative path -> (spec, combo|None)."""
        expected: Dict[str, tuple] = {}
        for s in specs:
            d = os.path.join(s.split, s.image_base)
            tname = construct_filename(s.params(), is_target=True)
            expected[os.path.join(d, tname)] = (s, None)
            for c in self.combos:
                p = dict(s.params())
                p.update(
                    resolution=c.resolution, rgb=c.colorspace,
                    pal=c.palette, dither=c.dither,
                )
                sname = construct_filename(p, is_target=False)
                expected[os.path.join(d, sname)] = (s, c)
        return expected

    def _scan_output(self) -> Dict[str, str]:
        """Existing parsable files: CANONICAL dest-relative path -> actual
        on-disk dest-relative path.

        Canonicalization lets corpora written with historical spellings
        keep satisfying specs (and protects them from orphan deletion):
        scale 0/100 are the same no-downscale operation (the reference
        writes s0), and no-dither is 'None' on the wire (earlier versions
        here wrote s100/dnone). A duplicate of a canonical name (both
        spellings on disk) keeps the first file; later duplicates are
        reported as orphans.
        """
        existing: Dict[str, str] = {}
        # reset BEFORE any early return: a prior scan's duplicates must not
        # leak into this run's orphan plan if dest has since disappeared
        self._duplicate_orphans: List[str] = []
        dest = self.cfg.dest_dir
        if not os.path.isdir(dest):
            return existing
        for root, _d, files in os.walk(dest):
            rel_root = os.path.relpath(root, dest)
            for f in sorted(files):
                parsed = parse_generated_filename(f)
                if parsed is None:
                    continue
                # construct_filename canonicalizes spelling (s100->s0,
                # dnone->dNone), so a legacy-spelled file maps onto its
                # canonical spec name here
                cname = construct_filename(
                    parsed, is_target=parsed["type"] == "target")
                crel = os.path.normpath(os.path.join(rel_root, cname))
                arel = os.path.normpath(os.path.join(rel_root, f))
                if crel in existing:
                    self._duplicate_orphans.append(arel)
                else:
                    existing[crel] = arel
        return existing

    # -- phase 5-6 ----------------------------------------------------------
    def _plan(self, expected: Dict[str, tuple], existing: Dict[str, str]):
        expected_set = set(map(os.path.normpath, expected.keys()))
        to_generate = sorted(expected_set - set(existing))
        # orphans are deleted at their ACTUAL on-disk paths (a legacy-
        # spelled file whose canonical spec exists is NOT an orphan)
        orphans = sorted(
            existing[c] for c in set(existing) - expected_set
        ) + sorted(getattr(self, "_duplicate_orphans", []))
        kept = len(expected_set & set(existing))
        self._log(
            1,
            f"plan: {kept} up-to-date, {len(to_generate)} to generate, "
            f"{len(orphans)} orphans",
        )
        return to_generate, orphans

    def _cleanup_orphans(self, orphans: List[str],
                         total_existing: int) -> None:
        if not orphans:
            return
        # Mass-deletion guard: a changed spec space (different --palette/
        # --dither/--grid defaults, a typo'd flag) can classify most of an
        # existing corpus as orphans. Deleting more than half of a
        # non-trivial destination requires the explicit opt-in.
        if (len(orphans) > 50 and len(orphans) * 2 > total_existing
                and not self.cfg.force_delete_orphans):
            self._log(
                0,
                f"REFUSING to delete {len(orphans)} of {total_existing} "
                "existing files (more than half the destination). If the "
                "spec change is intentional, re-run with "
                "--force_delete_orphans (force_delete_orphans=True).")
            return
        if not self.cfg.assume_yes:
            ans = input(f"Delete {len(orphans)} orphaned files? [y/N] ")
            if ans.strip().lower() != "y":
                return
        for rel in orphans:
            try:
                os.remove(os.path.join(self.cfg.dest_dir, rel))
            except OSError:
                pass
        self._log(1, f"deleted {len(orphans)} orphaned files")

    # -- phase 7 ------------------------------------------------------------
    def _generate(self, to_generate: List[str], expected: Dict[str, tuple]) -> int:
        cfg = self.cfg
        target_jobs, styled_jobs = [], []
        norm_expected = {os.path.normpath(k): v for k, v in expected.items()}
        for rel in to_generate:
            spec, combo = norm_expected[rel]
            out_path = os.path.join(cfg.dest_dir, rel)
            if combo is None:
                target_jobs.append(
                    (dataclasses.asdict(spec), cfg.crop_w, cfg.crop_h, out_path)
                )
            else:
                styled_jobs.append(
                    (dataclasses.asdict(spec), dataclasses.asdict(combo),
                     cfg.crop_w, cfg.crop_h, cfg.palette_algorithm,
                     cfg.quantize_backend, cfg.device, out_path)
                )

        done = 0
        errors = 0
        total = len(target_jobs) + len(styled_jobs)
        t0 = time.time()

        def report(path, err):
            # the single done/errors/rate/ETA bookkeeping point for every
            # execution path (pool, inline per-crop, batched device)
            nonlocal done, errors
            done += 1
            if err is not None:
                errors += 1
                self._log(1, f"ERROR {path}: {err}")
            if done % 50 == 0 or done == total:
                rate = done / max(time.time() - t0, 1e-9)
                eta = (total - done) / max(rate, 1e-9)
                self._log(1, f"  {done}/{total} ({rate:.1f}/s, ETA {eta:.0f}s)")

        def drain(futures):
            for fut in as_completed(futures):
                report(*fut.result())
                if _stop_requested:
                    for f in futures:
                        f.cancel()
                    break

        on_device = cfg.quantize_backend == "device"
        batched_styled = on_device and cfg.device_batch > 0

        # Phase A: targets first (styled pairing needs them); Phase B: styled.
        for jobs, worker, label in (
            (target_jobs, save_target_worker, "targets"),
            (styled_jobs, save_styled_worker, "styled"),
        ):
            if _stop_requested or not jobs:
                continue
            self._log(1, f"generating {len(jobs)} {label} ...")
            if label == "styled" and batched_styled:
                # in-process batched device pipeline: one process owns the
                # card, one device call per (style, spec-chunk)
                from .device_batch import run_styled_jobs_batched

                run_styled_jobs_batched(
                    jobs, cfg.device_batch, report,
                    should_stop=lambda: _stop_requested,
                )
                continue
            if on_device and cfg.workers == 1:
                # per-crop device path runs inline: one process owns the
                # card, and a pool worker forked after CUDA has initialised
                # in this process cannot use CUDA
                for j in jobs:
                    if _stop_requested:
                        break
                    path, err = worker(j)
                    report(path, err)
                continue
            # the device route with workers>1 must spawn (fresh interpreters:
            # CUDA cannot be used in a child forked after the parent
            # initialised it), and so must workers that run kmeans_torch;
            # the host path keeps the cheap fork default
            ctx = (multiprocessing.get_context("spawn")
                   if on_device or cfg.palette_algorithm == "kmeans_torch"
                   else None)
            with ProcessPoolExecutor(max_workers=cfg.workers,
                                     mp_context=ctx) as ex:
                drain([ex.submit(worker, j) for j in jobs])
        if errors:
            self._log(1, f"completed with {errors} errors")
        return done

    # -- public --------------------------------------------------------------
    def run(self) -> dict:
        global _stop_requested
        _stop_requested = False
        prev = signal.signal(signal.SIGINT, _sigint_handler)
        try:
            images = self._load_image_paths()
            specs = self._scan_ground_truth(images)
            if _stop_requested:
                # a partial scan must never drive deletions: everything not
                # scanned would be misclassified as orphaned
                self._log(1, "stopped during scan; no cleanup or generation")
                return self.summary({}, 0)
            existing = self._scan_output()
            specs = self._apply_split_quotas(specs, existing)
            expected = self._expected_files(specs)
            to_generate, orphans = self._plan(expected, existing)
            self._cleanup_orphans(orphans, len(existing))
            generated = 0
            if not _stop_requested:
                generated = self._generate(to_generate, expected)
            return self.summary(expected, generated)
        finally:
            signal.signal(signal.SIGINT, prev)

    def summary(self, expected: Dict[str, tuple], generated: int) -> dict:
        existing = self._scan_output()
        expected_set = set(map(os.path.normpath, expected.keys()))
        if _stop_requested and not expected_set:
            stats = {
                "expected": 0, "present": len(existing),
                "generated_this_run": 0, "missing": 0, "stopped": True,
            }
            self._log(1, f"summary: {stats}")
            return stats
        stats = {
            "expected": len(expected_set),
            "present": len(expected_set & set(existing)),
            "generated_this_run": generated,
            "missing": len(expected_set - set(existing)),
            "stopped": _stop_requested,
        }
        self._log(1, f"summary: {stats}")
        return stats


# ---------------------------------------------------------------------------
# CLI (argument surface mirrors reference generator.py:1648-1670)
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Idempotent dataset generator")
    ap.add_argument("--train_images", nargs="*", default=[])
    ap.add_argument("--test_images", nargs="*", default=[])
    # --destination_dir is the reference's spelling (generator.py:1652)
    ap.add_argument("--dest_dir", "--destination_dir", dest="dest_dir",
                    required=True)
    ap.add_argument("--crop_size", type=int, nargs=2, default=[376, 288],
                    metavar=("W", "H"))
    ap.add_argument("--resolution", nargs="*", default=["lores"],
                    choices=SUPPORTED_RESOLUTION_STYLES)
    # --rgb takes bare ints like the reference (e.g. 444 888);
    # --colorspace takes RGBxxx names
    ap.add_argument("--colorspace", nargs="*", default=None,
                    choices=VALID_COLOR_SPACES)
    ap.add_argument("--rgb", type=int, nargs="*", default=None,
                    help="RGB formats as ints (reference spelling): 444 555 565 666 888")
    ap.add_argument("--palette", type=int, nargs="*", default=None,
                    help="palette sizes; 0 means no palette reduction. "
                         "Absent vs '--palette 0' differ like the "
                         "reference: absent allows a bare checkerboard "
                         "combo, 0 converts checkerboard to none")
    ap.add_argument("--dither", nargs="*", default=["none"],
                    help=f"one of {valid_dither_methods()} (case-insensitive; "
                         "'None' accepted like the reference)")
    ap.add_argument("--rotation", "--rotate", dest="rotation", type=int,
                    nargs="*", default=[0])
    ap.add_argument("--downscale", type=int, nargs="*", default=[0],
                    help="percentages; 0 (reference spelling) or 100 = none")
    ap.add_argument("--force_delete_orphans", action="store_true",
                    help="allow deleting more than half of an existing "
                         "destination when the spec space changed")
    ap.add_argument("--grid", choices=["tile", "overlap"], default="tile",
                    help="crop grid: 'tile' matches the reference scan; "
                         "'overlap' is the centered 20%%-overlap grid "
                         "(~1.5x more crops)")
    ap.add_argument("--palette_algorithm", default="kmeans")
    ap.add_argument("--quantize_backend", default="numpy", choices=VALID_BACKENDS,
                    help="'numpy' (default) is the host route; 'device' runs "
                         "vectorizable dithers through the CUDA kernel (use "
                         "with --workers 1 or --device_batch)")
    ap.add_argument("--device_batch", type=int, default=0,
                    help="with --quantize_backend device: styled-phase "
                         "spec-chunk size for batched on-device palette + "
                         "dither calls (0 = per-crop)")
    ap.add_argument("--device", default=None,
                    help="where kmeans_torch and the dither kernel run "
                         "(default cuda; 'cpu' runs their plain versions)")
    ap.add_argument("--max_crops_per_image", type=int, default=None)
    ap.add_argument("--train_num_crops", type=int, default=0,
                    help="total unique target crops for train (0 = all)")
    ap.add_argument("--test_num_crops", type=int, default=0,
                    help="total unique target crops for test (0 = all)")
    ap.add_argument("--workers", "--max_workers", dest="workers", type=int,
                    default=None)
    ap.add_argument("--cache_dir", default=".scan_cache")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--verbose", type=int, default=1)
    args = ap.parse_args(argv)

    if args.colorspace and args.rgb:
        ap.error("use either --colorspace or --rgb, not both")
    if args.rgb:
        colorspaces = tuple(f"RGB{v}" for v in args.rgb)
    else:
        colorspaces = tuple(args.colorspace or ["RGB444"])
    # dither names are normalized (case-insensitive, warn-and-skip invalid,
    # empty -> 'none') by GeneratorConfig.__post_init__, reference semantics
    cfg = GeneratorConfig(
        train_images=args.train_images,
        test_images=args.test_images,
        dest_dir=args.dest_dir,
        crop_w=args.crop_size[0],
        crop_h=args.crop_size[1],
        resolutions=tuple(args.resolution),
        colorspaces=colorspaces,
        palettes=() if args.palette is None else tuple(
            None if p == 0 else p for p in args.palette),
        dithers=tuple(args.dither),
        rotations=tuple(args.rotation),
        downscales=tuple(args.downscale),
        grid=args.grid,
        force_delete_orphans=args.force_delete_orphans,
        palette_algorithm=args.palette_algorithm,
        quantize_backend=args.quantize_backend,
        device_batch=args.device_batch,
        device=args.device,
        max_crops_per_image=args.max_crops_per_image,
        train_num_crops=args.train_num_crops or None,
        test_num_crops=args.test_num_crops or None,
        workers=args.workers or max(1, (os.cpu_count() or 2) - 1),
        cache_dir=args.cache_dir,
        assume_yes=not args.interactive,
        verbose=args.verbose,
    )
    stats = DatasetGenerator(cfg).run()
    return 0 if stats["missing"] == 0 or stats["stopped"] else 1


if __name__ == "__main__":
    sys.exit(main())
