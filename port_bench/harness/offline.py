"""The offline load: a recording in host memory, enhanced a batch a call in
a closed loop, as ``parallel/inference.py``'s ``enhance_directory`` does
(``sharded(put(batch)).cpu().numpy()`` through ``make_sharded_enhance`` on the
1x1 mesh), without its PNG decode and encode.

Set-up reads the configuration's graph once and runs each distinct batch of
the recording once (the only shape the window uses). The window then calls
for ``--seconds`` and ends at the first call that completes past it; the
outputs of a sample of calls, drawn from the seed over the whole window, are
kept for the comparison.
"""
from __future__ import annotations

import gc
import math
import random
import sys
import time

import numpy as np

from . import compare
from .frames import recording
from .graphs import graph_path
from .trace import Slice


class Offline:
    def __init__(self, config: dict, traffic: dict, device, enhance=None):
        from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
        from fs_uae_image_enhancer_project_tpu_torch.parallel.inference import make_sharded_enhance
        from fs_uae_image_enhancer_project_tpu_torch.parallel.mesh import make_mesh

        fn = enhance or enhance_from_onnx(graph_path(config), device=device)
        self.sharded, self.put = make_sharded_enhance(fn, make_mesh(sp=1, device=device))
        self.batch = traffic["batch"]
        self.traffic = traffic
        self.cuda = str(device).startswith("cuda")
        self.slice = Slice(self.cuda)

    def batches(self, frames: np.ndarray):
        b = self.batch
        if len(frames) % b:
            raise ValueError(f"the recording's {len(frames)} frames do not divide by batch {b}")
        return [frames[i:i + b] for i in range(0, len(frames), b)]

    def call(self, batch: np.ndarray) -> np.ndarray:
        return self.sharded(self.put(batch)).cpu().numpy()

    def warm(self, frames: np.ndarray) -> None:
        for b in self.batches(frames):
            self.call(b)

    def window(self, frames: np.ndarray, seconds: float, seed: int, trace: bool = False) -> dict:
        batches = self.batches(frames)
        n_keep = math.ceil(self.traffic["check_frames"] / self.batch)
        pick = random.Random(seed)
        kept = []
        tr = self.traffic
        t_on = tr["trace_at"] * seconds
        length = min(tr["trace_seconds"], 0.5 * seconds)
        prof = self.slice if trace else None
        state, traced, on_at = "before", 0, 0.0
        calls = 0
        t0 = time.monotonic()
        while True:
            k = calls % len(batches)
            out = self.call(batches[k])
            if calls < n_keep:
                kept.append((k, out))
            else:
                j = pick.randrange(calls + 1)
                if j < n_keep:
                    kept[j] = (k, out)
            calls += 1
            elapsed = time.monotonic() - t0
            if prof is not None:
                if state == "before" and elapsed >= t_on:
                    prof.start()
                    state, traced, on_at = "on", calls, time.monotonic() - t0
                elif state == "on" and elapsed >= on_at + length:
                    prof.stop()
                    state, traced = "done", calls - traced
            if elapsed >= seconds:
                break
        if state == "on":
            prof.stop()
            traced = calls - traced
        pairs = [(k * self.batch + i, frame) for k, out in kept for i, frame in enumerate(out)]
        summary = prof.summary(traced * self.batch) if state != "before" else None
        return dict(t_start=t0, window_s=elapsed, calls=calls, frames=calls * self.batch,
                    kept=pairs, expected=n_keep * self.batch, trace=summary)


def print_setup(marks) -> None:
    """Where set-up went, on standard error: each step's seconds."""
    steps = " ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:]))
    print(f"set-up (s): {steps}", file=sys.stderr, flush=True)


def run(cell: dict, args, start: float) -> dict:
    import torch

    config, traffic = cell["config_data"], cell["traffic_data"]
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    h, w = args.frame or (config["frame"]["height"], config["frame"]["width"])
    marks = [("start", start), ("torch", time.monotonic())]
    frames = recording(args.seed, traffic["recording_frames"], h, w, traffic["palette_colours"])
    marks.append(("frames", time.monotonic()))
    off = Offline(config, traffic, dev)
    marks.append(("program", time.monotonic()))
    off.warm(frames)
    if args.trace:
        off.slice.warm()
    marks.append(("warm-up", time.monotonic()))
    print_setup(marks)
    launches = compare.read_counter(config) if cuda else 0
    rec = off.window(frames, args.seconds, args.seed, trace=bool(args.trace))
    launches = compare.read_counter(config) - launches if cuda else 0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del off
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = compare.readings(config, rec["kept"], frames, dev)
    checks = compare.checks(config, got, rec["expected"])
    if cuda:
        checks.update(compare.launch_check(config, launches, rec["calls"]))
    return dict(
        e2e={"frames_per_s": rec["frames"] / rec["window_s"], "setup_s": rec["t_start"] - start},
        ctx={"trace": rec["trace"]},
        checks=checks, attempted=rec["frames"], failed=0, memory_peak_bytes=peak)
