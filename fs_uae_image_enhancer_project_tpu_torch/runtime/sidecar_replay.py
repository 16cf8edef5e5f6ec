"""Replay client for the enhance sidecar: round-trip captured frames.

Port of ``fs_uae_image_enhancer_project_tpu/runtime/sidecar_replay.py``,
against the port's own ``SidecarClient``. Feeds PNG frames (e.g. the
reference's 8 sample captures) or raw RGBA dumps through a running
SidecarServer, saves the enhanced outputs, and logs per-frame wall-clock
latency — the deployment-realistic end-to-end number including both socket
hops and both host<->device transfers. ``--frames`` is required: the JAX
tool's default directory of reference captures is not part of the repo.

    python -m fs_uae_image_enhancer_project_tpu_torch.runtime.sidecar_replay \
        --socket /tmp/fsuae_enhance.sock --frames DIR --out /tmp/enhanced
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from .sidecar import SidecarClient


def load_frame(path: str, h: int, w: int) -> np.ndarray:
    if path.endswith(".png"):
        from PIL import Image

        with Image.open(path) as img:
            arr = np.asarray(img.convert("RGBA"), np.uint8)
        if arr.shape[:2] != (h, w):
            raise ValueError(f"{path}: {arr.shape[:2]} != {(h, w)}")
        return arr
    raw = np.fromfile(path, np.uint8)
    return raw.reshape(h, w, 4)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--socket", default="/tmp/fsuae_enhance.sock")
    ap.add_argument("--frames", required=True,
                    help="directory of PNGs or raw RGBA dumps at the server's geometry")
    ap.add_argument("--out", default=None)
    ap.add_argument("--loops", type=int, default=1,
                    help="replay the frame list this many times")
    ap.add_argument("--shutdown", action="store_true",
                    help="stop the server after the replay")
    args = ap.parse_args(argv)

    paths = sorted(
        glob.glob(os.path.join(args.frames, "*.png"))
        + glob.glob(os.path.join(args.frames, "*.raw"))
    )
    if not paths:
        print(f"no frames under {args.frames}", file=sys.stderr)
        return 1

    client = SidecarClient(args.socket)
    frames = [load_frame(p, client.h, client.w) for p in paths]
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    print(f"replaying {len(frames)} frames x{args.loops} "
          f"(depth {client.depth}, {client.w}x{client.h})", flush=True)

    outputs = {}
    lat_ms = []
    t_start = time.perf_counter()
    n_submitted = 0
    # responses arrive in submit order (delayed by `depth`); with --loops > 1
    # a name repeats, so pair responses with names positionally, not by a
    # len(outputs) counter (later loops overwrite the same key)
    submitted = []
    for loop in range(args.loops):
        for name, frame in zip(names, frames):
            t0 = time.perf_counter()
            out = client.submit(frame)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
            n_submitted += 1
            submitted.append(name)
            if out is not None:
                outputs[submitted.pop(0)] = out
    for out in client.drain():
        outputs[submitted.pop(0)] = out
    wall = time.perf_counter() - t_start

    n = n_submitted
    stats = {
        "frames": n,
        "fps_end_to_end": round(n / wall, 2),
        "ms_per_frame_wall": round(wall / n * 1e3, 3),
        "submit_ms_p50": round(float(np.percentile(lat_ms, 50)), 3),
        "submit_ms_p95": round(float(np.percentile(lat_ms, 95)), 3),
        "depth": client.depth,
    }
    print(json.dumps(stats), flush=True)

    if args.out:
        from PIL import Image

        os.makedirs(args.out, exist_ok=True)
        for name, arr in outputs.items():
            Image.fromarray(arr, mode="RGBA").save(
                os.path.join(args.out, f"{name}.png")
            )
        print(f"saved {len(outputs)} enhanced frames -> {args.out}")

    if args.shutdown:
        client.shutdown_server()
    client.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
