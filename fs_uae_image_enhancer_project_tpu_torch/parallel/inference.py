"""Sharded batch inference: offline enhancement at fleet scale.

Port of ``fs_uae_image_enhancer_project_tpu/parallel/inference.py``.
Real-time emulation is single-card/batch-1, but the same enhance function
serves offline workloads (re-rendering recordings, dataset-scale
enhancement). Here the frame batch is split over the mesh's dp ranks and each
rank enhances its share on its own device with its own copy of the weights:
no collective in the forward pass. On the 1x1 mesh (one process, no process
group) this is batched enhancement on one card: one enhance call, one launch
of the fused-stack kernel K1 for the pix_shuffle graph, a batch.
"""
from __future__ import annotations

import glob
import os
from typing import Callable, Optional

import numpy as np

from .mesh import Mesh, make_mesh, shard_batch


def make_sharded_enhance(
    enhance_fn: Callable,
    mesh: Optional[Mesh] = None,
):
    """Wrap an enhance function for dp-sharded batches.

    Returns ``(sharded_fn, shard_batch)``: ``shard_batch(frames)`` puts this
    rank's share of a host batch (its dp block of the batch axis) on its
    device, and ``sharded_fn`` enhances it there (a uint8 tensor). The
    batch must divide by dp."""
    if mesh is None:
        mesh = make_mesh(sp=1)
    return enhance_fn, lambda frames: shard_batch(mesh, frames, split_height=False)


def enhance_directory(
    enhance_fn: Callable,
    input_dir: str,
    output_dir: str,
    *,
    batch_size: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    verbose: int = 1,
) -> int:
    """Enhance every PNG in a directory with dp-sharded batches.

    The last chunk is padded by repeating its last frame; each rank writes
    the files of its own frames (never a padding frame; under sp the first
    rank of each dp row). Returns the number
    of frames written by all ranks; rank 0 reports it."""
    from PIL import Image

    if mesh is None:
        mesh = make_mesh(sp=1)
    dp = mesh.dp
    if batch_size is None:
        batch_size = dp
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} must be divisible by dp={dp}")
    share = batch_size // dp
    sharded, put = make_sharded_enhance(enhance_fn, mesh)
    os.makedirs(output_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(input_dir, "*.png")))
    done = 0
    for i in range(0, len(paths), batch_size):
        chunk = paths[i : i + batch_size]
        frames = np.stack(
            [np.asarray(Image.open(p).convert("RGBA"), np.uint8) for p in chunk]
        )
        pad = (-len(chunk)) % batch_size
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
        out = sharded(put(frames)).cpu().numpy()
        # the sp ranks of a dp row hold the same share: its first one writes
        mine = chunk[mesh.dp_index * share:(mesh.dp_index + 1) * share] \
            if mesh.sp_index == 0 else []
        for p, frame in zip(mine, out):
            Image.fromarray(frame, mode="RGBA").save(
                os.path.join(output_dir, os.path.basename(p))
            )
        done += len(chunk)
    if verbose and mesh.rank == 0:
        print(f"enhanced {done} frames -> {output_dir} (dp={dp})")
    return done
