"""Multi-process dry run: one FULL training step AND one sharded-serving
batch on an n-rank (dp, sp) mesh, on tiny shapes, on the CPU.

Port of ``fs_uae_image_enhancer_project_tpu/parallel/dryrun.py``. The JAX
package runs it on n virtual CPU devices; the port runs it in n processes in
one ``gloo`` process group (``parallel.mesh.spawn_ranks``). It asks for the
CPU explicitly: that is the dry run's contract, as JAX's virtual CPU devices
are, and not a fallback. One card cannot hold an ``nccl`` group of more than
one rank.

    python -m fs_uae_image_enhancer_project_tpu_torch.parallel.dryrun 4
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..export.enhance import make_enhance_fn
from ..losses.perceptual import build_criterion
from ..models import get_model, train_apply
from .inference import make_sharded_enhance
from .mesh import accum_batch_sharding, make_mesh, replicate, spawn_ranks
from .train_step import init_train_state, make_optimizer, make_train_step


def dryrun_rank(
    n_devices: int,
    *,
    micro: int = 2,
    per_micro: int = None,
    height: int = 48,
    width: int = 64,
    verbose: bool = False,
) -> float:
    """What each of the ``n_devices`` ranks of a gloo process group runs: one
    real pix_shuffle training step (perceptual loss incl. the VGG branch,
    gradient accumulation, Adam update) sharded dp x sp, then a dp-sharded
    uint8 enhance batch. Returns the loss (the global mean, on every rank)."""
    sp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, sp=sp, device="cpu")
    dp = n_devices // sp
    if per_micro is None:
        per_micro = dp  # one sample per dp shard

    m = get_model("pix_shuffle", "lightweight")
    params = replicate(mesh, m.init(torch.Generator().manual_seed(0), device="cpu"))
    criterion = build_criterion(m.loss, device="cpu")
    state = init_train_state(params, make_optimizer(lr=1e-3, steps_per_epoch=10))
    train_step = make_train_step(train_apply(m), criterion, mesh=mesh)

    rng = np.random.default_rng(0)
    lr_b = rng.uniform(0, 1, (micro, per_micro, height, width, 3)).astype(np.float32)
    hr_b = rng.uniform(0, 1, (micro, per_micro, height, width, 3)).astype(np.float32)
    # micro axis whole; per-micro batch over dp; height over sp
    take = accum_batch_sharding(mesh)
    new_state, loss = train_step(state, take(torch.from_numpy(lr_b)),
                                 take(torch.from_numpy(hr_b)))
    loss_val = float(loss)
    if verbose and mesh.rank == 0:
        print(f"dryrun train ok: mesh dp={dp} sp={sp}, loss={loss_val:.5f}, "
              f"step={new_state.step}")
    if not np.isfinite(loss_val):
        raise RuntimeError(f"dryrun produced non-finite loss: {loss_val}")

    # --- serving leg: dp-sharded batch inference over every rank ---------
    # the deployed uint8-RGBA enhance contract over the just-trained params
    enhance = make_enhance_fn(m.apply, new_state.params, crop_left=0, device="cpu")
    sharded, put = make_sharded_enhance(enhance, make_mesh(n_devices, sp=1, device="cpu"))
    frames = np.asarray(rng.integers(0, 256, (n_devices, 32, 48, 4)), np.uint8)
    out = sharded(put(frames))
    if tuple(out.shape) != (1, 32, 48, 4) or out.dtype != torch.uint8:
        raise RuntimeError(f"serving dryrun bad output: {tuple(out.shape)} {out.dtype}")
    if verbose and mesh.rank == 0:
        print(f"dryrun serve ok: dp={n_devices} sharded batch "
              f"{frames.shape} -> {n_devices} x {tuple(out.shape)} {out.dtype}")
    return loss_val


def run_dryrun(n_devices: int, *, timeout: float = 300.0, **kwargs) -> float:
    """Spawn ``n_devices`` CPU processes in one gloo group, run
    :func:`dryrun_rank` in each (``kwargs`` are its), and return rank 0's
    loss. Raises if a rank fails or the run outlasts ``timeout`` seconds."""
    return spawn_ranks(_dryrun, n_devices, (n_devices, kwargs), device="cpu",
                       timeout=timeout)[0]


def _dryrun(n_devices: int, kwargs: dict) -> float:
    return dryrun_rank(n_devices, **kwargs)


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    print(f"dryrun loss {run_dryrun(n, verbose=True):.6f} on {n} processes")
