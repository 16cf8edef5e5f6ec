"""Device mesh and sharding helpers on torch process groups.

Port of ``fs_uae_image_enhancer_project_tpu/parallel/mesh.py``. The JAX
package lays a ('dp', 'sp') mesh over devices and lets XLA insert the
collectives; here the mesh is a grid of process ranks, one process a device,
and the collectives are explicit:

- ``dp``: batch data parallelism; the train step all-reduces the gradients
  and, for BatchNorm models, the batch statistics (``parallel/train_step.py``,
  ``ops.conv.batchnorm_train``).
- ``sp``: spatial parallelism over image height; each sp rank runs the model
  on its row slab plus a halo (``parallel/spatial.py``), the stand-in for the
  halo exchanges XLA inserts.

Rank ``r`` sits at ``(r // sp, r % sp)``, where
``np.array(devices).reshape(dp, sp)`` puts JAX's r-th device. One process
with no process group is the 1x1 mesh, the single-card case, and needs no
``init_process_group``. Several processes join a process group first
(:func:`init_process_group`): ``nccl`` for cards, ``gloo`` for the CPU, chosen
by the device the caller passes; :func:`make_mesh` refuses a group whose
backend is not the device's. :func:`spawn_ranks` runs a function in that many
processes on one host.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..utils.profiler import span


def backend_for(device) -> str:
    """The process group backend for a device: ``nccl`` on a card, ``gloo``
    on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(rank: int, world_size: int, *, device, init_method: str,
                       timeout_s: float = 300.0) -> None:
    """Join the default process group with the device's backend
    (:func:`backend_for`); ``init_method`` is an address such as
    ``tcp://localhost:<port>`` or ``file://<path>``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend_for(dev), init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (dp, sp) grid of process ranks and this rank's place in it.

    ``devices`` is the grid of ranks (JAX's ``mesh.devices`` holds devices);
    ``dp_group`` holds the ranks of this rank's sp column (the ranks it
    shares gradients and batch statistics with when sp is 1),
    ``sp_group`` those of its dp row (the slabs of one frame). A group is
    None where its axis is 1 or there is no process group; ``world_group``
    is the whole process group wherever there is one, a 1x1 mesh's too, so
    that a world of one rank runs the same collectives as a larger one."""

    devices: np.ndarray
    rank: int
    device: torch.device
    dp_group: Any = None
    sp_group: Any = None
    world_group: Any = None
    axis_names = ("dp", "sp")

    @property
    def dp(self) -> int:
        return self.devices.shape[0]

    @property
    def sp(self) -> int:
        return self.devices.shape[1]

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    @property
    def size(self) -> int:
        return self.dp * self.sp


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    dp: Optional[int] = None,
    sp: int = 1,
    device=None,
) -> Mesh:
    """Build a ('dp', 'sp') mesh over the process group's ranks.

    Defaults: every rank on the dp axis. ``sp`` must divide n_devices. The
    available count is the process group's world size, or 1 without one; the
    mesh spans all of it. ``device`` is this rank's device (default ``cuda``,
    the rank's own card when no index is given).
    """
    avail = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices if n_devices is not None else avail
    if n > avail:
        # fail with the actual device arithmetic, not an opaque group error
        raise ValueError(
            f"asked for {n} devices but only {avail} are available"
        )
    if n < avail:
        raise ValueError(
            f"asked for {n} devices, but the process group has {avail} ranks: "
            "the mesh spans the whole group")
    if dp is None:
        if n % sp:
            raise ValueError(f"sp={sp} must divide device count {n}")
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp = {dp * sp} != {n} devices")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    grid = np.arange(n).reshape(dp, sp)
    if not dist.is_initialized():
        return Mesh(grid, rank, dev)
    if dist.get_backend() != backend_for(dev):
        raise ValueError(
            f"the process group's backend is {dist.get_backend()}, but a {dev.type} "
            f"mesh needs {backend_for(dev)}")
    # every rank creates every group, in the same order (new_group's rule)
    dp_groups = [dist.new_group(grid[:, s].tolist()) for s in range(sp)]
    sp_groups = [dist.new_group(grid[d, :].tolist()) for d in range(dp)]
    return Mesh(grid, rank, dev,
                dp_group=dp_groups[rank % sp] if dp > 1 else None,
                sp_group=sp_groups[rank // sp] if sp > 1 else None,
                world_group=dist.group.WORLD)


def _block(x, mesh: Mesh, batch_axis: int, height_axis: Optional[int]):
    """This rank's block of ``x``: the batch axis over dp, height over sp
    (whole where ``height_axis`` is None)."""
    n = x.shape[batch_axis]
    if n % mesh.dp:
        raise ValueError(f"batch {n} must be divisible by dp={mesh.dp}")
    b = n // mesh.dp
    index = [slice(None)] * x.ndim
    index[batch_axis] = slice(mesh.dp_index * b, (mesh.dp_index + 1) * b)
    if height_axis is not None:
        h = x.shape[height_axis]
        if h % mesh.sp:
            raise ValueError(f"height {h} must be divisible by sp={mesh.sp}")
        r = h // mesh.sp
        index[height_axis] = slice(mesh.sp_index * r, (mesh.sp_index + 1) * r)
    return x[tuple(index)]


def batch_sharding(mesh: Mesh) -> Callable:
    """NHWC batches: batch over dp, height over sp. Returns ``take(x)``, this
    rank's block of a host batch."""
    return lambda x: _block(x, mesh, 0, 1)


def accum_batch_sharding(mesh: Mesh) -> Callable:
    """(micro, batch, H, W, C) accumulation batches: micro axis whole (the
    step loops over it), batch over dp, height over sp. Returns ``take(x)``,
    this rank's block of a host batch."""
    return lambda x: _block(x, mesh, 1, 2)


def replicated(mesh: Mesh) -> Callable:
    """Returns ``put(x)``: the whole of ``x`` on this rank's device."""
    return lambda x: torch.as_tensor(x).to(mesh.device)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, batch, *, split_height: bool = True):
    """Put this rank's block of each NHWC array of a nested dict (or one
    array) on its device: the batch over dp, and the height over sp unless
    ``split_height`` is False (then every sp rank holds its dp share whole)."""
    height_axis = 1 if split_height else None
    with span("fse.upload"):
        return _tree_map(
            lambda x: _block(torch.as_tensor(x), mesh, 0, height_axis).to(mesh.device), batch)


def replicate(mesh: Mesh, tree):
    """Every tensor of a nested dict on this rank's device, with rank 0's
    values on every rank (a broadcast over the mesh)."""
    put = replicated(mesh)

    def bcast(x):
        t = put(x).clone()
        if mesh.world_group is not None:
            dist.broadcast(t, src=0)
        return t

    return _tree_map(bcast, tree)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group``; nothing to do without one."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def _rank_main(rank, call_path, n, init_method, device, results) -> None:
    with open(call_path, "rb") as f:
        fn, args = pickle.load(f)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init_process_group(rank, n, device=device, init_method=init_method)
    try:
        out = fn(*args)
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def spawn_ranks(fn: Callable, n: int, args: Sequence = (), *, device=None,
                timeout: float = 300.0) -> list:
    """Run ``fn(*args)`` in ``n`` spawned processes, rank 0 to n-1, each in
    one process group (:func:`init_process_group` with the device's backend,
    a rendezvous file in a fresh temporary directory) and return the ranks'
    results in rank order. ``fn`` and its results must pickle. ``device``
    defaults to ``cuda`` (nccl; raises without a card); pass ``"cpu"`` for
    gloo processes on the CPU.

    At the first rank that fails, ``torch.multiprocessing``'s
    ``ProcessContext.join`` stops the others and raises with that rank's
    traceback; past ``timeout`` seconds every child still alive is killed
    and the call raises ``TimeoutError``."""
    import torch.multiprocessing as mp

    device = resolve_device(device)
    results = mp.get_context("spawn").Queue()
    tmp = tempfile.mkdtemp(prefix="fse_ranks_")
    # the call goes through a file, not the children's start-up pipes: a
    # start() whose pickle outgrows the pipe waits for that child's imports
    call_path = os.path.join(tmp, "call.pkl")
    with open(call_path, "wb") as f:
        pickle.dump((fn, tuple(args)), f)
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    got, ranks = {}, None

    def drain(wait: float) -> None:
        # a child exits only once its result has left through the queue
        try:
            while len(got) < n:
                rank, out = results.get(timeout=wait)
                got[rank] = out
        except queue.Empty:
            pass

    try:
        ranks = mp.start_processes(_rank_main, args=(call_path, n, init_method, str(device),
                                                     results),
                                   nprocs=n, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        while not ranks.join(timeout=0.5):
            drain(0.05)
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n - len(got)} of {n} ranks did not finish in {timeout} s")
        drain(5.0)
    finally:
        for p in ranks.processes if ranks is not None else ():
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    if len(got) < n:
        raise RuntimeError(f"ranks {sorted(set(range(n)) - set(got))} exited without a result")
    return [got[r] for r in range(n)]
