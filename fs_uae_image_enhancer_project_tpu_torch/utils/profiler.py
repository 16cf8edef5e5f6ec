"""The FPS/latency harness of the port, and its spans.

Counterpart of ``fs_uae_image_enhancer_project_tpu/utils/profiler.py``, with
the same :class:`BenchResult`:

- :func:`measure_chained`: sustained throughput of ``fn`` whose output feeds
  its next call. On a card, each chunk of calls is closed by a pair of CUDA
  events and a ``synchronize`` of the end event: the events time the device
  from the chunk's first launch to its last kernel's end, and total wall time
  over all calls gives ms per call. The JAX package closed chunks with a
  probe fetch because its remote TPU's ``block_until_ready`` returned early;
  a local card needs no such workaround.
- :func:`device_times`: the device's time per call of a short kernel, with
  the calls enqueued behind a sleep kernel so that the host's launch cost
  is not counted (card only).
- :func:`trace`: a ``torch.profiler`` context that records CUDA activity
  when CUPTI is there.
- :func:`span`: the program's own marks at its layer boundaries, on the
  profiler's clock while a profiler records, and next to free otherwise
  (:data:`SPANS` lists them).

A CPU tensor is timed with ``time.perf_counter`` alone (no events), so the
tests run on the CPU; those numbers are CPU times, never device times.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, *, cuda: Optional[bool] = None):
    """``torch.profiler`` over the block. Records CPU activity, and CUDA
    activity when ``cuda`` (default: a card is available). Yields the
    profiler: ``prof.key_averages()`` gives time by kernel; with ``log_dir``
    the Chrome trace is written to ``log_dir/trace.json`` at the end."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield prof
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


SPANS = (
    "fse.upload",  # batch upload and readback: a host batch onto the card
    "fse.enhance",  # enhance step: the whole enhance call
    "fse.enhance.prologue",  # enhance prologue/epilogue: check, crop, /255, pow, bf16
    "fse.enhance.model",  # enhance step: the model's launches (K1, or cuDNN and ATen)
    "fse.enhance.epilogue",  # enhance prologue/epilogue: clamp, pow, x255, uint8, alpha
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A mark named ``name`` (one of :data:`SPANS`) over a ``with`` block: a
    ``torch.profiler.record_function`` while a profiler records in this
    process, so that it lands in the profiler's trace on the same clock as
    the device's work, and one shared no-op context otherwise. The check is
    the guard: a ``record_function`` dispatches two ops even when no
    profiler runs, which a frame path that opens a few spans a call would
    pay on every call."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@dataclasses.dataclass
class BenchResult:
    fps: float
    ms_per_call: float
    iterations: int
    duration_s: float
    compile_s: float
    # per-chunk latency percentiles (chunked-chain timing)
    p50_ms: float = 0.0
    p90_ms: float = 0.0
    p99_ms: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _on_cuda(x) -> bool:
    return any(t.is_cuda for t in _tensors(x))


def _sync(x) -> None:
    if _on_cuda(x):
        torch.cuda.synchronize()


class _Chunk:
    """Times one chunk of calls: CUDA events on a card (device time from the
    chunk's first launch to its last kernel's end), ``perf_counter`` on the
    CPU. ``ms()`` waits for the end and returns the chunk's milliseconds."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        if cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter()

    def ms(self) -> float:
        if self.cuda:
            self.end.record()
            self.end.synchronize()
            return self.start.elapsed_time(self.end)
        return (time.perf_counter() - self.t0) * 1e3


def device_times(fn: Callable, n: int = 50, reps: int = 3, preroll_ms: float = 30.0) -> dict:
    """Device time per call of ``fn`` (card only), with ``n`` calls back to
    back, ``reps`` times: the median, min and max of the repeats' means. A
    sleep kernel holds the stream while the host enqueues the calls, so the
    events time the device and not the Python that launches it (a short
    kernel takes less time than its wrapper). ``host_behind`` says that the
    host took longer to enqueue than the sleep lasted, so gaps may be
    counted."""
    fn()
    torch.cuda.synchronize()
    cycles = int(preroll_ms * 2e6)  # at most 2 GHz: the sleep lasts at least preroll_ms
    per, behind = [], False
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        h0 = time.perf_counter()
        s.record()
        for _ in range(n):
            fn()
        e.record()
        behind |= (time.perf_counter() - h0) * 1e3 > preroll_ms
        e.synchronize()
        per.append(s.elapsed_time(e) / n)
    return {"ms": float(np.median(per)), "min_ms": min(per), "max_ms": max(per),
            "reps_ms": per, "host_behind": behind}


def measure_chained(
    fn: Callable,
    x,
    *,
    warmup: int = 20,
    duration_s: float = 20.0,
    chunk=20,
    max_iters: Optional[int] = None,
) -> BenchResult:
    """Sustained throughput of ``fn`` whose output feeds its input (same
    shape and dtype): total time over all calls is the per-call latency, and
    each chunk's time over its calls gives the percentiles. ``chunk="auto"``
    sizes chunks from two probe chunks (5 and 25 calls, differenced so that
    the fixed cost of closing a chunk cancels) to about 0.2 s each."""
    cuda = _on_cuda(x)
    t0 = time.perf_counter()
    acc = fn(x)
    _sync(acc)
    compile_s = time.perf_counter() - t0

    for _ in range(max(warmup - 1, 0)):
        acc = fn(acc)
    _sync(acc)

    if chunk == "auto":
        probe = []
        for n in (5, 25):
            c = _Chunk(cuda)
            for _ in range(n):
                acc = fn(acc)
            probe.append(c.ms())
        est_ms = max((probe[1] - probe[0]) / 20.0, 1e-6)
        chunk = int(min(max(round(200.0 / est_ms), 10), 5000))

    lat = []
    iters = 0
    start = time.perf_counter()
    deadline = start + duration_s
    while True:
        c = _Chunk(cuda)
        for _ in range(chunk):
            acc = fn(acc)
        lat.append(c.ms() / chunk)
        iters += chunk
        if time.perf_counter() >= deadline or (max_iters is not None and iters >= max_iters):
            break
    total = time.perf_counter() - start
    lat_ms = np.array(lat)
    return BenchResult(
        fps=iters / total,
        ms_per_call=total / iters * 1e3,
        iterations=iters,
        duration_s=total,
        compile_s=compile_s,
        p50_ms=float(np.percentile(lat_ms, 50)),
        p90_ms=float(np.percentile(lat_ms, 90)),
        p99_ms=float(np.percentile(lat_ms, 99)),
    )
