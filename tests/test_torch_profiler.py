"""The port's timing harness on the CPU (methodology, not absolute numbers):
the counterparts of tests/test_profiler.py, plus ``chunk="auto"``,
``max_iters``, the chain feeding each output forward, and the trace context.
A CPU tensor is timed with ``perf_counter`` alone; the CUDA-event path runs
only on a card (chip_smoke.py's kernel_bench phase drives it)."""
import numpy as np
import torch

from fs_uae_image_enhancer_project_tpu.utils.profiler import BenchResult as JaxBenchResult
from fs_uae_image_enhancer_project_tpu_torch.utils.profiler import (
    BenchResult,
    measure_chained,
    measure_roundtrip,
    trace,
)


def test_bench_result_has_the_jax_fields():
    import dataclasses

    assert [f.name for f in dataclasses.fields(BenchResult)] == [
        f.name for f in dataclasses.fields(JaxBenchResult)]


def test_measure_chained_counts_and_percentiles():
    x = torch.ones(64, 64)
    res = measure_chained(lambda t: t * 1.0001, x, warmup=2, duration_s=60.0, chunk=5,
                          max_iters=20)
    assert res.iterations == 20
    assert res.fps > 0 and res.ms_per_call > 0
    assert res.p50_ms <= res.p99_ms
    assert res.compile_s >= 0


def test_measure_roundtrip_counts():
    x = torch.ones(8, 8)
    res = measure_roundtrip(lambda t: t + 1, x, warmup=1, duration_s=60.0, max_iters=7)
    assert res.iterations == 7
    assert np.isfinite(res.p90_ms)


def test_measure_chained_feeds_each_output_forward():
    calls = []

    def fn(t):
        calls.append(float(t[0]))
        return t + 1

    res = measure_chained(fn, torch.zeros(1), warmup=3, duration_s=60.0, chunk=4, max_iters=8)
    assert res.iterations == 8
    # the first call, 2 more warm-ups, then 2 chunks of 4: one chain, never reset
    assert calls == [float(i) for i in range(11)]


def test_measure_chained_auto_chunk_and_max_iters():
    res = measure_chained(lambda t: t * 0.5 + 1, torch.ones(16), warmup=1, duration_s=60.0,
                          chunk="auto", max_iters=30)
    # auto chunks are at least 10 calls; the run stops at the first chunk
    # boundary at or past max_iters
    assert 30 <= res.iterations <= 5000
    assert res.p50_ms > 0


def test_measure_chained_stops_at_the_deadline():
    res = measure_chained(lambda t: t + 1, torch.zeros(4), warmup=1, duration_s=0.0, chunk=3)
    assert res.iterations == 3  # one chunk, then the deadline has passed
    assert res.duration_s >= 0


def test_trace_records_cpu_activity(tmp_path):
    with trace(str(tmp_path), cuda=False) as prof:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert any("mm" in e.key for e in prof.key_averages())
    assert (tmp_path / "trace.json").exists()
