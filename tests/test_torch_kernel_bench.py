"""The port's kernel benches and chip_smoke.py's phases for them, rehearsed
on the CPU at small sizes (the kernels' plain versions; CPU times, never
device times). On a card chip_smoke.py runs the same functions at the
benches' shapes."""
import os
import statistics
import time

import pytest
import torch

import chip_smoke as cs
from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import import_pix_shuffle
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2
from fs_uae_image_enhancer_project_tpu_torch.scripts import bench_fused_stack

CPU = torch.device("cpu")
SMALL = [("l2/l6-class", "baseline", 96, 324, 36), ("l4-class", "packed-3", 32, 1296, 216)]


def test_bench_fused_stack_prints_errors_then_times(capsys, monkeypatch):
    monkeypatch.delenv("BENCH_FUSED_ONLY", raising=False)
    out = bench_fused_stack.main(duration_s=0.01, warmup=1, chunk=2, device="cpu",
                                 shape=(1, 16, 24, 3))
    lines = capsys.readouterr().out.splitlines()
    names = ["eager bf16", "cuda fused", "cuda packed-2"]
    assert [r["name"] for r in out] == names
    assert [line.split(" vs fp32:")[0] for line in lines[:3]] == names
    assert all(" max err " in line and " mean " in line for line in lines[:3])
    assert [line.split(":")[0] for line in lines[3:]] == names
    assert all(" ms (" in line and "fps, p50" in line for line in lines[3:])
    # the kernels' plain versions are within their bf16 limit of the fp32 forward
    assert all(r["max_err"] <= 6e-3 for r in out[1:])


def test_bench_fused_stack_only_filter(capsys, monkeypatch):
    monkeypatch.setenv("BENCH_FUSED_ONLY", "packed")
    out = bench_fused_stack.main(duration_s=0.01, warmup=1, chunk=2, device="cpu",
                                 shape=(1, 8, 8, 3))
    assert [r["name"] for r in out] == ["cuda packed-2"]
    assert len(capsys.readouterr().out.splitlines()) == 2


@pytest.fixture(scope="module")
def weights():
    params = params_from_jax(import_pix_shuffle(cs.ONNX).params, device="cpu")
    return fs.prepare_weights(params, CPU), k2.prepare_weights(params, CPU)


def test_stack_parity_phases_on_the_cpu(weights):
    sw, sw2 = weights
    recs = cs.stack_parity(CPU, k2.fused_stack_packed, k2.fused_stack_packed_plain, sw2,
                           other=(fs.fused_stack, sw))
    cs.check_stack("K2", recs)
    assert [r["shape"] for r in recs] == [[288, 376], [288, 368], [290, 375], [3, 40, 58]]
    assert recs[0]["max_abs"] <= 2e-3  # the plain version, then its bf16 output cast
    assert recs[0]["max_abs_vs_other"] <= 2e-3  # K2's plain version against K1's
    bad = [dict(recs[0], max_abs=1.0), recs[-1]]
    with pytest.raises(AssertionError):
        cs.check_stack("K2", bad)


def test_k4_parity_and_timing_phases_on_the_cpu(monkeypatch):
    recs = cs.k4_parity(CPU, cases=SMALL)
    cs.check_k4(recs)
    assert [r["shape"] for r in recs] == [list(c[2:]) for c in SMALL]
    with pytest.raises(AssertionError):
        cs.check_k4([dict(recs[0], acc_rel=2e-3)])

    def median_ms(fn, n=50, warmup=10):  # CUDA events need a card
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def device_ms(fn, n=50, reps=3, preroll_ms=30.0):  # a sleep kernel needs a card
        return {"ms": median_ms(fn), "host_behind": False}

    monkeypatch.setattr(cs, "median_ms", median_ms)
    monkeypatch.setattr(cs, "device_ms", device_ms)
    rows = cs.k4_timing(CPU, grid=1, cases=SMALL)
    assert [r["bound_by"] for r in rows] == ["bytes", "bytes"]  # tiny m: the bytes bind
    assert all(r["acc_max_abs"] == 0.0 and r["ctas"] >= 1 for r in rows)
    assert [r["n_per_instruction"] for r in rows] == [40, 216]
    assert [r["ring"] for r in rows] == ["resident", "streamed"]
    # cuBLAS's time for the 8 products a grid step: one matmul's, times 8
    assert all(r["library_ms"] > 0 and r["chain_ms"] > 0 for r in rows)
    o, acc = cs.library_lane_chain(*cs.k4_inputs(__import__("numpy").random.default_rng(0),
                                                 8, 16, 8, CPU), 1)
    assert o.shape == (8, 16) and acc.shape == (8, 8)


def test_kernel_bench_phase_counts_no_launch_on_the_cpu():
    kb = cs.kernel_bench(CPU, duration_s=0.01, fused_shape=(1, 8, 16, 3), lane_cases=SMALL[:1],
                         grid=1)
    assert kb["launches"] == {"fused_stack": 0, "fused_stack_packed": 0, "lane_packing_mm": 0,
                              "palette_dither": 0}
    assert [r["name"] for r in kb["fused"]] == ["eager bf16", "cuda fused", "cuda packed-2"]
    assert [r["variant"] for r in kb["lane"]] == ["baseline"]


def test_chip_smoke_names_its_sources():
    repo = os.path.dirname(os.path.abspath(cs.__file__))
    for src in (cs.K1_SOURCE, cs.K2_SOURCE, cs.K3_SOURCE, cs.K4_SOURCE):
        assert os.path.exists(os.path.join(repo, src)), src
    for rep in (cs.K1_REPLACES, cs.K2_REPLACES, cs.K3_REPLACES, cs.K4_REPLACES):
        path, line = rep.rsplit(":", 1)
        with open(os.path.join(repo, path)) as f:
            assert f.read().splitlines()[int(line) - 1].startswith("def _"), rep
