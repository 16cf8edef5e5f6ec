"""K4's plain version against a jax.numpy chain, the bench's cases against
the JAX script's, the kernel's tiling, and its wrapper's rules.

The Pallas kernel (scripts/bench_lane_packing.py::_mm_kernel) reads its
accumulator scratch before writing it, which in interpret mode is NaN; on
the TPU a finite start weighs 2^-(8 grid) at the end. So the reference here
is the same chain in jax.numpy from a zero accumulator (``dot_general`` on
bf16 with an fp32 result), which is what the port computes. Limits: the
accumulator within 1e-5 of its largest value (the two products sum in
another order), ``o`` within 1e-6 abs (the same fp32 operations).
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.utils import profiler as jax_profiler
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import lane_packing as k4
from fs_uae_image_enhancer_project_tpu_torch.scripts import bench_lane_packing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_lane_packing", os.path.join(REPO, "scripts", "bench_lane_packing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_chain(a, w, grid, reps=k4.REPS):
    a, w = jnp.asarray(a), jnp.asarray(w, jnp.bfloat16)
    acc = jnp.zeros((a.shape[0], w.shape[1]), jnp.float32)
    for _ in range(reps * grid):
        acc = jax.lax.dot_general(a.astype(jnp.bfloat16), w, (((1,), (0,)), ((), ())),
                                  preferred_element_type=jnp.float32) * 1e-4 + acc * 0.5
    s = jnp.sum(acc, axis=1, keepdims=True)
    return np.asarray(a * 0.999 + 1e-7 * s), np.asarray(acc)


def _data(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = np.asarray(jnp.asarray(rng.normal(0, 0.05, (k, n)).astype(np.float32), jnp.bfloat16))
    return a, w


@pytest.mark.parametrize("grid", [1, 3])
@pytest.mark.parametrize("m,k,n", [(48, 36, 12), (24, 72, 40), (33, 50, 9)])
def test_plain_matches_the_jax_chain_from_zero(m, k, n, grid):
    a, w = _data(m, k, n, seed=m + grid)
    want_o, want_acc = _jax_chain(a, w, grid)
    o, acc = k4.lane_packing_mm(torch.from_numpy(a),
                                torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16), grid)
    assert o.shape == (m, k) and acc.shape == (m, n)
    scale = np.abs(want_acc).max()
    assert np.abs(acc.numpy() - want_acc).max() <= 1e-5 * scale
    assert np.abs(o.numpy() - want_o).max() <= 1e-6


def test_the_twelve_cases_are_the_jax_scripts(monkeypatch):
    """Run the JAX script's main with its timing replaced by a recorder: the
    (m, k, n) it would time, in order, are the port's CASES."""
    mod = _jax_script()
    assert (mod.M_FULL, mod.REPS) == (k4.M_FULL, k4.REPS)
    seen = []

    def record(fn, a, **kw):
        seen.append((a.shape[0], a.shape[1], fn.__defaults__[0].shape[1]))
        return jax_profiler.BenchResult(1.0, 1.0, 1, 1.0, 0.0)

    monkeypatch.setattr(jax_profiler, "measure_chained", record)
    monkeypatch.setattr("fs_uae_image_enhancer_project_tpu.utils.platform."
                        "honor_jax_platforms_env", lambda: None)
    monkeypatch.setattr("fs_uae_image_enhancer_project_tpu.utils.compile_cache."
                        "enable_persistent_cache", lambda *a, **k: None)
    assert mod.main() == 0
    assert seen == [(m, k, n) for _l, _v, m, k, n in k4.CASES]
    assert len(k4.CASES) == 12


@pytest.mark.parametrize("case", k4.CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_tile_plan_fills_the_card_and_fits(case):
    _l, _v, m, k, n = case
    plan = k4.tile_plan(m, k, n)
    assert plan.ctas >= k4.SMS, "every variant has at least one CTA per SM"
    assert plan.smem <= k4.SMEM_LIMIT and 1 <= plan.ntw <= 9
    assert plan.ncol * plan.ntw * 8 >= n and plan.kp % 16 == 0 and plan.kp >= k
    assert (plan.ncol - 1) * plan.ntw * 8 < n  # no column slice is all padding


def test_prepared_weight_is_the_padded_b_fragment_matrix():
    """The kernel's W: B fragments [kstep][ntile][lane][4] of w, zero-padded
    to kp rows and ncol * ntw * 8 columns."""
    _, w = _data(8, 40, 20)
    wt = torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    plan = k4.TilePlan(kp=48, ntw=2, ncol=2, ctas=0, smem=0)
    f = k4.prepare_weight(wt, plan)
    g = f.float().reshape(3, 4, 8, 4, 2, 2)  # kstep, ntile, col g, t, khalf, pair
    got = g.permute(0, 4, 3, 5, 1, 2).reshape(48, 32)
    want = torch.zeros(48, 32)
    want[:40, :20] = wt.float()
    assert torch.equal(got, want)


def test_wrapper_checks_its_input():
    a = torch.zeros(8, 16)
    w = torch.zeros(16, 8, dtype=torch.bfloat16)
    for bad_a, bad_w in [(a.double(), w), (a, w.float()), (a[:, ::2], w[::2]), (a, w[:8]),
                         (a[None], w)]:
        with pytest.raises(ValueError):
            k4.lane_packing_mm(bad_a, bad_w, 1)
    with pytest.raises(ValueError):
        k4.lane_packing_mm(a, w, 0)
    with pytest.raises(ValueError):  # neither cpu nor cuda
        k4.lane_packing_mm(a.to("meta"), w.to("meta"), 1)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    a, w = _data(16, 24, 8)
    at, wt = torch.from_numpy(a), torch.from_numpy(w.astype(np.float32)).to(torch.bfloat16)
    before = k4.lane_packing_mm.launches
    o, acc = k4.lane_packing_mm(at, wt, 2)
    assert k4.lane_packing_mm.launches == before
    po, pacc = k4.lane_packing_mm_plain(at, wt, 2)
    assert torch.equal(o, po) and torch.equal(acc, pacc)


def test_bench_main_on_the_cpu_prints_a_line_a_case(capsys):
    cases = [("l2/l6-class", "baseline", 32, 36, 4), ("l2/l6-class", "packed-2", 16, 48, 8)]
    out = bench_lane_packing.main(duration_s=0.01, warmup=1, chunk=2, grid=1, device="cpu",
                                  cases=cases)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"m_full={k4.M_FULL} reps={k4.REPS} grid=1; useful MACs equal per class"
    assert lines[1].startswith("l2/l6-class baseline  (   32,  36)x(  36,  4):")
    assert lines[2].startswith("l2/l6-class packed-2  (   16,  48)x(  48,  8):")
    assert all(line.endswith("TFLOPS(raw)") for line in lines[1:])
    assert [r["variant"] for r in out] == ["baseline", "packed-2"]
    assert all(r["iterations"] >= 2 and r["tflops_raw"] > 0 for r in out)
