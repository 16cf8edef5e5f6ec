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
import re

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


CASE_IDS = [f"{c[0]}-{c[1]}" for c in k4.CASES]


# the cases whose plan leaves SMs idle because fewer CTAs measured faster
# (NCOL): l2/l6 and l7 packed-2 at the whole N on 72 row tiles, and every
# packed-3 case split 2 ways on 48 row tiles rather than 3 ways on 144 CTAs
FEWER_CTAS_THAN_SMS = {("l2/l6-class", "packed-2"): 72, ("l7-class", "packed-2"): 72,
                       ("l2/l6-class", "packed-3"): 96, ("l4-class", "packed-3"): 96,
                       ("l7-class", "packed-3"): 96, ("l5-class", "packed-3"): 96}


@pytest.mark.parametrize("case", k4.CASES, ids=CASE_IDS)
def test_tile_plan_fills_the_card_and_fits(case):
    """One wgmma N a CTA, a multiple of 8 and at most 256, compiled in; the
    CTAs cover every row and column once; shared memory within a block's
    227 KB; at least one CTA an SM, but for the named cases where fewer
    measured faster."""
    label, variant, m, k, n = case
    plan = k4.tile_plan(m, k, n)
    assert plan.nc % 8 == 0 and 8 <= plan.nc <= 256 and plan.nc in k4.WIDTHS
    assert plan.smem <= k4.SMEM_LIMIT
    assert (plan.rows - 1) * k4.BM < m <= plan.rows * k4.BM
    assert (plan.ncol - 1) * plan.nc < n <= plan.ncol * plan.nc
    assert plan.ctas == plan.rows * plan.ncol
    if (label, variant) in FEWER_CTAS_THAN_SMS:
        assert plan.ctas == FEWER_CTAS_THAN_SMS[label, variant] < k4.SMS
    else:
        assert plan.ctas >= k4.SMS
    assert plan.kp >= k > plan.kp - 16
    assert 1 <= plan.kc <= plan.ks
    if plan.resident:  # all of W, once
        assert (plan.kc, plan.stages) == (plan.ks, 1)
    else:
        assert plan.stages * plan.kc < plan.ks and plan.kc >= k4.WIDTHS[plan.nc]
        # a larger ring would not fit
        assert k4._smem(plan.ks, plan.nc, plan.kc + 1, plan.stages) > k4.SMEM_LIMIT


def test_the_four_that_do_not_fit_stream():
    """W beside the A tile fits resident at the whole N in 8 cases; l4
    packed-2 and packed-3 and l5 packed-2 and packed-3 stream it."""
    whole = {(c[0], c[1]): k4.plan_for(*c[2:]) for c in k4.CASES}
    streamed = sorted(key for key, p in whole.items() if not p.resident)
    assert streamed == [("l4-class", "packed-2"), ("l4-class", "packed-3"),
                        ("l5-class", "packed-2"), ("l5-class", "packed-3")]
    assert [p.nc for p in whole.values()] == [40, 72, 112, 72, 144, 216, 16, 24, 40, 40, 72,
                                              112]


def _hardware_address(r, kk):
    """Where wgmma reads element (row r, k kk of the k-step) of a K-major
    block at a 256-byte aligned start, from the descriptor's fields: 8-row
    groups SBO apart, rows of 32 bytes, address bit 4 flipped by bit 7 (the
    32-byte swizzle)."""
    d = k4.descriptor(0)
    sbo, layout = ((d >> 32) & 0x3FFF) << 4, d >> 62
    assert layout == k4.LAYOUT_SW32 and sbo == 8 * 32
    addr = (r // 8) * sbo + (r % 8) * 32 + kk * 2
    return addr ^ (((addr >> 7) & 1) << 4)


@pytest.mark.parametrize("case", k4.CASES, ids=CASE_IDS)
def test_prepared_weight_is_the_padded_b_fragment_matrix(case):
    """The kernel's W image: each element of W, zero-padded to kp rows and
    ncol * nc columns, exactly once, at the address the descriptor's
    core-matrix layout and swizzle give within its k-step block
    ([column slice][k-step] blocks of nc rows x 32 bytes)."""
    _l, _v, m, k, n = case
    plan = k4.tile_plan(m, k, n)
    idx = torch.arange(1, k * n + 1, dtype=torch.int64).reshape(k, n)
    img = k4.prepare_weight(idx, plan).numpy()
    assert img.size == plan.kp * plan.ncol * plan.nc
    kk, nn = np.meshgrid(np.arange(plan.kp), np.arange(plan.ncol * plan.nc), indexing="ij")
    c, r, s = nn // plan.nc, nn % plan.nc, kk // 16
    block = (c * plan.ks + s) * plan.nc * 32
    addr = block + _hardware_address(r, kk % 16)
    assert addr.min() >= 0 and np.all(addr % 2 == 0)
    assert np.array_equal(np.sort(addr.ravel()), np.arange(0, 2 * img.size, 2))
    want = np.zeros((plan.kp, plan.ncol * plan.nc), np.int64)
    want[:k, :n] = idx.numpy()
    assert np.array_equal(img[addr // 2], want)
    # the kernel's own offset formula is the same map
    assert np.array_equal(addr - block, k4.row_offset(r, (kk % 16) // 8) + (kk % 8) * 2)


@pytest.mark.parametrize("case", k4.CASES, ids=CASE_IDS)
def test_ring_chunks_and_blocks_are_aligned(case):
    """The kernel's shared-memory map for the case's plan (offsets from the
    256-byte aligned base, mirrored from csrc/lane_packing.cu): every k-step
    block of A and of each ring stage starts on the swizzle's 256-byte
    period; a product's chunks cover W's k-steps once, each one bulk copy of
    a multiple of 16 bytes from a 16-byte aligned offset within the slice's
    image into its stage; the first chunk feeds every accumulator chain (so
    each chain starts the product from zero); the mbarriers are 8-byte
    aligned and end within the plan's shared memory."""
    _l, _v, m, k, n = case
    plan = k4.tile_plan(m, k, n)
    a_kstep = k4.BM * k4.ROW_BYTES
    w_kstep = plan.nc * k4.ROW_BYTES
    w_s = plan.ks * a_kstep
    stage_bytes = plan.kc * w_kstep
    ring = min(plan.stages * plan.kc, plan.ks)
    assert all((s * a_kstep) % 256 == 0 for s in range(plan.ks))
    assert all((w_s + st * stage_bytes + j * w_kstep) % 256 == 0
               for st in range(plan.stages) for j in range(plan.kc))
    nchunks = -(-plan.ks // plan.kc)
    covered = []
    for c in range(nchunks):
        s0 = c * plan.kc
        nbytes = min(plan.kc, plan.ks - s0) * w_kstep
        src = s0 * w_kstep
        assert nbytes % 16 == 0 and src % 16 == 0 and 0 < nbytes <= stage_bytes
        for col in range(plan.ncol):
            assert col * plan.ks * w_kstep + src + nbytes <= plan.ncol * plan.ks * w_kstep
        covered += range(s0, s0 + nbytes // w_kstep)
    assert covered == list(range(plan.ks))
    assert min(plan.kc, plan.ks) >= k4.WIDTHS[plan.nc]
    full = w_s + ring * w_kstep
    assert full % 8 == 0 and full + 16 * plan.stages == plan.smem - k4.SLACK


def test_descriptor_fields():
    """Start address in 16-byte units in bits 0-13, LBO in 16-29, SBO in
    32-45, layout type in 62-63 (3: 32-byte swizzle)."""
    d = k4.descriptor(0x1A300)
    assert d & 0x3FFF == 0x1A30 and (d >> 16) & 0x3FFF == 1 and (d >> 32) & 0x3FFF == 16
    assert d >> 62 == 3 and (d >> 46) & 0xFFFF == 0
    # advancing a descriptor advances its start address in 16-byte units
    assert k4.descriptor(0x1A300 + 2048) == k4.descriptor(0x1A300) + 2048 // 16


def test_wgmma_header_is_the_generators():
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import gen_wgmma

    with open(gen_wgmma.HEADER) as f:
        assert f.read() == gen_wgmma.render()
    assert gen_wgmma.WIDTHS == tuple(sorted(k4.WIDTHS))  # an overload a compiled width
    cu = open(os.path.join(os.path.dirname(gen_wgmma.HEADER), "lane_packing.cu")).read()
    macro = re.search(r"#define FSE_K4_WIDTHS\(X\)((?:[^\n]*\\\n)*[^\n]*)", cu).group(1)
    assert dict(map(int, x) for x in re.findall(r"X\((\d+), (\d+)\)", macro)) == k4.WIDTHS
    assert "mma.sync" not in cu
    # chains x N / 2 accumulator registers a thread stay well under 255
    assert all(c * w // 2 <= 144 for w, c in k4.WIDTHS.items())


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
