"""The port's four design tools (``fs_uae_image_enhancer_project_tpu_torch.
benchmark_tools``) against the root ``benchmark_tools/`` on the CPU, at
reduced grids.

- activations: a row for every activation of the registry but the softmaxes
  (the root tool's default list), forward and forward+backward, and the
  backward is the gradient JAX's ``jax.grad`` gives;
- kernel sizes: JAX's analytic GFLOP; the ``SAME`` conv for every kernel
  size of the grid, even ones with XLA's asymmetric split, within 1e-5 of
  JAX's ``conv2d``; a reduced table;
- the channel search: the same bisection as JAX's on the same timing model,
  and a reduced search on the CPU;
- gamma: the curves and the fp32 and bf16 error tables against JAX's gamma
  functions, the SVG and the command line;
- ``chip_smoke.py``'s ``benchmark_tools`` phase rehearsed at a small size.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.ops import activations as jax_acts
from fs_uae_image_enhancer_project_tpu.ops import conv as jax_conv
from fs_uae_image_enhancer_project_tpu.ops import gamma as jax_gamma
from fs_uae_image_enhancer_project_tpu_torch.benchmark_tools import (
    benchmark_activation_functions as acts,
    benchmark_kernel_sizes as ks,
    benchmark_search_channels as sc,
    gamma_plot,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_tool(name):
    """A root benchmark tool (a script that imports its siblings by name)."""
    path = os.path.join(REPO, "benchmark_tools")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def test_activation_table_and_gradients():
    names = acts.default_names()
    assert names == [n for n in jax_acts.ACTIVATION_NAMES if n not in ("softmax", "log_softmax")]
    table = acts.activation_table([(1, 6, 8, 4)], names, torch.float32, "cpu", 0.002, 2)
    assert list(table) == ["1x6x8x4"] and list(table["1x6x8x4"]) == names
    assert all(v["fwd_us"] > 0 and v["fwd_bwd_us"] > 0 for v in table["1x6x8x4"].values())
    x = np.random.default_rng(0).normal(0, 1, (1, 6, 8, 4)).astype(np.float32)
    for name in ("relu", "mish", "sinlu", "gelu"):
        _fwd, bwd = acts.activation_fns(name, 4, "cpu")
        params = jax_acts.init_activation(jax.random.key(0), name, None)
        want = jax.grad(lambda t: jnp.mean(jax_acts.apply_activation(name, params, t)))(
            jnp.asarray(x))
        np.testing.assert_allclose(bwd(torch.from_numpy(x)).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("k", ks.KERNELS)
def test_same_conv_matches_jax(k):
    jtool = _root_tool("benchmark_kernel_sizes")
    assert ks.KERNELS == jtool.KERNELS and ks.CHANNELS == jtool.CHANNELS
    assert ks.analytic_gflops(288, 376, 36, 72, k) == jtool.analytic_gflops(288, 376, 36, 72, k)
    jp = jax.tree_util.tree_map(np.asarray, jax_conv.init_conv(jax.random.key(k), 5, 7, k))
    x = np.random.default_rng(k).normal(0, 1, (1, 9, 11, 5)).astype(np.float32)
    want = np.asarray(jax_conv.conv2d(jp, jnp.asarray(x)))
    got = ks.conv_same({n: torch.from_numpy(np.array(v)) for n, v in jp.items()},
                       torch.from_numpy(x))
    assert got.shape == want.shape == (1, 9, 11, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_kernel_table_on_a_reduced_grid():
    rows = ks.kernel_table(8, 12, torch.float32, 0.002, 2, "cpu", kernels=[2, 3],
                           channels=[4, 8])
    assert [(r["kernel"], r["channels"]) for r in rows] == [(2, 4), (2, 8), (3, 4), (3, 8)]
    assert all(r["ms"] > 0 for r in rows)
    assert ks.time_conv(4, 6, 3, 8, 12, torch.float32, 0.002, 2, "cpu") > 0  # ping-pong


def test_channel_search_is_jax_bisection(monkeypatch):
    """The same bisection on the same timing model (ms linear in channels
    times k^2): the same channel counts."""
    jtool = _root_tool("benchmark_search_channels")

    def model(cin, cout, k, h, w, dtype, duration=0.5, chunk=200, device=None):
        return 1e-4 * cin * k * k

    monkeypatch.setattr(sc, "time_conv", model)
    monkeypatch.setattr(jtool, "time_conv", model)
    target = model(36, 36, 3, 0, 0, None)
    for k in (1, 3, 5, 7):
        assert sc.find_equal_latency_channels(target, k, 8, 8, torch.float32) == \
            jtool.find_equal_latency_channels(target, k, 8, 8, jnp.float32)
    out = sc.search(3, 36, (1, 3, 5), 72, 8, 8, torch.float32, 0.01, "cpu")
    assert out["iso_latency_channels"][3] == 36 and sum(out["scaled_to_budget"].values()) > 0


def test_channel_search_runs_on_the_cpu():
    out = sc.search(3, 8, (1, 3), 16, 8, 8, torch.float32, 0.002, "cpu", hi=24)
    assert out["reference_ms"] > 0 and set(out["iso_latency_channels"]) == {1, 3}
    assert all(c % 4 == 0 and 4 <= c <= 24 for c in out["iso_latency_channels"].values())


def test_gamma_tables_match_jax(tmp_path, capsys):
    t = np.linspace(0, 1, 257, dtype=np.float32)
    cv = gamma_plot.curves(257, device="cpu")
    er = gamma_plot.errors(257, device="cpu")
    pairs = {"sRGB -> linear": (jax_gamma.srgb_to_linear, jax_gamma.srgb_to_linear_approx,
                                jax_gamma.srgb_to_linear_poly),
             "linear -> sRGB": (jax_gamma.linear_to_srgb, jax_gamma.linear_to_srgb_approx,
                                jax_gamma.linear_to_srgb_poly)}
    for d, (exact, approx, poly) in pairs.items():
        for key, fn in (("exact", exact), ("approx", approx), ("poly", poly)):
            np.testing.assert_allclose(cv[d][key], np.asarray(fn(jnp.asarray(t))),
                                       rtol=1e-5, atol=1e-6)
        e32 = np.abs(np.asarray(exact(jnp.asarray(t))) - np.asarray(approx(jnp.asarray(t))))
        eb = np.abs(np.asarray(exact(jnp.asarray(t)))
                    - np.asarray(approx(jnp.asarray(t, jnp.bfloat16))).astype(np.float32))
        np.testing.assert_allclose(er[d]["fp32"], e32, atol=1e-6)
        # bf16 pow rounds to one bf16 step (2^-8 relative) either way
        np.testing.assert_allclose(er[d]["bf16"], eb, atol=2 ** -8)
        assert er[d]["bf16"].max() > er[d]["fp32"].max() / 2
    out = str(tmp_path / "g.svg")
    assert gamma_plot.main(["--out", out, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {out}"
    svg = open(out).read()
    assert svg.startswith("<svg") and svg.rstrip().endswith("</svg>")
    assert svg.count("<polyline") == 10 and "1/255 (8-bit LSB)" in svg


def test_chip_smoke_benchmark_tools_rehearsal():
    import chip_smoke as cs

    rec = cs.benchmark_tools_phase(torch.device("cpu"), duration_s=0.002, shape=(8, 12),
                                   act_shape=(1, 6, 8, 12))
    cs.check_benchmark_tools(rec)
    assert len(rec["activations"]["table"]) == len(acts.default_names())
