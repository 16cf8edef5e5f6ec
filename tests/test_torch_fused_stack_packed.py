"""K2's plain version against the Pallas pair-packed stack, and its
wrapper's rules.

On the CPU the port's K2 wrapper takes its plain version, which forms every
conv as the product of [A|O] windows with the pair-packed weights, so these
tests hold the packing layout itself to the Pallas kernel (interpret mode,
at the sizes of tests/test_fused_stack.py::test_packed_matches_fp32_forward)
and to the fp32 forward, within 2e-3 abs (the JAX tests' own limit: bf16
intermediates cost about 1e-3). The CUDA kernel runs only on a card:
tests/test_torch_cuda.py and chip_smoke.py hold it to this plain version.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.ops.pallas.fused_stack_packed import (
    _pack_conv_weight,
    fused_stack_packed_apply as pallas_packed_apply,
)
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2

JM = jax_model("pix_shuffle")
TREE = jax.tree_util.tree_map(np.asarray, JM.init(jax.random.key(0)))
PARAMS = params_from_jax(TREE, device="cpu")
TOL = 2e-3


@pytest.mark.parametrize("cin,cout", [(12, 36), (36, 36), (36, 72), (72, 72), (72, 36),
                                      (36, 12), (5, 7)])
def test_pack_conv_weight_equals_the_pallas_wrappers(cin, cout):
    w = np.random.default_rng(cin * cout).normal(size=(3, 3, cin, cout)).astype(np.float32)
    got = k2.pack_conv_weight(w)
    assert got.shape == (12 * cin, 2 * cout)
    np.testing.assert_array_equal(got, _pack_conv_weight(w))
    assert (got == 0).mean() == pytest.approx(0.25, abs=0.01)  # the structural zeros


@pytest.mark.parametrize("hw,seed", [((48, 32), 0), ((96, 44), 1), ((144, 32), 2)])
def test_plain_matches_pallas_and_fp32_forward(hw, seed):
    x = np.random.default_rng(seed).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    truth = np.asarray(JM.apply(TREE, jnp.asarray(x)))
    pallas = np.asarray(pallas_packed_apply(TREE, jnp.asarray(x), interpret=True,
                                            fallback=False).astype(jnp.float32))
    plain = k2.fused_stack_packed_apply(PARAMS, torch.from_numpy(x)).numpy()
    assert np.abs(plain - pallas).max() <= TOL
    assert np.abs(plain - truth).max() <= TOL
    assert np.abs(pallas - truth).max() <= TOL
    # no spike at the 16-pixel tile seams or the right edge (W2 = 16 or 22)
    err = np.abs(plain - truth)[0]
    assert err.max(axis=(0, 2))[-4:].max() <= TOL and err.max(axis=(1, 2)).max() <= TOL


@pytest.mark.parametrize("shape", [(20, 28, 12), (9, 13, 12), (2, 10, 6, 12), (1, 1, 12)])
def test_plain_matches_k1_plain(shape):
    """K1's and K2's plain versions differ only in how the conv's sums are
    formed (F.conv2d against the packed product), then round at the same
    places: odd widths, a batch and a single pixel included."""
    u = torch.rand(shape, generator=torch.Generator().manual_seed(len(shape))).to(torch.bfloat16)
    got = k2.fused_stack_packed_plain(u, k2.prepare_weights(PARAMS, "cpu"), out_fp32=True)
    want = fs.fused_stack_plain(u, fs.prepare_weights(PARAMS, "cpu"), out_fp32=True)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("n,c,h,w,co", [(1, 12, 7, 9, 36), (2, 36, 6, 10, 72), (1, 72, 5, 1, 12)])
def test_packed_conv_equals_conv2d(n, c, h, w, co):
    g = torch.Generator().manual_seed(h * w)
    x = torch.randn(n, c, h, w, generator=g, dtype=torch.float64)
    wt = torch.randn(3, 3, c, co, generator=g, dtype=torch.float64)
    wp = torch.from_numpy(k2.pack_conv_weight(wt.float().numpy())).double()
    want = F.conv2d(x, wt.float().double().permute(3, 2, 0, 1), padding=1)
    torch.testing.assert_close(k2.packed_conv(x, wp), want, atol=1e-9, rtol=1e-9)


def _unfragment(f: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """Invert ``fs.fragments``: flat [kstep][ntile][lane][4] -> (K, N)."""
    ks, nt = -(-k // 16), n // 8
    g = f.float().reshape(ks, nt, 8, 4, 2, 2)  # s, ntile, col g, t, khalf, pair
    return g.permute(0, 4, 3, 5, 1, 2).reshape(ks * 16, nt * 8)[:k]


def test_fragments_hold_the_packed_weights_chunk_padded():
    """Per layer, the B fragments are the (K, 2 cout) matrix whose rows run
    over the 12 taps (dy, column) of each source, 8-channel chunks padded
    with zero rows (12 -> 16, 36 -> 40), the l1 source before the l5 one."""
    sw = k2.prepare_weights(PARAMS, "cpu")
    for i, ((name, sources, cout, _), frag) in enumerate(zip(fs.LAYERS, sw.frags)):
        w = torch.as_tensor(PARAMS[name]["w"]).float()
        k = 12 * sum(cp for _, cp in sources)
        got = _unfragment(frag, k, 2 * cout)
        rows, c0 = [], 0
        for cin, cin_pad in sources:
            p = torch.from_numpy(k2.pack_conv_weight(w[:, :, c0:c0 + cin].numpy()))
            p = F.pad(p.reshape(12, cin, 2 * cout), (0, 0, 0, cin_pad - cin))
            rows.append(p.reshape(-1, 2 * cout))
            c0 += cin
        want = torch.cat(rows).to(torch.bfloat16).float()
        assert torch.equal(got, want), name
        assert [m.shape for m in sw.plain[i]] == [(12 * c, 2 * cout) for c, _ in sources]


def test_rejects_other_configs_and_shapes():
    heavy = get_model("pix_shuffle", "heavyweight").config
    with pytest.raises(ValueError):
        k2.fused_stack_packed_apply(PARAMS, torch.zeros(1, 16, 16, 3), cfg=heavy)
    for shape in [(0, 16, 16, 3), (1, 15, 16, 3), (1, 16, 16, 4), (16, 16, 3)]:
        with pytest.raises(ValueError):
            k2.fused_stack_packed_apply(PARAMS, torch.zeros(shape))


def test_wrapper_checks_its_input():
    sw = k2.prepare_weights(PARAMS, "cpu")
    for bad in (torch.zeros(8, 8, 12), torch.zeros(8, 8, 11, dtype=torch.bfloat16),
                torch.zeros(8, 16, 12, dtype=torch.bfloat16)[:, ::2]):
        with pytest.raises(ValueError):
            fs.check_input(bad, sw, "fused_stack_packed")
    with pytest.raises(ValueError):  # neither cpu nor cuda
        k2.fused_stack_packed(torch.zeros(8, 8, 12, dtype=torch.bfloat16, device="meta"), sw)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    sw = k2.prepare_weights(PARAMS, "cpu")
    u = torch.rand(2, 10, 14, 12, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = k2.fused_stack_packed.launches
    y = k2.fused_stack_packed(u, sw)
    assert k2.fused_stack_packed.launches == before
    assert torch.equal(y, k2.fused_stack_packed_plain(u, sw))
    assert y.dtype == torch.bfloat16 and y.shape == u.shape
    assert torch.equal(y[1], k2.fused_stack_packed(u[1].contiguous(), sw))


def test_prep_cache_sees_replaced_leaves():
    params = params_from_jax(TREE, device="cpu")
    first = k2.prepare_weights_cached(params, "cpu")
    assert k2.prepare_weights_cached(params, "cpu") is first
    params["conv7"] = {k: torch.zeros_like(v) for k, v in params["conv7"].items()}
    again = k2.prepare_weights_cached(params, "cpu")
    assert again is not first and float(again.frags[6].float().abs().sum()) == 0.0
