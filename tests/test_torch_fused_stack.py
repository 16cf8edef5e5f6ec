"""K1's plain version against the Pallas fused stack, and its wrapper's rules.

On the CPU the port's fused-stack wrapper takes its plain version; the JAX
side runs the Pallas kernel in interpret mode at the sizes of
tests/test_fused_stack.py. Both must be within 2e-3 abs of each other and of
the JAX fp32 forward (the bf16 intermediates of both cost about 1e-3). The
CUDA kernel itself runs only on a card: tests/test_torch_cuda.py holds it to
the plain version there.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.ops.pallas.fused_stack import (
    fused_stack_apply as pallas_fused_stack_apply,
)
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs

JM = jax_model("pix_shuffle")
TREE = jax.tree_util.tree_map(np.asarray, JM.init(jax.random.key(0)))
PARAMS = params_from_jax(TREE, device="cpu")
TOL = 2e-3


@pytest.mark.parametrize("shape,seed", [((1, 96, 96, 3), 0), ((1, 96, 64, 3), 1),
                                        ((1, 144, 48, 3), 2)])
def test_plain_matches_pallas_and_fp32_forward(shape, seed):
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    truth = np.asarray(JM.apply(TREE, jnp.asarray(x)))
    pallas = np.asarray(pallas_fused_stack_apply(TREE, jnp.asarray(x), interpret=True,
                                                 fallback=False).astype(jnp.float32))
    plain = fs.fused_stack_apply(PARAMS, torch.from_numpy(x)).numpy()
    assert np.abs(plain - pallas).max() < TOL
    assert np.abs(plain - truth).max() < TOL
    assert np.abs(pallas - truth).max() < TOL
    # no error spike at the kernel's 16-pixel tile seams or the frame's edges
    per_row = np.abs(plain - truth)[0].max(axis=(1, 2))
    assert per_row.max() < TOL


def test_plain_takes_shapes_the_pallas_kernel_does_not():
    """Any even H and W (the TPU kernel needed H/2 % 24 == 0)."""
    x = np.random.default_rng(4).uniform(0, 1, (1, 30, 22, 3)).astype(np.float32)
    truth = np.asarray(JM.apply(TREE, jnp.asarray(x)))
    plain = fs.fused_stack_apply(PARAMS, torch.from_numpy(x)).numpy()
    assert np.abs(plain - truth).max() < TOL


def test_fragment_layout_is_the_mma_b_fragment():
    """Each lane's 4 bf16 of (kstep s, ntile j) are W[k, n] at n = 8j + lane//4
    and k = 16s + 2*(lane%4) + {0, 1, 8, 9}, with W the (K, cout_pad) matrix
    whose rows run tap-major over 8-channel chunks (zero-padded)."""
    sw = fs.prepare_weights(PARAMS, "cpu")
    for (name, sources, cout, cout_pad), frag in zip(fs.LAYERS, sw.frags):
        w = PARAMS[name]["w"].to(torch.bfloat16).float()
        rows, c0 = [], 0
        for cin, cin_pad in sources:
            blk = torch.zeros(3, 3, cin_pad, cout_pad)
            blk[:, :, :cin, :cout] = w[:, :, c0:c0 + cin, :]
            rows.append(blk.reshape(9 * cin_pad, cout_pad))
            c0 += cin
        full = torch.cat(rows)
        ks = -(-full.shape[0] // 16)
        f = frag.float().reshape(ks, cout_pad // 8, 32, 4)
        for s in (0, ks // 2, ks - 1):
            for j in range(cout_pad // 8):
                for lane in (0, 5, 31):
                    n = 8 * j + lane // 4
                    for i, dk in enumerate((0, 1, 8, 9)):
                        k = 16 * s + 2 * (lane % 4) + dk
                        want = full[k, n] if k < full.shape[0] else 0.0
                        assert f[s, j, lane, i] == want, (name, s, j, lane, i)


def test_param_vector_layout():
    sw = fs.prepare_weights(PARAMS, "cpu")
    assert sw.prm.numel() == fs.PARAM_TOTAL == 552
    o, _ = fs.PARAM_OFFSETS["b4"]
    np.testing.assert_array_equal(sw.prm[o:o + 72].numpy(), TREE["conv4"]["b"])
    o, _ = fs.PARAM_OFFSETS["p2s"]
    np.testing.assert_array_equal(sw.prm[o:o + 36].numpy(), TREE["l2_act4"]["slope"])
    o, _ = fs.PARAM_OFFSETS["scalars"]
    assert sw.prm[o + 4] == float(TREE["l7_act2"]["bias"][0])
    assert fs.MACS_PER_PIXEL == 136_080


def test_prep_cache_sees_replaced_and_in_place_updated_leaves():
    params = params_from_jax(TREE, device="cpu")
    first = fs.prepare_weights_cached(params, "cpu")
    assert fs.prepare_weights_cached(params, "cpu") is first
    params["conv7"]["b"].add_(1.0)  # in place: same id, new version
    second = fs.prepare_weights_cached(params, "cpu")
    assert second is not first
    params["conv7"] = {k: torch.zeros_like(v) for k, v in params["conv7"].items()}
    third = fs.prepare_weights_cached(params, "cpu")
    assert third is not second and float(third.frags[6].abs().sum()) == 0.0


def test_rejects_other_configs_and_shapes():
    heavy = get_model("pix_shuffle", "heavyweight").config
    with pytest.raises(ValueError):
        fs.fused_stack_apply(PARAMS, torch.zeros(1, 16, 16, 3), cfg=heavy)
    for shape in [(0, 16, 16, 3), (1, 15, 16, 3), (1, 16, 16, 4), (16, 16, 3)]:
        with pytest.raises(ValueError):
            fs.fused_stack_apply(PARAMS, torch.zeros(shape))


def test_wrapper_checks_its_input():
    sw = fs.prepare_weights(PARAMS, "cpu")
    with pytest.raises(ValueError):
        fs.check_input(torch.zeros(8, 8, 12), sw)  # fp32
    with pytest.raises(ValueError):
        fs.check_input(torch.zeros(8, 8, 11, dtype=torch.bfloat16), sw)
    with pytest.raises(ValueError):
        fs.check_input(torch.zeros(8, 16, 12, dtype=torch.bfloat16)[:, ::2], sw)
    fs.check_input(torch.zeros(8, 8, 12, dtype=torch.bfloat16), sw)


def test_cpu_tensor_takes_the_plain_version_without_launching():
    sw = fs.prepare_weights(PARAMS, "cpu")
    u = torch.rand(10, 14, 12, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    before = fs.fused_stack.launches
    y = fs.fused_stack(u, sw)
    assert fs.fused_stack.launches == before
    assert torch.equal(y, fs.fused_stack_plain(u, sw))
    assert y.dtype == torch.bfloat16 and y.shape == u.shape


def test_cuda_wrapper_raises_without_a_card():
    """Asked for the card where there is none, the wrapper's path raises: the
    kernel cannot be built, and a tensor on another device is refused."""
    from fs_uae_image_enhancer_project_tpu_torch import resolve_device
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    if not os.path.exists(build.library_path()):
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load_library()
    sw = fs.prepare_weights(PARAMS, "cpu")
    with pytest.raises(ValueError):
        fs.fused_stack(torch.zeros(8, 8, 12, dtype=torch.bfloat16, device="meta"), sw)
