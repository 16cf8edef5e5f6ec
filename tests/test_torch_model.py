"""The port's pix_shuffle model against the JAX package's, on the CPU.

Weights come from the JAX ``init`` and go through ``interop.params_from_jax``;
inputs are seeded numpy arrays. fp32 forward within 1e-4 abs (summation
order of the convs).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.models import count_params as jax_count
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.models import pix_shuffle as jps
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax, params_to_numpy
from fs_uae_image_enhancer_project_tpu_torch.models import count_params, get_model
from fs_uae_image_enhancer_project_tpu_torch.models import pix_shuffle as tps


def _jax_params(variant, seed=0):
    jm = jax_model("pix_shuffle", variant)
    tree = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, tree


@pytest.mark.parametrize("variant,shape", [
    ("lightweight", (1, 32, 48, 3)), ("lightweight", (2, 24, 16, 3)),
    ("heavyweight", (1, 32, 48, 3)),
])
def test_forward_fp32_matches_jax(variant, shape):
    jm, tree = _jax_params(variant)
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    m = get_model("pix_shuffle", variant)
    assert dataclasses.asdict(m.config) == dataclasses.asdict(jm.config)
    got = m.apply(params_from_jax(tree, device="cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_intermediates_match_jax():
    jm, tree = _jax_params("lightweight", seed=3)
    x = np.random.default_rng(1).uniform(0, 1, (1, 16, 24, 3)).astype(np.float32)
    want_y, want = jps.apply_with_intermediates(tree, jnp.asarray(x), jm.config)
    got_y, got = tps.apply_with_intermediates(
        params_from_jax(tree, device="cpu"), torch.from_numpy(x), jm.config)
    assert sorted(got) == sorted(want) == [f"layer{i}" for i in range(1, 8)]
    for tag in want:
        np.testing.assert_allclose(got[tag].numpy(), np.asarray(want[tag]), atol=1e-4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-4)


def test_param_count_and_structure():
    m = get_model("pix_shuffle")
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert count_params(p) == 136_602
    _, tree = _jax_params("lightweight")
    assert count_params(p) == jax_count(tree)
    shapes = jax.tree_util.tree_map(np.shape, tree)
    assert jax.tree_util.tree_map(np.shape, params_to_numpy(p)) == shapes
    heavy = get_model("pix_shuffle_heavy")
    assert heavy.variant == "heavyweight"
    assert count_params(heavy.init(device="cpu")) == jax_count(_jax_params("heavyweight")[1])


def test_init_is_seeded():
    m = get_model("pix_shuffle")
    a = m.init(torch.Generator().manual_seed(5), device="cpu")
    b = m.init(torch.Generator().manual_seed(5), device="cpu")
    assert torch.equal(a["conv4"]["w"], b["conv4"]["w"])
    assert torch.equal(a["l2_act4"]["bias"], b["l2_act4"]["bias"])


def test_interop_round_trip_is_exact():
    _, tree = _jax_params("lightweight", seed=7)
    back = params_to_numpy(params_from_jax(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves(tree)
    flat_b = jax.tree_util.tree_leaves(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_registry_errors():
    with pytest.raises(ValueError):
        get_model("pix_shuffle", "medium")
    with pytest.raises(NotImplementedError):
        get_model("conv3")
    with pytest.raises(ValueError):
        get_model("nope")


def test_cuda_forward_rejects_heavyweight_config(monkeypatch):
    """On a CUDA tensor the forward goes through the fused-stack kernel, which
    takes the lightweight config only: other configs raise, never fall back."""
    m = get_model("pix_shuffle", "heavyweight")
    p = m.init(device="cpu")
    x = torch.zeros(1, 8, 8, 3)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="lightweight"):
        m.apply(p, x)
