"""The port's ops against the JAX package's and the torch-made goldens.

Same seeded numpy inputs through both packages, on the CPU. Tolerance 1e-5
abs for gamma, pixel (un)shuffle and the activation registry (fp32
transcendentals of XLA and torch differ by a few ulp); 1e-4 for conv2d
(summation order).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu import ops as J
from fs_uae_image_enhancer_project_tpu_torch import ops as T

G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ops_goldens.npz"))
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


GAMMA = ["srgb_to_linear", "linear_to_srgb", "srgb_to_linear_approx",
         "linear_to_srgb_approx", "srgb_to_linear_poly", "linear_to_srgb_poly"]


@pytest.mark.parametrize("name", GAMMA)
def test_gamma_matches_jax_and_goldens(name):
    t = G["gamma_t"]
    got = getattr(T, name)(_t(t)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(J, name)(jnp.asarray(t))), atol=TOL)
    if f"gamma_{name}" in G:
        np.testing.assert_allclose(got, G[f"gamma_{name}"], atol=TOL)


@pytest.mark.parametrize("r", [2, 3])
def test_pixel_shuffle_pair_matches_jax_and_goldens(r):
    x = G[f"unshuf{r}_x"]
    got = T.pixel_unshuffle(_t(x), r).numpy()
    np.testing.assert_array_equal(got, G[f"unshuf{r}_out"])
    np.testing.assert_array_equal(got, np.asarray(J.pixel_unshuffle(jnp.asarray(x), r)))
    y = G[f"shuf{r}_x"]
    got = T.pixel_shuffle(_t(y), r).numpy()
    np.testing.assert_array_equal(got, G[f"shuf{r}_out"])
    np.testing.assert_array_equal(got, np.asarray(J.pixel_shuffle(jnp.asarray(y), r)))


def test_pixel_shuffle_rejects_bad_shapes():
    with pytest.raises(ValueError):
        T.pixel_unshuffle(torch.zeros(1, 5, 4, 3))
    with pytest.raises(ValueError):
        T.pixel_shuffle(torch.zeros(1, 2, 2, 6))


# (name, config) for every registry name; learnable ones get JAX-made params
ACTS = [(n, {}) for n in T.ACTIVATION_NAMES] + [
    ("gelu", {"approximate": "tanh"}), ("elu", {"alpha": 0.5}),
    ("leaky_relu", {"negative_slope": 0.2}), ("softplus", {"beta": 2.0, "threshold": 5.0}),
    ("prelu", {"num_parameters": 5, "init": 0.3}),
    ("biased_relu", {"num_parameters": 5}), ("biased_prelu", {"num_parameters": 5}),
]


def test_registry_names_match_jax():
    assert T.ACTIVATION_NAMES == J.ACTIVATION_NAMES
    assert len(T.ACTIVATION_NAMES) == 20


@pytest.mark.parametrize("name,config", ACTS, ids=lambda v: str(v))
def test_activation_matches_jax(name, config):
    x = np.random.default_rng(0).normal(0, 2.0, (2, 4, 6, 5)).astype(np.float32)
    jp = J.init_activation(jax.random.key(1), name, config)
    want = np.asarray(J.apply_activation(name, jp, jnp.asarray(x), config))
    tp = {k: _t(v) for k, v in jp.items()}
    got = T.apply_activation(name, tp, _t(x), config).numpy()
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("name", ["identity", "relu", "relu6", "sigmoid", "tanh", "silu",
                                  "swish", "mish", "gelu", "elu", "leaky_relu",
                                  "softplus", "telu", "scaled_tanh", "sinlu"])
def test_activation_matches_goldens(name):
    p = T.init_activation(name, device="cpu")
    got = T.apply_activation(name, p, _t(G["act_x"])).numpy()
    np.testing.assert_allclose(got, G[f"act_{name}"], atol=TOL)


@pytest.mark.parametrize("name,params", [
    ("prelu", {"slope": "prelu_slope"}),
    ("biased_relu", {"bias": "brelu_bias"}),
    ("biased_prelu", {"bias": "bprelu_bias", "slope": "bprelu_slope"}),
])
def test_learnable_activation_matches_goldens(name, params):
    p = {k: _t(G[v]) for k, v in params.items()}
    golden = {"prelu": "prelu_out", "biased_relu": "brelu_out", "biased_prelu": "bprelu_out"}
    got = T.apply_activation(name, p, _t(G["pact_x"])).numpy()
    np.testing.assert_allclose(got, G[golden[name]], atol=TOL)


def test_init_activation_shapes_and_seeding():
    g = torch.Generator().manual_seed(0)
    assert T.init_activation("relu", device="cpu") == {}
    p = T.init_activation("prelu", {"num_parameters": 7, "init": 0.3}, device="cpu")
    assert p["slope"].shape == (7,) and float(p["slope"][0]) == pytest.approx(0.3)
    p = T.init_activation("biased_prelu", {"num_parameters": 3}, generator=g, device="cpu")
    assert p["bias"].shape == (3,) and p["slope"].shape == (3,)
    assert bool((p["bias"].abs() <= 0.1).all())
    q = T.init_activation("biased_prelu", {"num_parameters": 3},
                          generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["bias"], q["bias"])


def test_activation_errors():
    with pytest.raises(ValueError):
        T.apply_activation("nope", {}, torch.zeros(1, 2, 2, 3))
    with pytest.raises(TypeError):
        T.apply_activation("leaky_relu", {}, torch.zeros(1, 2, 2, 3), {"negative_slop": 0.1})
    with pytest.raises(ValueError):
        T.apply_activation("gelu", {}, torch.zeros(1, 2, 2, 3), {"approximate": "nope"})
    with pytest.raises(ValueError):
        T.apply_activation("prelu", {"slope": torch.ones(4)}, torch.zeros(1, 2, 2, 3))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_conv2d_matches_jax_and_goldens(k):
    w_hwio = np.transpose(G[f"conv{k}_w_oihw"], (2, 3, 1, 0))
    x = G[f"conv{k}_x"]
    want = np.asarray(J.conv2d({"w": jnp.asarray(w_hwio), "b": jnp.asarray(G[f"conv{k}_b"])},
                               jnp.asarray(x)))
    got = T.conv2d({"w": _t(w_hwio), "b": _t(G[f"conv{k}_b"])}, _t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(got, G[f"conv{k}_out"], atol=1e-4)


def test_conv2d_without_bias_and_valid_padding_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 9, 7, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    for padding in ("SAME", "VALID"):
        want = np.asarray(J.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), padding=padding))
        got = T.conv2d({"w": _t(w)}, _t(x), padding=padding).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_init_conv_shapes_and_scale():
    p = T.init_conv(12, 36, 3, generator=torch.Generator().manual_seed(0), device="cpu")
    assert p["w"].shape == (3, 3, 12, 36) and p["b"].shape == (36,)
    bound = 1.0 / np.sqrt(12 * 9)
    assert float(p["w"].abs().max()) <= bound and float(p["b"].abs().max()) <= bound
    assert "b" not in T.init_conv(4, 4, 1, use_bias=False, device="cpu")
