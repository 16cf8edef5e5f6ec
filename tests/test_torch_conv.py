"""The port's depthwise conv, batchnorm, conv-BN fold and conv_stack models
against the JAX package's and the torch-made goldens.

Same seeded numpy inputs through both packages, on the CPU. Tolerances: the
goldens at the JAX package's own (``tests/test_ops.py``: 1e-5, BN train 1e-4);
against JAX 1e-5 abs (summation order), ``fuse_conv_bn`` 1e-6 abs.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.models import conv_stack as jcs
from fs_uae_image_enhancer_project_tpu.ops import conv as J
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax, params_to_numpy
from fs_uae_image_enhancer_project_tpu_torch.models import conv_stack as tcs
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops import conv as T

G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "ops_goldens.npz"))
LAP = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _bn(keys=("scale", "bias", "mean", "var")):
    return {k: G[f"bn_{k}"] for k in keys}


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_depthwise_conv2d_matches_goldens_and_jax(padding):
    x = G["lap_x"]
    got = T.depthwise_conv2d(_t(LAP), _t(x), padding=padding).numpy()
    if padding == "SAME":
        np.testing.assert_allclose(got, G["lap_out"], atol=1e-5)
    want = np.asarray(J.depthwise_conv2d(jnp.asarray(LAP), jnp.asarray(x), padding=padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)
    k5 = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32)
    got = T.depthwise_conv2d(_t(k5), _t(x), padding=padding).numpy()
    want = np.asarray(J.depthwise_conv2d(jnp.asarray(k5), jnp.asarray(x), padding=padding))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_init_batchnorm_is_torch_default():
    bn = T.init_batchnorm(5, device="cpu")
    want = J.init_batchnorm(5)
    for k in want:
        np.testing.assert_array_equal(bn[k].numpy(), np.asarray(want[k]))


def test_batchnorm_inference_matches_goldens_and_jax():
    x = G["bn_x"]
    got = T.batchnorm_inference({k: _t(v) for k, v in _bn().items()}, _t(x)).numpy()
    np.testing.assert_allclose(got, G["bn_eval_out"], atol=1e-5)
    want = J.batchnorm_inference({k: jnp.asarray(v) for k, v in _bn().items()}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_batchnorm_train_matches_goldens_and_jax():
    x = G["bn_x"]
    got, stats = T.batchnorm_train({k: _t(v) for k, v in _bn().items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), G["bn_train_out"], atol=1e-4)
    np.testing.assert_allclose(stats["mean"].numpy(), G["bn_train_new_mean"], atol=1e-5)
    np.testing.assert_allclose(stats["var"].numpy(), G["bn_train_new_var"], atol=1e-4)
    want, wstats = J.batchnorm_train({k: jnp.asarray(v) for k, v in _bn().items()},
                                     jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for k in ("scale", "bias", "mean", "var"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(wstats[k]), atol=1e-5)


def test_batchnorm_train_gradient_matches_jax():
    """Train-mode BN differentiates through the batch statistics; the new
    running stats carry no gradient."""
    x = G["bn_x"]
    w = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)

    def jloss(xs, scale, bias):
        p = {"scale": scale, "bias": bias, "mean": jnp.asarray(G["bn_mean"]),
             "var": jnp.asarray(G["bn_var"])}
        return jnp.sum(J.batchnorm_train(p, xs)[0] * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(G["bn_scale"]),
                                            jnp.asarray(G["bn_bias"]))
    xs, scale, bias = (_t(a).requires_grad_() for a in (x, G["bn_scale"], G["bn_bias"]))
    y, stats = T.batchnorm_train({"scale": scale, "bias": bias, "mean": _t(G["bn_mean"]),
                                  "var": _t(G["bn_var"])}, xs)
    assert not stats["mean"].requires_grad and not stats["var"].requires_grad
    (y * _t(w)).sum().backward()
    for got, want in zip((xs.grad, scale.grad, bias.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_fuse_conv_bn_matches_jax():
    rng = np.random.default_rng(11)
    cin, cout = 3, 8
    for use_bias in (True, False):
        conv = J.init_conv(jax.random.key(11), cin, cout, 3, use_bias=use_bias)
        bn = {"mean": rng.normal(size=(cout,)), "var": rng.uniform(0.5, 2.0, (cout,)),
              "scale": rng.normal(size=(cout,)), "bias": rng.normal(size=(cout,))}
        bn = {k: v.astype(np.float32) for k, v in bn.items()}
        want = J.fuse_conv_bn(conv, {k: jnp.asarray(v) for k, v in bn.items()})
        got = T.fuse_conv_bn(params_from_jax(conv, device="cpu"),
                             params_from_jax(bn, device="cpu"))
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)
        x = _t(rng.normal(size=(1, 7, 7, cin)))
        ref = T.batchnorm_inference(params_from_jax(bn, device="cpu"),
                                    T.conv2d(params_from_jax(conv, device="cpu"), x))
        np.testing.assert_allclose(T.conv2d(got, x).numpy(), ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("name", ["conv3", "conv5"])
def test_conv_stack_matches_jax(name):
    """init's layout, the train-mode forward with its BN stats, the
    inference forward, fuse and both deployed orders of apply_fused."""
    jcfg = getattr(jcs, f"{name}_config")("lightweight")
    m = get_model(name)
    assert m.loss.kind == ("ssim" if name == "conv5" else "perceptual")
    assert m.linear_io is False
    jp = jcs.init(jax.random.key(3), jcfg)
    tp = m.init(torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), tp) == jshapes
    # non-trivial running stats, so inference mode is not the identity
    rng = np.random.default_rng(4)
    jp = params_to_numpy(params_from_jax(jp, device="cpu"))
    for k in jp:
        if k.startswith("bn"):
            c = jp[k]["mean"].shape[0]
            jp[k]["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
            jp[k]["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
    tp = params_from_jax(jp, device="cpu")
    x = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    jx = jnp.asarray(x)
    jtree = jax.tree_util.tree_map(jnp.asarray, jp)

    y, stats = m.apply(tp, _t(x), train=True)
    jy, jstats = jcs.apply(jtree, jx, jcfg, train=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5)
    for k in jstats:
        for s in ("mean", "var"):
            np.testing.assert_allclose(stats[k][s].numpy(), np.asarray(jstats[k][s]), atol=1e-5)
    np.testing.assert_allclose(m.apply(tp, _t(x)).numpy(),
                               np.asarray(jcs.apply(jtree, jx, jcfg)), atol=1e-5)
    fused = tcs.fuse(tp, m.config)
    jfused = jcs.fuse(jtree, jcfg)
    for k in jfused:
        for leaf in jfused[k]:
            np.testing.assert_allclose(fused[k][leaf].numpy(), np.asarray(jfused[k][leaf]),
                                       atol=1e-6)
    for order in (False, True):
        got = tcs.apply_fused(fused, _t(x), m.config, relu_before_residual_add=order)
        want = jcs.apply_fused(jfused, jx, jcfg, relu_before_residual_add=order)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(tcs.apply_fused(fused, _t(x), m.config).numpy(),
                               m.apply(tp, _t(x)).numpy(), atol=1e-5)
