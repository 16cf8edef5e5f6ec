"""The port's losses against the JAX package's and the torch-made goldens.

Same seeded numpy inputs through both packages, on the CPU, fp32:
- ``functional.py``: rel 1e-5, abs 1e-6;
- ``ssim``, ``ms_ssim`` (at >= 176 px) and ``ssim_loss``: rel 1e-5;
- the VGG taps against ``tests/goldens/vgg_goldens.npz``: abs 5e-5 x the
  tap's scale, as ``tests/test_losses.py`` holds the JAX package (weights
  regenerated the same way); the three golden loss configs: rel 1e-4;
- the perceptual criterion's gradient with respect to the output against
  ``jax.grad``: max abs difference <= 1e-5 x max |g|.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu import losses as J
from fs_uae_image_enhancer_project_tpu.losses import vgg as jvgg
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu_torch import losses as T
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.losses import vgg as tvgg
from fs_uae_image_enhancer_project_tpu_torch.models import get_model

G = np.load(os.path.join(os.path.dirname(__file__), "goldens", "vgg_goldens.npz"))
RNG = np.random.default_rng(17)
REL, ABS = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0, 1, shape).astype(np.float32)
    return o, np.clip(o + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)


@pytest.mark.parametrize("name", ["l1_loss", "charbonnier_loss", "laplacian_hf_loss",
                                  "rgb_to_ycbcr", "luminance_loss"])
def test_functional_matches_jax(name):
    o, t = _pair((2, 12, 10, 3), 1)
    tf, jf = getattr(T, name), getattr(J, name)
    if name == "rgb_to_ycbcr":
        got, want = tf(_t(o)).numpy(), np.asarray(jf(jnp.asarray(o)))
    else:
        got, want = tf(_t(o), _t(t)).numpy(), np.asarray(jf(jnp.asarray(o), jnp.asarray(t)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=REL, atol=ABS)


def test_charbonnier_epsilon_and_shape_check():
    o, t = _pair((1, 4, 4, 3), 2)
    got = T.charbonnier_loss(_t(o), _t(t), 1e-2).item()
    want = float(J.charbonnier_loss(jnp.asarray(o), jnp.asarray(t), 1e-2))
    assert got == pytest.approx(want, rel=REL)
    with pytest.raises(ValueError):
        T.charbonnier_loss(_t(o), _t(t[:, :2]))


@pytest.mark.parametrize("shape", [(1, 176, 176, 3), (2, 192, 180, 3)])
def test_ssim_and_ms_ssim_match_jax(shape):
    o, t = _pair(shape, 3)
    for tf, jf in ((T.ssim, J.ssim), (T.ms_ssim, J.ms_ssim)):
        got = tf(_t(o), _t(t)).item()
        want = float(jf(jnp.asarray(o), jnp.asarray(t)))
        assert got == pytest.approx(want, rel=REL), tf.__name__
    assert T.ms_ssim(_t(o), _t(o)).item() == pytest.approx(1.0, abs=1e-4)


def test_ms_ssim_averages_the_batch_before_the_product():
    """The JAX package's order: each scale's term is the batch mean, and the
    product runs over those means (not the mean of per-image products)."""
    o, t = _pair((2, 176, 176, 3), 4)
    t[1] = np.clip(o[1] + 0.4 * RNG.normal(size=o[1].shape), 0, 1)
    got = T.ms_ssim(_t(o), _t(t)).item()
    per_image = np.mean([T.ms_ssim(_t(o[i:i + 1]), _t(t[i:i + 1])).item() for i in range(2)])
    assert got == pytest.approx(float(J.ms_ssim(jnp.asarray(o), jnp.asarray(t))), rel=REL)
    assert abs(got - per_image) > 1e-4


@pytest.mark.parametrize("side", [64, 168, 175])
def test_ms_ssim_guard_raises_below_176(side):
    x = _t(RNG.uniform(0, 1, (1, side, 200, 3)))
    with pytest.raises(ValueError, match="176"):
        T.ms_ssim(x, x)
    with pytest.raises(ValueError):
        J.ms_ssim(jnp.asarray(x.numpy()), jnp.asarray(x.numpy()))


@pytest.mark.parametrize("kw", [{}, {"pixel_loss_type": "charbonnier"},
                                {"convert_to_linear_for_ssim": True, "ssim_weight": 0.3}])
def test_ssim_loss_matches_jax(kw):
    o, t = _pair((2, 24, 20, 3), 5)
    got = T.ssim_loss(_t(o), _t(t), **kw).item()
    want = float(J.ssim_loss(jnp.asarray(o), jnp.asarray(t), **kw))
    assert got == pytest.approx(want, rel=REL)
    with pytest.raises(ValueError):
        T.ssim_loss(_t(o), _t(t), pixel_loss_type="nope")


def _regen_torch_vgg_state():
    """The golden's He-normal OIHW weights, regenerated bit for bit as
    ``tests/test_losses.py`` does (tests/golden_gen/gen_vgg_goldens.py)."""
    rng = np.random.default_rng(20260818)
    state = {}
    cin = 3
    for i, kind, cout in tvgg.VGG16_LAYOUT:
        if kind != "conv":
            continue
        std = np.sqrt(2.0 / (cin * 9))
        state[f"features.{i}.weight"] = rng.normal(0.0, std, (cout, cin, 3, 3)).astype(np.float32)
        state[f"features.{i}.bias"] = rng.normal(0.0, 0.01, (cout,)).astype(np.float32)
        cin = cout
    return state


@pytest.fixture(scope="module")
def golden_vgg(tmp_path_factory):
    asset = str(tmp_path_factory.mktemp("vgg") / "vgg16_features.npz")
    tvgg.convert_torchvision_state_dict(_regen_torch_vgg_state(), asset)
    return tvgg._load_asset(asset, "cpu"), jvgg._load_asset(asset)


def _golden_inputs():
    return (np.transpose(G["input_o"], (0, 2, 3, 1)), np.transpose(G["input_t"], (0, 2, 3, 1)))


def test_vgg_layout_matches_jax():
    assert tvgg.VGG16_LAYOUT == jvgg.VGG16_LAYOUT
    assert tvgg.TAP_INDICES == jvgg.TAP_INDICES and tvgg.TAP_WEIGHTS == jvgg.TAP_WEIGHTS
    assert tvgg.VGG_MEAN == jvgg.VGG_MEAN and tvgg.VGG_STD == jvgg.VGG_STD
    x = RNG.uniform(0, 1, (1, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(tvgg.normalize(_t(x)).numpy(),
                               np.asarray(jvgg.normalize(jnp.asarray(x))), rtol=REL, atol=1e-4)


def test_vgg_taps_match_golden(golden_vgg):
    tparams, _ = golden_vgg
    o, _ = _golden_inputs()
    feats = tvgg.extract_features(tparams, tvgg.normalize(_t(o)))
    assert len(feats) == 4
    for tap, got in zip(tvgg.TAP_INDICES, feats):
        want = np.transpose(G[f"tap_{tap}"], (0, 2, 3, 1))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy(), want, atol=5e-5 * max(scale, 1.0), rtol=0,
                                   err_msg=f"tap {tap}")


GOLDEN_CONFIGS = {
    "loss_srgb_l1_vgg": dict(pixel_loss_weight=0.990, vgg_weight=0.007,
                             pixel_loss_type="l1", high_frequency_weight=0.003),
    "loss_srgb_charb_lum": dict(pixel_loss_weight=1.0, vgg_weight=0.006,
                                pixel_loss_type="charbonnier", lambda_lum=0.05),
    "loss_linear_all": dict(pixel_loss_weight=0.990, vgg_weight=0.007,
                            pixel_loss_type="charbonnier", high_frequency_weight=0.003,
                            lambda_lum=0.02, input_is_linear=True),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CONFIGS))
def test_perceptual_loss_matches_golden_and_jax(golden_vgg, name):
    tparams, jparams = golden_vgg
    o, t = _golden_inputs()
    crit = T.make_perceptual_loss(T.PerceptualConfig(**GOLDEN_CONFIGS[name]), tparams)
    got = crit(_t(o), _t(t)).item()
    assert got == pytest.approx(float(G[name]), rel=1e-4)
    jcrit = J.make_perceptual_loss(J.PerceptualConfig(**GOLDEN_CONFIGS[name]), jparams)
    assert got == pytest.approx(float(jcrit(jnp.asarray(o), jnp.asarray(t))), rel=1e-4)


@pytest.mark.parametrize("name,zeros", [("loss_linear_all", True), ("loss_srgb_l1_vgg", False),
                                        ("loss_srgb_charb_lum", False)])
def test_perceptual_gradient_matches_jax(golden_vgg, name, zeros):
    """d loss / d output against ``jax.grad`` on the golden pair; in the
    linear case with exact zeros in the output (a ReLU model's black
    pixels), which the eps clamp and ``clip``'s half derivative meet.

    Through VGG's ReLUs and max-pools and the L1s the gradient is piecewise:
    where a kink lies within rounding of its input, the side it takes follows
    each package's last bits (of the pow before VGG, of a conv's summation
    order), and one such element moves the gradient by about 1e-5 absolute.
    The golden pair in the linear config without the zeros has one (4.8e-4
    x max |g|); these three cases have none."""
    tparams, jparams = golden_vgg
    cfg = GOLDEN_CONFIGS[name]
    o, t = _golden_inputs()
    if zeros:
        o = o.copy()
        o[:, :4, :4] = 0.0
    jcrit = J.make_perceptual_loss(J.PerceptualConfig(**cfg), jparams)
    jg = np.asarray(jax.grad(jcrit)(jnp.asarray(o), jnp.asarray(t)))
    x = _t(o).requires_grad_()
    T.make_perceptual_loss(T.PerceptualConfig(**cfg), tparams)(x, _t(t)).backward()
    g = x.grad.numpy()
    assert np.isfinite(g).all()
    assert np.abs(g - jg).max() <= 1e-5 * np.abs(jg).max()


def test_init_vgg16_loads_the_committed_asset_as_jax_does():
    got = tvgg.init_vgg16("cpu")
    want = jvgg.init_vgg16()
    assert len(got) == len(want) == len(tvgg.conv_indices()) == 12
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["w"].numpy(), np.asarray(b["w"]))
        np.testing.assert_array_equal(a["b"].numpy(), np.asarray(b["b"]))


def test_init_vgg16_without_an_asset_raises(monkeypatch, tmp_path):
    """Without either asset, init_vgg16 no longer raises: it warns and falls
    back to the JAX package's fixed-seed random basis, as JAX's does
    (tests/test_torch_train_drivers.py holds the basis to JAX's)."""
    monkeypatch.setattr(tvgg, "_ASSET", str(tmp_path / "none.npz"))
    monkeypatch.setattr(tvgg, "_ASSET_SELFTRAINED", str(tmp_path / "none_either.npz"))
    with pytest.warns(UserWarning, match="no vgg16 asset"):
        got = tvgg.init_vgg16("cpu")
    want = tvgg._random_init(device="cpu")
    assert len(got) == len(want) == 12
    for a, b in zip(got, want):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    with pytest.warns(UserWarning, match="FIXED-SEED RANDOM VGG"):
        crit = T.make_perceptual_loss(T.PerceptualConfig(vgg_weight=0.1), device="cpu")
    assert np.isfinite(crit(torch.zeros(1, 16, 16, 3), torch.ones(1, 16, 16, 3)).item())
    # without VGG, no asset is needed
    crit = T.make_perceptual_loss(T.PerceptualConfig(vgg_weight=0.0), device="cpu")
    assert np.isfinite(crit(torch.zeros(1, 4, 4, 3), torch.ones(1, 4, 4, 3)).item())


def test_params_from_jax_takes_lists(golden_vgg):
    """VGG's parameters are a list of dicts: through params_from_jax and back."""
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_to_numpy

    _, jparams = golden_vgg
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    assert isinstance(got, list) and len(got) == 12
    back = params_to_numpy(got)
    for a, b in zip(back, jparams):
        np.testing.assert_array_equal(a["w"], np.asarray(b["w"]))


@pytest.mark.parametrize("name", ["pix_shuffle", "conv3", "conv5"])
def test_build_criterion_from_model_specs_matches_jax(name):
    """Each model's own criterion (pix_shuffle and conv3 with VGG on the
    committed self-trained asset, conv5 the SSIM loss) on the same pair."""
    m, jm = get_model(name), jax_model(name)
    assert dataclasses.asdict(m.loss) == dataclasses.asdict(jm.loss)
    o, t = _pair((1, 32, 32, 3), 6)
    got = T.build_criterion(m.loss, device="cpu")(_t(o), _t(t)).item()
    want = float(J.build_criterion(jm.loss)(jnp.asarray(o), jnp.asarray(t)))
    assert got == pytest.approx(want, rel=1e-4)
    with pytest.raises(ValueError):
        T.build_criterion(dataclasses.replace(m.loss, kind="nope"))
