"""The port's other model families against the JAX package's, on the CPU.

- blocks: the residual feature block and the dense block against the
  reference goldens (``feature_block_goldens.npz``, ``dense_block_goldens.npz``)
  at the tolerances of ``tests/test_models.py``; triplet attention, which the
  dense goldens stub out, against the JAX function on the same weights;
- the residual U-Net against ``unet_model_goldens.npz`` (light, heavy and a
  learnable-activation config), with the weights regenerated by the goldens'
  own numpy scheme;
- conv6 and both U-Net variants against the JAX ``apply`` on the same
  weights (``interop.params_from_jax``), within 1e-5 of max |y| in fp32;
- the registry, the configs' JSON, conv3's uint8 contract;
- one fp32 train step of conv6 and of the lightweight U-Net (the pixel
  loss only) against the JAX step.
"""
import dataclasses
import json
import os
import zlib

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.models import blocks as jblocks
from fs_uae_image_enhancer_project_tpu.models import configs as jconfigs
from fs_uae_image_enhancer_project_tpu.models import conv_stack as jconv_stack
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax, params_to_numpy
from fs_uae_image_enhancer_project_tpu_torch.models import blocks, configs, conv_stack
from fs_uae_image_enhancer_project_tpu_torch.models import count_params, get_model
from fs_uae_image_enhancer_project_tpu_torch.models import residual_unet as ru

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _hwio(a):
    return _t(np.transpose(a, (2, 3, 1, 0)))


def _jax_tree(name, variant="lightweight", seed=0):
    jm = jax_model(name, variant)
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(seed)))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_feature_block_matches_reference_golden():
    g = np.load(os.path.join(GOLDENS, "feature_block_goldens.npz"))

    def conv(tag, name):
        return {"w": _hwio(g[f"{tag}_w_{name}.weight"]), "b": _t(g[f"{tag}_w_{name}.bias"])}

    # plain: in 8, mid 12, out 8, the default acts
    p = {f"conv{i}": conv("plain", f"conv{i}") for i in (1, 2, 3)}
    p.update({f"act{i}": {} for i in (1, 2, 3, 4)})
    y = blocks.apply_feature_block(p, _t(_nhwc(g["plain_x"])), blocks.DEFAULT_BLOCK_ACTS, 12, 8)
    np.testing.assert_allclose(y.numpy(), _nhwc(g["plain_y"]), atol=2e-5, rtol=1e-5)

    # proj: in 8, mid 12, out 16; a channel prelu in act2, a global one in act4
    acts = (("identity", ()), ("prelu", (("num_parameters", "channel"),)),
            ("identity", ()), ("prelu", (("num_parameters", "global"),)))
    p2 = {f"conv{i}": conv("proj", f"conv{i}") for i in (1, 2, 3)}
    p2.update(act1={}, act3={}, proj=conv("proj", "proj_conv"),
              act2={"slope": _t(g["proj_w_act2.weight"].reshape(-1))},
              act4={"slope": _t(g["proj_w_act4.weight"].reshape(-1))})
    y2 = blocks.apply_feature_block(p2, _t(_nhwc(g["proj_x"])), acts, 12, 16)
    np.testing.assert_allclose(y2.numpy(), _nhwc(g["proj_y"]), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("tag,n_convs,has_adjust", [
    ("match", 3, False), ("adjust", 2, True), ("prelu", 2, False)])
def test_dense_block_matches_reference_golden(tag, n_convs, has_adjust):
    g = np.load(os.path.join(GOLDENS, "dense_block_goldens.npz"))
    prelu = tag == "prelu"
    p = {}
    for i in range(n_convs):
        p[f"conv{i + 1}"] = {"w": _hwio(g[f"{tag}_w_dense_layers.{3 * i}.weight"]),
                             "b": _t(g[f"{tag}_w_dense_layers.{3 * i}.bias"])}
        p[f"l{i + 1}_act1"] = (
            {"slope": _t(g[f"{tag}_w_dense_layers.{3 * i + 1}.weight"].reshape(-1))}
            if prelu else {})
        p[f"l{i + 1}_act2"] = {}
    p["fusion"] = {"w": _hwio(g[f"{tag}_w_dense_feature_fusion.weight"]),
                   "b": _t(g[f"{tag}_w_dense_feature_fusion.bias"])}
    if has_adjust:
        p["adjust"] = {"w": _hwio(g[f"{tag}_w_local_residual_adjustment.weight"]),
                       "b": _t(g[f"{tag}_w_local_residual_adjustment.bias"])}
    acts = ((("prelu", (("num_parameters", "channel"),)), ("identity", ())) if prelu
            else blocks.DENSE_DEFAULT_ACTS)
    y = blocks.apply_dense_block(p, _t(_nhwc(g[f"{tag}_x"])), n_convs=n_convs, acts=acts)
    np.testing.assert_allclose(y.numpy(), _nhwc(g[f"{tag}_y"]), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 6, 10, 8), (2, 9, 5, 12)])
def test_triplet_attention_and_dense_block_match_jax(shape):
    """Triplet attention's three rotations (NHWC axes), alone and inside a
    dense block with a projection, on the JAX init's weights: a wrong
    permute moves the result by far more than 1e-5."""
    key = jax.random.key(3)
    jp = jax.tree_util.tree_map(np.asarray, jblocks.init_triplet_attention(key))
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(jblocks.apply_triplet_attention(jp, jnp.asarray(x)))
    got = blocks.apply_triplet_attention(params_from_jax(jp, device="cpu"), _t(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    acts = (("prelu", (("num_parameters", "channel"),)), ("identity", ()))
    jd = jax.tree_util.tree_map(np.asarray, jblocks.init_dense_block(
        key, shape[-1], 10, growth=6, n_convs=2, acts=acts, use_attention=True))
    td = blocks.init_dense_block(shape[-1], 10, growth=6, n_convs=2, acts=acts,
                                 use_attention=True, device="cpu")
    assert jax.tree_util.tree_map(np.shape, params_to_numpy(td)) == \
        jax.tree_util.tree_map(np.shape, jd)
    want = np.asarray(jblocks.apply_dense_block(jd, jnp.asarray(x), n_convs=2, acts=acts))
    got = blocks.apply_dense_block(params_from_jax(jd, device="cpu"), _t(x), n_convs=2,
                                   acts=acts)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())


def test_resolve_block_acts_matches_jax():
    acts = (("prelu", (("num_parameters", "channel"),)), ("relu", ()),
            ("biased_relu", (("num_parameters", "global"),)), ("identity", ()))
    assert blocks.resolve_block_acts(acts, 12, 16) == jblocks.resolve_block_acts(acts, 12, 16)
    assert blocks.resolve_dense_acts(acts[:2], 7) == jblocks.resolve_dense_acts(acts[:2], 7)
    with pytest.raises(ValueError):
        blocks.init_feature_block(4, 4, 4, 2, device="cpu")


# ---------------------------------------------------------------------------
# the residual U-Net against the reference goldens
# ---------------------------------------------------------------------------

def _regen(key, shape):
    """The goldens' weights: per-key crc32-seeded numpy, fan-in scaled
    (tests/golden_gen/gen_unet_model_goldens.py)."""
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    v = rng.standard_normal(shape).astype(np.float32)
    if len(shape) == 4:  # OIHW conv weight
        v /= np.sqrt(shape[1] * shape[2] * shape[3])
    else:
        v *= 0.25
    return v


def _unet_params_from_manifest(tag, manifest, cfg):
    def get(name):
        return _regen(f"{tag}/{name}", tuple(manifest[name]))

    def conv(prefix):
        return {"w": _hwio(get(f"{prefix}.weight")), "b": _t(get(f"{prefix}.bias"))}

    def block(prefix):
        p = {f"conv{i}": conv(f"{prefix}.conv{i}") for i in (1, 2, 3)}
        if f"{prefix}.proj_conv.weight" in manifest:
            p["proj"] = conv(f"{prefix}.proj_conv")
        for i in (1, 2, 3, 4):
            wname = f"{prefix}.act{i}.weight"
            p[f"act{i}"] = {"slope": _t(get(wname).reshape(-1))} if wname in manifest else {}
        return p

    p = {"stem": conv("first_pixel_unshuffle_and_conv.1")}
    for d in range(cfg.unet_depth):
        for i in range(cfg.blocks_per_level):
            p[f"enc{d}_block{i}"] = block(f"encoder_block_sequences.{d}.{i}")
    for i in range(cfg.blocks_per_level):
        p[f"bottleneck_block{i}"] = block(f"bottleneck.{i}")
    for i in range(cfg.unet_depth - 1):
        for j in range(cfg.blocks_per_level):
            p[f"dec{i}_block{j}"] = block(f"decoder_block_sequences.{i}.{j}")
    p["dec_final"] = conv(f"decoder_block_sequences.{cfg.unet_depth - 1}.0")
    return p


@pytest.mark.parametrize("tag", ["light", "heavy", "acts"])
def test_residual_unet_matches_reference_golden(tag):
    g = np.load(os.path.join(GOLDENS, "unet_model_goldens.npz"))
    cfg = {
        "light": ru.lightweight_config(),
        "heavy": ru.heavyweight_config(),
        "acts": configs.ResidualUNetConfig(
            base_channels=8, unet_depth=2, blocks_per_level=2,
            internal_block_channels_ratio=0.75,
            acts=(("telu", ()), ("prelu", (("num_parameters", "channel"),)),
                  ("identity", ()), ("prelu", (("num_parameters", "global"),)))),
    }[tag]
    manifest = json.loads(bytes(g[f"{tag}_manifest"]).decode())
    p = _unet_params_from_manifest(tag, manifest, cfg)
    with torch.no_grad():
        y = ru.apply(p, _t(_nhwc(g[f"{tag}_x"])), cfg)
    tol = dict(atol=5e-4, rtol=5e-4) if tag == "heavy" else dict(atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(y.numpy(), _nhwc(g[f"{tag}_y"]), **tol)


# ---------------------------------------------------------------------------
# conv6 and the U-Net against the JAX apply
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,variant,shape", [
    ("conv6", "lightweight", (2, 12, 20, 3)),
    ("residual_unet", "lightweight", (1, 16, 24, 3)),
    ("residual_unet", "heavyweight", (1, 16, 16, 3)),
])
def test_forward_fp32_matches_jax(name, variant, shape):
    jm, tree = _jax_tree(name, variant)
    m = get_model(name, variant)
    assert dataclasses.asdict(m.config) == dataclasses.asdict(jm.config)
    # init's structure and shapes are the JAX init's (empty dicts included)
    with torch.device("meta"):
        fresh = m.init(device="meta")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), fresh) == \
        jax.tree_util.tree_map(np.shape, tree)
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    with torch.no_grad():
        got = m.apply(params_from_jax(tree, device="cpu"), _t(x)).numpy()
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_unet_refuses_sizes_not_divisible_by_two_to_the_depth():
    m = get_model("residual_unet")
    p = m.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="2\\^depth=8"):
        m.apply(p, torch.zeros(1, 16, 20, 3))


def test_conv6_imported_dicts_may_omit_parameter_free_slots():
    m = get_model("conv6")
    p = m.init(torch.Generator().manual_seed(1), device="cpu")
    x = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(2))
    slim = {k: v for k, v in p.items() if v}
    assert len(slim) < len(p)
    assert torch.equal(m.apply(slim, x), m.apply(p, x))


def test_init_is_seeded_and_counts_match_jax():
    for name, variant in (("conv6", "lightweight"), ("residual_unet", "lightweight")):
        m = get_model(name, variant)
        a = m.init(torch.Generator().manual_seed(5), device="cpu")
        b = m.init(torch.Generator().manual_seed(5), device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(jax.tree_util.tree_leaves(a),
                                                     jax.tree_util.tree_leaves(b)))
        _, tree = _jax_tree(name, variant)
        assert count_params(a) == sum(int(v.size) for v in jax.tree_util.tree_leaves(tree))


def test_registry_errors_match_jax():
    for name, variant in (("nope", "lightweight"), ("pix_shuffle", "medium"),
                          ("conv6", "heavyweight"), ("conv6_heavy", "lightweight")):
        with pytest.raises(ValueError) as want:
            jax_model(name, variant)
        with pytest.raises(ValueError) as got:
            get_model(name, variant)
        assert str(got.value) == str(want.value)
    for name in ("conv6", "residual_unet", "residual_unet_heavy"):
        m, jm = get_model(name), jax_model(name)
        assert (m.name, m.variant, m.linear_io) == (jm.name, jm.variant, jm.linear_io)
        assert dataclasses.asdict(m.loss) == dataclasses.asdict(jm.loss)


@pytest.mark.parametrize("name", ["pix_shuffle", "conv3_heavy", "conv5", "conv6",
                                  "residual_unet_heavy"])
def test_config_json_is_the_jax_text_and_round_trips(name):
    cfg = get_model(name).config
    text = configs.config_to_json(cfg)
    assert text == jconfigs.config_to_json(jax_model(name).config)
    assert configs.config_from_json(text) == cfg
    assert jconfigs.config_from_json(text) == jax_model(name).config


def test_conv3_uint8_rgba_contract_matches_jax():
    jm, tree = _jax_tree("conv3", seed=2)
    jfused = jconv_stack.fuse(tree, jm.config)
    m = get_model("conv3")
    fused = conv_stack.fuse(params_from_jax(tree, device="cpu"), m.config)
    x = np.random.default_rng(4).integers(0, 256, (1, 10, 14, 4), dtype=np.uint8)
    want = np.asarray(jconv_stack.apply_uint8_rgba(jfused, jnp.asarray(x), jm.config))
    got = conv_stack.apply_uint8_rgba(fused, torch.from_numpy(x), m.config).numpy()
    assert got.shape == (1, 10, 14, 4)
    np.testing.assert_array_equal(got[..., 3], 255.0)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="FUSED"):
        conv_stack.apply_uint8_rgba(params_from_jax(tree, device="cpu"),
                                    torch.from_numpy(x), m.config)
    with pytest.raises(ValueError, match="RGBA"):
        conv_stack.apply_uint8_rgba(fused, torch.from_numpy(x[..., :3]), m.config)


# ---------------------------------------------------------------------------
# one train step of the new families
# ---------------------------------------------------------------------------

def _capture_grads():
    """An optax transformation that keeps the step's gradients as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("name", ["conv6", "residual_unet"])
def test_fp32_train_step_matches_jax(name):
    """One step, 2 micro-batches of 16x16 crops, the pixel loss only
    (Charbonnier, linear light). The gradient is piecewise at the ReLU-family
    kinks; the seeded weights and crops (seeds 0) put no pre-activation
    within fp32 rounding of a kink, so both packages take the same side."""
    from fs_uae_image_enhancer_project_tpu.data.dataset import batch_transform as jbt
    from fs_uae_image_enhancer_project_tpu.losses import build_criterion as jcrit
    from fs_uae_image_enhancer_project_tpu.models import LossSpec as JLossSpec
    from fs_uae_image_enhancer_project_tpu.parallel import train_step as J
    from fs_uae_image_enhancer_project_tpu_torch.data.dataset import batch_transform
    from fs_uae_image_enhancer_project_tpu_torch.losses import build_criterion
    from fs_uae_image_enhancer_project_tpu_torch.models import LossSpec, train_apply
    from fs_uae_image_enhancer_project_tpu_torch.parallel import train_step as T

    spec = dict(kind="perceptual", pixel_loss_weight=1.0, pixel_loss_type="charbonnier",
                input_is_linear=True)
    jm, tree = _jax_tree(name)
    rng = np.random.default_rng(0)
    hr = rng.integers(0, 256, (2, 1, 16, 16, 3), dtype=np.uint8)
    lr = ((hr // 32) * 32).astype(np.uint8)

    state = J.init_train_state(jax.tree_util.tree_map(jnp.asarray, tree), _capture_grads())
    step = jax.jit(J.make_train_step(jm.apply, jcrit(JLossSpec(**spec)), _capture_grads(),
                                     compute_dtype=jnp.float32,
                                     input_transform=jbt(jm.linear_io)))
    new, want_loss = step(state, jnp.asarray(lr), jnp.asarray(hr))
    want = jax.tree_util.tree_map(np.asarray, new.opt_state)

    m = get_model(name)
    tstate = T.init_train_state(params_from_jax(tree, device="cpu"),
                                T.make_optimizer(lr=0.0, weight_decay=0.0))
    tstep = T.make_train_step(train_apply(m), build_criterion(LossSpec(**spec), device="cpu"),
                              compute_dtype=torch.float32,
                              input_transform=batch_transform(m.linear_io))
    tstate, loss = tstep(tstate, torch.from_numpy(lr), torch.from_numpy(hr))
    assert loss.item() == pytest.approx(float(want_loss), rel=1e-5)
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy(), tstate.params)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = jax.tree_util.tree_leaves_with_path(grads)
    assert len(flat_g) == len(flat_w) > 0
    for path, g in flat_g:
        w = flat_w[path]
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), (path, np.abs(g - w).max())
