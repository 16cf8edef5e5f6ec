"""The port's VGG self-training against the JAX package's, on the CPU.

- one Adam step of the autoencoder (fp32 on both sides, JAX's random VGG and
  decoder carried across, two 32x32 patches): the loss within 1e-5
  relative; Adam's first moment (0.1 g) within 1e-4 relative plus 1e-5 of
  each leaf's largest; every parameter within 1e-5 where |g| >= 1e-7, and
  within one step's size (lr) everywhere. The first Adam step is
  lr g / (|g| + 1e-8): where |g| is near 1e-8, fp32's rounding of g moves
  it by up to lr / 4, so there the moment holds the gradient instead;
- ``measure_tap_rms`` within 1e-5 relative of JAX's, and ``rescale_taps``
  bringing each tap to its target within 1e-5 relative;
- ``save_asset`` round-trips through the port's ``init_vgg16``;
- ``random_baseline_rms`` is the asset JSON's stored target.
"""
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.losses import vgg as jvgg
from fs_uae_image_enhancer_project_tpu.losses import vgg_selftrain as jst
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax, params_to_numpy
from fs_uae_image_enhancer_project_tpu_torch.losses import vgg
from fs_uae_image_enhancer_project_tpu_torch.losses import vgg_selftrain as st

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _patches(seed, shape=(2, 32, 32, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_autoencoder_step_matches_jax(monkeypatch):
    import optax

    enc, dec = _np(jvgg._random_init(jax.random.key(0))), _np(jst.init_decoder(jax.random.key(1)))
    x = _patches(1)
    # the JAX step in fp32 (its autoencode defaults to bf16)
    monkeypatch.setattr(jst, "autoencode", functools.partial(jst.autoencode,
                                                             compute_dtype=jnp.float32))
    opt = optax.adam(1e-3)
    opt_state = opt.init({"enc": enc, "dec": dec})
    jstate, jenc, jdec, jloss = jax.jit(jst.make_train_step(opt))(opt_state, enc, dec,
                                                                  jnp.asarray(x))
    mu = _np(jstate[0].mu)

    penc, pdec = params_from_jax(enc, device="cpu"), params_from_jax(dec, device="cpu")
    recon = st.autoencode(penc, pdec, torch.from_numpy(x), compute_dtype=torch.float32)
    assert recon.shape == x.shape and recon.dtype == torch.float32
    step = st.make_train_step(penc, pdec, 1e-3, compute_dtype=torch.float32)
    loss = step(torch.from_numpy(x))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    opt_state = step.optimizer.state
    for got, want, m in ((penc, _np(jenc), mu["enc"]), (pdec, _np(jdec), mu["dec"])):
        for g, w, mm in zip(got, want, m):
            for k in ("w", "b"):
                exp_avg = opt_state[g[k]]["exp_avg"].numpy()
                np.testing.assert_allclose(exp_avg, mm[k], rtol=1e-4,
                                           atol=1e-5 * np.abs(mm[k]).max())
                decided = np.abs(mm[k]) >= 1e-8  # |g| >= 1e-7
                p = g[k].detach().numpy()
                np.testing.assert_allclose(p[decided], w[k][decided], atol=1e-5, rtol=0)
                np.testing.assert_allclose(p, w[k], atol=1e-3, rtol=0)  # one step's size
    # a few more steps lower the loss (bf16, the training default)
    penc, pdec = params_from_jax(enc, device="cpu"), params_from_jax(dec, device="cpu")
    step = st.make_train_step(penc, pdec, 1e-3)
    losses = [float(step(torch.from_numpy(x))) for _ in range(5)]
    assert losses[-1] < losses[0]


def test_tap_rms_and_rescale_match_jax():
    enc = _np(jvgg._random_init(jax.random.key(2)))
    probe = _patches(2)
    penc = params_from_jax(enc, device="cpu")
    np.testing.assert_allclose(st.measure_tap_rms(penc, probe), jst.measure_tap_rms(enc, probe),
                               rtol=1e-5)
    target = [1.0, 2.0, 4.0, 8.0]
    scaled = st.rescale_taps(penc, probe, target)
    np.testing.assert_allclose(st.measure_tap_rms(scaled, probe), target, rtol=1e-5)
    want = jst.rescale_taps(enc, probe, target)
    for g, w in zip(params_to_numpy(scaled), _np(want)):
        np.testing.assert_allclose(g["w"], w["w"], rtol=1e-5, atol=1e-7)
    # rescaling returns new tensors and leaves its input alone
    assert torch.equal(penc[0]["w"], torch.tensor(enc[0]["w"]))


def test_asset_round_trip_and_baseline(tmp_path, monkeypatch):
    enc = params_from_jax(_np(jvgg._random_init(jax.random.key(3))), device="cpu")
    path = str(tmp_path / "vgg16_features_selftrained.npz")
    st.save_asset(enc, path)
    monkeypatch.setattr(vgg, "_ASSET", str(tmp_path / "missing.npz"))
    monkeypatch.setattr(vgg, "_ASSET_SELFTRAINED", path)
    loaded = vgg.init_vgg16(device="cpu")
    assert len(loaded) == len(enc) == 12
    for a, b in zip(loaded, enc):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    with open(os.path.join(REPO, "assets", "vgg16_features_selftrained.json")) as f:
        stored = json.load(f)["tap_rms_target_random"]
    assert st.random_baseline_rms(_patches(0)) == stored and len(stored) == 4


def test_chip_smoke_tools_phase_on_the_cpu():
    """chip_smoke.py's tools phase rehearsed on the CPU at a small size (on
    a card: 20 steps at the asset's 128x128 patches, batch 32): the checks
    pass, K1 is never launched on the CPU, and a rising loss, a calibration
    off its target, a frame that is not the enhance's or a dump that misses
    a node fail them."""
    import chip_smoke as cs

    cpu = torch.device("cpu")
    rec = cs.tools(cpu, vgg_steps=4, vgg_batch=4, vgg_patch=64)
    cs.check_tools(rec, cpu)
    assert rec["raw_runner"]["k1_launches"] == 0
    assert rec["onnx_tools"]["nodes"] == 58
    json.dumps(rec)  # printable as the phase's line
    v, r, o = rec["vgg_selftrain"], rec["raw_runner"], rec["onnx_tools"]
    for bad in ({"vgg_selftrain": dict(v, loss_last=v["loss_first"] + 1)},
                {"vgg_selftrain": dict(v, tap_rel_err=2e-4)},
                {"vgg_selftrain": dict(v, asset_round_trip=False)},
                {"raw_runner": dict(r, png_equal=False)},
                {"raw_runner": dict(r, k1_launches=1)},
                {"onnx_tools": dict(o, dump_nodes=57)}):
        with pytest.raises(AssertionError):
            cs.check_tools({**rec, **bad}, cpu)
