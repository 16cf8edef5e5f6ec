"""The port's training and NAS drivers and the random VGG basis they train
under, against the JAX package and the repo's root ``scripts/``, on the CPU,
at small sizes (a seeded tree of 32x32 or 64x48 pairs that numpy makes):

- ``utils.threefry``: ``key``, ``split(k, n)``, 32-bit ``random_bits`` and
  ``uniform`` bit-equal to ``jax.random``'s for several seeds and shapes, odd
  sizes included; ``normal`` within 4 ulp (XLA's log1p rounds apart);
- the basis: ``vgg._random_init()`` against the JAX package's layer by layer
  within 4 ulp; the perceptual loss under each within 1e-5 relative;
  ``init_vgg16`` falling back to it with JAX's warning where neither asset
  exists;
- the fault the basis repairs: on a probe that is not the asset's,
  ``random_baseline_rms`` within 1e-5 relative of JAX's, where the stored
  values the port used to return are more than 1e-3 off;
- ``init_decoder`` bit-equal to JAX's; ``clipped_adamw`` against the optax
  chain over 6 updates on a toy tree (update 0 at learning rate 0, one update
  the clip scales, one it does not) within 1e-6 relative, its schedule within
  1e-6 relative of optax's;
- each driver's ``main`` against its root script: ``train_vgg_features``
  (3 steps, patch 32, batch 2: the logged losses within 2e-2 relative, the
  bf16 autoencoder's rounding apart; the same ``latest.npz``, asset and meta
  keys and shapes, and the port resuming from its checkpoint), ``training_parity_study`` (one epoch a leg: the summary's keys
  and structure; the ``superseded_by`` branch equal to the root's for a
  stale corpus tag), ``plot_training_parity`` (the points JSON equal to the
  root's on the committed CSV; exit 1 naming matplotlib without it),
  ``train_nas_winner`` (the winner's ``config_to_json`` and parameter count
  equal to JAX's from ``artifacts/nas_r5/best_trial.json``; its report's
  keys), ``nas_demo_r2`` (``NAS_TRIALS=2``: the summary's keys and a cache
  hit; the plots named where matplotlib does not import),
  ``convert_vgg16_weights`` (a stand-in ``torchvision.models``: both scripts
  write equal arrays; both exit 1 without it), ``probe_transfer_retention``
  (its fields);
- ``chip_smoke.py``'s ``train_drivers`` phase rehearsed at a small size (every
  trainer pinning the random basis, the pid registered), and its checks
  failing on bad records.
"""
import functools
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.losses import perceptual as jperc
from fs_uae_image_enhancer_project_tpu.losses import vgg as jvgg
from fs_uae_image_enhancer_project_tpu.losses import vgg_selftrain as jst
from fs_uae_image_enhancer_project_tpu.models import count_params as jax_count_params
from fs_uae_image_enhancer_project_tpu.models import conv6 as jconv6
from fs_uae_image_enhancer_project_tpu.models.configs import config_to_json as jax_config_to_json
from fs_uae_image_enhancer_project_tpu.nas.studies import (
    config_from_trial_params as jax_config_from_trial_params)
from fs_uae_image_enhancer_project_tpu_torch.losses import perceptual as tperc
from fs_uae_image_enhancer_project_tpu_torch.losses import vgg
from fs_uae_image_enhancer_project_tpu_torch.losses import vgg_selftrain as st
from fs_uae_image_enhancer_project_tpu_torch.models import count_params
from fs_uae_image_enhancer_project_tpu_torch.models.configs import config_to_json
from fs_uae_image_enhancer_project_tpu_torch.nas import studies as tstudies
from fs_uae_image_enhancer_project_tpu_torch.scripts import (
    convert_vgg16_weights, nas_demo_r2, plot_training_parity, probe_transfer_retention,
    train_nas_winner, train_vgg_features, training_parity_study)
from fs_uae_image_enhancer_project_tpu_torch.utils import platform as tplatform
from fs_uae_image_enhancer_project_tpu_torch.utils import threefry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ULP = 4


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max(
        initial=0))


def _root_script(name):
    """A root ``scripts/<name>.py`` imported by path, under a private name."""
    spec = importlib.util.spec_from_file_location(
        f"root_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def quiet_roots(monkeypatch, tmp_path):
    """The root scripts' side effects kept in the test: no pid file, no
    persistent compile cache, their ``from common import`` resolved to the
    root's ``scripts/common.py``; the port's pid file in ``tmp_path``."""
    from fs_uae_image_enhancer_project_tpu.utils import compile_cache, platform

    monkeypatch.setattr(platform, "register_preemptible_pid", lambda *a, **k: None)
    monkeypatch.setattr(compile_cache, "enable_persistent_cache", lambda *a, **k: "")
    monkeypatch.syspath_prepend(os.path.join(REPO, "scripts"))
    monkeypatch.delitem(sys.modules, "common", raising=False)
    pidfile = str(tmp_path / "trainer.pid")
    real = tplatform.register_preemptible_pid
    monkeypatch.setattr(tplatform, "register_preemptible_pid",
                        lambda *a, **k: real(pidfile, str(tmp_path / "bench.lock")))
    yield pidfile
    sys.modules.pop("common", None)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads for this module's torch work: the tests run
    beside other workers, where eight threads a worker oversubscribe the
    host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_basis():
    """The JAX package's random basis, drawn once for the module (14.7 M
    normals), as numpy arrays."""
    return [{k: np.asarray(v) for k, v in p.items()} for p in jvgg._random_init()]


@pytest.fixture
def jax_draws_cached(monkeypatch, jax_basis):
    """JAX's ``_random_init()`` answered from the module's draw."""
    monkeypatch.setattr(jvgg, "_random_init", lambda key=None: [
        {k: jnp.asarray(v) for k, v in p.items()} for p in jax_basis])


@pytest.fixture
def small_fps(monkeypatch):
    """``measure_fps`` on a 48x64 frame: its 576x752 frame takes seconds a
    call on the CPU."""
    monkeypatch.setattr(tstudies, "measure_fps", functools.partial(
        tstudies.measure_fps, height=48, width=64))


def _tree(root, hw=(32, 32), crops=4, styles=("rgb444_p16_dNone", "rgb444_p16_dbayer2x2")):
    """A generator-style tree ``train/img_<k>/`` of targets and styled
    crops, seeded; returns its ``train`` directory."""
    rng = np.random.default_rng(11)
    for k in range(2):
        d = os.path.join(root, "train", f"img_{k}")
        os.makedirs(d)
        for c in range(crops):
            loc = f"{c * hw[1]}_0_s0_r0"
            target = rng.integers(0, 256, (*hw, 3), np.uint8)
            Image.fromarray(target).save(os.path.join(d, f"target_{loc}.png"))
            for s in styles:
                noisy = np.clip(target.astype(int) + rng.integers(-30, 31, target.shape), 0, 255)
                Image.fromarray(noisy.astype(np.uint8)).save(
                    os.path.join(d, f"lores_{loc}_{s}.png"))
    return os.path.join(root, "train")


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


# --- jax.random without jax ----------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234, 2**32 - 1])
def test_threefry_draws_equal_jax_random(seed):
    k, tk = jax.random.key(seed), threefry.key(seed)
    assert tk == tuple(int(v) for v in jax.random.key_data(k))
    for n in (2, 5):
        np.testing.assert_array_equal(np.asarray(threefry.split(tk, n), np.uint32),
                                      np.asarray(jax.random.key_data(jax.random.split(k, n))))
    for shape in [(), (7,), (3, 5, 11), (3, 3, 3, 64), (2001,)]:
        np.testing.assert_array_equal(threefry.random_bits(tk, shape),
                                      np.asarray(jax.random.bits(k, shape, jnp.uint32)))
        # (-0.05, 0.05): a scale that XLA's fused multiply-add rounds once
        for lo, hi in ((0.0, 1.0), (-0.05, 0.05), (0.1, 3.7)):
            got = threefry.uniform(tk, shape, lo, hi)
            want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
            assert got.dtype == np.float32 and got.shape == tuple(shape)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        got = threefry.normal(tk, shape)
        assert got.dtype == np.float32 and got.shape == tuple(shape)
        assert _ulps(got, jax.random.normal(k, shape, jnp.float32)) <= ULP


def test_random_init_is_jaxs_basis(jax_basis):
    got = vgg._random_init(device="cpu")
    want = jax_basis
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g["w"].shape == w["w"].shape and g["w"].dtype == torch.float32
        assert _ulps(g["w"].numpy(), w["w"]) <= ULP
        np.testing.assert_array_equal(g["b"].numpy(), w["b"])
    # every call gives fresh tensors: training one call's leaves leaves the next alone
    got[0]["w"].add_(1.0)
    assert _ulps(vgg._random_init(device="cpu")[0]["w"].numpy(), want[0]["w"]) <= ULP


@pytest.mark.parametrize("linear", [False, True])
def test_perceptual_loss_under_the_random_basis_is_jaxs(linear, jax_draws_cached):
    rng = np.random.default_rng(5)
    o = rng.uniform(0, 1, (2, 32, 48, 3)).astype(np.float32)
    t = np.clip(o + rng.normal(0, 0.1, o.shape), 0, 1).astype(np.float32)
    cfg = dict(vgg_weight=0.007, pixel_loss_type="charbonnier", input_is_linear=linear)
    want = float(jperc.make_perceptual_loss(jperc.PerceptualConfig(**cfg), jvgg._random_init())(
        jnp.asarray(o), jnp.asarray(t)))
    crit = tperc.make_perceptual_loss(tperc.PerceptualConfig(**cfg),
                                      vgg._random_init(device="cpu"), device="cpu")
    got = float(crit(torch.from_numpy(o), torch.from_numpy(t)))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_init_vgg16_falls_back_to_the_basis_as_jax_does(monkeypatch, tmp_path,
                                                       jax_draws_cached):
    for mod in (vgg, jvgg):
        monkeypatch.setattr(mod, "_ASSET", str(tmp_path / "none.npz"))
        monkeypatch.setattr(mod, "_ASSET_SELFTRAINED", str(tmp_path / "none_either.npz"))
    with pytest.warns(UserWarning, match="FIXED-SEED RANDOM VGG") as w_port:
        got = vgg.init_vgg16("cpu")
    with pytest.warns(UserWarning, match="FIXED-SEED RANDOM VGG") as w_jax:
        want = jvgg.init_vgg16()
    assert str(w_port[0].message) == str(w_jax[0].message)
    for g, w in zip(got, want):
        assert _ulps(g["w"].numpy(), w["w"]) <= ULP


def test_random_baseline_rms_is_measured_on_the_probe_as_jax_does(jax_draws_cached):
    """The repaired fault: the port returned the asset JSON's stored targets
    whatever the probe; on another probe they are more than 1e-3 off the
    basis's tap RMS, which the port now measures within 1e-5 of JAX's."""
    probe = np.random.default_rng(21).uniform(0, 1, (3, 48, 48, 3)).astype(np.float32)
    got = st.random_baseline_rms(probe, device="cpu")
    want = jst.random_baseline_rms(probe)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with open(st.ASSET_JSON) as f:
        stored = json.load(f)["tap_rms_target_random"]
    assert max(abs(s - w) / w for s, w in zip(stored, want)) > 1e-3


# --- the self-training's initial decoder and optimizer ---------------------------

@pytest.mark.parametrize("seed", [0, 100])
def test_init_decoder_is_jaxs(seed):
    got = st.init_decoder(threefry.key(seed), device="cpu")
    want = jst.init_decoder(jax.random.key(seed))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


def _optax_chain(lr, warmup, steps):
    import optax

    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(
        optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps), weight_decay=1e-5))


def test_clipped_adamw_is_the_optax_chain():
    import optax

    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}
    # global norms about 0.2, 6, 0.4, 10, 0.1, 2: the clip acts on updates 1, 3, 5
    grads = [{k: (rng.normal(size=v.shape) * s).astype(np.float32) for k, v in tree.items()}
             for s in (0.05, 1.5, 0.1, 2.5, 0.03, 0.5)]
    norms = [np.sqrt(sum(float(np.sum(g ** 2)) for g in gs.values())) for gs in grads]
    assert norms[0] < 1 and norms[1] >= 1 and norms[2] < 1 and norms[3] >= 1
    lr, warmup, steps = 1e-2, 2, 6
    opt = _optax_chain(lr, warmup, steps)
    state, want = opt.init(tree), dict(tree)
    wants = []
    for g in grads:
        u, state = opt.update(g, state, want)
        want = optax.apply_updates(want, u)
        wants.append({k: np.asarray(v) for k, v in want.items()})

    leaves = {k: torch.tensor(v) for k, v in tree.items()}
    port = st.clipped_adamw(lr, warmup, steps)(list(leaves.values()))
    for i, g in enumerate(grads):
        assert port.lr() == pytest.approx(
            float(optax.warmup_cosine_decay_schedule(0.0, lr, warmup, steps)(i)), rel=1e-6)
        for k, t in leaves.items():
            t.grad = torch.tensor(g[k])
        port.step()
        if i == 0:  # learning rate 0: nothing moves but Adam's moments
            for k, t in leaves.items():
                np.testing.assert_array_equal(t.numpy(), tree[k])
            assert all(float(port.state[t]["mu"].abs().max()) > 0 for t in leaves.values())
        for k, t in leaves.items():
            np.testing.assert_allclose(t.numpy(), wants[i][k], rtol=1e-6, atol=1e-6 * np.abs(
                wants[i][k]).max())


@pytest.mark.parametrize("warmup,steps", [(200, 6000), (5, 20), (0, 10)])
def test_warmup_cosine_decay_is_optaxs(warmup, steps):
    import optax

    want = optax.warmup_cosine_decay_schedule(0.0, 2e-4, warmup, steps)
    got = st.warmup_cosine_decay(2e-4, warmup, steps)
    for c in sorted({0, 1, warmup - 1, warmup, warmup + 1, steps // 2, steps - 1, steps,
                     steps + 3} - {-1}):
        w = float(want(c))
        assert abs(got(c) - w) <= 1e-6 * 2e-4, (c, got(c), w)
    with pytest.raises(ValueError):
        st.warmup_cosine_decay(2e-4, 20, 20)


# --- the drivers against the root scripts ------------------------------------------

def test_train_vgg_features_main_is_the_roots(tmp_path, monkeypatch, quiet_roots):
    data = _tree(str(tmp_path / "corpus"), hw=(32, 32), crops=3)
    common = ["--data", data, "--gt", str(tmp_path / "no_gt"), "--steps", "3", "--batch_size",
              "2", "--patch", "32", "--warmup", "1", "--cache_images", "50"]
    root = _root_script("train_vgg_features")
    monkeypatch.setattr(sys, "argv", ["train_vgg_features.py", *common, "--work",
                                      str(tmp_path / "jax_work"), "--out",
                                      str(tmp_path / "jax" / "asset.npz")])
    assert root.main() == 0
    assert train_vgg_features.main([*common, "--work", str(tmp_path / "port_work"), "--out",
                                    str(tmp_path / "port" / "asset.npz"), "--device", "cpu"]) == 0

    def log(work):
        with open(tmp_path / work / "train_log.jsonl") as f:
            return [json.loads(line) for line in f]

    got, want = log("port_work"), log("jax_work")
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0, 2]
    for g, w in zip(got, want):
        for k in ("loss", "val"):
            assert abs(g[k] - w[k]) <= 2e-2 * abs(w[k]), (k, g, w)
    assert got[-1]["loss"] < got[0]["loss"]

    # the asset and its meta: the root's keys and shapes; calibrated taps on target
    with np.load(tmp_path / "port" / "asset.npz") as a, np.load(tmp_path / "jax" / "asset.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype for k in a.files)
    meta = json.loads((tmp_path / "port" / "asset.json").read_text())
    jmeta = json.loads((tmp_path / "jax" / "asset.json").read_text())
    assert sorted(meta) == sorted(jmeta)
    np.testing.assert_allclose(meta["tap_rms_calibrated"], meta["tap_rms_target_random"],
                               rtol=1e-4)

    # latest.npz (written every 1000 steps; here from the initial weights at
    # step 2): the root script's keys, shapes and initial weights
    ckpt = tmp_path / "latest.npz"
    train_vgg_features.save_checkpoint(
        str(ckpt), 2, vgg._random_init(threefry.key(0), device="cpu"),
        st.init_decoder(threefry.key(100), device="cpu"))
    enc, dec = jvgg._random_init(jax.random.key(0)), jst.init_decoder(jax.random.key(100))
    keys = {"step"} | {f"{n}{i}_{k}" for n, ps in (("enc", enc), ("dec", dec))
                       for i in range(len(ps)) for k in ("w", "b")}
    with np.load(ckpt) as c:
        assert set(c.files) == keys and int(c["step"]) == 2
        for n, ps in (("enc", enc), ("dec", dec)):
            for i, p in enumerate(ps):
                assert c[f"{n}{i}_w"].shape == p["w"].shape
                assert _ulps(c[f"{n}{i}_w"], p["w"]) <= ULP
    # the port resumes from it, with a fresh optimizer (learning rate 0 at its first update)
    pwork = tmp_path / "port_resume"
    pwork.mkdir()
    (pwork / "latest.npz").write_bytes(ckpt.read_bytes())
    assert train_vgg_features.main([*common, "--work", str(pwork), "--out",
                                    str(tmp_path / "port2" / "asset.npz"), "--resume",
                                    "--device", "cpu"]) == 0
    assert [r["step"] for r in log("port_resume")] == [2]


def _parity_args(data):
    return ["--data", data, "--crop_size", "16", "16", "--ablation_epochs", "1",
            "--plateau_epochs", "1", "--samples_per_epoch", "8", "--batch_size", "8",
            "--accumulation_steps", "1"]


def _structure(tree):
    """A JSON tree's keys and value types, the values left out."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return "number" if isinstance(tree, (int, float)) else type(tree).__name__


def test_training_parity_study_summary_is_the_roots(tmp_path, monkeypatch, capsys, quiet_roots):
    data = _tree(str(tmp_path / "corpus"), hw=(16, 16))
    root = _root_script("training_parity_study")
    monkeypatch.setattr(root, "OUT", str(tmp_path / "jax_out"))
    monkeypatch.setattr(training_parity_study, "OUT", str(tmp_path / "port_out"))
    monkeypatch.setattr(sys, "argv", ["training_parity_study.py", *_parity_args(data)])
    assert root.main() == 0
    assert training_parity_study.main([*_parity_args(data), "--device", "cpu"]) == 0
    printed = _last_json(capsys)
    got = json.loads((tmp_path / "port_out" / "eval_summary.json").read_text())
    want = json.loads((tmp_path / "jax_out" / "eval_summary.json").read_text())
    assert printed == got
    assert _structure(got) == _structure(want)
    assert sorted(os.listdir(tmp_path / "port_out")) == sorted(os.listdir(tmp_path / "jax_out"))
    for leg in ("novgg", "randvgg", "selfvgg"):
        assert np.isfinite(got["ablation"][leg]["srgb_psnr_db"])
    assert got["last_run"] == dict(want["last_run"], data=data)
    assert pytest.approx(got["plateau"]["reference_anchor"]) == want["plateau"]["reference_anchor"]

    # a --skip plateau rerun under another corpus tag: the stale plateau row
    # is superseded as the root script supersedes it, every leg skipped
    skip = ["--skip", "ablation", "selfvgg", "plateau", "--corpus_tag", "r9-other"]
    monkeypatch.setattr(sys, "argv", ["training_parity_study.py", *_parity_args(data), *skip])
    assert root.main() == 0
    assert training_parity_study.main([*_parity_args(data), *skip, "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "port_out" / "eval_summary.json").read_text())
    want = json.loads((tmp_path / "jax_out" / "eval_summary.json").read_text())
    assert got["plateau"] == want["plateau"] and "superseded_by" in got["plateau"]
    assert got["last_run"]["corpus_tag"] == want["last_run"]["corpus_tag"] == "r9-other"
    assert got["ablation"]["corpus_tag"] == "r4-rebuild"  # rows keep their own tag


def test_plot_training_parity_points_are_the_roots(tmp_path, monkeypatch):
    ours = os.path.join(REPO, "artifacts", "model_pix_shuffle_trained",
                        "training_stats_pix_shuffle.csv")
    # a reference-format CSV whose epoch 3 is written twice (a resume): the last write counts
    ref = tmp_path / "ref.csv"
    ref.write_text("Epoch,Train Loss,Validation Loss\n1,0.2,0.14\n2,0.19,0.13\n3,0.18,0.125\n"
                   "3,0.18,0.129\n4,0.17,0.12\n")
    root = _root_script("plot_training_parity")
    monkeypatch.setattr(root, "OURS", ours)
    monkeypatch.setattr(root, "REF", str(ref))
    monkeypatch.setattr(root, "OUT_DIR", str(tmp_path / "jax"))
    os.makedirs(tmp_path / "jax")
    assert root.main() == 0
    assert plot_training_parity.main(["--ours", ours, "--ref", str(ref), "--out_dir",
                                      str(tmp_path / "port")]) == 0
    got = json.loads((tmp_path / "port" / "val_curve_points.json").read_text())
    assert got == json.loads((tmp_path / "jax" / "val_curve_points.json").read_text())
    assert got["reference"][2] == [3, 0.129]
    assert (tmp_path / "port" / "val_curve_comparison.png").stat().st_size > 0
    # without --ref, the reference curve is the committed points'
    assert plot_training_parity.main(["--ours", ours, "--out_dir", str(tmp_path / "p2")]) == 0
    committed = json.loads(open(plot_training_parity.POINTS).read())
    assert json.loads((tmp_path / "p2" / "val_curve_points.json").read_text()) == committed


def test_plot_training_parity_without_matplotlib_exits_1(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert plot_training_parity.main(["--ours", str(tmp_path / "absent.csv"), "--out_dir",
                                      str(tmp_path)]) == 1
    out = capsys.readouterr()
    assert "matplotlib" in out.err and json.loads(out.out.strip().splitlines()[-1])[
        "missing_module"] == "matplotlib"
    assert os.listdir(tmp_path) == []


def test_train_nas_winner_trains_jaxs_winner(tmp_path, capsys, small_fps):
    best = os.path.join(REPO, "artifacts", "nas_r5", "best_trial.json")
    with open(best) as f:
        bt = json.load(f)["best_trial"]
    jcfg = jax_config_from_trial_params("prune_act_r2", bt["params"])
    got_bt, cfg, model = train_nas_winner.winner_model(os.path.dirname(best), "prune_act_r2")
    assert got_bt == bt and model.variant == f"nas_winner_trial{bt['number']}"
    assert config_to_json(cfg) == jax_config_to_json(jcfg)
    n = count_params(model.init(torch.Generator().manual_seed(0), device="cpu"))
    assert n == jax_count_params(jconv6.init(jax.random.key(0), jcfg))

    nas_out = tmp_path / "nas_out"
    nas_out.mkdir()
    (nas_out / "best_trial.json").write_text(open(best).read())
    data = _tree(str(tmp_path / "corpus"))
    assert train_nas_winner.main([
        "--nas_out", str(nas_out), "--data", data, "--out", str(tmp_path / "ck"),
        "--crop_size", "32", "32", "--epochs", "1", "--samples_per_epoch", "4",
        "--batch_size", "4", "--eval_samples", "4", "--fps_seconds", "0.05",
        "--device", "cpu"]) == 0
    report = _last_json(capsys)
    assert report == json.loads((nas_out / "winner_trained.json").read_text())
    with open(os.path.join(REPO, "artifacts", "nas_r5", "winner_trained.json")) as f:
        assert sorted(report) == sorted(json.load(f))
    assert report["winner_lr"] == bt["params"]["learning_rate"]
    assert np.isfinite(report["eval"]["srgb_psnr_db"]) and report["fps_deployment_shape"] > 0


def test_nas_demo_r2_two_trials_without_matplotlib(tmp_path, monkeypatch, capsys, quiet_roots,
                                                   small_fps):
    """Two trials; the plots (which the phase rehearsal writes with
    matplotlib) named as not written where it does not import."""
    data = _tree(str(tmp_path / "corpus"))
    env = dict(NAS_OUT=str(tmp_path / "out"), NAS_DATA=data, NAS_TRIALS="2", NAS_EPOCHS="1",
               NAS_SAMPLES="4", NAS_CROP="32x32", NAS_FPS_S="0.05")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert nas_demo_r2.main(["--device", "cpu"]) == 0
    summary = _last_json(capsys)
    assert summary == json.loads((tmp_path / "out" / "best_trial.json").read_text())
    with open(os.path.join(REPO, "artifacts", "nas_r5", "best_trial.json")) as f:
        assert sorted(summary) == sorted([*json.load(f), "plots"])
    assert summary["trials_total"] == 2 and summary["crop_size"] == [32, 32]
    hit = summary["fps_cache_hit_on_best_arch"]
    assert hit["hit"] and hit["measure_invocations"] == 0 and hit["fps"] > 0
    assert hit["fps"] == summary["best_trial"]["params"]["fps_measured"]
    plots = summary["plots"]
    assert plots["written"] == [] and plots["missing_module"] == "matplotlib"
    assert plots["not_written"] == list(nas_demo_r2.PLOTS)
    assert not any(f.endswith(".png") for f in os.listdir(tmp_path / "out"))
    assert os.path.exists(quiet_roots)  # the pid file


def _stand_in_torchvision(monkeypatch):
    """``torchvision`` and ``torchvision.models`` with a VGG16 whose state
    dict holds the 12 features convs' tensors (each element distinct within
    a filter, so a wrong transpose shows)."""
    state, cin = {}, 3
    for i, kind, cout in vgg.VGG16_LAYOUT:
        if kind == "conv":
            n = cout * cin * 9
            w = (np.arange(n, dtype=np.float32) % 997 + i).reshape(cout, cin, 3, 3)
            state[f"features.{i}.weight"] = torch.from_numpy(w)
            state[f"features.{i}.bias"] = torch.arange(cout, dtype=torch.float32) - i
            cin = cout
    state["features.28.weight"] = torch.zeros(512, 512, 3, 3)  # past the slice, not converted

    class Net:
        def state_dict(self):
            return dict(state)

    models = types.ModuleType("torchvision.models")
    models.VGG16_Weights = types.SimpleNamespace(IMAGENET1K_FEATURES="features")
    models.vgg16 = lambda weights=None: Net()
    package = types.ModuleType("torchvision")
    package.models = models
    monkeypatch.setitem(sys.modules, "torchvision", package)
    monkeypatch.setitem(sys.modules, "torchvision.models", models)


def test_convert_vgg16_weights_with_a_stand_in_torchvision(tmp_path, monkeypatch):
    root = _root_script("convert_vgg16_weights")
    monkeypatch.setitem(sys.modules, "torchvision", None)
    monkeypatch.setattr(sys, "argv", ["convert_vgg16_weights.py", "--out", str(tmp_path / "a")])
    assert root.main() == 1
    assert convert_vgg16_weights.main(["--out", str(tmp_path / "b.npz")]) == 1
    assert os.listdir(tmp_path) == []

    _stand_in_torchvision(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["convert_vgg16_weights.py", "--out",
                                      str(tmp_path / "jax.npz")])
    assert root.main() == 0
    assert convert_vgg16_weights.main(["--out", str(tmp_path / "port.npz")]) == 0
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 24
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    # the asset loads as the features
    monkeypatch.setattr(vgg, "_ASSET", str(tmp_path / "port.npz"))
    assert vgg.init_vgg16("cpu")[0]["w"].shape == (3, 3, 3, 64)


def test_probe_transfer_retention_prints_its_fields(capsys):
    assert probe_transfer_retention.main(["--mb", "1", "--n", "6", "--sample_every", "3",
                                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "device=cpu array=1.0 MB x 6 puts"
    assert lines[1].startswith("baseline rss: ") and lines[1].endswith(" GB")
    assert lines[2].startswith("puts=3 sent=0.00 GB rss_growth=") and "(ratio " in lines[2]
    report = json.loads(lines[-1])
    assert [s["puts"] for s in report["samples"]] == [3, 6]
    assert report["samples"][1]["sent_gb"] == 6 / 1024 and report["baseline_rss_gb"] > 0


def test_chip_smoke_train_drivers_phase_on_the_cpu(tmp_path, monkeypatch, small_fps):
    """chip_smoke.py's train_drivers phase rehearsed on the CPU at a small
    size (on a card: the datagen tree's 376x288 pairs, 20 VGG steps of 32
    128x128 patches): the checks pass, K1 is never launched on the CPU,
    and a driver's failure, a K1 count off, a calibration off its target, a
    pid file not this process's or a missing module's exit not taken fail
    them."""
    import copy

    import chip_smoke as cs

    pidfile = str(tmp_path / "trainer.pid")
    real = tplatform.register_preemptible_pid
    monkeypatch.setattr(tplatform, "PREEMPTIBLE_PIDFILE", pidfile)
    monkeypatch.setattr(tplatform, "register_preemptible_pid",
                        lambda *a, **k: real(pidfile, str(tmp_path / "bench.lock")))
    # every trainer pins the random basis: none falls back to init_vgg16's choice
    monkeypatch.setattr(vgg, "init_vgg16", lambda *a, **k: pytest.fail("basis not pinned"))
    tree = os.path.dirname(_tree(str(tmp_path / "corpus"), hw=(16, 16)))
    cpu = torch.device("cpu")
    small = dict(long_samples=8, batch=8)
    rec = cs.train_drivers(cpu, tree, crop=(16, 16), parity_samples=8, winner_samples=8,
                           eval_samples=8, fps_s=0.05, vgg_steps=3, vgg_batch=2, vgg_patch=16,
                           vgg_warmup=1, nas_crop=(16, 16), nas_samples=4, probe_mb=1,
                           probe_n=5, **small)
    cs.check_train_drivers(rec, cpu, **small)
    json.dumps(rec)  # printable as the phase's line
    assert not os.path.exists(pidfile) and rec["pidfile"] == str(os.getpid())
    assert rec["basis_draw_s"] > 0 and rec["convert_vgg16_weights"]["rc"] == 1
    assert all(r["k1_launches"] == 0 for r in rec.values() if isinstance(r, dict) and "rc" in r)
    for key, variant in (("train_psh_long", "lightweight"), ("train_psh_heavy_long",
                                                              "heavyweight")):
        assert rec[key]["report"]["model"] == f"pix_shuffle {variant}"
        assert rec[key]["report"]["val_samples"] == 64  # max(samples // 8, 64), the root's draw
    assert rec["nas_demo_r2"]["report"]["plots"]["missing_module"] is None

    def broken(path, value):
        bad = copy.deepcopy(rec)
        node = bad
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value(node[path[-1]])
        return bad

    meta = ("train_vgg_features", "report", "tap_rms_calibrated")
    for path, value in ((("train_nas_winner", "rc"), lambda v: 1),
                        (("train_psh_long", "k1_launches"), lambda v: v + 1),
                        (("training_parity_study", "k1_launches"), lambda v: v + 1),
                        (meta, lambda v: [x * (1 + 2e-4) for x in v]),
                        (("pidfile",), lambda v: "1"),
                        (("matplotlib",), lambda v: not v),
                        (("nas_demo_r2", "report", "fps_cache_hit_on_best_arch", "hit"),
                         lambda v: False),
                        (("probe_transfer_retention", "report", "samples"), lambda v: v[:2])):
        with pytest.raises(AssertionError):
            cs.check_train_drivers(broken(path, value), cpu, **small)
