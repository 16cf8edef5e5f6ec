"""The port's drivers (``fs_uae_image_enhancer_project_tpu_torch/scripts``)
against the repo's root ``scripts/`` and the JAX package, on the CPU, at
small sizes:

- ``make_gt_frames``: ``make_scene`` and ``main()`` give the root script's
  PNG bytes at the same seed (the root script is imported by path; it
  imports numpy and PIL only);
- ``common.psnr_u8`` equals the root script's; ``vggfree_eval`` gives the
  root script's loss within 1e-5 (relative) and its PSNR within 1e-3 dB
  (JAX, the same weights through ``interop``);
- ``build_artifacts`` re-exports the committed pix_shuffle graph byte for
  byte;
- ``eval_headtohead.main`` on a small generated-style corpus: the report's
  fields and invariants (the plateau-50 row from the JAX script's orbax
  checkpoint second, nothing skipped), and each row's PSNR within 1e-3 dB of the root
  script's ``vggfree_eval`` on the same pairs and weights with the forward
  in fp32 (0.01 dB in bf16);
- ``bench_sidecar_multiclient`` with 2 clients for 1 s: every client
  answered, with the in-process enhance's frames; its client side imports
  no torch;
- ``bench_generator_e2e`` without sklearn names its host leg
  ``host_kmeans_torch_cpu``, and runs only the ``--legs`` asked for;
  ``bench_families`` counts each family's frames;
- every activation's derivative at exact ties (0 and 6, biases 0) is
  ``jax.grad``'s of the JAX package's activation: relu6 takes one half at
  its bounds (``jnp.clip``), leaky_relu 1 at 0, where ``torch.clamp`` and
  ``F.leaky_relu`` took 1 and the slope; without a gradient (the one-pass
  inference route) the values are the same.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.data import SRDataset as JaxSRDataset
from fs_uae_image_enhancer_project_tpu.data import gather_all_samples_from_directory as jax_gather
from fs_uae_image_enhancer_project_tpu.data import split_pairs as jax_split
from fs_uae_image_enhancer_project_tpu.export.onnx_import import import_any as jax_import_any
from fs_uae_image_enhancer_project_tpu.export.onnx_import import (
    import_pix_shuffle as jax_import_pix_shuffle)
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.ops import activations as jax_act
from fs_uae_image_enhancer_project_tpu.train.trainer import load_params as jax_load_params
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import enhance_from_onnx
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops import activations as tor_act
from fs_uae_image_enhancer_project_tpu_torch.scripts import (
    bench_families, bench_generator_e2e, bench_sidecar_multiclient, build_artifacts, common,
    eval_headtohead, make_gt_frames)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _root_script(name):
    """A root ``scripts/<name>.py`` imported by path, under a private name."""
    spec = importlib.util.spec_from_file_location(
        f"root_scripts_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root_common():
    return _root_script("common")


@pytest.mark.parametrize("seed", [7000, 7001, 7002, 7003])
def test_make_scene_is_the_root_scripts(seed):
    root = _root_script("make_gt_frames")
    np.testing.assert_array_equal(make_gt_frames.make_scene(seed, 96, 72),
                                  root.make_scene(seed, 96, 72))


def test_make_gt_frames_main_writes_the_root_scripts_bytes(tmp_path, monkeypatch, capsys):
    root = _root_script("make_gt_frames")
    args = ["--scenes", "3", "--width", "96", "--height", "72", "--split"]
    monkeypatch.setattr(sys, "argv", ["make_gt_frames.py", "--out", str(tmp_path / "jax"), *args])
    assert root.main() == 0
    missing = str(tmp_path / "no_samples")
    assert make_gt_frames.main(["--out", str(tmp_path / "port"), "--ref_samples", missing,
                                *args]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["written"] == 3 + 8 and summary["kept"] == 0
    assert summary["split"] == {"train": 9, "test": 2} and not summary["reference_samples"]
    names = sorted(f for f in os.listdir(tmp_path / "jax") if f.endswith(".png"))
    assert names == sorted(f for f in os.listdir(tmp_path / "port") if f.endswith(".png"))
    for f in names:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "port" / f).read_bytes(), f
    for part in ("train", "test"):
        assert sorted(os.listdir(tmp_path / "jax" / part)) == sorted(
            os.listdir(tmp_path / "port" / part))
    # a rerun keeps every file
    assert make_gt_frames.main(["--out", str(tmp_path / "port"), "--ref_samples", missing,
                                *args]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert again["written"] == 0 and again["kept"] == 11


@pytest.mark.parametrize("case", ["equal", "noise", "offset"])
def test_psnr_u8_is_the_root_scripts(case, root_common):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (24, 32, 3), np.uint8)
    b = {"equal": a.copy(),
         "noise": np.clip(a.astype(int) + rng.integers(-9, 10, a.shape), 0, 255).astype(np.uint8),
         "offset": np.clip(a.astype(int) + 40, 0, 255).astype(np.uint8)}[case]
    assert common.psnr_u8(a, b) == root_common.psnr_u8(a, b)


def _batches(seed=0, n=2, batch=2, hw=(48, 64)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (batch, *hw, 3), np.uint8),
             rng.integers(0, 256, (batch, *hw, 3), np.uint8)) for _ in range(n)]


@pytest.mark.parametrize("source", ["init", "shipped"])
def test_vggfree_eval_is_the_root_scripts(source, root_common):
    jm = jax_model("pix_shuffle")
    if source == "init":
        jp = jm.init(jax.random.key(0))
    else:
        jp = jax_import_pix_shuffle(
            os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx")).params
    batches = _batches()
    want = root_common.vggfree_eval(jm, jp, iter(batches))
    got = common.vggfree_eval(get_model("pix_shuffle"), params_from_jax(jp, device="cpu"),
                              iter(batches), device="cpu")
    assert got["batches"] == want["batches"] == 2
    assert got["ms_ssim_srgb"] is None and want["ms_ssim_srgb"] is None
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * abs(want["loss"])
    # the bf16 forwards round apart in the last bits: 1.4e-4 dB at random
    # weights (7.66 dB), the bar is eval_headtohead's 1e-3 dB
    assert abs(got["srgb_psnr_db"] - want["srgb_psnr_db"]) <= 1e-3


def test_build_artifacts_writes_the_committed_pix_shuffle_graph(tmp_path):
    summary = build_artifacts.run(str(tmp_path), ["pix_shuffle"], device="cpu")
    assert summary["onnx_equal_to_committed"] == {"pix_shuffle": True}
    out = tmp_path / "model_pix_shuffle"
    assert (out / "pix_shuffle.onnx").read_bytes() == (
        open(os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx"),
             "rb").read())
    assert (out / "pix_shuffle.onnx.svg").exists()
    frames = sorted(os.listdir(out / "predicted"))
    assert frames == [f"sample{i}.png" for i in range(8)]
    with Image.open(out / "predicted" / "sample0.png") as im:
        assert im.size == (752, 576) and im.mode == "RGBA"
    report = json.loads((out / "parity_report.json").read_text())
    assert report["onnx_equal_to_committed"] and report["svg_equal_to_committed"]
    with pytest.raises(ValueError, match="artifacts"):
        build_artifacts.run(os.path.join(REPO, "artifacts", "x"), ["pix_shuffle"], device="cpu")


def _corpus(root, crops=5, styles=("rgb444_p16_dNone", "rgb444_p16_dbayer2x2"), hw=(48, 64)):
    """A generator-style tree: ``train/img_<k>/target_*.png`` with its styled
    crops, seeded."""
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


def _fp32_forward(model, cast):
    """``model`` whose apply runs in fp32 on the protocol's bf16 input."""
    return model._replace(apply=lambda p, x, _a=model.apply: _a(p, cast(x)))


@pytest.mark.parametrize("forward", ["bf16", "fp32"])
def test_eval_headtohead_rows_are_the_root_protocols(forward, tmp_path, capsys, monkeypatch,
                                                     root_common):
    """The report's fields and invariants, and each row's PSNR against the
    root script's ``vggfree_eval`` on the JAX package's pairs and draws with
    the same weights: within 1e-3 dB with the models' forward in fp32 (on
    the protocol's bf16 inputs), within 0.01 dB in bf16, where torch rounds
    each op and XLA each fusion (2.9e-3 dB on this corpus)."""
    import fs_uae_image_enhancer_project_tpu_torch.models as tor_models

    if forward == "fp32":
        real = tor_models.get_model
        monkeypatch.setattr(tor_models, "get_model", lambda *a: _fp32_forward(
            real(*a), lambda x: x.float()))
    data = _corpus(str(tmp_path))
    out = tmp_path / "h2h.json"
    assert eval_headtohead.main(["--data", data, "--crop_size", "64", "48", "--num_samples", "4",
                                 "--batch_size", "2", "--work_dir", str(tmp_path / "work"),
                                 "--out", str(out), "--device", "cpu"]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report = json.loads(out.read_text())
    assert printed == report
    for key in ("date", "harness", "data", "held_out_pairs", "num_samples", "protocol",
                "caveats", "corpus_generation", "heldout_pool_fingerprint_sha256_16", "rows",
                "skipped"):
        assert key in report, key
    assert report["held_out_pairs"] == 2 and report["num_samples"] == 4  # 10% of 20 pairs
    # the JAX script's plateau-50 row, read from its orbax checkpoint, in
    # its place, with its label and caveat; nothing is skipped
    assert report["skipped"] == []
    labels = [r["label"] for r in report["rows"]]
    assert len(labels) == 4 and labels[0].startswith("shipped")
    assert labels[1] == "trained here: pix_shuffle plateau-50"
    assert report["rows"][1]["caveat"] == eval_headtohead.CAVEAT_R2_TRAINED
    assert "pix_shuffle_trained" in labels[2] and "pix_shuffle_heavy" in labels[3]
    for r in report["rows"]:
        assert r["batches"] == 2 and r["ms_ssim_srgb"] is None and r["caveat"]
        assert np.isfinite(r["pixel_loss_vggfree"]) and np.isfinite(r["srgb_psnr_db"])

    # the root protocol: the JAX package's gather, split and draws, JAX's model
    _, val_pool = jax_split(jax_gather(data, (64, 48), verbose=0), 0.1)
    art = os.path.join(REPO, "artifacts")
    weights = [
        (jax_model("pix_shuffle"), jax_import_pix_shuffle(
            os.path.join(art, "model_pix_shuffle", "pix_shuffle.onnx")).params),
        (jax_model("pix_shuffle"), jax_load_params(
            eval_headtohead.PLATEAU_CKPT, jax_model("pix_shuffle").init(jax.random.key(0)))),
        (jax_model("pix_shuffle"), jax_import_pix_shuffle(
            os.path.join(art, "model_pix_shuffle_trained", "pix_shuffle_trained.onnx")).params),
        (jax_model("pix_shuffle", "heavyweight"), jax_import_any(
            os.path.join(art, "model_pix_shuffle_heavy", "pix_shuffle_heavy.onnx")).params),
    ]
    tol = 1e-3 if forward == "fp32" else 1e-2
    for row, (jm, jp) in zip(report["rows"], weights):
        if forward == "fp32":
            jm = _fp32_forward(jm, lambda x: x.astype(jnp.float32))
        va = JaxSRDataset(val_pool, (64, 48), 4, batch_size=2, flips=False, seed=1,
                          transfer_dtype="uint8")
        want = root_common.vggfree_eval(jm, jp, iter(va))
        assert abs(row["srgb_psnr_db"] - want["srgb_psnr_db"]) <= tol, (row, want)


def test_multiclient_answers_are_the_enhance(tmp_path):
    h, w = 48, 64
    report = bench_sidecar_multiclient.run(clients=(2,), depths=(0, 2), seconds=1.0,
                                           device="cpu", h=h, w=w)
    assert [(r["depth"], r["clients"]) for r in report["rows"]] == [(0, 2), (2, 2)]
    for r in report["rows"]:
        assert r["clients_failed"] == 0 and not r["errors"] and r["server_rc"] == 0
        assert len(r["per_client_fps"]) == 2 and all(f > 0 for f in r["per_client_fps"])
        assert r["answered_equals_sent"]
        st = r["server_stats"]
        assert st["frames"] >= r["total_frames"] and st["p50_ms"] <= st["p99_ms"]
        assert st["k1_launches"] == 0  # the CPU runs the plain version
    assert report["answers_agree"]
    enhance = enhance_from_onnx(
        os.path.join(REPO, "artifacts", "model_pix_shuffle", "pix_shuffle.onnx"), device="cpu")
    import hashlib
    for k, frame in enumerate(bench_sidecar_multiclient.client_frames(h, w)):
        out = enhance(frame[None]).numpy()[0]
        assert report["answer_digests"][str(k)] == hashlib.sha256(out.tobytes()).hexdigest()


def test_multiclient_client_side_imports_no_torch():
    code = ("import sys\n"
            "import fs_uae_image_enhancer_project_tpu_torch.scripts.bench_sidecar_multiclient\n"
            "print(sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_generator_e2e_names_its_host_leg(tmp_path, monkeypatch):
    gt = tmp_path / "gt"
    gt.mkdir()
    Image.fromarray(make_gt_frames.make_scene(7000, 376, 288)).save(gt / "scene_000.png")
    monkeypatch.setattr(bench_generator_e2e, "sklearn_available", lambda: False)
    monkeypatch.setattr(bench_generator_e2e, "PALETTES", (16,))
    monkeypatch.setattr(bench_generator_e2e, "DITHERS", ("none", "bayer4x4"))
    r = bench_generator_e2e.run(str(gt), images=["scene_000.png"], n_images=1, max_crops=1,
                                device="cpu", work_dir=str(tmp_path))
    assert "host" not in r and r["host_leg"] == "host_kmeans_torch_cpu"
    for leg in ("host_kmeans_torch_cpu", "device_per_crop", "device_batched"):
        assert r[leg]["target_crops"] == 1 and r[leg]["styled_crops"] == 2, r[leg]
        assert r[leg]["missing"] == 0 and r[leg]["k3_launches"] == 0  # plain version on the CPU
    assert r["host_kmeans_torch_cpu"]["palette_algorithm"] == "kmeans_torch"
    with pytest.raises(FileNotFoundError):
        bench_generator_e2e.run(str(gt), device="cpu")  # no sample*.png and no --images


def test_generator_e2e_runs_the_legs_asked_for(tmp_path, monkeypatch):
    gt = tmp_path / "gt"
    gt.mkdir()
    Image.fromarray(make_gt_frames.make_scene(7001, 376, 288)).save(gt / "scene_000.png")
    monkeypatch.setattr(bench_generator_e2e, "PALETTES", (16,))
    monkeypatch.setattr(bench_generator_e2e, "DITHERS", ("bayer4x4",))
    r = bench_generator_e2e.run(str(gt), images=["scene_000.png"], n_images=1, max_crops=1,
                                device="cpu", work_dir=str(tmp_path), legs=("device_batched",))
    assert r["slice"]["legs"] == ["device_batched"]
    assert r["device_batched"]["styled_crops"] == 1 and r["device_batched"]["device_batch"] == 16
    for absent in ("host", "host_kmeans_torch_cpu", "host_leg", "device_per_crop",
                   "device_batched_speedup_x"):
        assert absent not in r


def test_bench_families_counts_frames():
    r = bench_families.run(["pix_shuffle", "conv3"], duration_s=0.05, device="cpu",
                           frame_hw=(48, 64), warmup=2, chunk=2)
    assert [row["family"] for row in r["rows"]] == ["pix_shuffle", "conv3"]
    for row in r["rows"]:
        assert row["frames"] >= 4 and row["fps"] > 0 and row["k1_launches"] == 0
        assert row["weights"].startswith("shipped graph")


@pytest.mark.parametrize("name", jax_act.ACTIVATION_NAMES)
def test_activation_derivative_at_ties_is_jaxs(name):
    x = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    jp = {k: jnp.zeros_like(v) if k == "bias" else v
          for k, v in jax_act.init_activation(jax.random.key(0), name).items()}
    want = np.asarray(jax.grad(lambda v: jax_act.apply_activation(name, jp, v).sum())(
        jnp.asarray(x)))
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = tor_act.apply_activation(name, tp, tx)
    y.sum().backward()
    with torch.no_grad():  # the inference route: the same values
        assert torch.equal(tor_act.apply_activation(name, tp, tx), y.detach())
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(jax_act.apply_activation(name, jp, jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-6, atol=1e-6)
