"""The port's trainer and training CLI on the CPU, mirroring
``tests/test_trainer.py``: end to end and resume (with the BN model), the
fresh optimizer at the CSV's learning rate, the checkpoint round trip, the
CSV loader on the committed histories (as the JAX package reads them), the
first epoch's train loss against the JAX trainer (VGG off, fp32, JAX's
initial weights, the same data seeds: rel 1e-3), and the CLI, on one process
and on a mesh of gloo ranks against JAX's CLI on its virtual mesh."""
import csv
import dataclasses
import functools
import glob
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from fs_uae_image_enhancer_project_tpu.data import SRDataset as JaxDataset
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu.train import trainer as JT
from fs_uae_image_enhancer_project_tpu_torch.data import (
    SRDataset,
    gather_all_samples_from_directory,
    split_pairs,
)
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.parallel import mesh as pm
from fs_uae_image_enhancer_project_tpu_torch.parallel.train_step import (
    init_train_state,
    leaves,
    make_optimizer,
)
from fs_uae_image_enhancer_project_tpu_torch.train import cli
from fs_uae_image_enhancer_project_tpu_torch.train import trainer as T
from fs_uae_image_enhancer_project_tpu_torch.train.orbax_reader import (
    is_orbax_checkpoint,
    read_orbax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tiny_dataset(tmp_path):
    """A 3-location generated tree with 16x16 crops."""
    rng = np.random.default_rng(0)
    d = tmp_path / "train" / "img1"
    d.mkdir(parents=True)
    for loc in ((0, 0), (8, 8), (4, 4)):
        base = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        Image.fromarray(base).save(d / f"target_{loc[0]}_{loc[1]}_s100_r0.png")
        Image.fromarray((base // 32) * 32).save(
            d / f"lores_{loc[0]}_{loc[1]}_s100_r0_rgb444_p32_dnone.png")
    return str(tmp_path / "train")


def _cfg(ckpt_dir, **kw):
    base = dict(num_epochs=2, lr=1e-3, batch_size=2, accumulation_steps=2,
                checkpoint_interval=1, checkpoint_dir=ckpt_dir, verbose=0, device="cpu")
    return T.TrainerConfig(**{**base, **kw})


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def test_csv_resume_roundtrip(tmp_path):
    csv_file = str(tmp_path / "training_stats_x.csv")
    assert T.load_last_epoch_and_checkpoint(0.01, csv_file) == (0, float("inf"), 0, 0, 0.01, None)
    T.save_training_stats(csv_file, 1, 0.5, 0.4, 0, 0.001, "ckpt1")
    T.save_training_stats(csv_file, 2, 0.45, 0.42, 1, 0.00095, "ckpt2")
    assert T.load_last_epoch_and_checkpoint(0.01, csv_file) == (2, 0.4, 1, 1, 0.00095, "ckpt2")
    assert _rows(csv_file)[0] == JT.CSV_HEADER == T.CSV_HEADER


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(
    REPO, "artifacts", "training_demo", "training_stats_*.csv"))))
def test_csv_loader_reads_committed_histories_as_jax_does(path):
    for lr in (0.01, 1e-3):
        assert T.load_last_epoch_and_checkpoint(lr, path) == \
            JT.load_last_epoch_and_checkpoint(lr, path)


def _state(name="pix_shuffle", seed=0, **kw):
    m = get_model(name)
    return init_train_state(m.init(torch.Generator().manual_seed(seed), device="cpu"),
                            make_optimizer(**kw), has_batchnorm=name != "pix_shuffle")


def test_checkpoint_roundtrip(tmp_path):
    state = _state("conv5", steps_per_epoch=2)
    for p in leaves(state.params):  # an optimizer step, so Adam has moments
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.scheduler.step()
    state = state._replace(step=7)
    path = str(tmp_path / "ckpt")
    T.save_checkpoint(path, state)
    assert sorted(os.listdir(path)) == ["_CHECKPOINT_METADATA", "_METADATA", "array_metadatas",
                                        "d", "manifest.ocdbt"]
    T.save_checkpoint(path, state)  # overwrites in place
    restored = T.load_checkpoint(path, _state("conv5", seed=1, steps_per_epoch=2))
    assert restored.step == 7
    for a, b in zip(leaves(restored.params) + leaves(restored.buffers),
                    leaves(state.params) + leaves(state.buffers)):
        assert torch.equal(a, b)
    assert restored.optimizer.state_dict()["state"][0]["step"] == 1
    assert restored.scheduler.state_dict()["last_epoch"] == 1
    m = get_model("conv5")
    params = T.load_params(path, m.init(device="cpu"))
    assert torch.equal(params["bn2"]["mean"], state.buffers["bn2"]["mean"])
    assert torch.equal(params["conv3"]["w"], state.params["conv3"]["w"])


def test_orbax_checkpoint_raises(tmp_path):
    """A directory of the JAX package's orbax files is read (bit-equal
    parameters); one whose manifest is corrupted raises, by name, as does a
    directory with no checkpoint."""
    import shutil

    from fs_uae_image_enhancer_project_tpu.parallel.train_step import (
        init_train_state as jax_state,
        make_optimizer as jax_optimizer,
    )
    from fs_uae_image_enhancer_project_tpu_torch.interop import params_to_numpy

    path = str(tmp_path / "checkpoint_best_pix_shuffle")
    jparams = jax_model("pix_shuffle").init(jax.random.key(0))
    JT.save_checkpoint(path, jax_state(jparams, jax_optimizer()))
    got = params_to_numpy(T.load_params(path, get_model("pix_shuffle").init(device="cpu")))
    for (kp, want), (_, have) in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                                     jax.tree_util.tree_flatten_with_path(got)[0]):
        assert np.array_equal(np.asarray(want), have), kp
    bad = str(tmp_path / "corrupted")
    shutil.copytree(path, bad)
    manifest = os.path.join(bad, "manifest.ocdbt")
    raw = bytearray(open(manifest, "rb").read())
    raw[20] ^= 0x40
    open(manifest, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        T.load_params(bad, get_model("pix_shuffle").init(device="cpu"))
    with pytest.raises(FileNotFoundError):
        T.load_checkpoint(str(tmp_path / "nothing"), _state())


def test_trainer_end_to_end_and_resume_with_the_bn_model(tiny_dataset, tmp_path):
    m = get_model("conv5")
    pairs = gather_all_samples_from_directory(tiny_dataset, (16, 16), verbose=0)
    train_pool, val_pool = split_pairs(pairs, 0.34)
    ckpt_dir = str(tmp_path / "ckpts")
    train_ds = SRDataset(train_pool, (16, 16), num_samples=8, batch_size=2, linear=False,
                         transfer_dtype="uint8")
    val_ds = SRDataset(val_pool, (16, 16), num_samples=4, batch_size=2, linear=False,
                       flips=False, transfer_dtype="uint8")
    best_val, best_epoch, _ = T.Trainer(m, _cfg(ckpt_dir)).train(train_ds, val_ds)
    assert np.isfinite(best_val) and best_epoch >= 1
    stats = os.path.join(ckpt_dir, "training_stats_conv5.csv")
    assert is_orbax_checkpoint(os.path.join(ckpt_dir, "checkpoint_best_conv5"))
    assert is_orbax_checkpoint(os.path.join(ckpt_dir, "checkpoint_epoch_2_conv5"))
    saved = read_orbax(os.path.join(ckpt_dir, "checkpoint_epoch_2_conv5"))
    assert saved["step"] == 4 and set(saved["buffers"]) == {f"bn{i}" for i in range(1, 6)}
    assert not np.array_equal(saved["buffers"]["bn1"]["var"], np.ones(32))  # the stats moved

    # resume: the epochs continue from the CSV, none is trained twice
    T.Trainer(m, _cfg(ckpt_dir, num_epochs=3)).train(train_ds, val_ds)
    rows = _rows(stats)
    assert rows[0] == T.CSV_HEADER
    epochs = [int(r[0]) for r in rows[1:]]
    assert epochs == [1, 2, 3]
    assert all(np.isfinite(float(r[1])) and np.isfinite(float(r[2])) for r in rows[1:])


def test_resume_uses_fresh_optimizer_with_csv_lr(tiny_dataset, tmp_path):
    """CSV resume restores the weights and the learning rate but not the
    schedule's count: the decay is not applied twice."""
    m = get_model("pix_shuffle")
    m = m._replace(loss=dataclasses.replace(m.loss, vgg_weight=0.0, high_frequency_weight=0.0))
    pairs = gather_all_samples_from_directory(tiny_dataset, (16, 16), verbose=0)
    ckpt_dir = str(tmp_path / "ck")
    ds = SRDataset(pairs, (16, 16), num_samples=8, batch_size=2)
    T.Trainer(m, _cfg(ckpt_dir, lr_decay_rate=0.5)).train(ds, None)
    T.Trainer(m, _cfg(ckpt_dir, lr_decay_rate=0.5, num_epochs=3)).train(ds, None)
    rows = [json.loads(line) for line in open(os.path.join(ckpt_dir, "metrics_pix_shuffle.jsonl"))]
    lr2 = next(r["lr"] for r in rows if r["epoch"] == 2)
    lr3 = next(r["lr"] for r in rows if r["epoch"] == 3)
    assert lr3 == pytest.approx(lr2 * 0.5, rel=1e-6)
    assert all(r["val_k1_launches"] == 0 for r in rows)  # no card: no K1


def test_resume_with_a_missing_checkpoint_raises(tiny_dataset, tmp_path):
    m = get_model("conv5")
    ckpt_dir = str(tmp_path / "gone")
    os.makedirs(ckpt_dir)
    T.save_training_stats(os.path.join(ckpt_dir, "training_stats_conv5.csv"), 1, 0.3, 0.3, 0,
                          1e-3, str(tmp_path / "deleted_checkpoint"))
    pairs = gather_all_samples_from_directory(tiny_dataset, (16, 16), verbose=0)
    ds = SRDataset(pairs, (16, 16), num_samples=2, linear=False)
    with pytest.raises(FileNotFoundError, match="resume checkpoint"):
        T.Trainer(m, _cfg(ckpt_dir, num_epochs=2)).train(ds, None)


def test_first_epoch_loss_matches_the_jax_trainer(tiny_dataset, tmp_path):
    """VGG off, fp32, JAX's initial weights (jax.random.key(0), the JAX
    trainer's own), the same pools and data seeds: the first epoch's train
    loss within rel 1e-3."""
    jm = jax_model("pix_shuffle")
    jm = jm._replace(loss=dataclasses.replace(jm.loss, vgg_weight=0.0))
    m = get_model("pix_shuffle")
    m = m._replace(loss=dataclasses.replace(m.loss, vgg_weight=0.0))
    pairs = gather_all_samples_from_directory(tiny_dataset, (16, 16), verbose=0)
    kw = dict(num_samples=8, batch_size=2, seed=3, transfer_dtype="uint8")
    cfg = dict(num_epochs=1, batch_size=2, accumulation_steps=2, checkpoint_interval=1,
               verbose=0, compute_dtype="float32")
    JT.Trainer(jm, JT.TrainerConfig(checkpoint_dir=str(tmp_path / "jax"), **cfg)).train(
        JaxDataset(pairs, (16, 16), **kw), None)
    tr = T.Trainer(m, T.TrainerConfig(checkpoint_dir=str(tmp_path / "port"), device="cpu", **cfg))
    ds = SRDataset(pairs, (16, 16), **kw)
    params = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.key(0))), device="cpu")
    tr.train(ds, None, state=init_train_state(params, tr.optimizer(1e-3, ds)))
    want = float(_rows(str(tmp_path / "jax" / "training_stats_pix_shuffle.csv"))[1][1])
    got = float(_rows(str(tmp_path / "port" / "training_stats_pix_shuffle.csv"))[1][1])
    assert got == pytest.approx(want, rel=1e-3)


def _cli_args(tiny_dataset, ckpt_dir, *extra):
    return ["--model_type", "pix_shuffle", "--generator_train_dir", tiny_dataset,
            "--checkpoint_dir", ckpt_dir, "--crop_size", "16", "16", "--batch_size", "1",
            "--accumulation_steps", "2", "--train_samples", "4", "--val_samples", "2",
            "--val_split_ratio", "0.34", "--checkpoint_interval", "1", "--verbose", "0",
            *extra]


def test_cli_trains_a_tiny_tree_on_the_cpu(tiny_dataset, tmp_path, capsys):
    samples = tmp_path / "samples"
    samples.mkdir()
    Image.fromarray(np.random.default_rng(1).integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
        samples / "s0.png")
    ckpt_dir = str(tmp_path / "cli")
    args = _cli_args(tiny_dataset, ckpt_dir, "--samples_dir", str(samples), "--device", "cpu")
    assert cli.main(args + ["--epochs", "2"]) == 0
    assert "Best validation loss" in capsys.readouterr().out
    assert is_orbax_checkpoint(os.path.join(ckpt_dir, "checkpoint_best_pix_shuffle"))
    assert os.path.isfile(os.path.join(ckpt_dir, "predicted", "s0.png"))
    assert cli.main(args + ["--epochs", "3"]) == 0  # resume
    rows = _rows(os.path.join(ckpt_dir, "training_stats_pix_shuffle.csv"))
    assert [int(r[0]) for r in rows[1:]] == [1, 2, 3]


def _cli_resume_from(params, ckpt_dir, save):
    """A stats CSV whose epoch-0 row names a checkpoint of ``params``: the
    CLI then trains epoch 1 from those weights (resume), on either package."""
    ckpt = os.path.join(ckpt_dir, "init_ckpt")
    save(ckpt, params)
    T.save_training_stats(os.path.join(ckpt_dir, "training_stats_conv3.csv"), 0,
                          float("inf"), float("inf"), 0, 1e-3, ckpt)


def _fp32_rank(args, train_pool, val_pool):
    """``cli._train_rank`` with the trainer in fp32 (the CLI trains in bf16),
    in a spawned rank."""
    T.TrainerConfig = functools.partial(T.TrainerConfig, compute_dtype="float32")
    return cli._train_rank(args, train_pool, val_pool)


def test_cli_refuses_sharding_and_a_missing_card(devices8, tiny_dataset, tmp_path, capsys,
                                                 monkeypatch):
    """The CLI's mesh route against JAX's CLI. conv3 (BatchNorm, VGG on) from
    JAX's initial weights (a resume of both CLIs), fp32, one Adam step an
    epoch, a global batch of 2 x 2 micro-batches: at ``--n_devices 2`` (dp 2)
    and at ``--n_devices 4 --spatial 2`` (dp 2 x sp 2, gloo ranks) the CSV's
    losses within 1e-5 relative, the best checkpoint's parameters and running
    stats within 1e-5, and Adam's moments within 1e-4 relative of JAX's CLI
    on its dp 2 virtual mesh. (JAX's own dp 2 x sp 2 is not the reference
    here: on crops of 32 rows or fewer, XLA's CPU partitioner gives another
    loss for the sp-sharded VGG than its dp 2 and unsharded runs do.) Then
    JAX's three refusals and the missing cards."""
    from fs_uae_image_enhancer_project_tpu.parallel.train_step import (
        init_train_state as jax_state,
        make_optimizer as jax_optimizer,
    )
    from fs_uae_image_enhancer_project_tpu.train import cli as jax_cli

    jparams = jax_model("conv3").init(jax.random.key(0))
    flags = ["--model_type", "conv3", "--generator_train_dir", tiny_dataset,
             "--crop_size", "16", "16", "--batch_size", "2", "--accumulation_steps", "2",
             "--train_samples", "4", "--val_samples", "4", "--val_split_ratio", "0.34",
             "--checkpoint_interval", "1", "--verbose", "0", "--epochs", "1"]
    runs = {"jax": ["--n_devices", "2"], "dp2": ["--n_devices", "2"],
            "dp2sp2": ["--n_devices", "4", "--spatial", "2"]}
    for run, mesh_flags in runs.items():
        d = str(tmp_path / run)
        os.makedirs(d)
        if run == "jax":
            _cli_resume_from(jparams, d, lambda p, x: JT.save_checkpoint(
                p, jax_state(x, jax_optimizer(steps_per_epoch=1), has_batchnorm=True)))
            monkeypatch.setattr(JT, "TrainerConfig", functools.partial(
                JT.TrainerConfig, compute_dtype="float32"))
            # the port's ranks train in fp32 too, through the CLI's own launcher
            spawn = pm.spawn_ranks
            monkeypatch.setattr(pm, "spawn_ranks", lambda fn, *a, **kw: spawn(
                _fp32_rank if fn is cli._train_rank else fn, *a, **kw))
            assert jax_cli.main(flags + mesh_flags + ["--checkpoint_dir", d]) == 0
        else:
            _cli_resume_from(jparams, d, lambda p, x: T.save_checkpoint(p, init_train_state(
                params_from_jax(jax.tree_util.tree_map(np.asarray, x), device="cpu"),
                make_optimizer(), has_batchnorm=True)))
            assert cli.main(flags + mesh_flags + ["--checkpoint_dir", d, "--device", "cpu"]) == 0
    want_row = _rows(str(tmp_path / "jax" / "training_stats_conv3.csv"))[2]
    jax_saved = JT.load_checkpoint(
        str(tmp_path / "jax" / "checkpoint_best_conv3"),
        jax_state(jparams, jax_optimizer(steps_per_epoch=1), has_batchnorm=True))
    adam = next(s for s in jax_saved.opt_state if hasattr(s, "mu"))
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    want_leaves = jax.tree_util.tree_leaves(as_np(jax_saved.params))
    want_bufs = jax.tree_util.tree_leaves(as_np(jax_saved.buffers))
    want_moments = {"mu": jax.tree_util.tree_leaves(as_np(adam.mu)),
                    "nu": jax.tree_util.tree_leaves(as_np(adam.nu))}
    for run in ("dp2", "dp2sp2"):
        row = _rows(str(tmp_path / run / "training_stats_conv3.csv"))[2]
        assert row[0] == want_row[0] == "1"
        for col in (1, 2):  # the train and validation losses
            assert float(row[col]) == pytest.approx(float(want_row[col]), rel=1e-5), (run, col)
        saved = read_orbax(str(tmp_path / run / "checkpoint_best_conv3"),
                           subtrees=("step", "params", "buffers", "opt_state"))
        got = leaves(saved["params"])
        assert len(got) == len(want_leaves)
        for g, w in zip(got, want_leaves):  # both in sorted key order
            np.testing.assert_allclose(g.reshape(w.shape), w, atol=1e-5, rtol=0)
        for g, w in zip(leaves(saved["buffers"]), want_bufs):
            np.testing.assert_allclose(g.reshape(w.shape), w, atol=1e-5, rtol=0)
        adam_saved = saved["opt_state"][1]
        for k, want in want_moments.items():
            got = leaves(adam_saved[k])
            assert len(got) == len(want)
            for i, (g, w) in enumerate(zip(got, want)):
                np.testing.assert_allclose(g.reshape(w.shape), w, rtol=1e-4,
                                           atol=1e-5 * np.abs(w).max(), err_msg=f"{run} {k} {i}")
    capsys.readouterr()

    # the mesh arithmetic, in JAX's words, before any work
    base = _cli_args(tiny_dataset, str(tmp_path / "x"), "--epochs", "1", "--device", "cpu")
    assert cli.main(base + ["--n_devices", "4", "--spatial", "3"]) == 1
    assert "--spatial 3 must divide --n_devices 4" in capsys.readouterr().err
    assert cli.main(base + ["--n_devices", "2"]) == 1  # batch 1 over dp 2
    assert "must be divisible by the dp axis (2)" in capsys.readouterr().err
    assert cli.main(base + ["--n_devices", "2", "--spatial", "2", "--crop_size", "16", "15"]) == 1
    assert "crop height 15 must be divisible by --spatial 2" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x")
    # more ranks than cards: exit 1, never fewer ranks or the CPU
    cards = torch.cuda.device_count()
    assert cli.main(_cli_args(tiny_dataset, str(tmp_path / "y"), "--batch_size", "2",
                              "--n_devices", str(cards + 2))) == 1
    assert f"but only {cards} devices visible" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(_cli_args(tiny_dataset, str(tmp_path / "z"), "--epochs", "1"))


def test_chip_smoke_train_mesh_on_the_cpu(tmp_path):
    """chip_smoke.py's mesh run of the train phase rehearsed on the CPU: a
    gloo group of world size 1 (nccl on a card) over tcp://localhost, the
    trainer on its 1x1 mesh gives the run without a mesh's checkpoint
    (bit-equal here; 1e-6 the check) through the mesh path's collectives
    (the state's broadcast, each step's and each validation batch's
    all-reduces: a run without them fails the check), and the CLI asked for
    one rank more than the cards visible exits 1 with JAX's message."""
    import chip_smoke as cs

    rng = np.random.default_rng(0)
    d = tmp_path / "tree" / "img_0"
    d.mkdir(parents=True)
    for loc in range(6):
        base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        Image.fromarray(base).save(d / f"target_{loc * 8}_0_s0_r0.png")
        Image.fromarray((base // 16) * 16).save(d / f"lores_{loc * 8}_0_s0_r0_rgb444_p16_dNone.png")
    cpu = torch.device("cpu")
    rec = cs.train_mesh(cpu, str(tmp_path / "tree"), crop=(32, 32))
    cs.check_train_mesh(rec, cpu)
    assert rec["max_abs_diff"] == 0.0 and rec["steps"] == [2, 2] and rec["leaves"] == 24
    assert rec["collectives"] == {"broadcast": 24, "all_reduce": 2 * (24 + 1) + 2}
    assert not torch.distributed.is_initialized()
    json.dumps(rec)
    for bad in ({"max_abs_diff": 2e-6}, {"k1_launches": 2}, {"backend": "nccl"},
                {"collectives": {"broadcast": 0, "all_reduce": 0}},
                {"cli_too_few_cards": dict(rec["cli_too_few_cards"], exit_code=0)}):
        with pytest.raises(AssertionError):
            cs.check_train_mesh({**rec, **bad}, cpu)
