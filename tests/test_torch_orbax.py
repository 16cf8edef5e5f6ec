"""The port's reader of the JAX package's orbax checkpoints
(``train/orbax_reader.py`` over ``utils/ocdbt.py`` and ``utils/zstd.py``)
against tensorstore and the JAX package, on the CPU.

Tolerances: none. Reading moves bytes and does no arithmetic, so every key,
value, leaf and written graph is compared for equality, bit for bit.

- the 33 committed TPU-trained checkpoints: the port's OCDBT key list is
  tensorstore's, and for three of them every value's bytes are;
- epoch73, plateau-50 and heavy epoch60: the port's ``load_params`` is the
  JAX package's ``load_params``, leaf for leaf, and epoch73's leaves are the
  port's import of ``pix_shuffle_trained.onnx``;
- checkpoints the JAX package's ``save_checkpoint`` writes here: conv3 with
  batchnorm buffers and pix_shuffle with the ``__empty__`` sentinel, the
  step and optax's ``<i4`` count included;
- ``export.cli --checkpoint`` on epoch73 writes ``pix_shuffle_trained.onnx``'s
  bytes (fp32);
- the port's trainer resumed from a CSV and checkpoint written by the JAX
  trainer's functions starts from JAX's ``load_checkpoint`` weights and
  buffers, at the CSV's learning rate;
- the drivers read an orbax directory through ``load_params`` alone;
- OCDBT stores tensorstore writes with interior B-tree nodes, a version
  tree, numbered manifests, no compression and no keys; zarr arrays with
  several chunks, bf16, int64, a missing chunk and a dotted key;
- corrupted copies raise;
- ``chip_smoke.py``'s ``orbax`` phase rehearsed at a small size.
"""
import ast
import csv
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ts = pytest.importorskip("tensorstore")

from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model  # noqa: E402
from fs_uae_image_enhancer_project_tpu.parallel import train_step as jts  # noqa: E402
from fs_uae_image_enhancer_project_tpu.train import trainer as JT  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.data import (  # noqa: E402
    SRDataset, gather_all_samples_from_directory, split_pairs)
from fs_uae_image_enhancer_project_tpu_torch.export import cli as export_cli  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.export.enhance import make_enhance_fn  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.export.onnx_import import (  # noqa: E402
    import_pix_shuffle)
from fs_uae_image_enhancer_project_tpu_torch.interop import (  # noqa: E402
    params_from_jax, params_to_numpy)
from fs_uae_image_enhancer_project_tpu_torch.models import get_model  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.scripts import bench_families  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.train import trainer as T  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.train.orbax_reader import (  # noqa: E402
    OrbaxError, read_orbax)
from fs_uae_image_enhancer_project_tpu_torch.utils.ocdbt import (  # noqa: E402
    OcdbtError, OcdbtStore, crc32c)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts")
CHECKPOINTS = sorted(p for p in glob.glob(os.path.join(ART, "**", "checkpoint*"), recursive=True)
                     if os.path.isdir(p))
EPOCH73 = os.path.join(ART, "model_pix_shuffle_trained", "checkpoint_best_epoch73")
PLATEAU = os.path.join(ART, "training_parity", "plateau_full", "checkpoint_best_pix_shuffle")
HEAVY60 = os.path.join(ART, "model_pix_shuffle_heavy", "checkpoint_best_epoch60")
TRAINED = {"epoch73": (EPOCH73, "lightweight"), "plateau_50": (PLATEAU, "lightweight"),
           "heavy_epoch60": (HEAVY60, "heavyweight")}


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the test runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _ts_store(path):
    return ts.KvStore.open({"driver": "ocdbt",
                            "base": "file://" + os.path.abspath(path) + "/"}).result()


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], pre + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flat(v, pre + (i,))]
    return [(pre, tree)]


def _assert_bit_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def test_the_repo_ships_33_orbax_checkpoints():
    assert len(CHECKPOINTS) == 33


@pytest.mark.parametrize("path", CHECKPOINTS, ids=lambda p: os.path.relpath(p, ART))
def test_ocdbt_keys_are_tensorstores(path):
    assert OcdbtStore(path).list() == sorted(_ts_store(path).list().result())


@pytest.mark.parametrize("name", sorted(TRAINED))
def test_ocdbt_values_and_params_are_the_jax_packages(name):
    """Every value's bytes are tensorstore's; ``read_orbax``'s params and
    the port's ``load_params`` are the JAX package's ``load_params``."""
    path, variant = TRAINED[name]
    mine, theirs = OcdbtStore(path), _ts_store(path)
    for key in theirs.list().result():
        assert mine.read(key) == theirs.read(key).result().value, key
    want = JT.load_params(path, jax_model("pix_shuffle", variant).init(jax.random.key(0)))
    saved = read_orbax(path)
    assert saved["buffers"] == {}  # the __empty__ sentinel: no batchnorm
    _assert_bit_equal({k: v for k, v in saved["params"].items() if v != {}},
                      jax.tree.map(np.asarray, want))
    got = T.load_params(path, get_model("pix_shuffle", variant).init(device="cpu"))
    _assert_bit_equal(params_to_numpy(got), jax.tree.map(np.asarray, want))
    assert int(saved["step"]) > 0 and saved["step"].dtype == np.int32


def test_epoch73_is_the_trained_graph():
    """The committed checkpoint's 24 leaves are the port's import of the
    graph exported from it."""
    got = read_orbax(EPOCH73)["params"]
    want = import_pix_shuffle(os.path.join(ART, "model_pix_shuffle_trained",
                                           "pix_shuffle_trained.onnx")).params
    assert len(_flat(want)) == 24
    _assert_bit_equal({k: v for k, v in got.items() if v != {}}, want)


def _jax_state(name, step):
    params = jax_model(name).init(jax.random.key(1))
    state = jts.init_train_state(params, jts.make_optimizer(steps_per_epoch=3),
                                 has_batchnorm=name == "conv3")
    rng = np.random.default_rng(2)
    # buffers that are neither zeros nor ones, and a step that is not 0
    buffers = jax.tree.map(lambda b: jnp.asarray(rng.random(b.shape, np.float32) + 0.5),
                           state.buffers)
    return state._replace(step=jnp.int32(step), buffers=buffers)


@pytest.mark.parametrize("name", ["conv3", "pix_shuffle"])
def test_jax_save_checkpoint_is_read(name, tmp_path):
    path = str(tmp_path / f"checkpoint_best_{name}")
    state = _jax_state(name, 37)
    JT.save_checkpoint(path, state)
    whole = read_orbax(path, subtrees=("step", "params", "buffers", "opt_state"))
    assert int(whole["step"]) == 37
    _assert_bit_equal({k: v for k, v in whole["params"].items() if v != {}},
                      jax.tree.map(np.asarray, state.params))
    if name == "conv3":
        assert whole["buffers"] and "__empty__" not in whole["buffers"]
        _assert_bit_equal(whole["buffers"], jax.tree.map(np.asarray, state.buffers))
    else:
        assert whole["buffers"] == {}
    # optax's chain: (add_decayed_weights' empty state, adam's (count, mu,
    # nu), the schedule's count); every count an int32 scalar
    counts = [(k, v) for k, v in _flat(whole["opt_state"]) if k[-1] == "count"]
    assert counts and all(v.dtype == np.int32 and v.shape == () for _, v in counts)
    want = JT.load_params(path, jax_model(name).init(jax.random.key(0)))
    _assert_bit_equal(params_to_numpy(T.load_params(path, get_model(name).init(device="cpu"))),
                      jax.tree.map(np.asarray, want))


def test_export_cli_writes_the_trained_graph_from_its_checkpoint(tmp_path, capsys):
    out = tmp_path / "pix_shuffle_trained.onnx"
    assert export_cli.main(["--checkpoint", EPOCH73, "--model_type", "pix_shuffle",
                            "--output", str(out), "--fp32", "--device", "cpu"]) == 0
    assert out.read_bytes() == open(os.path.join(ART, "model_pix_shuffle_trained",
                                                 "pix_shuffle_trained.onnx"), "rb").read()


@pytest.fixture
def tiny_tree(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(0)
    d = tmp_path / "train" / "img1"
    d.mkdir(parents=True)
    for loc in ((0, 0), (8, 8), (4, 4)):
        base = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
        Image.fromarray(base).save(d / f"target_{loc[0]}_{loc[1]}_s100_r0.png")
        Image.fromarray((base // 32) * 32).save(
            d / f"lores_{loc[0]}_{loc[1]}_s100_r0_rgb444_p32_dnone.png")
    return str(tmp_path / "train")


def test_port_trainer_resumes_a_jax_run(tiny_tree, tmp_path, monkeypatch):
    """The JAX trainer's CSV (two epochs) and orbax checkpoint of a conv3
    run: the port's trainer goes on at epoch 3 from the checkpoint's weights
    and batchnorm buffers (JAX's ``load_checkpoint``), with a fresh
    optimizer at the CSV's learning rate."""
    ck_dir = str(tmp_path / "run")
    ckpt = os.path.join(ck_dir, "checkpoint_epoch_2_conv3")
    state = _jax_state("conv3", 6)
    JT.save_checkpoint(ckpt, state)
    stats = os.path.join(ck_dir, "training_stats_conv3.csv")
    JT.save_training_stats(stats, 1, 0.5, 0.4, 0, 9e-4, os.path.join(ck_dir, "gone"))
    JT.save_training_stats(stats, 2, 0.3, 0.35, 0, 8.5e-4, ckpt)
    want = JT.load_checkpoint(ckpt, state)

    first = {}
    real = T.make_train_step

    def capturing(*a, **kw):
        step = real(*a, **kw)

        def run(st, lr_b, hr_b):
            if not first:
                # copies: the CPU's numpy views share the tensors' memory
                first.update(params=jax.tree.map(np.array, params_to_numpy(st.params)),
                             buffers=jax.tree.map(np.array, params_to_numpy(st.buffers)),
                             lr=st.optimizer.param_groups[0]["lr"],
                             moments=len(st.optimizer.state))
            return step(st, lr_b, hr_b)
        return run

    monkeypatch.setattr(T, "make_train_step", capturing)
    pairs = gather_all_samples_from_directory(tiny_tree, (16, 16), verbose=0)
    train_pool, val_pool = split_pairs(pairs, 0.34)
    train_ds = SRDataset(train_pool, (16, 16), num_samples=4, batch_size=2, linear=False,
                         transfer_dtype="uint8")
    val_ds = SRDataset(val_pool, (16, 16), num_samples=2, batch_size=2, linear=False,
                       flips=False, transfer_dtype="uint8")
    cfg = T.TrainerConfig(num_epochs=3, lr=1e-3, batch_size=2, accumulation_steps=2,
                          checkpoint_interval=1, checkpoint_dir=ck_dir, verbose=0,
                          device="cpu")
    T.Trainer(get_model("conv3"), cfg).train(train_ds, val_ds)
    _assert_bit_equal(first["params"], jax.tree.map(np.asarray, want.params))
    _assert_bit_equal(first["buffers"], jax.tree.map(np.asarray, want.buffers))
    assert first["lr"] == 8.5e-4 and first["moments"] == 0
    with open(stats) as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows[1:]] == ["1", "2", "3"]
    assert float(rows[-1][4]) == 8.5e-4 * cfg.lr_decay_rate


def test_the_drivers_read_orbax_through_load_params(tmp_path, monkeypatch):
    """bench_families with no committed graph takes the heavy run's orbax
    checkpoint from its work directory: its frame is the one of JAX's
    ``load_params`` weights, byte for byte. bench_conv6_latency,
    train_nas_winner and training_parity_study reach checkpoints only
    through ``train.trainer.load_params``."""
    work = tmp_path / "work"
    ck = work / "train_psh" / "checkpoint_best_pix_shuffle"
    shutil.copytree(HEAVY60, ck)
    monkeypatch.setattr(bench_families, "ARTIFACTS", str(tmp_path / "no_graphs"))
    enhance, src = bench_families.family_fn("pix_shuffle_heavy", "cpu", str(work))
    assert src == f"trained checkpoint {ck}"
    m = get_model("pix_shuffle", "heavyweight")
    want = JT.load_params(str(ck), jax_model("pix_shuffle", "heavyweight").init(
        jax.random.key(0)))
    ref = make_enhance_fn(m.apply, params_from_jax(jax.tree.map(np.asarray, want), "cpu"),
                          crop_left=16, device="cpu")
    frame = np.random.default_rng(4).integers(0, 256, (1, 48, 80, 4), np.uint8)
    assert np.array_equal(enhance(frame).numpy(), ref(frame).numpy())
    for name in ("bench_conv6_latency", "train_nas_winner", "training_parity_study"):
        path = os.path.join(REPO, "fs_uae_image_enhancer_project_tpu_torch", "scripts",
                            f"{name}.py")
        tree = ast.parse(open(path).read())
        imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                    and n.module and n.module.endswith("train.trainer") for a in n.names}
        called = {n.func.id for n in ast.walk(tree)
                  if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)}
        assert "load_params" in imported and "load_params" in called, name
        assert "torch.load" not in open(path).read(), name


def _ts_write(path, config, commits):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + str(path) + "/",
                          "config": config}).result()
    for c in range(commits):
        with ts.Transaction() as txn:
            for i in range(40):
                kv.with_transaction(txn)[f"key{c:02d}_{i:04d}".encode()] = bytes(
                    [c]) * (i * 7 % 60)
    return kv


@pytest.mark.parametrize("config,commits,empty", [
    ({"max_decoded_node_bytes": 600, "version_tree_arity_log2": 1,
      "max_inline_value_bytes": 20}, 6, False),
    ({"manifest_kind": "numbered", "version_tree_arity_log2": 1}, 4, False),
    ({"compression": None}, 2, False),
    ({"compression": {"id": "zstd", "level": 5}}, 2, True),
], ids=["interior_nodes_version_tree", "numbered", "uncompressed", "emptied"])
def test_ocdbt_reads_tensorstores_stores(config, commits, empty, tmp_path):
    kv = _ts_write(tmp_path, config, commits)
    if empty:
        for key in kv.list().result():
            del kv[key]
    store = OcdbtStore(str(tmp_path))
    keys = kv.list().result()
    assert store.list() == sorted(keys) and (keys == []) == empty
    for key in keys:
        assert store.read(key) == kv.read(key).result().value
    gens = [v["generation_number"] for v in store.versions()]
    assert gens == list(range(1, len(gens) + 1)) and gens[-1] == store.version[
        "generation_number"]
    dump = ts.ocdbt.dump(ts.KvStore.open("file://" + str(tmp_path) + "/").result()).result()
    assert store.version["generation_number"] == dump["versions"][-1]["generation_number"]
    assert store.config["uuid"] == dump["config"]["uuid"]
    if not empty and config.get("max_decoded_node_bytes"):
        assert store.version["root_height"] > 0  # interior nodes were read


def test_zarr_arrays_of_every_supported_layout(tmp_path):
    """Several chunks (edge chunks cut), bf16, int64, a chunk left to the
    fill value, the "/" separator, and a key holding a dot; F order raises."""
    base = "file://" + str(tmp_path) + "/"
    rng = np.random.default_rng(9)
    arrays = {
        ("params", "conv.w"): (rng.standard_normal((5, 7, 3)).astype(np.float32),
                               dict(chunks=[2, 3, 3], order="C", dtype="<f4")),
        ("params", "bf"): (rng.standard_normal((9, 4)).astype(ts.bfloat16.numpy_dtype),
                           dict(chunks=[4, 4], order="C", dtype="bfloat16")),
        ("params", "i8"): (rng.integers(-2**40, 2**40, (6,)).astype(np.int64),
                           dict(chunks=[4], order="C", dtype="<i8",
                                dimension_separator="/")),
        ("params", "gap"): (np.full((8,), 1.5, np.float32),
                            dict(chunks=[2], order="C", dtype="<f4", fill_value=1.5)),
    }
    meta = {}
    for keys, (arr, zmeta) in arrays.items():
        name = ".".join(keys)
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base,
                                                   "path": name + "/"},
                     "metadata": dict(shape=list(arr.shape),
                                      compressor={"id": "zstd", "level": 1}, **zmeta)},
                    create=True).result()
        if keys[-1] == "gap":  # chunks of the fill value are not stored
            t[2:4] = np.float32(7.0)
            arr[2:4] = 7.0
        else:
            t[...] = arr
        meta[str(keys)] = {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                           "value_metadata": {"value_type": "jax.Array",
                                              "skip_deserialize": False}}
    with open(tmp_path / "_METADATA", "w") as f:
        json.dump({"tree_metadata": meta, "use_zarr3": False}, f)
    store = OcdbtStore(str(tmp_path))
    assert b"params.gap/0" not in store.list() and b"params.gap/1" in store.list()
    assert b"params.i8/1" in store.list()
    got = read_orbax(str(tmp_path), subtrees=("params",))["params"]
    assert set(got) == {"conv.w", "bf", "i8", "gap"}
    for keys, (arr, _) in arrays.items():
        want = arr.astype(np.float32) if arr.dtype == ts.bfloat16.numpy_dtype else arr
        assert got[keys[1]].dtype == want.dtype and np.array_equal(got[keys[1]], want), keys
    with pytest.raises(OrbaxError, match="step"):
        read_orbax(str(tmp_path))
    ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": base,
                                           "path": "params.f/"},
             "metadata": dict(shape=[2, 2], chunks=[2, 2], order="F", dtype="<f4",
                              compressor=None)}, create=True).result()[...] = 1.0
    meta["('params', 'f')"] = {"key_metadata": [{"key": "params", "key_type": 2},
                                                {"key": "f", "key_type": 2}],
                               "value_metadata": {"value_type": "jax.Array",
                                                  "skip_deserialize": False}}
    with open(tmp_path / "_METADATA", "w") as f:
        json.dump({"tree_metadata": meta, "use_zarr3": False}, f)
    with pytest.raises(OrbaxError, match="order"):
        read_orbax(str(tmp_path), subtrees=("params",))


def _corrupt_manifest(d):
    p = os.path.join(d, "manifest.ocdbt")
    raw = bytearray(open(p, "rb").read())
    raw[30] ^= 0x10
    open(p, "wb").write(bytes(raw))


def _corrupt_root_node(d):
    (node,) = glob.glob(os.path.join(d, "d", "*"))
    raw = bytearray(open(node, "rb").read())
    raw[len(raw) // 2] ^= 0x01
    open(node, "wb").write(bytes(raw))


def _truncate_data_file(d):
    big = max(glob.glob(os.path.join(d, "ocdbt.process_0", "d", "*")), key=os.path.getsize)
    raw = open(big, "rb").read()
    open(big, "wb").write(raw[:len(raw) // 2])


def _remove_data_file(d):
    big = max(glob.glob(os.path.join(d, "ocdbt.process_0", "d", "*")), key=os.path.getsize)
    os.remove(big)


@pytest.mark.parametrize("damage,match", [
    (_corrupt_manifest, "CRC-32C"), (_corrupt_root_node, "CRC-32C"),
    (_truncate_data_file, "past its"), (_remove_data_file, "missing file")],
    ids=["manifest", "btree_node", "truncated_data_file", "missing_data_file"])
def test_corrupted_copies_raise(damage, match, tmp_path):
    d = str(tmp_path / "ck")
    shutil.copytree(EPOCH73, d)
    damage(d)
    with pytest.raises(OcdbtError, match=match):
        read_orbax(d, subtrees=("step", "params", "buffers", "opt_state"))


def test_crc32c_known_value():
    """The iSCSI check value of CRC-32C (RFC 3720, B.4)."""
    assert crc32c(b"123456789") == 0xE3069283
    assert crc32c(bytes(32)) == 0x8A9136AA


def test_chip_smoke_orbax_phase_on_the_cpu(tmp_path):
    """chip_smoke.py's orbax phase rehearsed at a small size (on the card:
    576x752 frames and the datagen tree's 376x288 crops): its checks pass,
    and K1 never launches on the CPU."""
    from PIL import Image

    import chip_smoke as cs

    rng = np.random.default_rng(0)
    for img in range(2):
        d = tmp_path / "tree" / f"img_{img}"
        d.mkdir(parents=True)
        for loc in range(3):
            base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(base).save(d / f"target_{loc * 8}_0_s0_r0.png")
            Image.fromarray((base // 16) * 16).save(
                d / f"lores_{loc * 8}_0_s0_r0_rgb444_p16_dNone.png")
    cpu = torch.device("cpu")
    rec = cs.orbax_phase(cpu, str(tmp_path / "tree"), crop=(32, 32), frame_hw=(48, 80))
    cs.check_orbax(rec, cpu)
    assert rec["resume"]["new_row"][0] == "13" and rec["resume"]["first_step_lr"] == float(
        rec["resume"]["csv_lr"])
    assert set(rec["reads"]) == {"trained_epoch73", "plateau_50", "heavy_epoch60"}
    assert rec["trained_k1_launches"] == rec["resume_k1_launches"] == 0
