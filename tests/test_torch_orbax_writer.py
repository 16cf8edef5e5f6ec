"""The port's orbax writer (``train/orbax_writer.py`` over ``utils/ocdbt.py``'s
``write_store`` and ``utils/zstd.py``'s ``compress``) and the trainer's
checkpoints against the JAX package, orbax, tensorstore and zstandard, on
the CPU.

Tolerances: none. A checkpoint moves bytes and does no arithmetic, so every
leaf, count and metadata tree is compared for equality, bit for bit.

- port states of conv3 (BatchNorm buffers) and pix_shuffle (the ``__empty__``
  sentinel) after three Adam steps, with ``steps_per_epoch`` set and unset,
  written by the port's ``save_checkpoint``: the JAX package's
  ``load_params`` and ``load_checkpoint`` (its template from JAX's own
  ``make_optimizer``) give the port's step, params, buffers, Adam's
  ``count``, ``mu`` and ``nu`` and the schedule's ``count``; tensorstore
  reads every array to the same bytes; ``_METADATA`` is the one JAX's
  ``save_checkpoint`` writes for that state; the port's ``load_checkpoint``
  gives a fresh state whose next step is the original's;
- the committed ``checkpoint_best_epoch73`` read and written again gives
  JAX's ``load_params`` the same leaves;
- the JAX trainer resumes a run the port's trainer began;
- ``compress`` frames of one and several blocks, and of nothing, decoded by
  zstandard and the port; OCDBT stores of one leaf and with interior nodes
  read by tensorstore;
- a write that fails leaves the previous checkpoint whole and no temporary
  directory, and one that died between its renames is read where it set
  the old checkpoint aside; a ``state.pt`` of an earlier run still loads;
- the port's ``load_checkpoint`` restores the JAX package's checkpoint of
  the same state, and the committed epoch73 with its moments;
- every ``fse-torch-*`` console script is a callable ``main`` of the port.
"""
import csv
import dataclasses
import importlib
import json
import os
import tomllib

import numpy as np
import pytest
import torch

import jax

ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

from fs_uae_image_enhancer_project_tpu.data import SRDataset as JaxDataset  # noqa: E402
from fs_uae_image_enhancer_project_tpu.data import (  # noqa: E402
    gather_all_samples_from_directory as jax_gather, split_pairs as jax_split)
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model  # noqa: E402
from fs_uae_image_enhancer_project_tpu.parallel import train_step as jts  # noqa: E402
from fs_uae_image_enhancer_project_tpu.train import trainer as JT  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.data import (  # noqa: E402
    SRDataset, gather_all_samples_from_directory, split_pairs)
from fs_uae_image_enhancer_project_tpu_torch.models import get_model  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.parallel.train_step import (  # noqa: E402
    init_train_state, leaves, make_optimizer)
from fs_uae_image_enhancer_project_tpu_torch.train import orbax_writer  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.train import trainer as T  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.train.orbax_reader import read_orbax  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.utils import ocdbt, zstd  # noqa: E402
from fs_uae_image_enhancer_project_tpu_torch.utils.ocdbt import (  # noqa: E402
    OcdbtStore, write_store)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH73 = os.path.join(REPO, "artifacts", "model_pix_shuffle_trained", "checkpoint_best_epoch73")
CASES = [("conv3", 2), ("conv3", None), ("pix_shuffle", 2), ("pix_shuffle", None)]
IDS = ["conv3-steps_per_epoch", "conv3-no_schedule", "pix_shuffle-steps_per_epoch",
       "pix_shuffle-no_schedule"]


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads: the test runs beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _port_state(name, spe, steps=3, seed=5):
    """A port state after ``steps`` Adam steps on seeded gradients, its
    buffers (conv3) neither zeros nor ones."""
    m = get_model(name)
    state = init_train_state(m.init(torch.Generator().manual_seed(seed), device="cpu"),
                             make_optimizer(steps_per_epoch=spe), has_batchnorm=name == "conv3")
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(steps):
        for p in leaves(state.params):
            p.grad = torch.randn(p.shape, generator=g)
        state.optimizer.step()
        state.scheduler.step()
        state = state._replace(step=state.step + 1)
    with torch.no_grad():
        for b in leaves(state.buffers):
            b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return state


def _named(tree, pre=""):
    """{dotted path: leaf} of a nested dict of tensors, empty dicts left out."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _named(tree[key], f"{pre}{key}.").items()}
    return {pre[:-1]: tree}


def _want(state, spe):
    """The JAX package's payload for ``state``, built here from the
    optimizer's own state dicts: {name: numpy array}."""
    want = {"step": np.int32(state.step)}
    params = _named(state.params)
    want.update({f"params.{k}": t.detach().numpy() for k, t in params.items()})
    want.update({f"buffers.{k}": t.numpy() for k, t in _named(state.buffers).items()})
    for k, t in params.items():
        st = state.optimizer.state[t]
        want[f"opt_state.1.mu.{k}"] = st["exp_avg"].numpy()
        want[f"opt_state.1.nu.{k}"] = st["exp_avg_sq"].numpy()
        want["opt_state.1.count"] = np.int32(st["step"].item())
    if spe:
        want["opt_state.2.count"] = np.int32(state.scheduler.last_epoch)
    return want


def _jax_named(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", getattr(k, "name", None))) for k in path]
        out[".".join(map(str, keys))] = np.asarray(leaf)
    return out


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


def _jax_template(name, spe):
    return jts.init_train_state(jax_model(name).init(jax.random.key(0)),
                                jts.make_optimizer(steps_per_epoch=spe),
                                has_batchnorm=name == "conv3")


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each case's port state and its checkpoint, written once."""
    out = {}
    for name, spe in CASES:
        state = _port_state(name, spe)
        path = str(tmp_path_factory.mktemp("ck") / f"checkpoint_best_{name}")
        T.save_checkpoint(path, state)
        out[(name, spe)] = (state, path)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_jax_restores_the_ports_checkpoint_bit_for_bit(case, written):
    name, spe = case
    state, path = written[case]
    assert not os.path.exists(os.path.join(path, T.LEGACY_CHECKPOINT_FILE))
    want = _want(state, spe)
    r = JT.load_checkpoint(path, _jax_template(name, spe))
    assert r.opt_state[0] == () and (r.opt_state[2] == ()) == (spe is None)
    _assert_equal(_jax_named({"step": r.step, "params": r.params, "buffers": r.buffers,
                              "opt_state": r.opt_state}), want)
    merged = JT.load_params(path, jax_model(name).init(jax.random.key(0)))
    _assert_equal(_jax_named(merged), {k.split(".", 1)[1]: v for k, v in want.items()
                                       if k.startswith(("params.", "buffers."))})


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_tensorstore_reads_every_array_and_metadata_is_jaxs(case, written, tmp_path):
    name, spe = case
    state, path = written[case]
    want = _want(state, spe)
    if name == "pix_shuffle":
        want["buffers.__empty__"] = np.zeros((1,), np.float32)
    meta = json.load(open(os.path.join(path, "_METADATA")))
    arrays = {".".join(k["key"] for k in e["key_metadata"])
              for e in meta["tree_metadata"].values()
              if e["value_metadata"]["value_type"] == "jax.Array"}
    assert arrays == set(want)
    for name_ in arrays:
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt",
                                                   "base": f"file://{path}/",
                                                   "path": f"{name_}/"}}).result()
        got = t.read().result()
        assert got.dtype == want[name_].dtype and got.tobytes() == want[name_].tobytes(), name_
    # the same state saved by the JAX package
    r = JT.load_checkpoint(path, _jax_template(name, spe))
    JT.save_checkpoint(str(tmp_path / "jax"), r)
    assert meta == json.load(open(tmp_path / "jax" / "_METADATA"))
    ckpt_meta = json.load(open(os.path.join(path, "_CHECKPOINT_METADATA")))
    assert set(ckpt_meta) == set(json.load(open(tmp_path / "jax" / "_CHECKPOINT_METADATA")))
    procs = json.load(open(os.path.join(path, "array_metadatas", "process_0")))
    assert procs == json.load(open(tmp_path / "jax" / "array_metadatas" / "process_0"))
    # and the port restores JAX's checkpoint to the state it was written from
    restored = T.load_checkpoint(str(tmp_path / "jax"), _port_state(name, spe, steps=0, seed=7))
    assert restored.step == state.step
    _assert_same_optimizer(restored, state)


def _assert_same_optimizer(a, b):
    """Equal moments and Adam steps leaf for leaf, and equal schedules."""
    for p, q in zip(leaves(a.params), leaves(b.params)):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert sorted(sa) == sorted(sb) == ["exp_avg", "exp_avg_sq", "step"]
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert a.scheduler.last_epoch == b.scheduler.last_epoch
    assert ([g["lr"] for g in a.optimizer.param_groups]
            == [g["lr"] for g in b.optimizer.param_groups])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_port_restores_its_checkpoint_and_steps_on_equal(case, written):
    """A fresh state (other seed) restored by the port's ``load_checkpoint``
    holds the original's step, leaves and optimizer, and its next Adam step
    on the same gradients gives the original's leaves."""
    name, spe = case
    path = written[case][1]
    state = _port_state(name, spe)  # the written state, made again: this test steps it
    fresh = _port_state(name, spe, steps=0, seed=11)
    restored = T.load_checkpoint(path, fresh)
    assert restored.step == state.step
    assert restored.scheduler.last_epoch == state.scheduler.last_epoch
    assert ([g["lr"] for g in restored.optimizer.param_groups]
            == [g["lr"] for g in state.optimizer.param_groups])
    for st in (state, restored):
        g = torch.Generator().manual_seed(21)
        for p in leaves(st.params):
            p.grad = torch.randn(p.shape, generator=g)
        st.optimizer.step()
        st.scheduler.step()
    for a, b in zip(leaves(restored.params) + leaves(restored.buffers),
                    leaves(state.params) + leaves(state.buffers)):
        assert torch.equal(a, b)
    # the written checkpoint is unchanged by the step taken after it
    assert int(read_orbax(path)["step"]) == state.step


def test_epoch73_written_again_gives_jax_the_same_leaves(tmp_path):
    tree = read_orbax(EPOCH73, subtrees=("step", "params", "buffers", "opt_state"))
    tree["buffers"] = {T.EMPTY_BUFFERS: np.zeros((1,), np.float32)}
    out = str(tmp_path / "epoch73")
    orbax_writer.write_orbax(out, tree)
    template = jax_model("pix_shuffle").init(jax.random.key(0))
    _assert_equal(_jax_named(JT.load_params(out, template)),
                  _jax_named(JT.load_params(EPOCH73, template)))
    assert (json.load(open(os.path.join(out, "_METADATA")))
            == json.load(open(os.path.join(EPOCH73, "_METADATA"))))
    whole = read_orbax(out, subtrees=("step", "params", "buffers", "opt_state"))
    _assert_equal(_named_np(whole), _named_np(dict(tree, buffers={})))  # the sentinel read as {}


def test_port_restores_epoch73_with_its_moments(tmp_path):
    """The committed TPU checkpoint restored by the port's ``load_checkpoint``
    into a pix_shuffle state: its weights, Adam's moments and count, and the
    schedule's count with the learning rate the port's schedule gives it."""
    saved = read_orbax(EPOCH73, subtrees=("step", "params", "opt_state"))
    adam, schedule = saved["opt_state"][1], saved["opt_state"][2]
    spe = 7
    state = init_train_state(get_model("pix_shuffle").init(torch.Generator().manual_seed(0),
                                                           device="cpu"),
                             make_optimizer(steps_per_epoch=spe))
    restored = T.load_checkpoint(EPOCH73, state)
    assert restored.step == int(saved["step"])
    count, n = int(adam["count"]), int(schedule["count"])
    assert count > 0 and restored.scheduler.last_epoch == n
    assert [g["lr"] for g in restored.optimizer.param_groups] == [1e-3 * 0.955 ** (n // spe)]
    for k, p in _named(restored.params).items():
        st = restored.optimizer.state[p]
        assert np.array_equal(p.detach().numpy(), _named_np(saved["params"])[k]), k
        assert np.array_equal(st["exp_avg"].numpy(), _named_np(adam["mu"])[k]), k
        assert np.array_equal(st["exp_avg_sq"].numpy(), _named_np(adam["nu"])[k]), k
        assert st["step"].item() == count


def test_rewrite_that_died_between_its_renames_is_read_aside(tmp_path):
    """A process that died after setting the old checkpoint aside and
    before renaming the new one into place: the port still loads the old
    one by its path, and the next write removes it."""
    path = str(tmp_path / "checkpoint_best_conv3")
    state = _port_state("conv3", 2)
    T.save_checkpoint(path, state)
    aside = f"{path}.orbax-checkpoint-old-0123456789abcdef"
    os.rename(path, aside)
    assert orbax_writer.committed(path) == aside
    restored = T.load_checkpoint(path, _port_state("conv3", 2, steps=0, seed=3))
    assert restored.step == state.step
    _assert_same_optimizer(restored, state)
    for a, b in zip(leaves(restored.params) + leaves(restored.buffers),
                    leaves(state.params) + leaves(state.buffers)):
        assert torch.equal(a, b)
    T.save_checkpoint(path, state)
    assert os.listdir(tmp_path) == ["checkpoint_best_conv3"]
    assert orbax_writer.committed(path) == path


def _named_np(tree, pre=""):
    if isinstance(tree, (dict, list)):
        keys = tree if isinstance(tree, dict) else range(len(tree))
        return {k: v for key in keys for k, v in _named_np(tree[key], f"{pre}{key}.").items()}
    return {} if tree is None else {pre[:-1]: tree}


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


def test_jax_trainer_resumes_a_port_run(tiny_tree, tmp_path, monkeypatch):
    """The port's trainer runs conv3 for two epochs (VGG off); the JAX
    trainer goes on at epoch 3 from the CSV, and its ``load_checkpoint``
    gives the weights, buffers and step of the checkpoint the CSV names."""
    ck_dir = str(tmp_path / "run")
    m = get_model("conv3")
    m = m._replace(loss=dataclasses.replace(m.loss, vgg_weight=0.0))
    pairs = gather_all_samples_from_directory(tiny_tree, (16, 16), verbose=0)
    train_pool, val_pool = split_pairs(pairs, 0.34)
    cfg = T.TrainerConfig(num_epochs=2, lr=1e-3, batch_size=2, accumulation_steps=2,
                          checkpoint_interval=1, checkpoint_dir=ck_dir, verbose=0,
                          device="cpu")
    T.Trainer(m, cfg).train(
        SRDataset(train_pool, (16, 16), num_samples=4, batch_size=2, linear=False,
                  transfer_dtype="uint8"),
        SRDataset(val_pool, (16, 16), num_samples=2, batch_size=2, linear=False, flips=False,
                  transfer_dtype="uint8"))
    stats = os.path.join(ck_dir, "training_stats_conv3.csv")
    with open(stats) as f:
        rows = list(csv.reader(f))
    ckpt = rows[-1][5]
    assert rows[-1][0] == "2" and ckpt.endswith("checkpoint_epoch_2_conv3")
    saved = read_orbax(ckpt)
    assert int(saved["step"]) == 2  # one optimizer step an epoch

    restored = {}
    real = JT.load_checkpoint

    def recording(path, template):
        r = real(path, template)
        restored.update(path=path, step=int(r.step), params=_jax_named(r.params),
                        buffers=_jax_named(r.buffers))
        return r

    monkeypatch.setattr(JT, "load_checkpoint", recording)
    jm = jax_model("conv3")
    jm = jm._replace(loss=dataclasses.replace(jm.loss, vgg_weight=0.0))
    jpairs = jax_gather(tiny_tree, (16, 16), verbose=0)
    jtrain, jval = jax_split(jpairs, 0.34)
    jcfg = JT.TrainerConfig(num_epochs=3, lr=1e-3, batch_size=2, accumulation_steps=2,
                            checkpoint_interval=1, checkpoint_dir=ck_dir, verbose=0,
                            compute_dtype="float32")
    JT.Trainer(jm, jcfg).train(
        JaxDataset(jtrain, (16, 16), num_samples=4, batch_size=2, linear=False),
        JaxDataset(jval, (16, 16), num_samples=2, batch_size=2, linear=False, flips=False))
    assert restored["path"] == ckpt and restored["step"] == 2
    _assert_equal(restored["params"], _named_np(saved["params"]))
    _assert_equal(restored["buffers"], _named_np(saved["buffers"]))
    with open(stats) as f:
        rows = list(csv.reader(f))
    assert [r[0] for r in rows[1:]] == ["1", "2", "3"]
    assert float(rows[-1][4]) == pytest.approx(float(rows[-2][4]) * cfg.lr_decay_rate,
                                               rel=1e-12)


@pytest.mark.parametrize("n", [0, 1, 4096, (1 << 17) - 1, 1 << 17, (1 << 17) + 1, 300_000])
def test_compress_is_read_by_zstandard_and_the_port(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    frame = zstd.compress(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == n and not params.has_checksum
    assert len(frame) == 10 + 3 * max(1, -(-n // (1 << 17))) + n  # raw blocks only


@pytest.mark.parametrize("config", [
    {"max_decoded_node_bytes": 600, "max_inline_value_bytes": 20},
    {},
], ids=["interior_nodes", "one_leaf"])
def test_ocdbt_writer_is_read_by_tensorstore(config, tmp_path, monkeypatch):
    """Under the checkpoints' config one leaf holds every key; with a node
    limit of 600 bytes (and values over 20 bytes in the data file) the
    leaves need interior nodes above them."""
    for k, v in config.items():
        monkeypatch.setitem(ocdbt.CONFIG, k, v)
    items = {f"k{i:03d}/{'x' * (i % 5)}".encode(): bytes([i]) * (i * 13 % 90)
             for i in range(120)}
    write_store(str(tmp_path), items)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/"}).result()
    assert sorted(kv.list().result()) == sorted(items)
    for k, v in items.items():
        assert kv.read(k).result().value == v
    store = OcdbtStore(str(tmp_path))
    assert store.list() == sorted(items)
    assert (store.version["root_height"] > 0) == ("max_decoded_node_bytes" in config)
    assert len(os.listdir(tmp_path / "d")) == 1


def test_failed_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    parent = tmp_path / "run"
    path = str(parent / "checkpoint_best_pix_shuffle")
    first = _port_state("pix_shuffle", 2, steps=1)
    T.save_checkpoint(path, first)
    before = read_orbax(path, subtrees=("step", "params", "buffers", "opt_state"))
    second = _port_state("pix_shuffle", 2, steps=2, seed=9)

    def broken(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(orbax_writer, "write_store", broken)
    with pytest.raises(OSError, match="disk full"):
        T.save_checkpoint(path, second)
    assert os.listdir(parent) == ["checkpoint_best_pix_shuffle"]
    _assert_equal(_named_np(read_orbax(path, subtrees=("step", "params", "buffers",
                                                       "opt_state"))), _named_np(before))
    monkeypatch.undo()
    T.save_checkpoint(path, second)  # a rewrite: the old one replaced, nothing left over
    assert os.listdir(parent) == ["checkpoint_best_pix_shuffle"]
    assert int(read_orbax(path)["step"]) == 2


def test_a_state_pt_of_an_earlier_run_still_loads(tmp_path):
    """The format earlier port runs wrote: one ``torch.save`` file."""
    state = _port_state("conv3", 2)
    path = tmp_path / "checkpoint_epoch_1_conv3"
    path.mkdir()
    torch.save({"step": state.step, "params": {k: {n: t.detach() for n, t in v.items()}
                                               for k, v in state.params.items()},
                "buffers": state.buffers, "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict()},
               str(path / T.LEGACY_CHECKPOINT_FILE))
    restored = T.load_checkpoint(str(path), _port_state("conv3", 2, steps=0, seed=3))
    assert restored.step == 3 and restored.scheduler.last_epoch == 3
    for a, b in zip(leaves(restored.params) + leaves(restored.buffers),
                    leaves(state.params) + leaves(state.buffers)):
        assert torch.equal(a, b)
    assert restored.optimizer.state_dict()["state"][0]["step"] == 3
    params = T.load_params(str(path), get_model("conv3").init(device="cpu"))
    assert torch.equal(params["bn1"]["mean"], state.buffers["bn1"]["mean"])


def _scripts():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]["scripts"]


JAX_SCRIPTS = sorted(k for k, v in _scripts().items()
                     if v.startswith("fs_uae_image_enhancer_project_tpu."))


def test_the_port_has_one_console_script_for_each_of_jaxs():
    scripts = _scripts()
    port = {k for k, v in scripts.items() if v.startswith("fs_uae_image_enhancer_project_tpu_torch.")}
    assert len(JAX_SCRIPTS) == 13
    assert port == {"fse-torch-" + k[len("fse-"):] for k in JAX_SCRIPTS}
    assert set(scripts) == port | set(JAX_SCRIPTS)


@pytest.mark.parametrize("jax_name", JAX_SCRIPTS)
def test_each_port_console_script_is_a_main_of_the_port(jax_name):
    scripts = _scripts()
    target = scripts["fse-torch-" + jax_name[len("fse-"):]]
    module, func = target.split(":")
    jmodule, jfunc = scripts[jax_name].split(":")
    assert module == jmodule.replace("fs_uae_image_enhancer_project_tpu.",
                                     "fs_uae_image_enhancer_project_tpu_torch.", 1)
    assert func == jfunc == "main"
    assert callable(getattr(importlib.import_module(module), func))
