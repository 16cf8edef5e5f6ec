"""The port's dataset against the JAX package's, on the CPU: the gatherer
and split (and ``tests/goldens/gather_goldens.json``), ``SRDataset``'s
batches byte for byte for one seed (float32 and uint8, with flips, with the
retries), ``batch_transform`` (rel 1e-6) and the prefetch's producer exit."""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from fs_uae_image_enhancer_project_tpu.data import dataset as J
from fs_uae_image_enhancer_project_tpu_torch.data import dataset as T


def _make_tree(root, w=8, h=8):
    d = os.path.join(root, "train", "img1")
    os.makedirs(d)
    rng = np.random.default_rng(0)

    def save(name):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(d, name))

    save("target_0_0_s100_r0.png")
    save("lores_0_0_s100_r0_rgb444_p32_dfloyd-steinberg.png")
    save("lores_0_0_s100_r0_rgb888_pNone_dnone.png")
    save("target_4_0_s100_r0.png")
    save("lores_4_0_s100_r0_rgb444_p16_dbayer4x4.png")
    # a location without a target: ignored
    save("lores_4_4_s100_r0_rgb444_p32_dnone.png")
    return os.path.join(root, "train")


@pytest.mark.parametrize("styles", [None, {"rgb444"}, {"bayer"}])
def test_gather_matches_jax(tmp_path, styles):
    train_dir = _make_tree(str(tmp_path))
    got = T.gather_all_samples_from_directory(train_dir, (8, 8), styles, verbose=0)
    want = J.gather_all_samples_from_directory(train_dir, (8, 8), styles, verbose=0)
    assert sorted(got) == sorted(want) and len(got) > 0
    assert T.gather_all_samples_from_directory(train_dir, (16, 16), verbose=0) == []
    with pytest.raises(FileNotFoundError):
        T.gather_all_samples_from_directory(str(tmp_path / "missing"), (8, 8), verbose=0)


def test_gather_matches_reference_golden(tmp_path):
    """The tree of ``gather_goldens.json``: negative crops and rotations, pal
    'None', hyphenated dithers, underscored resolutions, wrong-size targets,
    orphans, noise files, root-level files and the style filter."""
    golden = json.load(open(os.path.join(os.path.dirname(__file__), "goldens",
                                         "gather_goldens.json")))
    base = tmp_path / "split"
    for subdir, name, size in golden["tree"]:
        d = base / subdir if subdir else base
        d.mkdir(parents=True, exist_ok=True)
        if name.endswith(".png"):
            Image.new("RGB", tuple(size), (1, 2, 3)).save(d / name)
        else:
            (d / name).write_bytes(b"not an image")

    def rel_pairs(styles):
        pairs = T.gather_all_samples_from_directory(str(base), tuple(golden["crop"]),
                                                    styles_to_include=styles, verbose=0)
        return sorted([os.path.relpath(s, base), os.path.relpath(t, base)] for s, t in pairs)

    assert rel_pairs(None) == golden["pairs_all"]
    assert rel_pairs({"rgb444"}) == golden["pairs_rgb444"]


def test_gather_same_named_subdirs_do_not_collide(tmp_path):
    rng = np.random.default_rng(1)
    for split in ("train", "val"):
        d = os.path.join(str(tmp_path), split, "sceneA")
        os.makedirs(d)
        for name in ("target_0_0_s100_r0.png", "lores_0_0_s100_r0_rgb444_p32_dnone.png"):
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(
                os.path.join(d, name))
    pairs = T.gather_all_samples_from_directory(str(tmp_path), (8, 8), verbose=0)
    assert len(pairs) == 2
    assert all(os.path.dirname(s) == os.path.dirname(t) for s, t in pairs)


@pytest.mark.parametrize("n,ratio,seed", [(10, 0.2, 1), (1, 0.5, 0), (7, 0.0, 3), (5, 1.0, 2),
                                          (2, 0.1, 4), (13, 0.35, 9)])
def test_split_pairs_matches_jax(n, ratio, seed):
    pairs = [(f"a{i}", f"b{i}") for i in range(n)]
    got = T.split_pairs(pairs, ratio, seed=seed)
    want = J.split_pairs(pairs, ratio, seed=seed)
    assert got == want


def _batches(mod, pairs, **kw):
    return list(mod.SRDataset(pairs, (8, 8), **kw))


@pytest.mark.parametrize("transfer_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("linear,flips", [(True, True), (False, True), (True, False)])
def test_srdataset_batches_are_jax_byte_for_byte(tmp_path, transfer_dtype, linear, flips):
    pairs = T.gather_all_samples_from_directory(_make_tree(str(tmp_path)), (8, 8), verbose=0)
    kw = dict(num_samples=12, batch_size=3, seed=5, linear=linear, flips=flips,
              transfer_dtype=transfer_dtype)
    got, want = _batches(T, pairs, **kw), _batches(J, pairs, **kw)
    assert len(got) == len(want) == 4
    for (gl, gh), (wl, wh) in zip(got, want):
        assert gl.dtype == wl.dtype == np.dtype(transfer_dtype)
        assert gl.shape == (3, 8, 8, 3)
        assert gl.tobytes() == wl.tobytes() and gh.tobytes() == wh.tobytes()
    assert len(T.SRDataset(pairs, (8, 8), num_samples=7, batch_size=2)) == 3
    with pytest.raises(ValueError):
        T.SRDataset(pairs, (8, 8), num_samples=2, transfer_dtype="float16")


@pytest.mark.parametrize("parts", [2, 4])
def test_srdataset_dp_share_is_jax_batches_block(tmp_path, parts):
    """A dp rank's share (``batches(part, parts)``, what each rank of a mesh
    loads): block ``part`` of JAX's whole batches, byte for byte, the stream
    unchanged; a batch that does not divide raises."""
    pairs = T.gather_all_samples_from_directory(_make_tree(str(tmp_path)), (8, 8), verbose=0)
    kw = dict(num_samples=12, batch_size=4, seed=5, transfer_dtype="uint8")
    want = _batches(J, pairs, **kw)
    n = 4 // parts
    for part in range(parts):
        got = list(T.SRDataset(pairs, (8, 8), **kw).batches(part, parts))
        assert len(got) == len(want) == 3
        for (gl, gh), (wl, wh) in zip(got, want):
            assert gl.shape == (n, 8, 8, 3)
            assert gl.tobytes() == wl[part * n:(part + 1) * n].tobytes()
            assert gh.tobytes() == wh[part * n:(part + 1) * n].tobytes()
    with pytest.raises(ValueError, match="divisible"):
        next(T.SRDataset(pairs, (8, 8), **kw).batches(0, 3))


def test_srdataset_empty_pool_raises():
    with pytest.warns(UserWarning):
        ds = T.SRDataset([], (8, 8), num_samples=2)
    with pytest.raises(IndexError):
        next(iter(ds))


def test_srdataset_corrupt_file_retry_matches_jax(tmp_path):
    d = tmp_path / "train" / "img"
    d.mkdir(parents=True)
    good = np.random.default_rng(0).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    Image.fromarray(good).save(d / "target_0_0_s100_r0.png")
    Image.fromarray(good[::-1]).save(d / "lores_0_0_s100_r0_rgb444_p32_dnone.png")
    Image.fromarray(good).save(d / "target_4_4_s100_r0.png")
    (d / "lores_4_4_s100_r0_rgb444_p32_dnone.png").write_bytes(b"not a png")
    pairs = T.gather_all_samples_from_directory(str(tmp_path / "train"), (8, 8), verbose=0)
    assert len(pairs) == 2
    with pytest.warns(UserWarning, match="Retrying"):
        got = _batches(T, pairs, num_samples=12, batch_size=2, seed=0)
    with pytest.warns(UserWarning):
        want = _batches(J, pairs, num_samples=12, batch_size=2, seed=0)
    assert len(got) == 6
    for (gl, gh), (wl, wh) in zip(got, want):
        assert gl.tobytes() == wl.tobytes() and gh.tobytes() == wh.tobytes()


def test_srdataset_wrong_size_styled_file_retries(tmp_path):
    pairs = T.gather_all_samples_from_directory(_make_tree(str(tmp_path)), (8, 8), verbose=0)
    Image.fromarray(np.zeros((9, 8, 3), np.uint8)).save(pairs[0][0])
    with pytest.warns(UserWarning, match="Retrying"):
        got = _batches(T, pairs, num_samples=8, batch_size=2, seed=0)
    with pytest.warns(UserWarning):
        want = _batches(J, pairs, num_samples=8, batch_size=2, seed=0)
    assert len(got) == 4
    for (gl, gh), (wl, wh) in zip(got, want):
        assert gl.shape == (2, 8, 8, 3) and gl.tobytes() == wl.tobytes()
        assert gh.tobytes() == wh.tobytes()


@pytest.mark.parametrize("linear", [True, False])
def test_batch_transform_matches_jax(linear):
    x = np.random.default_rng(2).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    got = T.batch_transform(linear)(torch.from_numpy(x))
    want = np.asarray(J.batch_transform(linear)(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    f = torch.rand(1, 2, 2, 3)
    assert T.batch_transform(linear)(f) is f  # float batches pass unchanged


def test_device_prefetch_yields_the_batches_on_the_cpu():
    batches = [(np.full((1, 2, 2, 3), i, np.uint8), np.full((1, 2, 2, 3), -i, np.float32))
               for i in range(5)]
    got = list(T.device_prefetch(iter(batches), size=2, device="cpu"))
    assert len(got) == 5
    for (a, b), (x, y) in zip(batches, got):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert np.array_equal(x.numpy(), a) and np.array_equal(y.numpy(), b)


def test_device_prefetch_reraises_the_producers_error():
    def broken():
        yield (np.zeros((1, 2, 2, 3), np.float32),) * 2
        raise OSError("disk gone")

    gen = T.device_prefetch(broken(), size=2, device="cpu")
    next(gen)
    with pytest.raises(OSError, match="disk gone"):
        next(gen)


def test_device_prefetch_producer_exits_on_early_consumer_exit():
    """Abandoning the prefetch (an exception in the train loop) retires the
    producer instead of leaving it blocked on a full queue."""
    n_before = threading.active_count()
    batches = iter([(np.zeros((1, 4, 4, 3), np.float32),) * 2 for _ in range(100)])
    gen = T.device_prefetch(batches, size=2, device="cpu")
    next(gen)
    gen.close()
    deadline = time.time() + 30
    while threading.active_count() > n_before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= n_before
    # the producer stopped drawing: at most the queue's 2, the one in hand
    # and the one it was putting are gone from the iterator
    assert len(list(batches)) >= 100 - 5


def test_device_prefetch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(T.device_prefetch(iter([]), size=2))
