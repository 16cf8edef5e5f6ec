"""The port's repairs, held to the JAX package and its reference goldens on
the CPU:

- the forward's route: on a card the lightweight config in bf16 takes the
  fused-stack kernel, anything else the eager forward (the reference's own
  route); any config and any batch size run, as the JAX ``apply`` runs them;
- the k-means first index is JAX's draw, ``jax.random.randint(jax.random.
  key(seed), (), 0, n)``, computed without jax, so ``kmeans_torch`` palettes
  and corpora equal ``kmeans_jax``'s;
- the generator's defaults are the JAX generator's (the host ``numpy``
  route; the device route is opt-in);
- the reference-run goldens the JAX tests read (pix_shuffle models,
  geometry, the generator's output) hold for the port too.

Tolerances are the JAX tests': 1e-4 for the fp32 forward against JAX, 2e-3
for the bf16 kernels' plain versions, 2e-5 for the pix_shuffle goldens,
byte equality for the geometry, palettes and PNG trees.
"""
import dataclasses
import hashlib
import json
import os
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from fs_uae_image_enhancer_project_tpu.datagen import generator as jax_gen_mod
from fs_uae_image_enhancer_project_tpu.datagen import quantize as jq
from fs_uae_image_enhancer_project_tpu.models import get_model as jax_model
from fs_uae_image_enhancer_project_tpu_torch.datagen import generator as gen_mod
from fs_uae_image_enhancer_project_tpu_torch.datagen import quantize as tq
from fs_uae_image_enhancer_project_tpu_torch.datagen import util_img
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.models import pix_shuffle as tps
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2
from fs_uae_image_enhancer_project_tpu_torch.utils import threefry

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _jax_params(variant):
    jm = jax_model("pix_shuffle", variant)
    return jm, jax.tree_util.tree_map(np.asarray, jm.init(jax.random.key(0)))


# --- the forward's route -------------------------------------------------------

@pytest.mark.parametrize("variant", ["lightweight", "heavyweight"])
def test_batch_of_two_matches_jax_apply(variant):
    jm, tree = _jax_params(variant)
    x = np.random.default_rng(5).uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    m = get_model("pix_shuffle", variant)
    got = m.apply(params_from_jax(tree, device="cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("apply", [fs.fused_stack_apply, k2.fused_stack_packed_apply],
                         ids=["k1", "k2"])
def test_kernel_routes_take_a_batch_of_two(apply):
    """Through the kernels' plain versions (a CPU tensor), two frames at once
    equal each frame alone and the JAX fp32 forward within 2e-3."""
    jm, tree = _jax_params("lightweight")
    x = np.random.default_rng(6).uniform(0, 1, (2, 24, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(tree, jnp.asarray(x)))
    params = params_from_jax(tree, device="cpu")
    both = apply(params, torch.from_numpy(x))
    assert np.abs(both.numpy() - want).max() <= 2e-3
    for i in range(2):
        assert torch.equal(both[i:i + 1], apply(params, torch.from_numpy(x[i:i + 1])))


def test_route_on_a_card_by_config_and_dtype(monkeypatch):
    """With tensors that report ``is_cuda``: the lightweight config in bf16
    goes to the fused-stack kernel's route; fp32, and the heavyweight config
    in bf16, go to the eager forward."""
    light, heavy = get_model("pix_shuffle"), get_model("pix_shuffle", "heavyweight")
    pl, ph = light.init(device="cpu"), heavy.init(device="cpu")
    x = torch.rand(1, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    taken = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(fs, "fused_stack_apply",
                        lambda p, t, cfg=None: taken.append(t.dtype) or t)
    assert light.apply(pl, x.to(torch.bfloat16)) is not None and taken == [torch.bfloat16]
    eager = tps._forward(pl, x, light.config, lambda _t, v: v)
    assert torch.equal(light.apply(pl, x), eager)
    assert torch.equal(heavy.apply(ph, x.to(torch.bfloat16)),
                       tps._forward(ph, x.to(torch.bfloat16), heavy.config, lambda _t, v: v))
    assert taken == [torch.bfloat16]
    assert torch.backends.cudnn.allow_tf32  # restored after the eager route


# --- JAX's randint without jax -------------------------------------------------

_NS = sorted({2, 3, 5, 7, 10, 16, 255, 256, 257, 1000, 4095, 4096, 4097, 27072, 65535, 65536,
              65537, 108288, 131072, 1_000_003, 2_000_000}
             | {int(n) for n in np.random.default_rng(9).integers(2, 2_000_001, 80)})


@pytest.mark.parametrize("seed", [0, 7, 42])
def test_randint_equals_jax(seed):
    got = [threefry.randint(seed, n) for n in _NS]
    want = [int(jax.random.randint(jax.random.key(seed), (), 0, n)) for n in _NS]
    assert got == want


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_key_and_split_equal_jax(seed):
    with pytest.raises(ValueError):
        threefry.key(2**32)
    k = jax.random.key(seed)
    assert threefry.key(seed) == tuple(int(v) for v in jax.random.key_data(k))
    want = [tuple(int(v) for v in row) for row in jax.random.key_data(jax.random.split(k))]
    assert list(threefry.split(threefry.key(seed))) == want


def _stacks(h, w, b=2):
    rng = np.random.default_rng(h * w)
    crops = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    return np.stack([jq.grid_quantize(c, "RGB444").reshape(-1, 3) for c in crops]).astype(
        np.float32)


@pytest.mark.parametrize("k,h,w", [(8, 40, 52), (64, 72, 94)])
def test_kmeans_torch_default_equals_kmeans_jax(k, h, w):
    stacks = _stacks(h, w)
    got = tq.generate_palettes_kmeans_torch_batch(stacks, k, device="cpu").numpy()
    np.testing.assert_array_equal(got, jq.generate_palettes_kmeans_jax_batch(stacks, k))
    one = tq.generate_palette_kmeans_torch(stacks[0], k, device="cpu")
    np.testing.assert_array_equal(one, jq.generate_palette_kmeans_jax(stacks[0], k))


# --- the generator -------------------------------------------------------------

def _write_sources(src, n=2, w=96, h=72):
    rng = np.random.default_rng(11)
    for i in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255 / w, yy * 255 / h, (xx + yy) * 127 / (w + h)], axis=-1)
        arr = np.clip(base + rng.normal(0, 24, (h, w, 3)) + 30, 1, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(src, f"img_{i}.png"))


def _tree(root):
    out = {}
    for r, _d, files in os.walk(root):
        for f in files:
            with open(os.path.join(r, f), "rb") as fh:
                out[os.path.relpath(os.path.join(r, f), root)] = fh.read()
    return out


def test_kmeans_torch_tree_equals_the_jax_kmeans_jax_tree(tmp_path):
    """The port's device route with ``kmeans_torch`` palettes (on the CPU:
    the plain versions), per crop and batched, writes the JAX device route's
    ``kmeans_jax`` tree byte for byte. (The JAX route runs in-process with
    one worker; its host route would run jax in a forked worker.)"""
    src = tmp_path / "src"
    src.mkdir()
    _write_sources(str(src))
    common = dict(train_images=[str(src)], crop_w=48, crop_h=32, resolutions=("lores",),
                  colorspaces=("RGB444",), palettes=(8, 16),
                  dithers=("none", "checkerboard", "bayer4x4"), workers=1, verbose=0)
    jcfg = jax_gen_mod.GeneratorConfig(dest_dir=str(tmp_path / "jax"), palette_algorithm="kmeans_jax",
                                       quantize_backend="pallas", cache_dir=str(tmp_path / "cj"),
                                       **common)
    assert jax_gen_mod.DatasetGenerator(jcfg).run()["missing"] == 0
    want = _tree(jcfg.dest_dir)
    assert sum("_p16_" in k for k in want) >= 8  # k-means palettes of 16 colours
    for batch in (0, 3):
        cfg = gen_mod.GeneratorConfig(dest_dir=str(tmp_path / f"port{batch}"),
                                      palette_algorithm="kmeans_torch", quantize_backend="device",
                                      device_batch=batch, cache_dir=str(tmp_path / f"c{batch}"),
                                      device="cpu", **common)
        assert gen_mod.DatasetGenerator(cfg).run()["missing"] == 0
        got = _tree(cfg.dest_dir)
        assert got.keys() == want.keys()
        assert [k for k in got if got[k] != want[k]] == []


def _captured_config(main, argv, monkeypatch, mod):
    seen = {}

    class Stub:
        def __init__(self, cfg):
            seen["cfg"] = cfg

        def run(self):
            return {"missing": 0, "stopped": False}

    monkeypatch.setattr(mod, "DatasetGenerator", Stub)
    assert main(argv) == 0
    return seen["cfg"]


def test_generator_defaults_equal_the_jax_generators(tmp_path, monkeypatch):
    port = {f.name: f for f in dataclasses.fields(gen_mod.GeneratorConfig)}
    jaxf = {f.name: f for f in dataclasses.fields(jax_gen_mod.GeneratorConfig)}
    assert set(jaxf) <= set(port) and set(port) - set(jaxf) == {"device"}
    for name, f in jaxf.items():
        if f.default is not dataclasses.MISSING:
            assert port[name].default == f.default, name
    assert port["quantize_backend"].default == "numpy"
    argv = ["--train_images", str(tmp_path), "--dest_dir", str(tmp_path / "out")]
    jcfg = _captured_config(jax_gen_mod.main, argv, monkeypatch, jax_gen_mod)
    pcfg = _captured_config(gen_mod.main, argv + ["--device", "cpu"], monkeypatch, gen_mod)
    for name in jaxf:
        assert getattr(pcfg, name) == getattr(jcfg, name), name


# --- the reference goldens -----------------------------------------------------

def _regen_weight(key, shape):
    """The goldens' weights: per key, crc32-seeded numpy normals, fan-in
    scaled (a copy of tests/golden_gen's regen_weight)."""
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    v = rng.standard_normal(shape).astype(np.float32)
    if len(shape) == 4:  # OIHW conv weight
        v /= np.sqrt(shape[1] * shape[2] * shape[3])
    else:
        v *= 0.25
    return v


def _pix_shuffle_params(tag, manifest):
    """The reference pix_shuffle state_dict mapped onto the port's (the JAX
    package's) parameter tree."""
    p = {}
    for name, shape in manifest.items():
        v = _regen_weight(f"{tag}/{name}", tuple(shape))
        head, *rest = name.split(".")
        if head.startswith("conv") or head in ("skip1_proj_conv", "skip2_proj_conv"):
            d = p.setdefault(head if head.startswith("conv") else head[:10], {})
            d["w" if rest[0] == "weight" else "b"] = (np.transpose(v, (2, 3, 1, 0))
                                                      if rest[0] == "weight" else v)
        else:  # l{li}_act{si} learnable activation parameters
            d = p.setdefault(head, {})
            if rest in (["a"], ["b"], ["bias"]):
                d[rest[0]] = v
            elif rest in (["weight"], ["prelu", "weight"]):
                d["slope"] = v.reshape(-1)
            else:
                raise AssertionError(f"unmapped state_dict key {name}")
    return p


@pytest.mark.parametrize("tag,variant", [("light", "lightweight"), ("heavy", "heavyweight")])
def test_pix_shuffle_matches_reference_golden(tag, variant):
    g = np.load(os.path.join(GOLDENS, "pix_shuffle_model_goldens.npz"))
    manifest = json.loads(bytes(g[f"{tag}_manifest"]).decode())
    params = params_from_jax(_pix_shuffle_params(tag, manifest), device="cpu")
    x = torch.from_numpy(np.transpose(g[f"{tag}_x"], (0, 2, 3, 1)).copy())
    y = get_model("pix_shuffle", variant).apply(params, x).numpy()
    np.testing.assert_allclose(y, np.transpose(g[f"{tag}_y"], (0, 2, 3, 1)), atol=2e-5, rtol=2e-5)


def test_geometry_matches_reference_golden():
    g = np.load(os.path.join(GOLDENS, "geometry_goldens.npz"))
    img = Image.fromarray(g["src"], "RGB")
    for name in ("black75", "black76"):
        assert util_img.should_discard_by_black_ratio(Image.fromarray(g[name])) == bool(
            g[f"{name}_discard"])
    for i, (x, y, w, h) in enumerate([(0, 0, 32, 24), (-8, -4, 32, 24), (48, 40, 32, 24),
                                      (60, 44, 8, 8)]):
        np.testing.assert_array_equal(np.asarray(util_img.get_crop_and_pad(img, x, y, w, h)),
                                      g[f"crop{i}"])
    for a in (0, 20, 45, 80):
        np.testing.assert_array_equal(np.asarray(util_img.apply_rotation(img, a)), g[f"rot{a}"])
    for s in (40, 75, 100):
        np.testing.assert_array_equal(np.asarray(util_img.apply_downscaling(img, s)),
                                      g[f"scale{s}"])
    for st in ("lores", "hires", "lores_laced", "hires_laced"):
        low = util_img.pre_apply_resolution_style(img, st)
        np.testing.assert_array_equal(np.asarray(low), g[f"pre_{st}"])
        np.testing.assert_array_equal(np.asarray(util_img.post_apply_resolution_style(low, st)),
                                      g[f"post_{st}"])


def test_generator_output_matches_reference_golden(tmp_path):
    """The reference generator's file sets (and bytes, where the reference's
    palettes do not enter) on its 2-image corpus, through the port's CLI on
    the default host route: run A (RGB444, none + bayer2x2) names and bytes;
    run B (palette 16, median cut) names, and target bytes; run C
    (checkerboard without a palette) only targets, exit 1."""
    blob = np.load(os.path.join(GOLDENS, "generator_goldens.npz"))
    golden = json.loads(bytes(blob["meta"]).decode())
    corpus = tmp_path / "gt"
    corpus.mkdir()
    for i, name in enumerate(golden["corpus_names"]):
        Image.fromarray(blob[f"corpus_{i}"], "RGB").save(corpus / name)
    w, h = golden["crop"]

    def run(tag, extra, expect_rc=0):
        dest = tmp_path / f"out_{tag}"
        rc = gen_mod.main(["--train_images", str(corpus), "--dest_dir", str(dest),
                           "--crop_size", str(w), str(h), "--rotation", "0",
                           "--resolution", "lores", "--workers", "1", "--device", "cpu",
                           "--cache_dir", str(tmp_path / f"cache_{tag}"), "--verbose", "0"]
                          + extra)
        assert rc == expect_rc
        return {k: hashlib.sha256(v).hexdigest() for k, v in _tree(str(dest)).items()}

    assert run("a", ["--rgb", "444", "--dither", "none", "bayer2x2"]) == golden["files"]
    ours_b = run("b", ["--rgb", "444", "--palette", "16", "--dither", "none", "atkinson",
                       "bayer2x2", "--palette_algorithm", "median_cut"])
    assert sorted(ours_b) == sorted(golden["files_palette"])
    for rel, sha in golden["files_palette"].items():
        if os.path.basename(rel).startswith("target_"):
            assert ours_b[rel] == sha, rel
    assert run("c", ["--rgb", "444", "--dither", "checkerboard"], expect_rc=1) == \
        golden["files_checker"]
