"""The port's NAS harness against the JAX package's, on the CPU.

- the search engine is pure Python in both packages, so it must match
  exactly: 40 trials of a seeded TPE and random sampler on ``_quadratic``
  (``tests/test_nas.py``) give identical params, values and states; a study
  database written by either package is read by the other; ``_snap_to_lattice``
  and the median pruner's decisions are equal;
- the search space: ``suggest_conv6_config`` gives equal ``config_to_json``
  and params for 20 seeded trials of each preset, and
  ``config_from_trial_params`` replays them equal;
- the FPS cache: keys scoped by torch's backend (``cpu`` here), JAX's key
  format, failures remembered and retried under ``FSE_FPS_CACHE_RETRY_FAILED``;
- the objective: one trial's short training (crop 32x24, 16 samples, batch
  4, one epoch, bf16 forward on both sides) from JAX's conv6 initial weights
  carried across gives JAX's validation loss within 2e-2 relative;
- ``visualize``: the PNGs, and ``param_importances`` equal to JAX's;
- ``studies.main`` exits 1 when every trial failed, and ``prune_failed``
  cleans a study;
- ``chip_smoke.py``'s nas phase rehearsed on the CPU.
"""
import functools
import json
import math
import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from fs_uae_image_enhancer_project_tpu.models.configs import config_to_json as jax_config_json
from fs_uae_image_enhancer_project_tpu.nas import search as JS
from fs_uae_image_enhancer_project_tpu.nas import studies as JSt
from fs_uae_image_enhancer_project_tpu.nas import visualize as JV
from fs_uae_image_enhancer_project_tpu.nas.fps_cache import FPSCache as JaxFPSCache
from fs_uae_image_enhancer_project_tpu_torch.interop import params_from_jax
from fs_uae_image_enhancer_project_tpu_torch.models.configs import config_to_json
from fs_uae_image_enhancer_project_tpu_torch.nas import FPSCache, prune_failed
from fs_uae_image_enhancer_project_tpu_torch.nas import search as S
from fs_uae_image_enhancer_project_tpu_torch.nas import studies as St
from fs_uae_image_enhancer_project_tpu_torch.nas import visualize as V
from fs_uae_image_enhancer_project_tpu_torch.nas.fps_cache import current_backend
from test_nas import _quadratic


def _record(study):
    return [(t.number, t.state, t.value, t.params, t.intermediate) for t in study.trials]


@pytest.mark.parametrize("sampler", ["TPESampler", "RandomSampler"])
def test_study_matches_jax_exactly(tmp_path, sampler):
    """40 seeded trials: the same params, values and states, to the bit."""
    got = S.create_study("quad", str(tmp_path / "port.sqlite"),
                         sampler=getattr(S, sampler)(seed=4))
    got.optimize(_quadratic, n_trials=40, verbose=0)
    want = JS.create_study("quad", str(tmp_path / "jax.sqlite"),
                           sampler=getattr(JS, sampler)(seed=4))
    want.optimize(_quadratic, n_trials=40, verbose=0)
    assert _record(got) == _record(want)
    assert got.best_params == want.best_params and got.best_value == want.best_value


def test_study_database_crosses_packages(tmp_path):
    """A database written by one package is read by the other, and a study
    continued in the other package numbers on and stays in the stream."""
    port_db, jax_db = str(tmp_path / "p.sqlite"), str(tmp_path / "j.sqlite")
    S.create_study("x", port_db, sampler=S.TPESampler(seed=1)).optimize(
        _quadratic, n_trials=12, verbose=0)
    JS.create_study("x", jax_db, sampler=JS.TPESampler(seed=1)).optimize(
        _quadratic, n_trials=12, verbose=0)
    assert _record(JS.Study("x", port_db)) == _record(S.Study("x", jax_db))
    cont_port = S.create_study("x", jax_db, sampler=S.TPESampler(seed=2))
    cont_port.optimize(_quadratic, n_trials=5, verbose=0)
    cont_jax = JS.create_study("x", port_db, sampler=JS.TPESampler(seed=2))
    cont_jax.optimize(_quadratic, n_trials=5, verbose=0)
    assert [t.number for t in cont_port.trials] == list(range(17))
    assert _record(S.Study("x", jax_db)) == _record(S.Study("x", port_db))
    with pytest.raises(ValueError, match="already exists"):
        S.create_study("x", jax_db, load_if_exists=False)


def test_snap_to_lattice_and_median_pruner_match_jax():
    rng = random.Random(0)
    for _ in range(500):
        low = rng.choice([0, 1, 3, -2])
        step = rng.choice([1, 2, 3, 0.5])
        high = low + rng.choice([4, 5, 7.5, 9])
        v = rng.uniform(low - 3, high + 3)
        assert S._snap_to_lattice(v, low, high, step) == JS._snap_to_lattice(v, low, high, step)

    class _T:
        def __init__(self, inter):
            self._intermediate = inter

    for case in range(200):
        n = rng.randint(0, 9)
        states = [rng.choice([S.COMPLETE, S.PRUNED, S.FAIL]) for _ in range(n)]
        inters = [{s: rng.uniform(0, 1) for s in range(rng.randint(0, 3))} for _ in range(n)]
        hist = [S.FrozenTrial(i, st, rng.uniform(0, 1) if st == S.COMPLETE else None, {}, it)
                for i, (st, it) in enumerate(zip(states, inters))]
        jhist = [JS.FrozenTrial(t.number, t.state, t.value, {}, dict(t.intermediate))
                 for t in hist]
        mine = {s: rng.uniform(0, 1) for s in range(rng.randint(0, 3))}
        startup, warmup = rng.randint(0, 4), rng.randint(0, 2)
        assert (S.MedianPruner(startup, warmup).should_prune(_T(mine), hist)
                == JS.MedianPruner(startup, warmup).should_prune(_T(mine), jhist)), case


@pytest.mark.parametrize("study", sorted(St.STUDY_PRESETS))
def test_search_space_and_replay_match_jax(tmp_path, study):
    """20 seeded trials of each preset: equal params, equal config JSON, and
    the replay of each trial's params gives that config in both packages."""
    keys = ("searched_slots", "activation_choices", "saturating_choices",
            "rectifier_choices", "param_policy", "search_layer6_kernel")
    preset = {k: v for k, v in St.STUDY_PRESETS[study].items() if k in keys}
    jpreset = {k: v for k, v in JSt.STUDY_PRESETS[study].items() if k in keys}
    assert preset == jpreset
    assert St.ALL_ACTIVATIONS == JSt.ALL_ACTIVATIONS and St.LAYER_SLOTS == JSt.LAYER_SLOTS
    got = S.Study(study, str(tmp_path / "p.sqlite"), sampler=S.RandomSampler(seed=7))
    want = JS.Study(study, str(tmp_path / "j.sqlite"), sampler=JS.RandomSampler(seed=7))
    for n in range(20):
        t, jt = S.Trial(got, n), JS.Trial(want, n)
        cfg = St.suggest_conv6_config(t, **preset)
        jcfg = JSt.suggest_conv6_config(jt, **jpreset)
        assert t.params == jt.params
        assert config_to_json(cfg) == jax_config_json(jcfg)
        replay = St.config_from_trial_params(study, t.params)
        assert replay == cfg
        assert config_to_json(replay) == jax_config_json(
            JSt.config_from_trial_params(study, jt.params))


def test_fps_cache_scoped_by_backend_and_retried(tmp_path, monkeypatch):
    path = str(tmp_path / "fps.json")
    cache = FPSCache(path)
    arch = config_to_json(St.suggest_conv6_config(
        S.Trial(S.Study("c", str(tmp_path / "c.sqlite"), sampler=S.RandomSampler(seed=0)), 0),
        **St.STUDY_PRESETS["opt_act"]))
    assert current_backend() == ("cuda:" + torch.cuda.get_device_name(0)
                                 if torch.cuda.is_available() else "cpu")
    for backend in ("cpu", "cuda:NVIDIA H100 80GB HBM3"):  # JAX's key format
        assert cache.make_key(arch, backend) == JaxFPSCache.make_key(arch, backend)
        assert cache.make_key({"ch": 36}, backend) == JaxFPSCache.make_key({"ch": 36}, backend)
    assert cache.make_key(arch, "cpu") != cache.make_key(arch, "cuda:NVIDIA H100 80GB HBM3")
    calls = []

    def measure():
        calls.append(1)
        return 123.0

    assert cache.get_or_measure(arch, measure) == 123.0
    assert cache.get_or_measure(arch, measure) == 123.0 and len(calls) == 1
    # a number measured on one backend is not another's
    monkeypatch.setattr("fs_uae_image_enhancer_project_tpu_torch.nas.fps_cache.current_backend",
                        lambda: "cuda:another card")
    assert cache.get(arch) is None
    monkeypatch.undo()
    assert FPSCache(path).get(arch) == 123.0  # persisted

    def boom():
        raise RuntimeError("transient")

    other = {"ch": 12}
    assert cache.get_or_measure(other, boom) == 0.0
    assert cache.get_or_measure(other, lambda: 77.0) == 0.0  # the failure is remembered
    monkeypatch.setenv("FSE_FPS_CACHE_RETRY_FAILED", "1")
    assert cache.get_or_measure(other, lambda: 77.0) == 77.0
    monkeypatch.delenv("FSE_FPS_CACHE_RETRY_FAILED")
    assert cache.get_or_measure(other, boom) == 77.0
    with open(path) as f:
        assert all(json.loads(k)["__backend__"] == "cpu" for k in json.load(f))


def test_measure_fps_on_the_cpu():
    cfg = St.suggest_conv6_config(
        S.Trial(S.Study("m", ":memory:", sampler=S.RandomSampler(seed=0)), 0),
        **St.STUDY_PRESETS["opt_act"])
    fps = St.measure_fps(cfg, height=24, width=32, duration_s=0.05, device="cpu")
    assert math.isfinite(fps) and fps > 0


@pytest.fixture
def nas_tree(tmp_path):
    """4 locations of 32x24 crops."""
    rng = np.random.default_rng(0)
    d = tmp_path / "train" / "img"
    d.mkdir(parents=True)
    for loc in range(4):
        base = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
        Image.fromarray(base).save(d / f"target_{loc * 8}_0_s100_r0.png")
        Image.fromarray((base // 32) * 32).save(d / f"lores_{loc * 8}_0_s100_r0_rgb444_p32_dnone.png")
    return str(tmp_path / "train")


def test_objective_short_training_matches_jax(nas_tree, tmp_path, monkeypatch):
    """prune_act_r2's first trial (the same config and learning rate from
    the seeded sampler), JAX's conv6 initial weights (jax.random.key(0)) in
    both, crop 32x24, 16 samples a batch of 4, one epoch: the validation loss
    within 2e-2 relative (bf16 forwards). The FPS is stubbed on both sides
    (a 576x752 measurement on the CPU is not the point here)."""
    from fs_uae_image_enhancer_project_tpu.data import (
        gather_all_samples_from_directory as jax_gather)
    from fs_uae_image_enhancer_project_tpu.models import conv6 as jconv6
    from fs_uae_image_enhancer_project_tpu_torch.data import gather_all_samples_from_directory

    monkeypatch.setattr(St, "measure_fps", lambda cfg, **kw: 250.0)
    monkeypatch.setattr(JSt, "measure_fps", lambda cfg, **kw: 250.0)
    kw = dict(train_pairs=None, crop_size=(32, 24), epochs_per_trial=1, samples_per_epoch=16,
              batch_size=4, fps_duration_s=0.1, **St.STUDY_PRESETS["prune_act_r2"])

    def jax_init(cfg, number):
        return params_from_jax(jax.tree_util.tree_map(
            np.asarray, jconv6.init(jax.random.key(number), cfg)), device="cpu")

    pairs = gather_all_samples_from_directory(nas_tree, (32, 24), verbose=0)
    jpairs = jax_gather(nas_tree, (32, 24), verbose=0)
    assert len(pairs) == len(jpairs) == 4
    obj = St.make_objective(**{**kw, "train_pairs": pairs},
                            fps_cache=FPSCache(str(tmp_path / "p.json")), device="cpu",
                            init_params=jax_init)
    jobj = JSt.make_objective(**{**kw, "train_pairs": jpairs},
                              fps_cache=JaxFPSCache(str(tmp_path / "j.json")))
    got = S.create_study("t", str(tmp_path / "p.sqlite"), sampler=S.RandomSampler(seed=5))
    got.optimize(obj, n_trials=1, verbose=0)
    want = JS.create_study("t", str(tmp_path / "j.sqlite"), sampler=JS.RandomSampler(seed=5))
    want.optimize(jobj, n_trials=1, verbose=0)
    (t,), (jt,) = got.trials, want.trials
    assert t.state == jt.state == S.COMPLETE
    assert t.params == jt.params  # the same candidate and learning rate
    assert t.value == pytest.approx(jt.value, rel=2e-2)
    assert t.intermediate == {0: t.value} and t.params["fps_measured"] == 250.0
    # the replayed architecture is the one the objective measured
    key = config_to_json(St.config_from_trial_params("prune_act_r2", t.params))
    assert FPSCache(str(tmp_path / "p.json")).get(key) == 250.0


def test_visualize_and_importances_match_jax(tmp_path):
    db = str(tmp_path / "v.sqlite")
    study = S.create_study("viz", db, sampler=S.RandomSampler(seed=0))

    def obj(t):
        v = _quadratic(t)
        t.params["fps_measured"] = 100.0 + 10.0 * t.params["x"]
        return v

    study.optimize(obj, n_trials=15, verbose=0)
    imps = V.param_importances(study)
    assert imps == JV.param_importances(JS.Study("viz", db))
    assert set(imps) == {"x", "y", "c", "fps_measured"} and sum(imps.values()) == pytest.approx(1)
    paths = V.export_all(study, str(tmp_path / "plots"))
    assert [os.path.basename(p) for p in paths] == [
        "viz_history.png", "viz_importances.png", "viz_pareto.png"]
    for p in paths:
        assert os.path.getsize(p) > 1000


def test_all_failed_study_exits_1_and_prune_failed_cleans(tmp_path, monkeypatch, capsys):
    def broken(**_kw):
        def objective(trial):
            trial.suggest_float("x", 0.0, 1.0)
            raise NameError("systematic objective bug")

        return objective

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(St, "make_objective", broken)
    db = str(tmp_path / "s.sqlite")
    assert St.main(["--study", "opt_act", "--trials", "2", "--storage", db,
                    "--device", "cpu"]) == 1
    assert "no completed trial" in capsys.readouterr().err
    assert [t.state for t in S.Study("opt_act", db).trials] == [S.FAIL, S.FAIL]
    assert prune_failed.main(["--storage", db, "--study", "opt_act"]) == 0
    assert "deleted 2" in capsys.readouterr().out
    assert S.Study("opt_act", db).trials == []
    assert not os.path.exists(tmp_path / "model_performance_cache.json")


def test_chip_smoke_nas_phase_on_the_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's nas phase rehearsed on the CPU at a small size (on a
    card: the datagen tree cut to 128x96, 32 samples, FPS at 576x752; here
    FPS at 32x24): 4 trials through ``studies.main``, every check passing,
    no FPS measured twice; a FAIL trial, a failed (0.0) FPS, a replay to an
    architecture the cache lacks or that measures again, a missing step
    time, and non-finite importances fail the checks."""
    import chip_smoke as cs

    monkeypatch.setattr(St, "measure_fps", functools.partial(St.measure_fps, height=24,
                                                             width=32))

    rng = np.random.default_rng(0)
    for img in range(2):
        d = tmp_path / "tree" / f"img_{img}"
        d.mkdir(parents=True)
        for loc in range(5):
            base = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            Image.fromarray(base).save(d / f"target_{loc * 8}_0_s0_r0.png")
            for pal in (16, 32):
                Image.fromarray((base // pal) * pal).save(
                    d / f"lores_{loc * 8}_0_s0_r0_rgb444_p{pal}_dNone.png")
    cpu = torch.device("cpu")
    rec = cs.nas(cpu, str(tmp_path / "tree"), crop=(32, 24), samples=16, fps_duration=0.05,
                 timed_steps=1)
    cs.check_nas(rec)
    assert rec["files"] == 30 and len(rec["trials"]) == cs.NAS_TRIALS
    assert rec["importances"] and rec["replay"]["new_measurements"] == 0
    assert rec["fps_measurements"] == len({t["arch"] for t in rec["trials"]})
    json.dumps(rec)
    t0 = rec["trials"][0]
    for bad in ({"trials": [dict(t0, state=S.FAIL)] + rec["trials"][1:]},
                {"trials": [dict(t0, fps=0.0)] + rec["trials"][1:]},
                {"trials": [dict(t0, fps_cached=None)] + rec["trials"][1:]},
                {"trials": [dict(t0, ms_per_step=None)] + rec["trials"][1:]},
                {"replay": dict(rec["replay"], new_measurements=1)},
                {"importances": {"x": float("nan")}},
                {"exit_code": 1}):
        with pytest.raises(AssertionError):
            cs.check_nas({**rec, **bad})
