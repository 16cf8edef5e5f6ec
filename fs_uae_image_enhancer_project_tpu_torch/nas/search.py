"""Self-contained architecture/hyperparameter search engine.

The port's copy of ``fs_uae_image_enhancer_project_tpu/nas/search.py``, which
is pure Python (``sqlite3``, ``random.Random``): the same SQLite schema, the
same state names and the same sampling stream, so a study database written by
either package is read by the other, and a seeded sampler suggests the same
values in both.

The reference's NAS layer is Optuna TPE + MedianPruner over SQLite studies
(optuna_study_opt_act.py:406-420). Optuna is not installed, so this module
implements the subset the reference uses, API-compatible at the call sites:

- ``Study`` with SQLite persistence and ``load_if_exists`` semantics,
- ``trial.suggest_float/suggest_int/suggest_categorical`` (log scale, step),
- ``trial.report`` + ``trial.should_prune`` with a median pruner
  (prune when the intermediate value is worse than the median of completed
  trials' values at the same step, after n_startup_trials),
- a TPE-flavoured sampler: after ``n_startup_trials`` random trials, split
  history into good/bad halves by objective and sample candidates that
  maximise the ratio of good-half to bad-half kernel density (numeric
  params) / smoothed category frequency (categorical params).
"""
from __future__ import annotations

import json
import math
import os
import random
import sqlite3
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

COMPLETE = "COMPLETE"
PRUNED = "PRUNED"
FAIL = "FAIL"
RUNNING = "RUNNING"


class TrialPruned(Exception):
    """Raised by objectives to signal a pruned trial."""


@dataclass
class FrozenTrial:
    number: int
    state: str
    value: Optional[float]
    params: Dict[str, Any]
    intermediate: Dict[int, float] = field(default_factory=dict)

    @property
    def is_complete(self) -> bool:
        return self.state == COMPLETE and self.value is not None


# ---------------------------------------------------------------------------
# Samplers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _ParamSpec:
    kind: str  # 'float' | 'int' | 'categorical'
    low: float = 0.0
    high: float = 1.0
    log: bool = False
    step: Optional[float] = None
    choices: tuple = ()


def _snap_to_lattice(v: float, low: float, high: float, step: float) -> float:
    """Round v onto the {low + k*step} lattice, clamping k so the result
    stays a lattice point even when (high - low) is not a step multiple
    (a plain min(v, high) clamp could return an off-lattice high — e.g.
    low=0 high=5 step=3 must yield {0, 3}, never 5; Optuna semantics)."""
    max_k = int((high - low) // step)
    k = min(max(round((v - low) / step), 0), max_k)
    return low + k * step


class RandomSampler:
    def __init__(self, seed: Optional[int] = None):
        self.rng = random.Random(seed)

    def sample(self, spec: _ParamSpec, history, name: str):
        r = self.rng
        if spec.kind == "categorical":
            return r.choice(list(spec.choices))
        if spec.log:
            v = math.exp(r.uniform(math.log(spec.low), math.log(spec.high)))
        else:
            v = r.uniform(spec.low, spec.high)
        if spec.kind == "int":
            return int(_snap_to_lattice(v, spec.low, spec.high, int(spec.step or 1)))
        if spec.step:
            return float(_snap_to_lattice(v, spec.low, spec.high, spec.step))
        return float(min(max(v, spec.low), spec.high))


class TPESampler(RandomSampler):
    """Simplified Tree-structured Parzen Estimator (minimisation)."""

    def __init__(self, seed: Optional[int] = None, n_startup_trials: int = 10,
                 gamma: float = 0.25, n_candidates: int = 24):
        super().__init__(seed)
        self.n_startup = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    def sample(self, spec: _ParamSpec, history: List[FrozenTrial], name: str):
        done = [t for t in history if t.is_complete and name in t.params]
        if len(done) < self.n_startup:
            return super().sample(spec, history, name)
        done.sort(key=lambda t: t.value)
        n_good = max(1, int(len(done) * self.gamma))
        good = [t.params[name] for t in done[:n_good]]
        bad = [t.params[name] for t in done[n_good:]] or good

        if spec.kind == "categorical":
            def score(choice):
                g = (good.count(choice) + 1.0) / (len(good) + len(spec.choices))
                b = (bad.count(choice) + 1.0) / (len(bad) + len(spec.choices))
                return g / b
            weights = [score(c) for c in spec.choices]
            return self.rng.choices(list(spec.choices), weights=weights, k=1)[0]

        # numeric: sample candidates from the good-half KDE, score by g/b
        def transform(v):
            return math.log(v) if spec.log else v

        def inv(v):
            return math.exp(v) if spec.log else v

        gt = [transform(v) for v in good]
        bt = [transform(v) for v in bad]
        lo, hi = transform(spec.low), transform(spec.high)
        bw = max((hi - lo) / 10.0, 1e-12)

        def kde(pts, x):
            return sum(
                math.exp(-0.5 * ((x - p) / bw) ** 2) for p in pts
            ) / (len(pts) * bw) + 1e-12

        best_x, best_score = None, -1.0
        for _ in range(self.n_candidates):
            center = self.rng.choice(gt)
            x = min(max(self.rng.gauss(center, bw), lo), hi)
            s = kde(gt, x) / kde(bt, x)
            if s > best_score:
                best_score, best_x = s, x
        v = inv(best_x)
        if spec.kind == "int":
            return int(_snap_to_lattice(v, spec.low, spec.high, int(spec.step or 1)))
        if spec.step:
            return float(_snap_to_lattice(v, spec.low, spec.high, spec.step))
        return float(min(max(v, spec.low), spec.high))


class MedianPruner:
    """Prune when the intermediate value is worse than the median of prior
    trials' intermediate values at the same step."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup = n_startup_trials
        self.n_warmup = n_warmup_steps

    def should_prune(self, trial: "Trial", history: List[FrozenTrial]) -> bool:
        if not trial._intermediate:
            return False
        step = max(trial._intermediate)
        if step < self.n_warmup:
            return False
        # COMPLETE only (Optuna MedianPruner semantics, and this class's
        # docstring): counting PRUNED trials would fold their bad early
        # intermediates into the median — a self-weakening pruner — and
        # would let min_fps-gate prunes (which report nothing) satisfy
        # n_startup_trials before any trial has finished
        done = [t for t in history if t.is_complete]
        if len(done) < self.n_startup:
            return False
        prior = [t.intermediate[step] for t in done if step in t.intermediate]
        if not prior:
            return False
        prior.sort()
        median = prior[len(prior) // 2]
        return trial._intermediate[step] > median


class NopPruner:
    def should_prune(self, trial, history) -> bool:
        return False


# ---------------------------------------------------------------------------
# Trial / Study
# ---------------------------------------------------------------------------

class Trial:
    def __init__(self, study: "Study", number: int):
        self.study = study
        self.number = number
        self.params: Dict[str, Any] = {}
        self._intermediate: Dict[int, float] = {}

    def _suggest(self, name: str, spec: _ParamSpec):
        if name in self.params:
            return self.params[name]
        v = self.study.sampler.sample(spec, self.study.trials, name)
        self.params[name] = v
        return v

    def suggest_float(self, name, low, high, *, log=False, step=None):
        return self._suggest(name, _ParamSpec("float", low, high, log, step))

    def suggest_int(self, name, low, high, step=1, *, log=False):
        return self._suggest(name, _ParamSpec("int", low, high, log, step))

    def suggest_categorical(self, name, choices: Sequence[Any]):
        return self._suggest(name, _ParamSpec("categorical", choices=tuple(choices)))

    def report(self, value: float, step: int) -> None:
        self._intermediate[int(step)] = float(value)

    def should_prune(self) -> bool:
        return self.study.pruner.should_prune(self, self.study.trials)


class Study:
    """Minimisation study persisted to SQLite (load_if_exists semantics)."""

    def __init__(
        self,
        study_name: str,
        storage: str = "studies.sqlite",
        sampler=None,
        pruner=None,
        seed: Optional[int] = None,
    ):
        self.study_name = study_name
        self.sampler = sampler or TPESampler(seed=seed)
        self.pruner = pruner or MedianPruner()
        self.path = storage
        self._trials_cache: Optional[List[FrozenTrial]] = None
        os.makedirs(os.path.dirname(os.path.abspath(storage)), exist_ok=True)
        self._db = sqlite3.connect(storage)
        self._db.execute(
            "CREATE TABLE IF NOT EXISTS trials ("
            "study TEXT, number INTEGER, state TEXT, value REAL, "
            "params TEXT, intermediate TEXT, ts REAL, "
            "PRIMARY KEY (study, number))"
        )
        self._db.commit()

    # -- persistence ---------------------------------------------------------
    @property
    def trials(self) -> List[FrozenTrial]:
        """All recorded trials (cached: suggest_*/should_prune hit this once
        per call, and re-parsing every prior trial's JSON each time is
        quadratic in trial count). The cache assumes this process is the
        study's only writer — _record/delete_trials invalidate it; a
        concurrent writer in another process would need refresh()."""
        if self._trials_cache is None:
            self._trials_cache = self._load_trials()
        return self._trials_cache

    def refresh(self) -> None:
        """Drop the trials cache (re-read from SQLite on next access)."""
        self._trials_cache = None

    def _load_trials(self) -> List[FrozenTrial]:
        rows = self._db.execute(
            "SELECT number, state, value, params, intermediate FROM trials "
            "WHERE study = ? ORDER BY number",
            (self.study_name,),
        ).fetchall()
        return [
            FrozenTrial(
                number=n, state=s, value=v,
                params=json.loads(p),
                intermediate={int(k): float(x) for k, x in json.loads(i).items()},
            )
            for (n, s, v, p, i) in rows
        ]

    def _record(self, trial: Trial, state: str, value: Optional[float]) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO trials VALUES (?, ?, ?, ?, ?, ?, ?)",
            (
                self.study_name, trial.number, state, value,
                json.dumps(trial.params, sort_keys=True),
                json.dumps(trial._intermediate), time.time(),
            ),
        )
        self._db.commit()
        self._trials_cache = None

    def delete_trials(self, states=("FAIL",), non_finite: bool = True) -> int:
        """Remove failed/non-finite trials — counterpart of the reference's
        prune_failed_trials.py direct-SQL cleanup (prune_failed_trials.py:
        33-40, :65-97)."""
        n = 0
        for t in self.trials:
            bad = t.state in states or (
                non_finite and t.value is not None and not math.isfinite(t.value)
            )
            if bad:
                self._db.execute(
                    "DELETE FROM trials WHERE study = ? AND number = ?",
                    (self.study_name, t.number),
                )
                n += 1
        self._db.commit()
        self._trials_cache = None
        return n

    # -- optimization ----------------------------------------------------------
    @property
    def best_trial(self) -> Optional[FrozenTrial]:
        done = [t for t in self.trials if t.is_complete and math.isfinite(t.value)]
        return min(done, key=lambda t: t.value) if done else None

    @property
    def best_value(self) -> float:
        bt = self.best_trial
        return bt.value if bt else float("inf")

    @property
    def best_params(self) -> Dict[str, Any]:
        bt = self.best_trial
        return dict(bt.params) if bt else {}

    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int,
        catch: tuple = (Exception,),
        verbose: int = 1,
    ) -> None:
        start_number = max([t.number for t in self.trials], default=-1) + 1
        for i in range(n_trials):
            trial = Trial(self, start_number + i)
            try:
                value = objective(trial)
                self._record(trial, COMPLETE, float(value))
                if verbose:
                    print(
                        f"[{self.study_name}] trial {trial.number} COMPLETE "
                        f"value={value:.6g} best={self.best_value:.6g}",
                        flush=True,
                    )
            except TrialPruned:
                self._record(trial, PRUNED, None)
                if verbose:
                    print(f"[{self.study_name}] trial {trial.number} PRUNED", flush=True)
            except catch as e:
                self._record(trial, FAIL, None)
                if verbose:
                    # full traceback, not a one-liner: an unattended study
                    # whose every trial FAILs on a systematic objective bug
                    # must leave a diagnosable record (callers check
                    # best_trial for the all-failed case — studies.main
                    # exits nonzero on it)
                    import traceback

                    print(
                        f"[{self.study_name}] trial {trial.number} FAIL "
                        f"{type(e).__name__}: {e}",
                        flush=True,
                    )
                    traceback.print_exc()


def create_study(
    study_name: str, storage: str = "studies.sqlite", load_if_exists: bool = True,
    sampler=None, pruner=None, seed: Optional[int] = None,
) -> Study:
    s = Study(study_name, storage, sampler=sampler, pruner=pruner, seed=seed)
    if not load_if_exists and s.trials:
        raise ValueError(f"study {study_name} already exists in {storage}")
    return s
