"""Study visualizations (matplotlib; plotly is not a dependency).

Port of ``fs_uae_image_enhancer_project_tpu/nas/visualize.py``, the
counterpart of the reference's plotly exports to tuning_results/
(optuna_study_opt_act.py:442-465): optimization history, parameter
importances, and a value-vs-FPS pareto view when FPS data is present.
:func:`param_importances` needs numpy only; each plot imports matplotlib
when it is called.
"""
from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Dict, List

from .search import Study


def _finite_trials(study: Study):
    return [
        t for t in study.trials
        if t.is_complete and t.value is not None and math.isfinite(t.value)
    ]


def plot_optimization_history(study: Study, out_path: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    trials = _finite_trials(study)
    if not trials:
        return
    xs = [t.number for t in trials]
    ys = [t.value for t in trials]
    best = []
    cur = float("inf")
    for v in ys:
        cur = min(cur, v)
        best.append(cur)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    ax.scatter(xs, ys, s=14, alpha=0.6, label="trial value")
    ax.plot(xs, best, lw=1.5, label="best so far")
    ax.set_xlabel("trial")
    ax.set_ylabel("objective")
    ax.set_title(f"optimization history — {study.study_name}")
    ax.legend()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def param_importances(study: Study) -> Dict[str, float]:
    """Spearman-rank-correlation-based importance per parameter.

    Categorical params are scored by the spread of per-category mean
    objective values. Normalised to sum to 1."""
    import numpy as np

    trials = _finite_trials(study)
    if len(trials) < 4:
        return {}
    values = np.array([t.value for t in trials])
    scores: Dict[str, float] = {}
    names = sorted({k for t in trials for k in t.params})
    for name in names:
        pts = [(t.params[name], t.value) for t in trials if name in t.params]
        if len(pts) < 4:
            continue
        xs = [p for p, _v in pts]
        vs = np.array([v for _p, v in pts])
        if all(isinstance(x, (int, float)) for x in xs):
            xr = np.argsort(np.argsort(xs)).astype(float)
            vr = np.argsort(np.argsort(vs)).astype(float)
            if xr.std() == 0 or vr.std() == 0:
                continue
            scores[name] = abs(float(np.corrcoef(xr, vr)[0, 1]))
        else:
            groups = defaultdict(list)
            for x, v in pts:
                groups[str(x)].append(v)
            means = [np.mean(g) for g in groups.values() if g]
            if len(means) < 2 or values.std() == 0:
                continue
            scores[name] = float(np.std(means) / (values.std() + 1e-12))
    total = sum(scores.values())
    return {k: v / total for k, v in scores.items()} if total else scores


def plot_param_importances(study: Study, out_path: str, top: int = 20) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imps = param_importances(study)
    if not imps:
        return
    items = sorted(imps.items(), key=lambda kv: kv[1])[-top:]
    fig, ax = plt.subplots(figsize=(8, max(3, 0.3 * len(items))))
    ax.barh([k for k, _ in items], [v for _, v in items])
    ax.set_xlabel("relative importance")
    ax.set_title(f"parameter importances — {study.study_name}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def plot_pareto(study: Study, out_path: str) -> None:
    """Objective-vs-FPS pareto view (reference plotly pareto export
    counterpart); uses the 'fps_measured' value recorded per trial."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = [
        (t.params["fps_measured"], t.value)
        for t in _finite_trials(study)
        if "fps_measured" in t.params
    ]
    if not pts:
        return
    fig, ax = plt.subplots(figsize=(7, 5))
    xs, ys = zip(*pts)
    ax.scatter(xs, ys, s=18, alpha=0.7)
    # pareto front (maximize fps, minimize objective)
    front = []
    for x, y in sorted(pts, key=lambda p: -p[0]):
        if not front or y < front[-1][1]:
            front.append((x, y))
    if len(front) > 1:
        fx, fy = zip(*front)
        ax.plot(fx, fy, "r--", lw=1.2, label="pareto front")
        ax.legend()
    ax.set_xlabel("fps")
    ax.set_ylabel("objective (val loss)")
    ax.set_title(f"quality vs speed — {study.study_name}")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def export_all(study: Study, out_dir: str = "tuning_results") -> List[str]:
    paths = []
    p1 = os.path.join(out_dir, f"{study.study_name}_history.png")
    plot_optimization_history(study, p1)
    paths.append(p1)
    p2 = os.path.join(out_dir, f"{study.study_name}_importances.png")
    plot_param_importances(study, p2)
    paths.append(p2)
    p3 = os.path.join(out_dir, f"{study.study_name}_pareto.png")
    plot_pareto(study, p3)
    paths.append(p3)
    return [p for p in paths if os.path.exists(p)]
