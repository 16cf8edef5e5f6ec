"""The activation-search NAS studies.

Port of ``fs_uae_image_enhancer_project_tpu/nas/studies.py``: re-creations
of the reference's three Optuna studies over the conv6 model:

- ``opt_act``       - activations for layers 1/2/4/6/7 with conditional
                      sub-params (optuna_study_opt_act.py:122-165),
- ``prune_act``     - wider activation sets across all layers + batch size
                      (optuna_study_prune_act.py:122-165),
- ``prune_act_r2``  - all 20 registry activations, act-specific param
                      suggestion, layer-6 kernel in {3,5,7}, FPS measured
                      after training (optuna_study_prune_act_r2.py:102-159).

Each trial: resolve config -> FPS from cache or measured on the card
(:func:`measure_fps`) -> short training run with per-epoch reports -> median
pruning -> best validation loss (inf on NaN, optuna_study_prune_act.py:
321-323). The search space, the presets and the replay are the JAX
package's, so one seeded sampler gives both packages the same configs.

    python -m fs_uae_image_enhancer_project_tpu_torch.nas.studies \
        --study prune_act_r2 --generator_train_dir DIR --trials 35
"""
from __future__ import annotations

import math
import sys
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..models.configs import Conv6Config, ConvLayerSpec, act, config_to_json
from .fps_cache import FPSCache
from .search import MedianPruner, TrialPruned, TPESampler, create_study

# the full registry surface (optuna_study_prune_act_r2.py:127-132)
ALL_ACTIVATIONS = [
    "identity", "elu", "gelu", "leaky_relu", "mish", "prelu",
    "relu", "relu6", "sigmoid", "silu", "swish", "softplus",
    "tanh", "log_softmax", "softmax", "scaled_tanh", "telu",
    "sinlu", "biased_relu", "biased_prelu",
]

# Per-slot choice sets, exactly the reference's: odd slots (act1/act3) draw
# from a saturating set, even slots (act2/act4) from a rectifier set.
# opt_act: optuna_study_opt_act.py:122-150
OPT_ACT_SATURATING = ["identity", "tanh", "telu", "sinlu", "mish", "silu"]
OPT_ACT_RECTIFIERS = ["identity", "relu", "leaky_relu", "biased_relu",
                      "biased_prelu", "prelu", "relu6"]
# prune_act: optuna_study_prune_act.py:122-162 (adds gelu/sigmoid/elu to
# the saturating set, drops biased_prelu from the rectifier set)
PRUNE_ACT_SATURATING = ["identity", "tanh", "telu", "gelu", "sigmoid",
                        "sinlu", "elu", "mish", "silu"]
PRUNE_ACT_RECTIFIERS = ["identity", "relu", "leaky_relu", "biased_relu",
                        "prelu", "relu6"]

# act slots per conv6 layer (matching the pix_shuffle/conv6 topology)
LAYER_SLOTS = {1: 2, 2: 4, 3: 2, 4: 4, 5: 2, 6: 2, 7: 2}


def suggest_activation_params(
    trial, prefix: str, act_name: str, out_channels: int,
    policy: str = "r2",
) -> Dict[str, Any]:
    """Conditional activation sub-params, per study.

    ``policy='r2'``: prune_act_r2's _get_activation_params
    (optuna_study_prune_act_r2.py:135-159) — log-scale leaky_relu slope,
    prelu num_parameters, elu alpha, gelu approximate, softmax axis.
    ``policy='opt_act'``: optuna_study_opt_act.py:152-165 — LINEAR-scale
    leaky_relu slope, num_parameters for prelu AND biased_prelu; the
    caller applies it to even (rectifier) slots only, as the reference does.
    ``policy='none'``: prune_act suggests no sub-params at all
    (optuna_study_prune_act.py passes bare act names into Model).
    """
    params: Dict[str, Any] = {}
    if policy == "none":
        return params
    if policy == "opt_act":
        if act_name == "leaky_relu":
            params["negative_slope"] = trial.suggest_float(
                f"{prefix}_negative_slope", 0.001, 0.5
            )
        elif act_name in ("prelu", "biased_prelu"):
            choice = trial.suggest_categorical(
                f"{prefix}_num_parameters_choice", ["global", "per_channel"]
            )
            params["num_parameters"] = (
                1 if choice == "global" else out_channels
            )
        return params
    if policy != "r2":
        raise ValueError(f"unknown param policy {policy!r}")
    if act_name == "leaky_relu":
        params["negative_slope"] = trial.suggest_float(
            f"{prefix}_negative_slope", 0.001, 0.5, log=True
        )
    elif act_name == "prelu":
        choice = trial.suggest_categorical(
            f"{prefix}_num_parameters_choice", ["global", "per_channel"]
        )
        params["num_parameters"] = 1 if choice == "global" else out_channels
    elif act_name == "elu":
        params["alpha"] = trial.suggest_float(f"{prefix}_alpha", 0.1, 2.0)
    elif act_name == "gelu":
        params["approximate"] = trial.suggest_categorical(
            f"{prefix}_approximate", ["none", "tanh"]
        )
    elif act_name in ("log_softmax", "softmax"):
        params["axis"] = -1  # channel axis in NHWC (reference dim=1 in NCHW)
    return params


def suggest_conv6_config(
    trial,
    *,
    searched_slots: Dict[int, int],
    activation_choices: Optional[Sequence[str]] = None,
    saturating_choices: Optional[Sequence[str]] = None,
    rectifier_choices: Optional[Sequence[str]] = None,
    param_policy: str = "r2",
    search_layer6_kernel: bool = False,
    channels: int = 36,
) -> Conv6Config:
    """Build a Conv6Config from trial suggestions.

    ``searched_slots`` maps layer -> number of act slots suggested (the
    reference studies search different slot subsets: opt_act skips layers
    3/5 entirely, prune_act_r2 searches only 2 of layer 4's slots and
    stops at layer 6). Unsearched slots keep the conv6 Model DEFAULTS —
    the reference passes no kwargs for them — not identity.
    Slot choice sets: a single ``activation_choices`` list (prune_act_r2)
    or per-parity ``saturating_choices``/``rectifier_choices`` (opt_act,
    prune_act).
    """
    from ..models.conv6 import default_config

    defaults = default_config().layers
    layer_specs: List[ConvLayerSpec] = []
    for li in range(1, 8):
        out_ch = 3 if li == 7 else channels
        n_slots = LAYER_SLOTS[li]
        acts = []
        for si in range(1, n_slots + 1):
            if si <= searched_slots.get(li, 0):
                prefix = f"layer{li}_act{si}"
                if activation_choices is not None:
                    choices = activation_choices
                elif si % 2 == 1:
                    choices = saturating_choices
                else:
                    choices = rectifier_choices
                name = trial.suggest_categorical(prefix, list(choices))
                if param_policy == "opt_act" and si % 2 == 1:
                    # the reference's conditional-param loop covers even
                    # (rectifier) slots only (opt_act.py:152)
                    cfg = {}
                else:
                    cfg = suggest_activation_params(
                        trial, prefix, name, out_ch, policy=param_policy
                    )
                acts.append(act(name, **cfg))
            else:
                acts.append(defaults[li - 1].acts[si - 1])
        ks = 3
        if li == 6 and search_layer6_kernel:
            ks = trial.suggest_int("layer6_kernel_size", 3, 7, step=2)
        layer_specs.append(ConvLayerSpec(out_ch, ks, tuple(acts)))
    return Conv6Config(layers=tuple(layer_specs))


def measure_fps(
    cfg: Conv6Config,
    *,
    height: int = 576,
    width: int = 752,
    duration_s: float = 3.0,
    compute_dtype="bfloat16",
    device=None,
) -> float:
    """Chained FPS of the candidate's forward at the deployment shape, on a
    device-resident frame (reference protocol: model_pix_shuffle.py:348-368):
    ``utils.profiler.measure_chained``, each call's output the next one's
    input, timed with CUDA events on a card. Weights from seed 0."""
    import torch

    from .. import resolve_device
    from ..models import conv6 as conv6_mod
    from ..utils.profiler import measure_chained

    dev = resolve_device(device)
    dtype = getattr(torch, str(compute_dtype))
    params = conv6_mod.init(cfg, torch.Generator().manual_seed(0), device=dev)
    x = torch.zeros((1, height, width, 3), dtype=dtype, device=dev)
    with torch.no_grad():
        res = measure_chained(lambda t: conv6_mod.apply(params, t, cfg), x, warmup=3,
                              duration_s=duration_s)
    return res.fps


def trial_train_step(cfg: Conv6Config):
    """A trial's train step for the candidate ``cfg``: the conv6 forward,
    L1 loss, uint8 batches made fp32 on the device (the port's
    ``make_train_step``; bf16 forward). The objective trains with it, and a
    caller can time it on its own."""
    from ..data.dataset import batch_transform
    from ..losses.functional import l1_loss
    from ..models import conv6 as conv6_mod
    from ..parallel.train_step import make_train_step

    return make_train_step(lambda p, x: conv6_mod.apply(p, x, cfg),
                           lambda o, t: l1_loss(o, t), input_transform=batch_transform(linear=True))


def make_objective(
    *,
    searched_slots: Dict[int, int],
    activation_choices: Optional[Sequence[str]] = None,
    saturating_choices: Optional[Sequence[str]] = None,
    rectifier_choices: Optional[Sequence[str]] = None,
    param_policy: str = "r2",
    search_layer6_kernel: bool = False,
    train_pairs=None,
    val_pairs=None,
    crop_size=(128, 96),
    epochs_per_trial: int = 3,
    samples_per_epoch: int = 64,
    batch_size: int = 16,
    search_batch_size: bool = False,
    min_fps: float = 0.0,
    fps_cache: Optional[FPSCache] = None,
    fps_duration_s: float = 3.0,
    device=None,
    init_params: Optional[Callable] = None,
):
    """Build the study objective: config -> FPS gate -> short train -> loss.

    ``init_params(cfg, trial_number)`` gives a trial's initial weights
    (default: ``conv6.init`` from ``torch.Generator().manual_seed(
    trial_number)``; a test passes the JAX package's through ``interop``)."""
    import torch

    from .. import resolve_device
    from ..data.dataset import SRDataset, batch_transform, device_prefetch
    from ..losses.functional import l1_loss
    from ..models import conv6 as conv6_mod
    from ..parallel.train_step import init_train_state, make_optimizer

    dev = resolve_device(device)
    cache = fps_cache or FPSCache()
    if init_params is None:
        def init_params(cfg, number):
            return conv6_mod.init(cfg, torch.Generator().manual_seed(number), device=dev)

    def objective(trial) -> float:
        cfg = suggest_conv6_config(
            trial,
            searched_slots=searched_slots,
            activation_choices=activation_choices,
            saturating_choices=saturating_choices,
            rectifier_choices=rectifier_choices,
            param_policy=param_policy,
            search_layer6_kernel=search_layer6_kernel,
        )
        lr = trial.suggest_float("learning_rate", 1e-5, 1e-3, log=True)
        bs = batch_size
        if search_batch_size:
            bs = trial.suggest_categorical("batch_size", [16, 32])

        # config_to_json is the canonical NAS cache key (models/configs.py)
        arch_key = config_to_json(cfg)
        fps = cache.get_or_measure(
            arch_key, lambda: measure_fps(cfg, duration_s=fps_duration_s, device=dev))
        trial.params["fps_measured"] = fps  # recorded for pareto plots
        if min_fps and fps < min_fps:
            raise TrialPruned()

        if train_pairs is None:
            # FPS-only mode (no dataset supplied)
            return -fps

        state = init_train_state(init_params(cfg, trial.number), make_optimizer(lr=lr))
        step = trial_train_step(cfg)
        # uint8 batches cross to the device and become fp32 there
        tf = batch_transform(linear=True)

        @torch.no_grad()
        def eval_loss(p, lr_b, hr_b):
            y = conv6_mod.apply(p, tf(lr_b).to(torch.bfloat16), cfg)
            return l1_loss(y.float(), tf(hr_b).float())

        best_val = float("inf")
        for epoch in range(epochs_per_trial):
            ds = SRDataset(
                train_pairs, crop_size, samples_per_epoch, batch_size=bs,
                seed=trial.number * 100 + epoch, transfer_dtype="uint8",
            )
            loss = None
            for lr_b, hr_b in device_prefetch(iter(ds), device=dev):
                state, loss = step(state, lr_b[None], hr_b[None])
            # NaN-abort check once an epoch: a NaN reached mid-epoch
            # persists in every later step's loss anyway
            if loss is not None and not math.isfinite(float(loss)):
                return float("inf")
            vds = SRDataset(
                val_pairs or train_pairs, crop_size, max(bs, 16),
                batch_size=bs, seed=1, flips=False, transfer_dtype="uint8",
            )
            vals = [float(eval_loss(state.params, a, b))
                    for a, b in device_prefetch(iter(vds), device=dev)]
            val = float(np.mean(vals)) if vals else float("inf")
            best_val = min(best_val, val)
            trial.report(val, epoch)
            if trial.should_prune():
                raise TrialPruned()
        return best_val if math.isfinite(best_val) else float("inf")

    return objective


def config_from_trial_params(study: str, trial_params: dict) -> "Conv6Config":
    """Deterministically rebuild the Conv6Config a finished trial searched,
    from its recorded params (the SQLite record / best_trial.json).

    Replays ``suggest_conv6_config`` against a stub trial that answers every
    suggestion from the recorded dict — the same mechanism the FPS-cache-hit
    demo uses. Non-architecture keys (learning_rate, fps_measured,
    batch_size) are simply never asked for by the suggestion pass.

    A key the record lacks falls back to the FIRST choice / range low end:
    trials recorded before a search-space widening (e.g. the round-4 parity
    fix added gelu ``approximate``) never suggested the new conditional
    sub-params, and the first choice is those trials' actual behaviour
    (activation defaults). Fallbacks are deterministic, so the rebuilt
    config still matches the FPS cache key of a post-widening re-measure.
    """
    preset = STUDY_PRESETS[study]

    class _Replay:
        def __init__(self, params):
            self.trial_params = dict(params)

        def suggest_categorical(self, name, choices):
            return self.trial_params.get(name, list(choices)[0])

        def suggest_int(self, name, lo, hi, step=1):
            return int(self.trial_params.get(name, lo))

        def suggest_float(self, name, lo, hi, log=False):
            return float(self.trial_params.get(name, lo))

    keys = ("searched_slots", "activation_choices", "saturating_choices",
            "rectifier_choices", "param_policy", "search_layer6_kernel")
    kw = {k: preset[k] for k in keys if k in preset}
    return suggest_conv6_config(_Replay(trial_params), **kw)


STUDY_PRESETS = {
    # layers 1/2/4/6/7, per-parity sets, even-slot conditional sub-params
    # (opt_act.py:122-165)
    "opt_act": dict(
        searched_slots={1: 2, 2: 4, 4: 4, 6: 2, 7: 2},
        saturating_choices=OPT_ACT_SATURATING,
        rectifier_choices=OPT_ACT_RECTIFIERS,
        param_policy="opt_act",
    ),
    # all 7 layers, wider saturating set, NO sub-params, batch size
    # (prune_act.py:122-165)
    "prune_act": dict(
        searched_slots={1: 2, 2: 4, 3: 2, 4: 4, 5: 2, 6: 2, 7: 2},
        saturating_choices=PRUNE_ACT_SATURATING,
        rectifier_choices=PRUNE_ACT_RECTIFIERS,
        param_policy="none",
        search_batch_size=True,
    ),
    # all 20 registry activations for every searched slot, layer4 limited
    # to 2 slots, layer7 NOT searched, layer6 kernel in {3,5,7}
    # (prune_act_r2.py:102-159: suggests layer1..6, layer4_act1/act2 only)
    "prune_act_r2": dict(
        searched_slots={1: 2, 2: 4, 3: 2, 4: 2, 5: 2, 6: 2},
        activation_choices=ALL_ACTIVATIONS,
        param_policy="r2",
        search_layer6_kernel=True,
    ),
}


def build_parser():
    """The study's command line (JAX's flags, ``--fps_cache`` and ``--device``)."""
    import argparse

    ap = argparse.ArgumentParser(description="Run a NAS activation study")
    ap.add_argument("--study", choices=sorted(STUDY_PRESETS), required=True)
    ap.add_argument("--storage", default="tuning_results/studies.sqlite")
    ap.add_argument("--trials", type=int, default=35)
    ap.add_argument("--generator_train_dir", default=None)
    ap.add_argument("--crop_size", type=int, nargs=2, default=[128, 96])
    ap.add_argument("--epochs_per_trial", type=int, default=3)
    ap.add_argument("--samples_per_epoch", type=int, default=64)
    ap.add_argument("--min_fps", type=float, default=0.0)
    ap.add_argument("--fps_duration", type=float, default=3.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--pruning_warmup_steps", type=int, default=0,
        help="MedianPruner warmup epochs (reference optuna_study_opt_act.sh flag)",
    )
    ap.add_argument("--fps_cache", default="model_performance_cache.json",
                    help="the FPS cache's JSON file (keys name the card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda with no card raises")
    return ap


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)

    train_pairs = val_pairs = None
    if args.generator_train_dir:
        from ..data.dataset import gather_all_samples_from_directory, split_pairs

        pairs = gather_all_samples_from_directory(
            args.generator_train_dir, tuple(args.crop_size), verbose=1
        )
        train_pairs, val_pairs = split_pairs(pairs, 0.1)

    preset = dict(STUDY_PRESETS[args.study])
    objective = make_objective(
        train_pairs=train_pairs,
        val_pairs=val_pairs,
        crop_size=tuple(args.crop_size),
        epochs_per_trial=args.epochs_per_trial,
        samples_per_epoch=args.samples_per_epoch,
        min_fps=args.min_fps,
        fps_duration_s=args.fps_duration,
        fps_cache=FPSCache(args.fps_cache),
        device=args.device,
        **preset,
    )
    study = create_study(
        args.study, args.storage, load_if_exists=True,
        sampler=TPESampler(seed=args.seed),
        pruner=MedianPruner(n_warmup_steps=args.pruning_warmup_steps),
    )
    study.optimize(objective, n_trials=args.trials)
    bt = study.best_trial
    if bt:
        print(f"best value {bt.value:.6g} with params:")
        for k, v in sorted(bt.params.items()):
            print(f"  {k} = {v}")
        return 0
    # optimize() turns objective exceptions into FAIL rows so an unattended
    # study survives transient trial failures, but a study that produced NO
    # usable trial must not look like success
    states = [t.state for t in study.trials]
    print(f"ERROR: no completed trial in study {args.study!r} "
          f"(states: { {s: states.count(s) for s in set(states)} }); "
          "see FAIL tracebacks above", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
