"""The port's run recipes (``fs_uae_image_enhancer_project_tpu_torch/recipes``)
against the JAX package's (``recipes/``), on the CPU.

Each pair runs with a shim in place of Python: the root recipe finds it as
``python`` on ``PATH``, the port's as ``$PYTHON``. The shim writes its
argv and exits 0 (for the staged recipe it also appends the CSV row that a
finished stage process writes). The port's command lines must be the JAX
recipe's after the module prefix is mapped and each recipe's decision is
applied (:data:`ADDED`, :data:`DROPPED`, :data:`PASSED_ON`), and each must
parse under the port module's own ``build_parser()``.
"""
import glob
import importlib
import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "fs_uae_image_enhancer_project_tpu", "fs_uae_image_enhancer_project_tpu_torch"
ROOT_RECIPES = os.path.join(REPO, "recipes")
PORT_RECIPES = os.path.join(REPO, PORT_PKG, "recipes")

# each recipe's positional arguments and the flags its pass-through takes
# (None: the recipe passes nothing through)
CASES = {
    "generate_dataset.sh": (["src/train", "src/test", "out"], ["--max_crops_per_image", "8"]),
    "prepare_groundtruth.sh": (["src", "dst"], ["--workers", "2"]),
    "nas_opt_act.sh": (["data/train"], ["--seed", "1"]),
    "nas_prune_act.sh": (["data/train"], ["--seed", "1"]),
    "nas_prune_act_r2.sh": (["data/train"], ["--seed", "1"]),
    "serve_sidecar.sh": (["s.sock", "conv3", "w.onnx"], ["--stats", "stats.json"]),
    "train_conv3.sh": (["data/train", "ck"], None),
    "train_conv3_heavy.sh": (["data/train", "ck"], None),
    "train_conv5.sh": (["data/train", "ck"], ["--verbose", "0"]),
    "train_conv5_heavy.sh": (["data/train", "ck"], None),
    "train_heavy_staged.sh": (None, None),  # positionals from staged_args
    "train_pix_shuffle.sh": (["data/train", "ck"], ["--verbose", "0"]),
    "train_pix_shuffle_multichip.sh": (["data/train", "ck", "4", "2"], None),
    "train_residual_unet.sh": (["data/train", "ck"], ["--verbose", "0"]),
}
# the decisions of the port's recipes: flags added before the pass-through,
# flags dropped, and the recipe whose pass-through is new
ADDED = {"generate_dataset.sh": ["--palette_algorithm", "kmeans_torch", "--quantize_backend",
                                 "device", "--device_batch", "16", "--workers", "1"]}
DROPPED = {"train_pix_shuffle.sh": "--samples_dir"}  # the flag and its value
PASSED_ON = {"serve_sidecar.sh"}

SHIM = r"""#!/bin/bash
printf '%s\0' "$(basename "$0")" "$@" >> "$SHIM_LOG"
printf '\n' >> "$SHIM_LOG"
out= epochs=
while [ $# -gt 0 ]; do
  case "$1" in --out) out=$2 ;; --epochs) epochs=$2 ;; esac
  shift
done
if [ -n "$out" ] && [ -n "$epochs" ]; then
  printf '%s,0.1,0.1,0,0.00015,seed\n' "$epochs" >> "$out/training_stats_pix_shuffle.csv"
fi
exit 0
"""


@pytest.fixture(scope="module")
def shims(tmp_path_factory):
    """``python`` in a directory for ``PATH``, and ``port_python`` for
    ``$PYTHON`` (not on ``PATH``)."""
    d = tmp_path_factory.mktemp("shim")
    for name in ("python", "port_python"):
        path = d / name
        path.write_text(SHIM)
        path.chmod(0o755)
    return d


def record(recipe, args, shims, workdir, log):
    env = dict(os.environ, PATH=f"{shims}{os.pathsep}{os.environ['PATH']}",
               PYTHON=str(shims / "port_python"), SHIM_LOG=str(log))
    r = subprocess.run(["bash", recipe, *args], cwd=workdir, env=env, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    with open(log, "rb") as f:
        calls = [rec.split(b"\0")[:-1] for rec in f.read().split(b"\n")[:-1]]
    return [[a.decode() for a in c] for c in calls]


def expected(name, jax_calls, extra):
    """JAX's command lines as the port's recipe must give them."""
    out = []
    for shim, *argv in jax_calls:
        assert shim == "python"
        if argv[0] == "-m":
            assert argv[1].startswith(JAX_PKG + ".")
            argv = ["-m", PORT_PKG + argv[1][len(JAX_PKG):], *argv[2:]]
        else:  # the root script the staged recipe runs
            assert argv[0] == "scripts/train_psh_heavy_long.py"
            argv = ["-m", PORT_PKG + ".scripts.train_psh_heavy_long", *argv[1:]]
        if name in PASSED_ON:  # the root recipe drops what follows its 3rd argument
            fixed, passed = argv, list(extra or ())
        else:
            n = len(extra or ())
            fixed, passed = argv[:len(argv) - n], argv[len(argv) - n:]
        if name in DROPPED:
            i = fixed.index(DROPPED[name])
            fixed = fixed[:i] + fixed[i + 2:]
        out.append(["port_python", *fixed, *ADDED.get(name, []), *passed])
    return out


def staged_args(work):
    """The staged recipe's positionals in ``work``: an output directory, lr,
    30 epochs (stage processes to 12, 24 and 30) and a seed checkpoint.
    (Its defaults are not run: the root recipe's are one machine's absolute
    paths.)"""
    seed = work / "seed_ckpt"
    seed.mkdir()
    return [str(work / "out"), "0.0002", "30", str(seed)]


@pytest.mark.parametrize("name,given", [(n, g) for n in sorted(CASES) for g in (True, False)
                                        if g or n != "train_heavy_staged.sh"])
def test_port_recipe_runs_the_jax_recipes_command_lines(name, given, shims, tmp_path):
    pos, extra = CASES[name]
    extra = extra if given else None
    calls = {}
    for side, recipes in (("jax", ROOT_RECIPES), ("port", PORT_RECIPES)):
        work = tmp_path / side
        work.mkdir()
        if name == "train_heavy_staged.sh":  # a fresh stage for each side
            args = staged_args(work)
        else:
            args = pos + (extra or []) if given else []
        calls[side] = record(os.path.join(recipes, name), args, shims, work,
                             tmp_path / f"{side}.log")
    if name == "train_heavy_staged.sh":  # the same stage at each side's paths
        calls["jax"] = [[a.replace(str(tmp_path / "jax"), str(tmp_path / "port")) for a in c]
                        for c in calls["jax"]]
        assert [c[c.index("--epochs") + 1] for c in calls["port"]] == ["12", "24", "30"]
    assert calls["jax"] and calls["port"] == expected(name, calls["jax"], extra)
    for _shim, _m, module, *argv in calls["port"]:
        importlib.import_module(module).build_parser().parse_args(argv)


def test_every_root_recipe_has_a_case():
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT_RECIPES, "*.sh")))
    assert names == sorted(CASES)


# chip_smoke.py's recipes record as the phase printed it on an NVIDIA H100
# 80GB HBM3 at 700 W, less its step seconds
CARD_RECORD = {
    "groundtruth": {"img_0.png": [1410, 1080], "img_1.png": [1410, 1080]},
    "generate": {"files": 80, "targets": 16, "styled": 64, "crop_sizes": [[376, 288]],
                 "summary": {"expected": 80, "present": 80, "generated_this_run": 80,
                             "missing": 0, "stopped": False, "k3_launches": 8}},
    "train": {"csv_epochs": [1], "best_checkpoint": ["state.pt"],
              "metrics": [{"epoch": 1, "train_loss": 0.19873902201652527,
                           "val_loss": 0.17940348386764526, "lr": 0.00051952,
                           "seconds": 3.61, "val_k1_launches": 1}]},
    "serve": {"server_rc": 0,
              "replay_warmup": {"frames": 16, "ms_per_frame": 10.004, "fps": 100.0, "depth": 2},
              "replay": {"frames": 400, "ms_per_frame": 6.57, "fps": 152.2, "depth": 2},
              "depth": 2, "frames": 417, "k1_launches": 418, "p50_ms": 14.977,
              "p90_ms": 18.718, "mean_ms": 15.327, "max_ms": 33.544, "c_equal_python": True,
              "c_equal_direct": True, "python_equal_direct": True,
              "socket_floor": {"frames": 400, "ms_per_frame": 2.511, "fps": 398.2, "depth": 2}},
    "launches": {"fused_stack": 419, "palette_dither": 8},
}

# each a fault the check must catch: the path into the record and a bad value
BROKEN = {
    "one_groundtruth_image": (("groundtruth",), lambda v: dict(list(v.items())[:1])),
    "styled_not_four_a_target": (("generate", "styled"), lambda v: v - 1),
    "crop_size_cut": (("generate", "crop_sizes"), lambda v: [[188, 144]]),
    "generator_missing_files": (("generate", "summary", "missing"), lambda v: 1),
    "generator_summary_off_the_tree": (("generate", "summary", "present"), lambda v: v - 1),
    "k3_not_launched_on_the_card": (("generate", "summary", "k3_launches"), lambda v: 0),
    "no_csv_epoch": (("train", "csv_epochs"), lambda v: []),
    "nan_loss": (("train", "metrics"), lambda v: [dict(v[0], val_loss=float("nan"))]),
    "no_best_checkpoint": (("train", "best_checkpoint"), lambda v: []),
    "k1_not_in_validation": (("train", "metrics"), lambda v: [dict(v[0], val_k1_launches=0)]),
    "server_exit_nonzero": (("serve", "server_rc"), lambda v: 1),
    "replay_frames_short": (("serve", "replay", "frames"), lambda v: v - 1),
    "server_frames_off": (("serve", "frames"), lambda v: v - 1),
    "c_differs_from_direct": (("serve", "c_equal_direct"), lambda v: False),
    "c_differs_from_python": (("serve", "c_equal_python"), lambda v: False),
    "python_differs_from_direct": (("serve", "python_equal_direct"), lambda v: False),
    "server_no_k1": (("serve", "k1_launches"), lambda v: 0),
    "no_socket_floor": (("serve", "socket_floor", "frames"), lambda v: 0),
}


def _broken(rec, path, value):
    import copy

    bad = copy.deepcopy(rec)
    node = bad
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value(node[path[-1]])
    return bad


@pytest.mark.parametrize("fault", ["none", *sorted(BROKEN)])
def test_chip_smoke_check_recipes_holds_a_card_record(fault):
    """The recipes phase's check passes the card's record and fails each
    fault in :data:`BROKEN`; on the CPU, the same record fails for its
    launches, and passes once K1 and K3 count none."""
    import torch

    import chip_smoke as cs

    card, cpu = torch.device("cuda"), torch.device("cpu")
    if fault == "none":
        cs.check_recipes(CARD_RECORD, card)
        with pytest.raises(AssertionError):
            cs.check_recipes(CARD_RECORD, cpu)
        rec = _broken(CARD_RECORD, ("generate", "summary", "k3_launches"), lambda v: 0)
        rec = _broken(rec, ("train", "metrics"), lambda v: [dict(v[0], val_k1_launches=0)])
        cs.check_recipes(_broken(rec, ("serve", "k1_launches"), lambda v: 0), cpu)
    else:
        with pytest.raises(AssertionError):
            cs.check_recipes(_broken(CARD_RECORD, *BROKEN[fault]), card)
