"""The port installed from the repo's wheel, on the CPU. The wheel is built
once for the module from a copy of the tree (``chip_smoke.build_wheel``) and
installed with ``pip install --no-deps --target``; then: the wheel carries
every kernel source byte for byte, and the installed copy imports from its
own files without jax and builds its kernels under its user cache in the
checkout's hash directory. Nothing lands in the repo. The installed
``fse-torch-sidecar`` serving frames is ``test_torch_wheel_phase.py``'s."""
import glob
import json
import os
import subprocess
import sys
import zipfile

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "fs_uae_image_enhancer_project_tpu_torch"


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Two intra-op threads here and in the children: the tests run beside
    other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "2")
        yield
    torch.set_num_threads(threads)


def _repo_state() -> tuple:
    """The checkout's top-level entries, and what a setuptools build in it
    would leave below them: ``*.egg-info`` in a package, ``build/lib``,
    ``build/bdist.*``."""
    built = [p for pattern in ("*/*.egg-info", "build/lib", "build/bdist.*")
             for p in glob.glob(os.path.join(REPO, pattern))]
    return sorted(os.listdir(REPO)), sorted(built)


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    import chip_smoke as cs

    before = _repo_state()
    tmp = tmp_path_factory.mktemp("wheel")
    cache, target, work = (str(tmp / d) for d in ("cache", "target", "work"))
    os.makedirs(work)
    whl = cs.build_wheel(str(tmp / "wheel"), cache)
    cs.install_wheel(whl, target, cache)
    return dict(whl=whl, target=target, cache=cache, work=work, before=before)


def test_wheel_carries_every_kernel_source_byte_equal(installed):
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

    csrc = f"{PORT}/ops/cuda/csrc/"
    with zipfile.ZipFile(installed["whl"]) as z:
        carried = {n[len(csrc):]: z.read(n) for n in z.namelist() if n.startswith(csrc)}
    sources = build._sources()
    assert len(sources) == 8
    assert sorted(carried) == sorted(os.path.basename(s) for s in sources)
    for path in sources:
        with open(path, "rb") as f:
            assert carried[os.path.basename(path)] == f.read(), path


CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
import importlib, json, os, pkgutil
import fs_uae_image_enhancer_project_tpu_torch as p
for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):
    importlib.import_module(m.name)
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build
print(json.dumps(dict(
    files={n: getattr(m, "__file__", None) for n, m in sys.modules.items()
           if m is not None and n.split(".")[0] == p.__name__},
    loaded=[n for n, m in sys.modules.items() if m is not None
            and n.split(".")[0] in ("jax", "jaxlib", "fs_uae_image_enhancer_project_tpu")],
    build_root=build.BUILD_ROOT, library=build.library_path(),
    sources=[os.path.basename(s) for s in build._sources()])))
"""


def test_installed_copy_imports_without_jax_from_the_target(installed):
    """Every module of the installed port imports with jax blocked, in a
    child whose path holds the install and not the checkout; each module's
    file lies under the install; its kernels would build under its
    ``XDG_CACHE_HOME``, in the checkout's hash directory."""
    from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

    target, cache = installed["target"], installed["cache"]
    env = dict(os.environ, PYTHONPATH=target, XDG_CACHE_HOME=cache)
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=installed["work"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert not got["loaded"], got["loaded"]
    assert len(got["files"]) > 100
    for name, path in got["files"].items():
        assert path and path.startswith(target + os.sep), (name, path)
    assert f"{PORT}.runtime.sidecar" in got["files"]
    assert got["build_root"] == os.path.join(cache, PORT, "torch_kernels")
    lib = got["library"]
    assert os.path.dirname(os.path.dirname(lib)) == got["build_root"]
    assert not lib.startswith(target + os.sep)
    assert (os.path.basename(os.path.dirname(lib))
            == os.path.basename(os.path.dirname(build.library_path())))
    assert got["sources"] == [os.path.basename(s) for s in build._sources()]


STRIPPED_CHILD = """
import sys
sys.modules["jax"] = None
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build
try:
    build.load_library()
except FileNotFoundError as e:
    print(e)
"""


def test_install_without_kernel_sources_names_them(installed, tmp_path):
    """The fault this packaging repairs, from the install's side: the
    installed port with its ``csrc`` emptied (a wheel without the package
    data) fails at its first kernel with the error that names ``csrc`` and
    the missing sources, not a link of no object, and builds nothing."""
    import shutil

    site, cache = tmp_path / "site", tmp_path / "cache"
    shutil.copytree(os.path.join(installed["target"], PORT), site / PORT,
                    ignore=shutil.ignore_patterns("*.cu", "*.cuh", "__pycache__"))
    csrc = site / PORT / "ops" / "cuda" / "csrc"
    assert not os.listdir(csrc)
    env = dict(os.environ, PYTHONPATH=str(site), XDG_CACHE_HOME=str(cache))
    r = subprocess.run([sys.executable, "-c", STRIPPED_CHILD], cwd=installed["work"], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert str(csrc) in r.stdout and "installed without its kernel sources" in r.stdout
    assert not cache.exists()


def test_wheel_build_and_install_leave_nothing_in_the_repo(installed):
    """Last in the module: after the build, the install and the child, the
    checkout holds what it held."""
    assert _repo_state() == installed["before"]
