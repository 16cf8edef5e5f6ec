"""Where the port's CUDA kernels build (``ops/cuda/build.py``): a checkout's
``build/torch_kernels``, an install's user cache, and a clear error when the
sources are missing. CPU only: nothing here calls nvcc."""
import os

import pytest

from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "fs_uae_image_enhancer_project_tpu_torch"


def _no_nvcc(*_a, **_k):
    raise AssertionError("nvcc was called")


@pytest.mark.parametrize("left", ["nothing", "headers only"])
def test_build_without_sources_names_the_directory_before_nvcc(tmp_path, monkeypatch, left):
    """A ``csrc`` with no ``.cu`` (an install without its package data)
    raises an error that names the directory and the cause, before any
    nvcc is looked for or run, and writes nothing."""
    monkeypatch.setattr(build, "_nvcc", _no_nvcc)
    monkeypatch.setattr(build, "_run", _no_nvcc)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    if left == "headers only":
        (csrc / "fused_stack_common.cuh").write_text("// a header\n")
    out = tmp_path / "out" / build.LIB_NAME
    with pytest.raises(FileNotFoundError) as e:
        build.build(str(out), str(csrc))
    assert str(csrc) in str(e.value)
    assert "installed without its kernel sources" in str(e.value)
    assert not (tmp_path / "out").exists()


def test_load_library_without_sources_raises_the_named_error(tmp_path, monkeypatch):
    """``load_library`` on such a ``csrc`` hashes no source, finds no
    library and reaches the same error, not a link of no object."""
    monkeypatch.setattr(build, "_nvcc", _no_nvcc)
    monkeypatch.setattr(build, "_run", _no_nvcc)
    monkeypatch.setattr(build, "BUILD_ROOT", str(tmp_path / "kernels"))
    with pytest.raises(FileNotFoundError, match="installed without its kernel sources"):
        build.load_library(csrc=str(tmp_path))
    assert not (tmp_path / "kernels").exists()


def test_build_root_in_the_checkout_is_build_torch_kernels():
    assert os.path.isfile(os.path.join(build.REPO_ROOT, "pyproject.toml"))
    assert build.REPO_ROOT == REPO
    assert build.BUILD_ROOT == os.path.join(REPO, "build", "torch_kernels")
    assert build.build_root(REPO) == build.BUILD_ROOT


def test_build_root_outside_a_checkout_is_the_user_cache(tmp_path, monkeypatch):
    """A root without ``pyproject.toml`` (``site-packages`` or a ``--target``
    directory) builds under ``$XDG_CACHE_HOME``, else ``~/.cache``."""
    site = tmp_path / "site-packages"
    (site / PACKAGE).mkdir(parents=True)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert build.build_root(str(site)) == str(tmp_path / "xdg" / PACKAGE / "torch_kernels")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    for unset in (monkeypatch.delenv, lambda k: monkeypatch.setenv(k, "")):
        unset("XDG_CACHE_HOME")
        assert build.build_root(str(site)) == str(
            tmp_path / "home" / ".cache" / PACKAGE / "torch_kernels")
    (site / "pyproject.toml").write_text("")
    assert build.build_root(str(site)) == str(site / "build" / "torch_kernels")


def test_checkout_library_path_is_unchanged():
    """The checkout's library stays at ``build/torch_kernels/<16 hex>/``, so
    an existing build is found and the card builds nothing new."""
    lib = build.library_path()
    digest = os.path.basename(os.path.dirname(lib))
    assert os.path.dirname(os.path.dirname(lib)) == os.path.join(REPO, "build", "torch_kernels")
    assert os.path.basename(lib) == "libfse_kernels.so"
    assert len(digest) == 16 and int(digest, 16) >= 0
