"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The ``.cu`` sources under ``csrc/`` have a plain C interface and include no
PyTorch header. Each is compiled by its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects: seconds in all. The
library goes to ``<BUILD_ROOT>/<content-hash>/libfse_kernels.so``, built at
first use: ``BUILD_ROOT`` is ``build/torch_kernels`` under the repo root in a
checkout (a root that holds ``pyproject.toml``), and in an installed copy,
whose ``csrc`` comes from the wheel's package data,
``${XDG_CACHE_HOME:-~/.cache}/fs_uae_image_enhancer_project_tpu_torch/
torch_kernels``. The hash covers the flags and the sources' names and bytes,
so a checkout and an install of the same tree name the same directory. The
build writes to temporary names and ``os.replace``-s the library into place,
so a build that is cut off leaves neither a half-written library nor a lock.
Any failure raises.

``load_library(csrc=..., defines=...)`` builds another source tree or the
same one with preprocessor settings (a tile sweep, or a parent commit's
kernels timed beside these), each into its own hashed directory.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
PACKAGE = "fs_uae_image_enhancer_project_tpu_torch"


def build_root(repo_root: str = REPO_ROOT) -> str:
    """Where the kernels build: the checkout's ``build/torch_kernels``, or
    the user's cache when ``repo_root`` is no checkout (an install, where
    it is ``site-packages`` or a ``--target`` directory)."""
    if os.path.isfile(os.path.join(repo_root, "pyproject.toml")):
        return os.path.join(repo_root, "build", "torch_kernels")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, PACKAGE, "torch_kernels")


BUILD_ROOT = build_root()
LIB_NAME = "libfse_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]
BUILD_TIMEOUT_S = 180

_lock = threading.Lock()
_libs: dict = {}
# how the default library was obtained in this process: build seconds and
# ptxas report (``infos`` has the same for every library loaded)
build_info: dict = {}
infos: dict = {}


def _sources(csrc: str = CSRC):
    return sorted(glob.glob(os.path.join(csrc, "*.cu")) + glob.glob(os.path.join(csrc, "*.cuh")))


def _flags(defines) -> list:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def library_path(csrc: str = CSRC, defines=()) -> str:
    """Where the library for the sources in ``csrc`` and these flags lives."""
    h = hashlib.sha256(" ".join(_flags(defines) + LINK_FLAGS).encode())
    for path in _sources(csrc):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], LIB_NAME)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                           "CUDA toolkit is installed")
    return nvcc


def _run(cmds, deadline: float) -> str:
    """Run the commands in parallel, each in its own process group (on
    timeout the compiler's children, cicc and ptxas, die too instead of
    holding the output pipes open past the limit). Returns their stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              start_new_session=True) for c in cmds]
    logs, failed = [], None
    try:
        for proc, cmd in zip(procs, cmds):
            try:
                _, stderr = proc.communicate(timeout=max(deadline - time.perf_counter(), 0.1))
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s") from e
            logs.append(stderr)
            if proc.returncode != 0 and failed is None:
                failed = f"nvcc failed ({proc.returncode}) on {cmd[-1]}:\n{stderr[-8000:]}"
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    if failed:
        raise RuntimeError(failed)
    return "".join(logs)


def build(out: str, csrc: str = CSRC, defines=()) -> dict:
    """Compile every ``.cu`` of ``csrc`` into ``out``: one nvcc per source, in
    parallel, then one link. Returns ``dict(seconds=..., built=True)``."""
    sources = [s for s in _sources(csrc) if s.endswith(".cu")]
    if not sources:
        raise FileNotFoundError(
            f"no CUDA kernel sources (*.cu) in {csrc}: the package was installed without "
            f"its kernel sources; install it from a wheel built with the package data "
            f"that pyproject.toml names, or run it from a checkout")
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [f"{out}.{os.path.basename(s)}.{tag}.o" for s in sources]
    tmp = f"{out}.{tag}"
    t0 = time.perf_counter()
    deadline = t0 + BUILD_TIMEOUT_S
    try:
        stderr = _run([[nvcc, *_flags(defines), "-c", "-o", o, s]
                       for s, o in zip(sources, objs)], deadline)
        _run([[nvcc, *LINK_FLAGS, "-o", tmp, *objs]], deadline)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    finally:
        for o in objs:
            if os.path.exists(o):
                os.unlink(o)
    seconds = time.perf_counter() - t0
    log_tmp = f"{out}.ptxas.{tag}"
    with open(log_tmp, "w") as f:
        f.write(stderr)
    os.replace(log_tmp, out + ".ptxas.log")
    os.replace(tmp, out)
    return dict(seconds=seconds, built=True)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("fse_fused_stack", "fse_fused_stack_packed"):
        getattr(lib, name).argtypes = [p] * 10 + [i, i, i, i, p]
        getattr(lib, name).restype = i
        getattr(lib, name + "_smem_bytes").argtypes = []
        getattr(lib, name + "_smem_bytes").restype = i
        if hasattr(lib, name + "_info"):  # not in a library built before the info entry
            getattr(lib, name + "_info").argtypes = [ctypes.POINTER(i), i]
            getattr(lib, name + "_info").restype = i
        if hasattr(lib, name + "_profile"):  # a build with -DFSE_PROFILE
            getattr(lib, name + "_profile").argtypes = [p]
            getattr(lib, name + "_profile").restype = i
    if hasattr(lib, "fse_fused_stack_u8"):  # not in a library built from an older tree
        lib.fse_fused_stack_u8.argtypes = [p] * 12 + [i] * 5 + [p]
        lib.fse_fused_stack_u8.restype = i
        lib.fse_fused_stack_u8_init.argtypes = [i]
        lib.fse_fused_stack_u8_init.restype = i
        lib.fse_fused_stack_u8_info.argtypes = [ctypes.POINTER(i), i]
        lib.fse_fused_stack_u8_info.restype = i
    lib.fse_lane_packing.argtypes = [p] * 4 + [i] * 11 + [p]
    lib.fse_lane_packing.restype = i
    lib.fse_palette_dither.argtypes = [p] * 4 + [i] * 6 + [ctypes.POINTER(i), i, p]
    lib.fse_palette_dither.restype = i
    # not in a library built from an older tree (a parent's fused-stack sweep)
    for name, args in (("fse_lane_packing_info", [ctypes.POINTER(i)] + [i] * 5),
                       ("fse_palette_dither_info", [ctypes.POINTER(i), i])):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i


def load_library(csrc: Optional[str] = None, defines=()) -> ctypes.CDLL:
    """The kernels' library, built on first use under ``BUILD_ROOT``: from this
    package's ``csrc`` by default or from the ``csrc`` given, with ``-D``
    for each of ``defines`` (strings such as ``"FSE_TILE_W=16"``)."""
    key = (os.path.abspath(csrc or CSRC), tuple(defines))
    with _lock:
        if key not in _libs:
            path = library_path(key[0], defines)
            info = (build(path, key[0], defines) if not os.path.exists(path)
                    else dict(seconds=0.0, built=False))
            lib = ctypes.CDLL(path)
            _declare(lib)
            log = path + ".ptxas.log"
            info.update(ptxas=open(log).read() if os.path.exists(log) else "", path=path)
            infos[key] = info
            if csrc is None and not defines:
                build_info.update(info)
            _libs[key] = lib
        return _libs[key]
