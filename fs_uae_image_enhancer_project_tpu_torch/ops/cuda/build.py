"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The ``.cu`` sources under ``csrc/`` have a plain C interface and include no
PyTorch header, so one ``nvcc`` call builds them in seconds. The library goes
to ``build/torch_kernels/<content-hash>/libfse_kernels.so`` under the repo
root, built at first use. The build writes to a temporary name and
``os.replace``-s it into place, so a build that is cut off leaves neither a
half-written library nor a lock. Any failure raises.
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
BUILD_ROOT = os.path.join(REPO_ROOT, "build", "torch_kernels")
LIB_NAME = "libfse_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
BUILD_TIMEOUT_S = 180

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# how the library was obtained in this process: build seconds and ptxas report
build_info: dict = {}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def library_path() -> str:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
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


def build(out: str) -> None:
    """Compile every ``csrc/*.cu`` into ``out`` (one nvcc call)."""
    nvcc = _nvcc()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    # own process group: on timeout the compiler's children (cicc, ptxas) die
    # too, instead of holding the output pipes open past the limit
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        _, stderr = proc.communicate(timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s") from e
    finally:
        if os.path.exists(tmp) and proc.returncode != 0:
            os.unlink(tmp)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{stderr[-8000:]}")
    log_tmp = f"{out}.ptxas.tmp{os.getpid()}"
    with open(log_tmp, "w") as f:
        f.write(stderr)
    os.replace(log_tmp, out + ".ptxas.log")
    os.replace(tmp, out)
    build_info.update(seconds=seconds, built=True)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fse_fused_stack.argtypes = [p] * 10 + [i, i, i, p]
    lib.fse_fused_stack.restype = i
    lib.fse_fused_stack_smem_bytes.argtypes = []
    lib.fse_fused_stack_smem_bytes.restype = i
    lib.fse_palette_dither.argtypes = [p] * 4 + [i] * 6 + [ctypes.POINTER(i), i, p]
    lib.fse_palette_dither.restype = i


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use in this checkout."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.exists(path):
                build(path)
            else:
                build_info.update(seconds=0.0, built=False)
            lib = ctypes.CDLL(path)
            _declare(lib)
            log = path + ".ptxas.log"
            build_info["ptxas"] = open(log).read() if os.path.exists(log) else ""
            build_info["path"] = path
            _lib = lib
        return _lib
