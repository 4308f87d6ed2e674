"""Builds and loads the port's CUDA kernels at first use.

Every source under ``ops/csrc/`` has a plain C interface and includes no
PyTorch header. ``nvcc`` compiles each one for ``sm_90a`` into an object
file, all of them at once, and links the objects into one shared library in
``ops/_build/``, named by the hash of the sources and flags; ``ctypes``
loads it. A cold build takes seconds, a warm one nothing. The compiler's
register and shared-memory report (``-Xptxas -v``) is kept beside the
library as ``build_<hash>.log``.

Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

__all__ = ["load_library", "build_library", "build_log_path", "check"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = sorted(glob.glob(os.path.join(_DIR, "csrc", "*.cu")))
_BUILD_DIR = os.path.join(_DIR, "_build")
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"
_FLAGS = [ARCH_FLAG, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# every C function of the library: (argtypes, restype)
_SIGNATURES = {
    "dpt_flash_decode": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "dpt_flash_fwd": ([_P] * 6 + [_I] * 6 + [_P], _I),
    "dpt_flash_bwd": ([_P] * 12 + [_I] * 6 + [_P], _I),
    "dpt_flash_smem_bytes": ([_I] * 2, _I),
    "dpt_fused_update": ([_P] * 6 + [ctypes.c_longlong, _P, _I, _P], _I),
    "dpt_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(root, "bin", "nvcc") if root else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA kernels "
                           "are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_log_path() -> str:
    """Where the compiler's output for the current sources is kept."""
    return os.path.join(_BUILD_DIR, f"build_{_digest()}.log")


def build_library() -> str:
    """Compile the kernels if they are not built for the current sources,
    and return the library's path. One ``nvcc -c`` per source, all started
    together, then one link."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    path = os.path.join(_BUILD_DIR, f"libdpt_kernels_{_digest()}.so")
    if os.path.exists(path):
        return path
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        procs = []
        for src in _SOURCES:
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *_FLAGS, "-c", "-o", obj, src], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {os.path.basename(src)} (rc {proc.returncode})\n"
                       f"{out}")
            if proc.returncode != 0:
                failed.append(os.path.basename(src))
        lib_tmp = os.path.join(tmp, "lib.so")
        if not failed:
            link = subprocess.run(
                [nvcc, ARCH_FLAG, "-shared", "-o", lib_tmp,
                 *[obj for _src, obj, _p in procs]],
                capture_output=True, text=True)
            log.append(f"== link (rc {link.returncode})\n{link.stdout}"
                       f"{link.stderr}")
            if link.returncode != 0:
                failed.append("link")
        with open(build_log_path(), "w") as f:
            f.write("\n".join(log))
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(log))
        os.replace(lib_tmp, path)  # atomic: concurrent builds race benignly
    return path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, with every C
    function's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch was refused (its C function returned a
    ``cudaError_t`` other than 0)."""
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.dpt_error_string(err).decode()}")
