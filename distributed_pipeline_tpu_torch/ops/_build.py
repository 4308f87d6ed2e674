"""Builds and loads the port's CUDA kernels at first use.

The sources under ``ops/csrc/`` have a plain C interface and include no
PyTorch header, so a cold build takes seconds. They compile for ``sm_90a``
into one shared library in ``ops/_build/`` that ``ctypes`` loads:

* with ``ninja`` installed, through ``torch.utils.cpp_extension.load``
  (``is_python_module=False``), which caches by content and rebuilds when a
  source changes;
* without it, through ``nvcc`` directly, into a library named by the hash
  of its sources and flags.

Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

__all__ = ["load_library", "build_library"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = [os.path.join(_DIR, "csrc", "flash_decode.cu")]
_BUILD_DIR = os.path.join(_DIR, "_build")
ARCH_FLAG = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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


def _build_with_nvcc() -> str:
    flags = [ARCH_FLAG, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC"]
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _SOURCES:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(_BUILD_DIR, f"libdpt_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, *_SOURCES],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: concurrent builds race benignly
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def build_library() -> str:
    """Compile the kernels if they are not built for the current sources,
    and return the library's path."""
    os.makedirs(_BUILD_DIR, exist_ok=True)  # load() does not create it
    from torch.utils import cpp_extension
    if not cpp_extension.is_ninja_available():
        return _build_with_nvcc()
    return cpp_extension.load(
        name="dpt_kernels", sources=_SOURCES, build_directory=_BUILD_DIR,
        extra_cuda_cflags=["-O3", ARCH_FLAG], is_python_module=False,
        verbose=False)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call, with every C
    function's signature declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            lib.dpt_flash_decode.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                + [ctypes.c_void_p])
            lib.dpt_flash_decode.restype = ctypes.c_int
            lib.dpt_error_string.argtypes = [ctypes.c_int]
            lib.dpt_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
