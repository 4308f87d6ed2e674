"""Native (C++) host-side data components, read through ``ctypes``: a copy
of the JAX package's ``native`` binding (the port imports nothing of that
package, so it carries and builds its own copy of the sources).

* ``bpe_encoder.cpp`` - the BPE merge loop behind the exact contract of
  ``data/tokenizer.py:BPEVocab``;
* ``jsonl_index.cpp`` - mmap'd random access over jsonl corpora (an offset
  table instead of every line in Python memory; pages shared across loader
  processes by the page cache).

The library is built at first use with the host's C++ compiler (``$CXX``,
else ``g++``, else ``clang++``; a plain C ABI, no pybind11) into
``native/_build/``, named by the hash of its sources and flags, so a
library never outlives the sources it was built from. ``DPT_NATIVE=0``
opts out. With no compiler, or a build that fails, the Python paths serve
the same ids and lines, after one warning.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import threading
import warnings
from typing import Dict, List, Optional

__all__ = ["load_library", "build_library", "NativeBPE", "NativeJsonlIndex",
           "native_enabled"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_DIR, "bpe_encoder.cpp"),
         os.path.join(_DIR, "jsonl_index.cpp")]
_BUILD_DIR = os.path.join(_DIR, "_build")
_FLAGS = ["-O2", "-std=c++17", "-Wall", "-Wextra", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U8P = ctypes.POINTER(ctypes.c_uint8)
# every C function of the library: (argtypes, restype)
_SIGNATURES = {
    "dpt_bpe_create": ([ctypes.c_char_p, ctypes.c_uint64], _P),
    "dpt_bpe_destroy": ([_P], None),
    "dpt_bpe_encode": ([_P, ctypes.c_char_p, ctypes.c_uint64,
                        ctypes.POINTER(ctypes.c_int32), _I64], _I64),
    "dpt_bpe_oov_count": ([_P], _I64),
    "dpt_bpe_oov_get": ([_P, _I64, _U8P, _I64], _I64),
    "dpt_jsonl_open": ([ctypes.c_char_p], _P),
    "dpt_jsonl_count": ([_P], _I64),
    "dpt_jsonl_get": ([_P, _I64, _U8P, _I64], _I64),
    "dpt_jsonl_close": ([_P], None),
}


def native_enabled() -> bool:
    """False when the user opted out with ``DPT_NATIVE=0``."""
    return os.environ.get("DPT_NATIVE", "1") not in ("0", "false", "False")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SRCS:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library() -> str:
    """Compile the library if it is not built for the current sources, and
    return its path; raises ``RuntimeError`` when no compiler builds it.
    The compile lands in a temporary file that is renamed into place, so
    concurrent processes race benignly."""
    path = os.path.join(_BUILD_DIR, f"libdpt_native_{_digest()}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    env_cxx = os.environ.get("CXX")
    errors = []
    for cxx in [env_cxx] if env_cxx else ["g++", "clang++"]:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, *_SRCS],
                                  capture_output=True, text=True,
                                  timeout=120)
            if proc.returncode == 0:
                os.replace(tmp, path)
                return path
            errors.append(f"{cxx}: rc {proc.returncode}: {proc.stderr}")
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cxx}: {e!r}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise RuntimeError("no C++ compiler built the native library:\n"
                       + "\n".join(errors))


def load_library() -> Optional[ctypes.CDLL]:
    """The process-wide handle to the native library, built on first use;
    None when native code is disabled or cannot be built or loaded (the
    callers then take their Python paths; the failure warns once)."""
    global _lib, _lib_failed
    if not native_enabled():
        return None
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(build_library())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
        except (RuntimeError, OSError, AttributeError) as e:
            _lib_failed = True
            warnings.warn(f"distributed_pipeline_tpu_torch.native: the "
                          f"library is unavailable ({e}); tokenizing and "
                          f"indexing in pure Python")
            return None
        _lib = lib
        return _lib


def _pack_tables(merges: List[List[str]], vocab: Dict[str, int]) -> bytes:
    """Serialize the BPE artifact into the C++ wire format (see
    bpe_encoder.cpp's header): length-prefixed UTF-8 strings, no JSON
    parsing on the native side."""
    parts = [struct.pack("<II", 0x45504254, 1), struct.pack("<I", len(merges))]
    for a, b in merges:
        ab, bb = a.encode(), b.encode()
        parts.append(struct.pack("<I", len(ab)) + ab)
        parts.append(struct.pack("<I", len(bb)) + bb)
    parts.append(struct.pack("<I", len(vocab)))
    for s, i in vocab.items():
        sb = s.encode()
        parts.append(struct.pack("<I", len(sb)) + sb + struct.pack("<i", i))
    return b"".join(parts)


class NativeBPE:
    """ctypes wrapper around one C++ encoder instance.

    ``encode_words`` takes the words of one text (the caller keeps Python's
    ``str.split()`` Unicode-whitespace semantics) and returns ids identical
    to ``BPEVocab.encode``'s Python path: vocab hits come from C++,
    out-of-alphabet symbols come back as sentinels and are resolved here
    with the same blake2s stable hash."""

    def __init__(self, merges: List[List[str]], vocab: Dict[str, int],
                 vocab_size: int, n_reserved: int):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native BPE library unavailable")
        blob = _pack_tables(merges, vocab)
        handle = lib.dpt_bpe_create(blob, len(blob))
        if not handle:
            raise RuntimeError("native BPE rejected the vocab tables")
        # imported here: data.tokenizer imports this package
        from ..data.tokenizer import stable_hash_id
        self._hash = stable_hash_id
        self._lib = lib
        self._handle = handle
        self._vocab_size = vocab_size
        self._n_reserved = n_reserved
        self._buf_cap = 4096
        self._buf = (ctypes.c_int32 * self._buf_cap)()
        self._lock = threading.Lock()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.dpt_bpe_destroy(handle)
            self._handle = None

    def _resolve_oov(self, k: int) -> int:
        cap = 64
        while True:
            raw = (ctypes.c_uint8 * cap)()
            n = self._lib.dpt_bpe_oov_get(self._handle, k, raw, cap)
            if n < 0:
                raise RuntimeError(f"native BPE: bad OOV index {k}")
            if n <= cap:
                break
            cap = int(n)
        symbol = bytes(raw[:n]).decode()
        return self._hash(symbol, self._vocab_size, self._n_reserved)

    def encode_words(self, words: List[str]) -> List[int]:
        if not words:
            return []
        text = "\n".join(words).encode()
        with self._lock:
            n = self._lib.dpt_bpe_encode(self._handle, text, len(text),
                                         self._buf, self._buf_cap)
            if n > self._buf_cap:
                self._buf_cap = int(n)
                self._buf = (ctypes.c_int32 * self._buf_cap)()
                n = self._lib.dpt_bpe_encode(self._handle, text, len(text),
                                             self._buf, self._buf_cap)
            # OOV sentinels must be resolved before the NEXT encode on this
            # handle (which may flush the C++ memo and OOV tables when the
            # bounded word cache overflows), so under the lock
            return [i if i >= 0 else self._resolve_oov(-i - 1)
                    for i in self._buf[:n]]


class NativeJsonlIndex:
    """mmap'd random access over a jsonl corpus (jsonl_index.cpp).

    The offset table is the only per-process memory (16 bytes a line); the
    file's pages stream in on demand and are shared across loader
    processes by the page cache. ``line(i)`` returns the decoded non-blank
    line i, blank meaning whitespace-only, the contract of the Python path
    in ``data/dataset.py``."""

    def __init__(self, path: str):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        handle = lib.dpt_jsonl_open(os.fspath(path).encode())
        if not handle:
            raise RuntimeError(f"native jsonl index failed to open {path!r}")
        self._lib = lib
        self._handle = handle
        self._len = int(lib.dpt_jsonl_count(handle))
        # one growable buffer, guarded by a lock: loader threads share the
        # dataset
        self._buf_cap = 4096
        self._buf = (ctypes.c_uint8 * self._buf_cap)()
        self._buf_lock = threading.Lock()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.dpt_jsonl_close(handle)
            self._handle = None

    def __len__(self) -> int:
        return self._len

    def line(self, i: int) -> str:
        with self._buf_lock:
            n = self._lib.dpt_jsonl_get(self._handle, i, self._buf,
                                        self._buf_cap)
            if n < 0:
                raise IndexError(i)
            if n > self._buf_cap:
                self._buf_cap = int(n)
                self._buf = (ctypes.c_uint8 * self._buf_cap)()
                n = self._lib.dpt_jsonl_get(self._handle, i, self._buf,
                                            self._buf_cap)
            return bytes(self._buf[:n]).decode()
