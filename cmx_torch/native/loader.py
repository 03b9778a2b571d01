"""ctypes bindings for the C++ corpus loader, with on-demand build + fallback
(a copy of cmx/native/loader.py).

`load_corpus_native(paths, size, mode)` decodes and resizes a whole corpus in
a C++ thread pool (cmx_torch/native/npy_loader.cpp). The library is built
at first use by g++ into cmx_torch/_build/ (listed in .gitignore), under a
name that carries a hash of the source, the flags and the host (the build
is -march=native, so a copy of the tree on another machine rebuilds).
Where cmx falls back to the Python/PIL path (cmx.data.corpus) -- no
toolchain, a failed build or load, a file the parser refuses -- this
returns None and the caller falls back to cmx_torch.data.corpus.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).resolve().parent / "npy_loader.cpp"
_BUILD_DIR = _SRC.parent.parent / "_build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-pthread"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> Path:
    host = f"{platform.node()} {platform.machine()}"
    h = hashlib.sha256(" ".join(_FLAGS + [host]).encode() + _SRC.read_bytes())
    return _BUILD_DIR / f"npy_loader-{h.hexdigest()[:12]}.so"


def _build(path: Path) -> bool:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    os.replace(tmp, path)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = _lib_path()
        if not path.exists() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.cmx_load_corpus.restype = ctypes.c_int
        lib.cmx_load_corpus.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def load_corpus_native(
    paths: Sequence[str], size: int = 256, mode: str = "bicubic",
    n_threads: int = 0,
) -> Optional[np.ndarray]:
    """(N, size, size) float32, or None if the native path is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size), dtype=np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.cmx_load_corpus(
        c_paths, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_threads, 0 if mode == "bicubic" else 1,
    )
    if rc != 0:
        return None
    return out
