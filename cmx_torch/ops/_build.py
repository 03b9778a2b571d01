"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` for Hopper (`sm_90a`) into a shared
library with a plain C interface, loaded with ctypes (no PyTorch headers, so a
build takes seconds). The build runs at first use, all sources at once (one
`nvcc` process each), into `cmx_torch/_build/` (listed in .gitignore); a
library's file name carries a hash of its sources, so an edited source is
rebuilt and an unchanged one is reused within a checkout.

A launch wrapper calls a C entry point with raw pointers and the current
stream; the entry returns the `cudaGetLastError()` of its launches and
`check()` raises on anything but 0.

While `recorded` is a list, every kernel wrapper (CUDA, Triton or its CPU
path) appends `(wrapper name, copies of its arguments)` of each call to it:
chip_smoke.py records one train step this way and replays the calls to hold
each kernel against its plain version at exactly the step's operands.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# C entry points and their argument types (p = pointer, i = int).
_SIGNATURES = {
    "flat_conv_fwd": {"cmx_flat_conv_fwd": "pppppppp" + "iiiiii" + "p"},
    "flat_conv_bwd": {"cmx_flat_bwd": "ppppppppppp" + "iiiiiiiii" + "p"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas registers/spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cmx_torch: nvcc not found; the CUDA kernels build "
                       "only on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in _SIGNATURES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        procs = {}
        for name, out in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("cmx_torch: nvcc failed\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        for fn, sig in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = [_CTYPES[c] for c in sig]
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"cmx_torch: {what} launch failed with CUDA error "
                           f"{err}")


recorded: Optional[List[Tuple[str, tuple]]] = None


def _copy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    if isinstance(a, tuple):
        return tuple(_copy(v) for v in a)
    return a


def record(name: str, *args) -> None:
    """Append `(name, args)` to `recorded` when recording is on."""
    if recorded is not None:
        recorded.append((name, _copy(args)))
