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
import re
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
    "crop_resize": {"cmx_crop_resize": "pppppp" + "iiiii" + "p"},
    "nhwc_conv_fwd": {"cmx_nhwc_conv_fwd": "pppppppp" + "iiiiii" + "p",
                      "cmx_nhwc_stem": "pppppp" + "iii" + "p",
                      "cmx_nhwc_mma_geometry": "p"},
    "nhwc_conv_bwd": {"cmx_nhwc_bwd": "ppppppppppp" + "iiiiiiii" + "p",
                      "cmx_nhwc_dw_blocks_per_sm": "i",
                      "cmx_nhwc_mma_geometry": "p"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas registers/spills)


def _cuda_tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    cand = Path("/usr/local/cuda/bin") / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"cmx_torch: {name} not found; the CUDA kernels build "
                       "only on a machine with the CUDA toolkit")


def _nvcc() -> str:
    return _cuda_tool("nvcc")


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
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("cmx_torch: nvcc failed\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers and spills) for library `name`, from
    this process's build or the one that made the library on disk."""
    if name not in build_logs:
        log = build_all()[name].with_suffix(".log")
        build_logs[name] = log.read_text() if log.exists() else ""
    return build_logs[name]


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


def kernel_label(mangled: str) -> str:
    """`cmx::name<true,false>` for an Itanium-mangled kernel of namespace
    cmx with bool template arguments (the port's kernels); else the name
    with the per-build hash of an anonymous namespace dropped, so that two
    builds of one source give the same labels."""
    m = re.match(r"_ZN3cmx(\d+)", mangled)
    if not m:
        return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", mangled)
    end = m.end() + int(m.group(1))
    label = "cmx::" + mangled[m.end():end]
    targs = re.match(r"I((?:Lb[01]E)+)E", mangled[end:])
    if targs:
        bools = re.findall(r"Lb([01])E", targs.group(1))
        label += "<" + ",".join("true" if b == "1" else "false"
                                for b in bools) + ">"
    return label


def ptxas_usage(log: str) -> Dict[str, Tuple[int, int, int]]:
    """kernel label -> (registers, spill store bytes, spill load bytes) from
    nvcc's `-Xptxas -v` output."""
    usage: Dict[str, List[int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_label(m.group(1))
            usage[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


def sass_by_kernel(sass: str) -> Dict[str, List[str]]:
    """kernel label -> its instructions (predicate, mnemonic, operands;
    no address or encoding) in `cuobjdump --dump-sass` output."""
    kernels: Dict[str, List[str]] = {}
    name = None
    pat = re.compile(r"^\s*/\*[0-9a-f]+\*/\s+(.*?)\s*;")
    for line in sass.splitlines():
        m = re.search(r"Function\s*:\s*(\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            kernels[name] = []
            continue
        m = pat.match(line)
        if name is not None and m:
            kernels[name].append(m.group(1))
    return kernels


def sass_counts(sass: str, ops=("HMMA", "HGMMA")) -> Dict[str, Dict[str, int]]:
    """kernel label -> {op: count} of the tensor-core instructions in
    `cuobjdump --dump-sass` output (an op counts where an instruction's
    mnemonic starts with it and a dot or a space follows)."""
    mnemonic = re.compile(r"^(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")
    counts: Dict[str, Dict[str, int]] = {}
    for name, instrs in sass_by_kernel(sass).items():
        counts[name] = {op: 0 for op in ops}
        for ins in instrs:
            m = mnemonic.match(ins)
            if m and m.group(1) in ops:
                counts[name][m.group(1)] += 1
    return counts


def sass_digests(sass: str) -> Dict[str, str]:
    """kernel label -> a short hash of its instructions: equal digests mean
    the same machine code, whatever else the library holds."""
    return {name: hashlib.sha256("\n".join(instrs).encode()).hexdigest()[:16]
            for name, instrs in sass_by_kernel(sass).items()}


def dump_sass(name: str) -> str:
    """`cuobjdump --dump-sass` of the built library `name`."""
    path = build_all()[name]
    return subprocess.run([_cuda_tool("cuobjdump"), "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
