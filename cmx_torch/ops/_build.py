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

    python -m cmx_torch.ops._build OTHER_CSRC OUT_DIR

builds every `*.cu` of another checkout's `cmx_torch/csrc` with this file's
flags into OUT_DIR and prints, as JSON, each library's SASS digests and
those of this checkout's build (equal digests, equal machine code).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time
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
    "flat_conv_fwd": {"cmx_flat_conv_fwd": "pppppppp" + "iiiiii" + "p",
                      "cmx_mma_geometry": "p"},
    "flat_conv_bwd": {"cmx_flat_bwd": "ppppppppppp" + "iiiiiiiii" + "p",
                      "cmx_dw_blocks_per_sm": "i",
                      "cmx_mma_geometry": "p"},
    "crop_resize": {"cmx_crop_resize": "ppp" + "iiiii" + "p"},
    "spark_loss": {"cmx_spark_loss_fwd": "pppppppp" + "iiiii" + "p",
                   "cmx_spark_loss_bwd": "pppppp" + "iiiii" + "p"},
    "nhwc_conv_fwd": {"cmx_nhwc_conv_fwd": "pppppppp" + "iiiiii" + "p",
                      "cmx_nhwc_stem": "pppppp" + "iii" + "p",
                      "cmx_stem_blocks_per_sm": "", "cmx_stem_run": "",
                      "cmx_mma_geometry": "p"},
    "nhwc_conv_bwd": {"cmx_nhwc_bwd": "ppppppppppp" + "iiiiiiii" + "p",
                      "cmx_dw_blocks_per_sm": "i",
                      "cmx_mma_geometry": "p"},
    "span_marks": {"cmx_span_count": "", "cmx_span_mark": "ii" + "p"},
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int}

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # nvcc's output (ptxas registers/spills)
# Seconds this process has spent in `load` building and loading libraries,
# cumulative (StepGraph.report's kernel_load_s is its change over a step).
load_seconds = 0.0


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


def _nvcc_all(csrc: Path, outs: Dict[str, Path]) -> Dict[str, str]:
    """Compile `csrc/<name>.cu` into outs[name] for every name, one nvcc
    process each, all at once; name -> nvcc's output. Raises, after every
    process has ended, if one failed."""
    nvcc = _nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
         str(csrc / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, out in outs.items()}
    logs = {name: proc.communicate()[0] for name, proc in procs.items()}
    failed = [f"{name}:\n{logs[name]}" for name, proc in procs.items()
              if proc.returncode != 0]
    if failed:
        raise RuntimeError("cmx_torch: nvcc failed\n" + "\n".join(failed))
    return logs


def build_all() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, in parallel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: _lib_path(name) for name in _SIGNATURES}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        tmps = {n: p.with_suffix(f".{os.getpid()}.tmp") for n, p in todo.items()}
        for name, log in _nvcc_all(CSRC, tmps).items():
            build_logs[name] = log
            todo[name].with_suffix(".log").write_text(log)
            os.replace(tmps[name], todo[name])
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
    global load_seconds
    lib = _libs.get(name)
    if lib is None:
        t0 = time.perf_counter()
        try:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for fn, sig in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = [_CTYPES[c] for c in sig]
                f.restype = ctypes.c_int
            _libs[name] = lib
        finally:
            load_seconds += time.perf_counter() - t0
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


def _template_args(s: str) -> Optional[List[str]]:
    """The arguments of an Itanium template-argument list `I...E` at the
    start of s that holds bools, float or named types; else None."""
    if not s.startswith("I"):
        return None
    args, i = [], 1
    while i < len(s) and s[i] != "E":
        m = re.match(r"Lb([01])E|(f)|(\d+)", s[i:])
        if not m:
            return None
        i += m.end()
        if m.group(1):
            args.append("true" if m.group(1) == "1" else "false")
        elif m.group(2):
            args.append("float")
        else:
            n = int(m.group(3))
            args.append(s[i:i + n])
            i += n
    return args if i < len(s) else None


def kernel_label(mangled: str) -> str:
    """`cmx::name<true,false>` for an Itanium-mangled kernel of namespace
    cmx whose template arguments are bools, float or named types (the
    port's kernels, e.g. `cmx::spark_loss_fwd_kernel<__nv_bfloat16,float>`);
    else the name with the per-build hash of an anonymous namespace dropped,
    so that two builds of one source give the same labels."""
    m = re.match(r"_ZN3cmx(\d+)", mangled)
    if not m:
        return re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", mangled)
    end = m.end() + int(m.group(1))
    label = "cmx::" + mangled[m.end():end]
    targs = _template_args(mangled[end:])
    if targs:
        label += "<" + ",".join(targs) + ">"
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


def _sass_of(path: Path) -> str:
    return subprocess.run([_cuda_tool("cuobjdump"), "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout


def dump_sass(name: str) -> str:
    """`cuobjdump --dump-sass` of the built library `name`."""
    return _sass_of(build_all()[name])


def digests_of_sources(csrc: Path, out: Path) -> Dict[str, Dict[str, str]]:
    """library -> kernel label -> SASS digest of every `*.cu` under `csrc`,
    each built with NVCC_FLAGS into `out` (in parallel)."""
    out.mkdir(parents=True, exist_ok=True)
    libs = {f.stem: out / f"{f.stem}.so" for f in sorted(csrc.glob("*.cu"))}
    _nvcc_all(csrc, libs)
    return {name: sass_digests(_sass_of(lib)) for name, lib in libs.items()}


if __name__ == "__main__":
    import json

    other = digests_of_sources(Path(sys.argv[1]), Path(sys.argv[2]))
    this = {name: sass_digests(dump_sass(name)) for name in build_all()}
    print(json.dumps({"other": other, "this": this}))
