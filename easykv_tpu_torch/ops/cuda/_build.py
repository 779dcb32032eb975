"""Builds the CUDA sources under easykv_tpu_torch/csrc/ at first use.

Each source compiles alone, by one `nvcc` process per file, all started
together, into a shared library with a plain C interface that the kernel
wrappers load with ctypes. Libraries land in easykv_tpu_torch/_build/,
named by a hash of the source, the headers in csrc/ and the flags: an
edited source or header rebuilds, an unchanged one is loaded as it is. Nothing here runs at import.

Every C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns cudaGetLastError() as an int.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

SOURCES = ("decode_attention", "sidecar_update", "row_write", "chunk_attention",
           "kv_compact", "quant_matmul", "w4_matmul", "w4_stream", "w4_gemm",
           "fused_decode", "fused_decode_batch", "quant_gemv")
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The sidecar pass and the K/V compaction must round like their plain
# PyTorch versions, op by op: an FMA contraction of roco's `ssq/c - mean*mean`
# moves the k-th smallest std, one of the rotation's `x1*c + x2*s` moves an
# int8 requant. The one-kernel decode steps' elementwise steps (K14's int8
# activation planes, K15's rounded feed) follow their plain versions the same way.
EXTRA_FLAGS = {"sidecar_update": ["--fmad=false"], "kv_compact": ["--fmad=false"],
               "fused_decode": ["--fmad=false"], "fused_decode_batch": ["--fmad=false"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(cand)


def _flags(name: str):
    return FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))  # included headers
    key = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{key}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, in parallel.
    Returns {name: compiler output (ptxas register report)}; raises
    RuntimeError naming each source that failed to compile."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str, signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """The loaded library of one source, built first if it is missing, with
    each C function's (argtypes, restype) declared from `signatures`."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def load_debug(name: str, define, signatures: Dict[str, Tuple[list, object]]) -> ctypes.CDLL:
    """A debug build of one source: compiled anew with -D for `define` (one
    name, or several: the source's own instrumentation, such as STEP_STAMPS
    or STEP_DUMP, and its diagnostic switches) into
    BUILD/lib<name>_<defines>.so and loaded with `signatures` declared. The
    wrappers go on loading the normal build unless the caller puts this
    one in _libs[name]."""
    BUILD.mkdir(parents=True, exist_ok=True)
    defines = (define,) if isinstance(define, str) else tuple(define)
    lib = BUILD / f"lib{name}_{'_'.join(d.lower() for d in defines)}.so"
    out = subprocess.run([nvcc_path(), *_flags(name), *(f"-D{d}" for d in defines), "-o",
                          str(lib), str(CSRC / f"{name}.cu")], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"CUDA build of {name}.cu with -D{' -D'.join(defines)} failed:\n"
                           f"{out.stdout}{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in signatures.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = restype
    return dll


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def stream_of(t) -> int:
    """Handle of PyTorch's current stream on t's device (the raw handle:
    `torch.cuda.current_stream` builds a Stream object, ~11 µs of host time
    a call on an H100 host against 0.4, tools/torch_quant_host.py)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
