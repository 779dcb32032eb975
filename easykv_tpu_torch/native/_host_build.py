"""Builds the repository's framework-neutral host libraries (native/*.cc)
for the port's ctypes bindings.

A source is compiled at first use, by the host C++ compiler with
native/Makefile's flags, into easykv_tpu_torch/_build/, named by a hash of
the source and the flags (as ops/cuda/_build.py names the CUDA libraries).
Nothing is written into native/ and nothing is built at import. The build
goes to a temporary name that is then renamed, so processes that build at
once never load a half-written library. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

PKG = Path(__file__).resolve().parents[1]
NATIVE = PKG.parent / "native"
BUILD = PKG / "_build"
FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]   # native/Makefile's CXXFLAGS, -shared

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


def compiler() -> str:
    """The host C++ compiler: $CXX, else g++, else c++."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no host C++ compiler found: set CXX or put g++ on PATH")


def library_path(source: Path) -> Path:
    key = hashlib.sha256(source.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"lib{source.stem}-{key}.so"


def build(source: Path) -> Path:
    """Compile `source` unless its library exists; returns the library's
    path. Raises RuntimeError with the compiler's output if the build
    fails."""
    lib = library_path(source)
    if lib.exists():
        return lib
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler(), *FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{source.name} build failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source: Path, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The library of `source` (built first if need be), once a process,
    with each C function's (argtypes, restype) declared from `signatures`."""
    with _lock:
        if source not in _libs:
            lib = ctypes.CDLL(str(build(source)))
            for name, (argtypes, restype) in signatures.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = restype
            _libs[source] = lib
        return _libs[source]
