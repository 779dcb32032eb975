"""ctypes binding of the repository's mmap safetensors reader,
native/safetensors_mmap.cc (counterpart of easykv_tpu/native/loader.py:
SafetensorsFile, load_safetensors_dir), and a small safetensors writer.

Tensors are zero-copy torch views of the file mapping: no JSON is parsed in
Python and nothing is copied, so `.to("cuda")` reads the pages straight from
the OS page cache. BF16 maps to torch.bfloat16; no other package (the
`safetensors` library, ml_dtypes) is needed. The library is compiled at first
use into easykv_tpu_torch/_build/ (native/_host_build.py).

Lifetime: the mapping belongs to an internal owner that every view's buffer
holds, so it is unmapped only when the SafetensorsFile is closed (or
collected) AND no view, nor any view derived from one, is alive. A view
outlives its file. The mapping is read-only: no in-place op may touch a
view (copy it first). A tensor whose offset in the file is not a multiple of
its element size (e.g. an F32 after an odd-length I8) is the one case that
is copied, into aligned memory.
"""
from __future__ import annotations

import ctypes
import json
import math
import os
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import torch

from . import _host_build

SOURCE = _host_build.NATIVE / "safetensors_mmap.cc"

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
NAMES = {v: k for k, v in DTYPES.items()}

_i64, _ptr, _str = ctypes.c_int64, ctypes.c_void_p, ctypes.c_char_p
SIGNATURES = {  # name: (argtypes, restype), as native/safetensors_mmap.cc declares them
    "st_open": ([_str], _ptr),
    "st_error": ([_ptr], _str),
    "st_num_tensors": ([_ptr], _i64),
    "st_tensor_name": ([_ptr, _i64], _str),
    "st_tensor_info": ([_ptr, _str, _str, ctypes.POINTER(_i64), ctypes.POINTER(_i64)],
                       ctypes.c_int),
    "st_tensor_data": ([_ptr, _str], _ptr),
    "st_close": ([_ptr], None),
}


class _Mapping:
    """Owns one st_open handle; st_close (munmap) runs when the last
    reference, the file's or a view buffer's, is gone."""

    def __init__(self, lib: ctypes.CDLL, h: int):
        self.lib, self.h = lib, h

    def __del__(self):
        try:
            self.lib.st_close(self.h)
        except Exception:   # at interpreter exit the library may be gone first
            pass


class SafetensorsFile:
    """Zero-copy reader for one .safetensors file."""

    def __init__(self, path: str):
        lib = _host_build.load(SOURCE, SIGNATURES)
        h = lib.st_open(os.fspath(path).encode())
        err = lib.st_error(h)
        if err:
            lib.st_close(h)
            raise OSError(f"{path}: {err.decode()}")
        self._lib = lib
        self._m: Optional[_Mapping] = _Mapping(lib, h)

    def close(self) -> None:
        """Drops the file's hold on the mapping; views already taken keep it
        mapped until they are gone."""
        self._m = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _handle(self) -> int:
        if self._m is None:
            raise ValueError("SafetensorsFile is closed")
        return self._m.h

    def keys(self) -> Iterator[str]:
        h = self._handle()
        for i in range(self._lib.st_num_tensors(h)):
            yield self._lib.st_tensor_name(h, i).decode()

    def tensor(self, name: str) -> torch.Tensor:
        """A read-only, zero-copy view of tensor `name` (KeyError if the file
        has none); it keeps the mapping alive."""
        h = self._handle()
        dtype_buf = ctypes.create_string_buffer(16)
        shape = (_i64 * 8)()
        nbytes = _i64()
        ndim = self._lib.st_tensor_info(h, name.encode(), dtype_buf, shape, ctypes.byref(nbytes))
        if ndim < 0:
            raise KeyError(name)
        st_dtype = dtype_buf.value.decode()
        if st_dtype not in DTYPES:
            raise ValueError(f"unsupported safetensors dtype {st_dtype!r}")
        dt = DTYPES[st_dtype]
        shp = tuple(shape[i] for i in range(ndim))
        size = dt.itemsize * math.prod(shp)
        if nbytes.value != size:
            raise OSError(f"tensor {name!r}: {nbytes.value} bytes for {st_dtype} {list(shp)}")
        if size == 0:
            return torch.empty(shp, dtype=dt)
        ptr = self._lib.st_tensor_data(h, name.encode())
        buf = (ctypes.c_char * size).from_address(ptr)
        buf._st_owner = self._m   # torch.frombuffer holds buf, buf holds the mapping
        raw = torch.frombuffer(buf, dtype=torch.uint8)
        if ptr % dt.itemsize:
            raw = raw.clone()     # misaligned for its dtype: an aligned copy
        return raw.view(dt).reshape(shp)

    def items(self) -> Iterator[Tuple[str, torch.Tensor]]:
        for k in self.keys():
            yield k, self.tensor(k)


def load_safetensors_dir(path: str) -> Tuple[Dict[str, torch.Tensor], List[SafetensorsFile]]:
    """Every tensor of every *.safetensors under `path` (sorted by file
    name), as zero-copy views; and the open files. The views keep their
    mappings alive on their own. FileNotFoundError if there is none."""
    files: List[SafetensorsFile] = []
    tensors: Dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".safetensors"):
            continue
        f = SafetensorsFile(os.path.join(path, fname))
        files.append(f)
        for k in f.keys():
            tensors[k] = f.tensor(k)
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    return tensors, files


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Mapping[str, str]] = None) -> int:
    """Writes `tensors` (on any device) to one .safetensors file, largest
    alignment first and then by name, as the safetensors library orders
    them, so that every tensor starts at a multiple of its element size.
    Returns the bytes written."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for k in order:
        t = tensors[k]
        if t.dtype not in NAMES:
            raise ValueError(f"{k}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for k in order:
            t = tensors[k].detach().to("cpu").contiguous().reshape(-1)
            if t.numel():
                f.write(memoryview(t.view(torch.uint8).numpy()))
    return 8 + len(head) + offset
