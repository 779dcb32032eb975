"""In-place K/V row write of a decode step (kernel K3).

CUDA kernel: easykv_tpu_torch/csrc/row_write.cu, which replaces the TPU
kernel easykv_tpu/ops/pallas/row_write.py `write_rows`. It is bound by
launch latency; the source note says why and what the design does.

`write_rows` launches the kernel for CUDA tensors and runs
`write_rows_plain` (one advanced-index assignment per buffer) for CPU
tensors. Rows are written unconditionally, as in the JAX package. The copy
is byte-wise, so an int8 cache's rows (quantized by the caller) take the
same kernel; their scales are K2's to write.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"write_rows": ([_vp] * 5 + [_int] * 3 + [_vp], _int)}


def _index(slots: torch.Tensor):
    L, B, H = slots.shape
    dev = slots.device
    return (torch.arange(L, device=dev)[:, None, None],
            torch.arange(B, device=dev)[None, :, None],
            torch.arange(H, device=dev)[None, None, :],
            slots.long())


def write_rows_plain(k, v, kn, vn, slots) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel; same arguments and results."""
    idx = _index(slots)
    k[idx] = kn[:, :, :, 0]
    v[idx] = vn[:, :, :, 0]
    return k, v


def write_rows(
    k: torch.Tensor,      # (L, B, H, S, Dh) cache, written in place
    v: torch.Tensor,
    kn: torch.Tensor,     # (L, B, H, 1, Dh) rows to write, cache dtype
    vn: torch.Tensor,
    slots: torch.Tensor,  # (L, B, H) int32 target slot per head
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (k, v) with the rows written in place."""
    if k.device.type == "cpu":
        return write_rows_plain(k, v, kn, vn, slots)
    L, B, H, S, Dh = k.shape
    for name, t, shape in (("v", v, k.shape), ("kn", kn, (L, B, H, 1, Dh)),
                           ("vn", vn, (L, B, H, 1, Dh))):
        if t.dtype != k.dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {k.dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if slots.dtype != torch.int32 or tuple(slots.shape) != (L, B, H):
        raise ValueError("slots must be int32 (L, B, H)")
    if any(t.device != k.device or not t.is_contiguous() for t in (v, kn, vn, slots)) \
            or not k.is_contiguous():
        raise ValueError("write_rows takes contiguous tensors on one device")
    row_bytes = Dh * k.element_size()
    if row_bytes % 16 != 0:
        raise ValueError(f"a row of {row_bytes} bytes is not a multiple of 16")
    rows = L * B * H
    if rows == 0:
        return k, v
    lib = _build.load("row_write", SIGNATURES)
    err = lib.write_rows(k.data_ptr(), v.data_ptr(), kn.data_ptr(), vn.data_ptr(),
                         slots.data_ptr(), rows, S, row_bytes, _build.stream_of(k))
    _build.check(err, "write_rows")
    write_rows.launches += 1
    return k, v


write_rows.launches = 0
