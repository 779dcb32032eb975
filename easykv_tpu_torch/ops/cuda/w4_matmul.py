"""w4a16 GEMV over halves-packed int4 (kernel K12).

CUDA kernel: easykv_tpu_torch/csrc/w4_matmul.cu (on
csrc/weight_stream.cuh), which replaces the TPU kernel
easykv_tpu/ops/pallas/w4_matmul.py `w4a16_gemv`. It is bound by the packed
weight bytes and scales; the source notes say what the design does.

`w4a16_gemv` launches the kernel for CUDA tensors and runs
`w4a16_gemv_plain` (the JAX package's `_mm_int4`: nibbles sign-extended,
one grouped f32 product per half, scales on the group sums) for CPU
tensors. It takes M <= 8 rows, as the JAX package's mm routes them to it
(the TPU wrapper runs its kernel at M = 1 and `_mm_int4` above, the same
function). The two differ only in the order of the f32 sums.
"""
from __future__ import annotations

import torch

from . import _wstream
from .w4_stream import grouped_int4

MAX_M = 8
SIGNATURES = {"w4a16_gemv": _wstream.SIGNATURE}


def unpack_int4(q4p: torch.Tensor):
    """(.., K/2, N) packed int8 -> (lo, hi) sign-extended nibbles; lo =
    rows [0, K/2), hi = rows [K/2, K)."""
    return (q4p << 4) >> 4, q4p >> 4


def w4a16_gemv_plain(x: torch.Tensor, q4p: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel; same arguments and result."""
    gch = gs.shape[0] // 2
    return grouped_int4(x, *unpack_int4(q4p), gs[:gch], gs[gch:])


def w4a16_gemv(
    x: torch.Tensor,      # (M, K) f32 or bf16, M <= 8
    q4p: torch.Tensor,    # (K/2, N) int8, halves packing
    gs: torch.Tensor,     # (K/G, N) f32 group scales, G a multiple of 8
) -> torch.Tensor:
    """x @ dequant(q4p, gs) -> (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return w4a16_gemv_plain(x, q4p, gs)
    if x.dim() != 2 or q4p.dim() != 2 or gs.dim() != 2:
        raise ValueError("w4a16_gemv: x, q4p and gs must be 2-D")
    M, K = x.shape
    Kh, N = q4p.shape
    gc = gs.shape[0]
    if not 1 <= M <= MAX_M:
        raise ValueError(f"w4a16_gemv takes 1 <= M <= {MAX_M} rows, got {M}")
    if K != 2 * Kh or gc % 2 or Kh % (gc // 2):
        raise ValueError(f"w4a16_gemv: x {tuple(x.shape)}, q4p {tuple(q4p.shape)}, gs "
                         f"{tuple(gs.shape)} do not fit")
    out = _wstream.launch("w4_matmul", "w4a16_gemv", SIGNATURES, x, q4p, gs, torch.float32,
                          (gc, N), K // gc)
    w4a16_gemv.launches += 1
    return out


w4a16_gemv.launches = 0
