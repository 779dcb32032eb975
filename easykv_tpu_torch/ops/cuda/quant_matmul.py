"""w8a16 product (kernel K13).

CUDA kernel: easykv_tpu_torch/csrc/quant_matmul.cu (on
csrc/weight_stream.cuh), which replaces the TPU kernel
easykv_tpu/ops/pallas/quant_matmul.py `quant_matmul`. It is bound by the
int8 weight bytes at decode widths; the source notes say what the design
does about that.

`quant_matmul` launches the kernel for CUDA tensors and runs
`quant_matmul_plain` for CPU tensors. Both accumulate the whole contraction
in f32, multiply by the f32 column scale once and round once, to x's dtype
or, with out_f32 (the int8 LM head), to f32. They differ only in the order
of the f32 sums. (The JAX package's XLA path instead rounds a bf16 product
and scales in bf16, quant.py:394-395; the port follows the kernel.)
"""
from __future__ import annotations

import torch

from . import _wstream

MAX_M = 256
SIGNATURES = {"quant_matmul": _wstream.SIGNATURE}


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       out_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel; same arguments and result."""
    y = (x.to(torch.float32) @ q.to(torch.float32)) * s
    return y if out_f32 else y.to(x.dtype)


def quant_matmul(
    x: torch.Tensor,      # (M, K) f32 or bf16, M <= 256
    q: torch.Tensor,      # (K, N) int8
    s: torch.Tensor,      # (N,) f32 per-column scale
    out_f32: bool = False,
) -> torch.Tensor:
    """x @ (q * s) -> (M, N), in x's dtype or f32 (out_f32)."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, s, out_f32)
    if x.dim() != 2 or q.dim() != 2:
        raise ValueError("quant_matmul: x and q must be 2-D")
    M, K = x.shape
    N = q.shape[1]
    if not 1 <= M <= MAX_M or q.shape[0] != K:
        raise ValueError(f"quant_matmul takes 1 <= M <= {MAX_M} rows of K = q's rows; got x "
                         f"{tuple(x.shape)}, q {tuple(q.shape)}")
    out = _wstream.launch("quant_matmul", "quant_matmul", SIGNATURES, x, q, s, torch.float32,
                          (N,), out_f32=out_f32)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
