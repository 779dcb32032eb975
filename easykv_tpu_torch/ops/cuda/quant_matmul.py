"""w8a16 product (kernel K13).

CUDA kernels, which replace the TPU kernel
easykv_tpu/ops/pallas/quant_matmul.py `quant_matmul`: at M = 1 (the decode
row) easykv_tpu_torch/csrc/quant_gemv.cu, a ring of tensor-map copies in
shared memory filled by a producer warp, the rows split over a thread-block
cluster whose partials add through distributed shared memory (no workspace,
no ticket); at 1 < M <= 256 easykv_tpu_torch/csrc/quant_matmul.cu (on
csrc/weight_stream.cuh). Both are bound by the int8 weight bytes at decode
widths; the source notes say what the designs do about that. `gemv_plan`
picks the M = 1 launch.

`quant_matmul` launches a kernel for CUDA tensors and runs
`quant_matmul_plain` for CPU tensors. All accumulate the whole contraction
in f32, multiply by the f32 column scale once and round once, to x's dtype
or, with out_f32 (the int8 LM head), to f32. They differ only in the order
of the f32 sums. (The JAX package's XLA path instead rounds a bf16 product
and scales in bf16, quant.py:394-395; the port follows the kernel.)
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build, _wstream

MAX_M = 256
SIGNATURES = {"quant_matmul": _wstream.SIGNATURE}
_vp, _int = ctypes.c_void_p, ctypes.c_int
GEMV_SIGNATURES = {"quant_gemv": ([_vp] * 4 + [_int] * 8 + [_vp], _int),
                   "quant_gemv_smem": ([_int] * 4, ctypes.c_size_t)}

SMS = 132                 # streaming multiprocessors of an H100
TN = 256                  # columns of a block's slab (csrc/quant_gemv.cu kTN)
WARPS = 8                 # consumer warps of a block (kWarps)
ROW_LANES = 16            # rows a stage's pass takes (kRowLanes); a stage is a multiple
STAGE_ROWS = 128          # rows a stage
STAGES = 2                # stages of the ring: 64 KB in flight a block
MAX_CLUSTER = 8
# Clusters: the largest power of two (at most 8, at most one a stage) that
# keeps the grid within two blocks an SM. Stage rows, stages and clusters
# from `python3 tools/torch_k13_k14_times.py --sweep` on an H100 (PERF.md
# section 6): a 64 KB ring beat 96 and 128 KB at every width, in 128-row
# stages better than in 64 or 32 (wgu 37.91 against 41.28 and 43.02 µs),
# clusters of 3 or 5 blocks ran slower than their powers of two, and grids
# past two blocks an SM slower.
WAVE = 2 * SMS


class GemvPlan(NamedTuple):
    rs: int        # rows a stage (a multiple of ROW_LANES)
    stages: int    # stages in the ring
    cluster: int   # blocks a slab's rows split over
    slabs: int     # column slabs of TN columns


@functools.lru_cache(maxsize=None)
def gemv_plan(K: int, N: int) -> GemvPlan:
    """K13's launch at M = 1 for a weight (K, N): slabs of TN columns whose
    stages split over `cluster` blocks (see MAX_CLUSTER)."""
    slabs = -(-N // TN)
    ns = -(-K // STAGE_ROWS)
    cluster = 1
    while 2 * cluster <= min(MAX_CLUSTER, ns) and slabs * 2 * cluster <= WAVE:
        cluster *= 2
    return GemvPlan(STAGE_ROWS, STAGES, cluster, slabs)


def gemv_smem(K: int, p: GemvPlan) -> int:
    """Shared memory of one block of the M = 1 kernel (csrc/quant_gemv.cu
    geometry): the ring, the warps' and the block's partials, x for the
    block's rows (f32), the 2 stages mbarriers, 128 bytes of alignment."""
    xrows = -(-(-(-K // p.rs)) // p.cluster) * p.rs
    body = p.stages * p.rs * TN + WARPS * TN * 4 + TN * 4 + xrows * 4
    return 128 + -(-body // 8) * 8 + 2 * p.stages * 8


def block_stages(p: GemvPlan, rank: int, K: int):
    """Stages [s0, s1) that block `rank` of a slab's cluster takes (the
    kernel's s_begin and its end; stage s is rows s * p.rs .. + p.rs)."""
    ns = -(-K // p.rs)
    return rank * ns // p.cluster, (rank + 1) * ns // p.cluster


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       out_f32: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel; same arguments and result."""
    y = (x.to(torch.float32) @ q.to(torch.float32)) * s
    return y if out_f32 else y.to(x.dtype)


def quant_gemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
               out_f32: bool) -> torch.Tensor:
    """The M = 1 kernel on x's current stream (arguments checked)."""
    K, N = q.shape
    p = gemv_plan(K, N)
    out = torch.empty((1, N), dtype=torch.float32 if out_f32 else x.dtype, device=x.device)
    lib = _build.load("quant_gemv", GEMV_SIGNATURES)
    err = lib.quant_gemv(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), K, N, p.rs,
                         p.stages, p.cluster, int(x.dtype == torch.bfloat16), int(out_f32),
                         int(N % 16 == 0), _build.stream_of(x))
    _build.check(err, "quant_gemv")
    return out


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
    if M == 1:
        _wstream.check_args("quant_matmul", x, q, s, torch.float32, (N,))
        out = quant_gemv(x, q, s, out_f32)
    else:
        out = _wstream.launch("quant_matmul", "quant_matmul", SIGNATURES, x, q, s,
                              torch.float32, (N,), out_f32=out_f32)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
