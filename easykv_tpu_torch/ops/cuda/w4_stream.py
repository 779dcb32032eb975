"""w4a16 products over the arithmetic int4 carrier: kernels K10
(`w4a16_gemv_arith`, M = 1) and K11 (`w4a16_gemm_arith`, 1 < M <= 512).

CUDA kernels: K10 in easykv_tpu_torch/csrc/quant_gemv.cu (the M = 1
tensor-map stream it shares with K13, in its carrier format; its plan is
ops/cuda/quant_matmul.py `gemv_plan` with the group), K11 in
easykv_tpu_torch/csrc/w4_gemm.cu (its own tensor-core kernel), which
replace the TPU kernels easykv_tpu/ops/pallas/w4_stream.py
`w4a16_gemv_arith` and `w4a16_gemm_arith`. K10 is bound by the carrier
bytes; K11 by them at small M and by its multiply-adds at M = 512. The
source notes say what the designs do about that. K11's tile configuration
and the split of its groups over blocks come from `gemm_plan`.

Each wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors: the carrier unpacked (hi = (p + 8) >> 4, lo =
p - 16 hi), one grouped f32 product per half, the group scales on the f32
group sums (`grouped_int4`, the JAX package's grouped einsum). K10 takes the
bf16 scale pair gs3 = [gs_hi; gs_lo] / 16, K11 the f32 group scales gs;
gs3 * 16 == gs for the bf16-representable scales quantize_linear_int4 makes.
Kernel and plain version differ only in the order of the f32 sums (the TPU
kernel's xl - xh/16 rounding in bf16 is not carried over; K11 splits an f32
x into three bf16 limbs whose sum is x exactly). K10 keeps no state between
launches: no workspace, no ticket.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build, _wstream
from .quant_matmul import GEMV_SIGNATURES, gemv_plan

MAX_M = 512
GROUP = 128
_vp, _int = ctypes.c_void_p, ctypes.c_int
GEMM_SIGNATURES = {"w4a16_gemm_arith": ([_vp] * 6 + [_int] * 6 + [_vp], _int)}

# K11's tiles (csrc/w4_gemm.cu): 128 columns; 16 rows of x (M <= SMALL_M,
# the weights on the MMA's 16-row side) or 64
SMS = 132                 # streaming multiprocessors of an H100
TILE_N = 128
SMALL_M = 16
TILE_M = 64
BLOCKS_PER_SM = {True: 3, False: 2}   # resident blocks a tile's shared memory allows (bf16 x)


@functools.lru_cache(maxsize=None)
def gemm_plan(M: int, K: int, N: int) -> Tuple[bool, int, int, Tuple[int, int, int]]:
    """K11's launch for x (M, K) and a carrier (K/2, N): (small tiles, groups
    a block walks, blocks the groups split over, grid (column tiles, row
    tiles, splits)). The groups split only where the tiles are fewer than
    the blocks the card holds at once, into about as many equal runs as
    fit beside them; every split holds at least one group."""
    if not 1 < M <= MAX_M or (K // 2) % GROUP or K % 2:
        raise ValueError(f"w4a16_gemm_arith takes 1 < M <= {MAX_M} and (K/2) % {GROUP} == 0; "
                         f"got M={M}, K={K}")
    gch = K // 2 // GROUP
    small = M <= SMALL_M
    cols, rows = -(-N // TILE_N), 1 if small else -(-M // TILE_M)
    tiles = cols * rows
    ksplit = min(gch, max(1, BLOCKS_PER_SM[small] * SMS // tiles))
    gps = -(-gch // ksplit)
    ksplit = -(-gch // gps)
    if ksplit > 1 and tiles > _wstream.MAX_TICKETS:
        raise ValueError(f"{tiles} tiles with split groups (at most {_wstream.MAX_TICKETS})")
    return small, gps, ksplit, (cols, rows, ksplit)


def unpack_int4_arith(p: torch.Tensor):
    """(.., K/2, N) arithmetic carrier -> (lo, hi) nibble values; lo =
    rows [0, K/2), hi = rows [K/2, K)."""
    hi = (p + 8) >> 4                                 # round(p / 16), exact
    return (p - 16 * hi).to(torch.int8), hi


def grouped_int4(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, s_lo: torch.Tensor,
                 s_hi: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ [lo; hi] (K, N) int4 values, group scales s_lo / s_hi
    (gc/2, N) on the f32 sums of each group of each half -> (M, N) in x's
    dtype (easykv_tpu/ops/quant.py:135-154, 326-339)."""
    M = x.shape[0]
    Kh, N = lo.shape
    gch = s_lo.shape[0]
    G = Kh // gch

    def half(xh, wh, sh):
        y = torch.einsum("mgk,gkn->mgn", xh.to(torch.float32).reshape(M, gch, G),
                         wh.to(torch.float32).reshape(gch, G, N))
        return (y * sh).sum(dim=1)
    return (half(x[:, :Kh], lo, s_lo) + half(x[:, Kh:], hi, s_hi)).to(x.dtype)


def w4a16_gemv_arith_plain(x: torch.Tensor, p: torch.Tensor, gs3: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K10; same arguments and result."""
    gch = gs3.shape[0] // 2
    s = gs3.to(torch.float32) * 16.0
    return grouped_int4(x, *unpack_int4_arith(p), s[gch:], s[:gch])


def w4a16_gemm_arith_plain(x: torch.Tensor, p: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11; same arguments and result."""
    gch = gs.shape[0] // 2
    return grouped_int4(x, *unpack_int4_arith(p), gs[:gch], gs[gch:])


def _shapes(x, p, scales, what):
    """(M, K, N, gc, G) of a product the wrappers take; raises otherwise."""
    if x.dim() != 2 or p.dim() != 2 or scales.dim() != 2:
        raise ValueError(f"{what}: x, carrier and scales must be 2-D")
    M, K = x.shape
    Kh, N = p.shape
    gc = scales.shape[0]
    if K != 2 * Kh or gc % 2 or Kh % (gc // 2):
        raise ValueError(f"{what}: x {tuple(x.shape)}, carrier {tuple(p.shape)}, scales "
                         f"{tuple(scales.shape)} do not fit")
    return M, K, N, gc, K // gc


def w4a16_gemv_arith(
    x: torch.Tensor,      # (1, K) f32 or bf16
    p: torch.Tensor,      # (K/2, N) int8 arithmetic carrier
    gs3: torch.Tensor,    # (K/G, N) bf16 pair [gs_hi; gs_lo] / 16, G a multiple of 8
) -> torch.Tensor:
    """x @ dequant(p, gs3) -> (1, N) in x's dtype."""
    if x.device.type == "cpu":
        return w4a16_gemv_arith_plain(x, p, gs3)
    M, K, N, gc, G = _shapes(x, p, gs3, "w4a16_gemv_arith")
    if M != 1:
        raise ValueError(f"w4a16_gemv_arith takes one row, got {M}")
    _wstream.check_args("w4a16_gemv_arith", x, p, gs3, torch.bfloat16, (gc, N))
    plan = gemv_plan(K // 2, N, G)
    out = torch.empty((1, N), dtype=x.dtype, device=x.device)
    lib = _build.load("quant_gemv", GEMV_SIGNATURES)
    err = lib.w4a16_gemv_arith(x.data_ptr(), p.data_ptr(), gs3.data_ptr(), out.data_ptr(), K, N,
                               G, plan.rs, plan.stages, plan.cluster,
                               int(x.dtype == torch.bfloat16),
                               int(N % 16 == 0 and gs3.data_ptr() % 16 == 0), _build.stream_of(x))
    _build.check(err, "w4a16_gemv_arith")
    w4a16_gemv_arith.launches += 1
    return out


def w4a16_gemm_arith(
    x: torch.Tensor,      # (M, K) f32 or bf16, 1 < M <= 512
    p: torch.Tensor,      # (K/2, N) int8 arithmetic carrier, (K/2) % 128 == 0
    gs: torch.Tensor,     # (K/128, N) f32 group scales
) -> torch.Tensor:
    """x @ dequant(p, gs) -> (M, N) in x's dtype."""
    if x.device.type == "cpu":
        return w4a16_gemm_arith_plain(x, p, gs)
    M, K, N, gc, G = _shapes(x, p, gs, "w4a16_gemm_arith")
    if not 1 < M <= MAX_M or G != GROUP or (K // 2) % GROUP:
        raise ValueError(f"w4a16_gemm_arith takes 1 < M <= {MAX_M}, group {GROUP} and "
                         f"(K/2) % {GROUP} == 0; got M={M}, group {G}, K={K}")
    if x.dtype not in _wstream.DTYPES:
        raise TypeError(f"w4a16_gemm_arith takes float32 or bfloat16 activations, got {x.dtype}")
    dev = x.device
    if (p.dtype != torch.int8 or gs.dtype != torch.float32 or p.device != dev
            or gs.device != dev or not x.is_contiguous() or not p.is_contiguous()
            or not gs.is_contiguous() or x.data_ptr() % 16 or p.data_ptr() % 16):
        raise ValueError(f"w4a16_gemm_arith: x, an int8 carrier and f32 scales, contiguous on "
                         f"{dev}, x and the carrier 16-byte aligned; got x {x.dtype} "
                         f"{tuple(x.stride())}, carrier {p.dtype}, scales {gs.dtype}")
    small, gps, ksplit, _ = gemm_plan(M, K, N)
    stream = _build.stream_of(x)
    ws = tk = None
    if ksplit > 1:
        ws, tk = _wstream.workspace(dev, stream, ksplit * M * N), _wstream.tickets(dev, stream)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    lib = _build.load("w4_gemm", GEMM_SIGNATURES)
    err = lib.w4a16_gemm_arith(x.data_ptr(), p.data_ptr(), gs.data_ptr(), out.data_ptr(),
                               _wstream.ptr(ws), _wstream.ptr(tk), M, K, N, int(small), gps,
                               ksplit, int(x.dtype == torch.bfloat16), stream)
    _build.check(err, "w4a16_gemm_arith")
    w4a16_gemm_arith.launches += 1
    return out


w4a16_gemv_arith.launches = 0
w4a16_gemm_arith.launches = 0
