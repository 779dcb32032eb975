"""w4a16 GEMV over halves-packed int4 (kernel K12).

CUDA kernel: easykv_tpu_torch/csrc/w4_matmul.cu, which replaces the TPU
kernel easykv_tpu/ops/pallas/w4_matmul.py `w4a16_gemv`. It is bound by the
packed weight bytes and scales; the source notes say what the design does
(a ring of tensor-map copies in shared memory, mma.sync on the unpacked
nibbles, the rows split over a thread-block cluster where the column slabs
do not fill the card). `plan` picks the
launch; the kernel lays out its shared memory and fits its ring's stages
into the plan's byte budget.

`w4a16_gemv` launches the kernel for CUDA tensors and runs
`w4a16_gemv_plain` (the JAX package's `_mm_int4`: nibbles sign-extended,
one grouped f32 product per half, scales on the group sums) for CPU
tensors. It takes M <= 8 rows, as the JAX package's mm routes them to it
(the TPU wrapper runs its kernel at M = 1 and `_mm_int4` above, the same
function). The two differ only in the order of the f32 sums.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build, _wstream
from .w4_stream import grouped_int4

MAX_M = 8
SMS = 132                 # streaming multiprocessors of an H100
TN = 256                  # columns of a block's slab (csrc/w4_matmul.cu kTN)
# Blocks of a cluster: at most 6 (the portable limit is 8, but clusters of
# 7 and 8 ran no faster at any 7B width and slower at wd)
MAX_CLUSTER = 6
RING_BYTES = 96 * 1024    # the ring's budget (3 to 8 stages), so that two blocks fit an SM
# Blocks of one wave: two an SM; with clusters of 3 or more blocks, room to
# place them (at wg, 43 clusters of 6 blocks ran slower than 43 of 5). Both
# limits from `python3 tools/torch_k12_k15_times.py --sweep` on an H100
# (PERF.md section 6).
WAVE, WAVE_CLUSTERED = 2 * SMS, 216
DTYPES = (torch.float32, torch.bfloat16)
_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"w4a16_gemv": ([_vp] * 4 + [_int] * 11 + [_vp], _int)}


class Plan(NamedTuple):
    mt: int        # rows of x a block takes (M padded to 1, 2, 4 or 8)
    rs: int        # packed rows a stage (a multiple of 8 dividing the group)
    cluster: int   # blocks a slab's rows split over
    slabs: int     # column slabs of TN columns


def tile_rows(M: int) -> int:
    return 1 if M == 1 else 2 if M == 2 else 4 if M <= 4 else 8


@functools.lru_cache(maxsize=None)
def plan(M: int, Kh: int, N: int, G: int) -> Plan:
    """K12's launch for x (M, 2 Kh) and a carrier (Kh, N) in groups of G
    packed rows. A slab's stage rows split over
    `cluster` blocks, as many as keep the grid within one wave of two
    blocks an SM (at most MAX_CLUSTER, at most one a stage)."""
    if not _wstream.group_ok(G) or Kh % G:
        raise ValueError(f"group of {G} rows: the kernel takes groups of a multiple of "
                         f"{_wstream.ROW_CHUNKS[-1]} rows")
    rs = math.gcd(G, 64)
    slabs = -(-N // TN)
    cluster = max([1] + [c for c in range(2, min(MAX_CLUSTER, Kh // rs) + 1)
                         if slabs * c <= (WAVE if c <= 2 else WAVE_CLUSTERED)])
    return Plan(tile_rows(M), rs, cluster, slabs)


def block_rows(p: Plan, rank: int, Kh: int):
    """Packed rows [r0, r1) that block `rank` of a slab's cluster takes (the
    kernel's s_begin and s_end, in stages of p.rs rows)."""
    ns = Kh // p.rs
    return rank * ns // p.cluster * p.rs, (rank + 1) * ns // p.cluster * p.rs


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
    if x.dtype not in DTYPES:
        raise TypeError(f"w4a16_gemv takes float32 or bfloat16 activations, got {x.dtype}")
    if q4p.dtype != torch.int8 or gs.dtype != torch.float32 or gs.shape[1] != N:
        raise ValueError(f"w4a16_gemv: q4p {q4p.dtype} {tuple(q4p.shape)}, gs {gs.dtype} "
                         f"{tuple(gs.shape)} (expected int8 and float32 ({gc}, {N}))")
    dev = x.device
    if (q4p.device != dev or gs.device != dev or not x.is_contiguous()
            or not q4p.is_contiguous() or not gs.is_contiguous() or q4p.data_ptr() % 16):
        raise ValueError(f"w4a16_gemv: x, q4p and gs must be contiguous and on {dev}, q4p "
                         "16-byte aligned")
    p = plan(M, Kh, N, K // gc)
    tma = N % 16 == 0 and x.data_ptr() % 16 == 0 and gs.data_ptr() % 16 == 0
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    lib = _build.load("w4_matmul", SIGNATURES)
    err = lib.w4a16_gemv(x.data_ptr(), q4p.data_ptr(), gs.data_ptr(), out.data_ptr(), M, K, N,
                         K // gc, p.mt, p.rs, RING_BYTES, p.cluster,
                         int(x.dtype == torch.bfloat16), 0, int(tma), _build.stream_of(x))
    _build.check(err, "w4a16_gemv")
    w4a16_gemv.launches += 1
    return out


w4a16_gemv.launches = 0
