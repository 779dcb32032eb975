"""w8a16 product (kernel K13), and the M = 1 weight stream it shares with
K10.

CUDA kernels, which replace the TPU kernel
easykv_tpu/ops/pallas/quant_matmul.py `quant_matmul`: at M = 1 (the decode
row) easykv_tpu_torch/csrc/quant_gemv.cu, a ring of tensor-map copies in
shared memory filled by a producer warp, the rows split over a thread-block
cluster whose partials add through distributed shared memory; at 1 < M <=
256 easykv_tpu_torch/csrc/quant_matmul.cu, mma.sync on the tensor cores
over a ring of tensor-map copies of the weight and x, a block owning a
column tile and every row of x, the stages split over a cluster in the same
way. Neither keeps a workspace or a
ticket. Both are bound by the int8 weight bytes at decode widths, the M >
1 kernel by its multiply-adds at M = 256; the source notes say what the
designs do about that. `gemv_plan` picks the M = 1 launch of either format
of quant_gemv.cu: K13's int8 weight, or (with a group G) K10's arithmetic
int4 carrier (ops/cuda/w4_stream.py w4a16_gemv_arith); `matmul_plan` the
M > 1 launch.

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
import math
from typing import NamedTuple

import torch

from . import _build, _wstream

MAX_M = 256
_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {"quant_matmul": ([_vp] * 4 + [_int] * 12 + [_vp], _int),
              "quant_matmul_smem": ([_int] * 5, ctypes.c_size_t)}
GEMV_SIGNATURES = {"quant_gemv": ([_vp] * 4 + [_int] * 8 + [_vp], _int),
                   "quant_gemv_smem": ([_int] * 4, ctypes.c_size_t),
                   "w4a16_gemv_arith": ([_vp] * 4 + [_int] * 8 + [_vp], _int),
                   "w4a16_gemv_arith_smem": ([_int] * 5, ctypes.c_size_t)}

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


def stage_rows(G: int) -> int:
    """Carrier rows a K10 stage takes for groups of G rows: the most whole
    groups within STAGE_ROWS, the stage a multiple of ROW_LANES (G = 128:
    one group a stage); else STAGE_ROWS, whole stages of a group where G is
    a multiple of it, groups straddling stages otherwise (odd multiples of 8
    above 64 rows, which no 7B tree has)."""
    lcm = ROW_LANES * G // math.gcd(ROW_LANES, G)
    return STAGE_ROWS // lcm * lcm if lcm <= STAGE_ROWS else STAGE_ROWS


def stage_groups(rs: int, G: int) -> int:
    """Scale groups a stage's slot holds (csrc/quant_gemv.cu stage_groups)."""
    if rs % G == 0:
        return rs // G
    if G % rs == 0:
        return 1
    return (rs + G - 2) // G + 1


@functools.lru_cache(maxsize=None)
def gemv_plan(R: int, N: int, G: int = 0) -> GemvPlan:
    """The M = 1 launch for a weight of R rows by N columns: K13's int8
    weight (G = 0, R = K), or K10's arithmetic carrier (R = K / 2 rows in
    groups of G, stages of stage_rows(G)): slabs of TN columns
    whose stages split over `cluster` blocks (see MAX_CLUSTER). K10 takes
    groups of a multiple of 8 rows (ValueError otherwise)."""
    if G % 8:
        raise ValueError(f"group of {G} rows: the kernel takes groups of a multiple of 8 rows")
    rs = stage_rows(G) if G else STAGE_ROWS
    slabs = -(-N // TN)
    ns = -(-R // rs)
    cluster = 1
    while 2 * cluster <= min(MAX_CLUSTER, ns) and slabs * 2 * cluster <= WAVE:
        cluster *= 2
    return GemvPlan(rs, STAGES, cluster, slabs)


def gemv_smem(R: int, p: GemvPlan, G: int = 0) -> int:
    """Shared memory of one block of the M = 1 kernel (csrc/quant_gemv.cu
    geometry): the ring (K10: each stage with its groups' scale rows), the
    warps' and the block's partials, x for the block's rows (f32; K10 two a
    row), the 2 stages mbarriers, 128 bytes of alignment."""
    xrows = -(-(-(-R // p.rs)) // p.cluster) * p.rs
    stage = p.rs * TN + (4 * TN * stage_groups(p.rs, G) if G else 0)
    body = p.stages * stage + WARPS * TN * 4 + TN * 4 + xrows * 4 * (2 if G else 1)
    return 128 + -(-body // 8) * 8 + 2 * p.stages * 8


def block_stages(p: GemvPlan, rank: int, R: int):
    """Stages [s0, s1) that block `rank` of a slab's cluster takes (the
    kernel's s_begin and its end; stage s is rows s * p.rs .. + p.rs)."""
    ns = -(-R // p.rs)
    return rank * ns // p.cluster, (rank + 1) * ns // p.cluster


# The M > 1 kernel (csrc/quant_matmul.cu): 256 threads; the small tiles (M
# <= 16: 256 columns by 8 or 16 rows, the weight on the MMA's 16-row side)
# or the large (128 columns by 64, 128 or 256 rows); the weight and x in
# boxes of 128-byte rows. Rows of a stage and stages from `python3
# tools/torch_k13_k9_times.py --sweep` (PERF.md section 6).
SMALL_M = 16
MM_TN = {True: 256, False: 128}
MM_BOX = 128              # bytes of a box row (the weight's and x's)
SMEM_LIMIT = 232448       # shared memory one block may use
SM_SMEM = 233472          # shared memory of an SM, 1 KB of it reserved a block
MM_REG_BLOCKS = {(True, 1): 2, (True, 2): 2, (False, 1): 2, (False, 2): 1, (False, 4): 1}


class MatmulPlan(NamedTuple):
    small: bool    # the small tiles (M <= SMALL_M)
    rows: int      # small: n8 blocks of x rows (1, 2); large: m16 tiles a warp (1, 2, 4)
    rs: int        # weight rows a stage (32, 64 or 128)
    stages: int    # stages in the ring
    cluster: int   # blocks a column tile's stages split over
    tiles: int     # column tiles


def matmul_smem(p: MatmulPlan, x_f32: bool) -> int:
    """Shared memory of one block of the M > 1 kernel (csrc/quant_matmul.cu
    geometry): the ring (each stage the tile's weight rows, then its x rows
    at those K columns), or the partial tile (f32) that reuses it, whichever
    is larger; the stages' mbarriers and release counts; 1 KB of slack for
    the alignment."""
    tn = MM_TN[p.small]
    tm = 8 * p.rows if p.small else 64 * p.rows
    stage = p.rs * tn + tm * p.rs * (4 if x_f32 else 2)
    return 1024 + max(p.stages * stage, tm * tn * 4) + 12 * p.stages


def matmul_ring(small: bool, rows: int, x_f32: bool):
    """(rows a stage, stages) of a configuration: 128-row stages, two of
    them (three for the large tiles up to 128 rows of x); with an f32 x on
    the large tiles, stages of 32 rows (one 128-byte box of x), three of
    them."""
    if x_f32 and not small:
        return 32, 3
    return 128, 3 if not small and rows < 4 else 2


@functools.lru_cache(maxsize=None)
def matmul_plan(M: int, K: int, N: int, x_f32: bool) -> MatmulPlan:
    """The 1 < M <= 256 launch for x (M, K) and a weight (K, N): the tile
    configuration that holds every row of x (so each weight byte is read
    once), its ring (matmul_ring), and the largest power-of-two cluster (at
    most 8, at most one a stage) that keeps the grid within a third over one
    wave of the blocks the card holds at once (the sweep's best at the 7B
    widths but for the large tiles' wgu, wo and wd, 10-20% off)."""
    if not 1 < M <= MAX_M:
        raise ValueError(f"the M > 1 kernel takes 1 < M <= {MAX_M}, got {M}")
    small = M <= SMALL_M
    rows = (1 if M <= 8 else 2) if small else (1 if M <= 64 else 2 if M <= 128 else 4)
    rs, stages = matmul_ring(small, rows, x_f32)
    p = MatmulPlan(small, rows, rs, stages, 1, -(-N // MM_TN[small]))
    per_sm = min(MM_REG_BLOCKS[(small, rows)], SM_SMEM // (matmul_smem(p, x_f32) + 1024))
    ns = -(-K // rs)
    cluster = 1
    while (2 * cluster <= min(MAX_CLUSTER, ns)
           and 3 * p.tiles * 2 * cluster <= 4 * max(per_sm, 1) * SMS):
        cluster *= 2
    return p._replace(cluster=cluster)


def matmul_stages(p: MatmulPlan, rank: int, K: int):
    """Stages [s0, s1) that block `rank` of a tile's cluster takes (the
    kernel's block_stages; stage s is weight rows s * p.rs .. + p.rs)."""
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


def quant_mm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, out_f32: bool) -> torch.Tensor:
    """The 1 < M <= 256 kernel on x's current stream (arguments checked)."""
    M, K = x.shape
    N = q.shape[1]
    x_f32 = x.dtype == torch.float32
    p = matmul_plan(M, K, N, x_f32)
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 or x_f32 else x.dtype,
                      device=x.device)
    lib = _build.load("quant_matmul", SIGNATURES)
    err = lib.quant_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), M, K, N,
                           int(p.small), p.rows, p.rs, p.stages, p.cluster, int(not x_f32),
                           int(out_f32), int(N % 16 == 0 and q.data_ptr() % 16 == 0),
                           int(K * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0),
                           _build.stream_of(x))
    _build.check(err, "quant_matmul")
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
    _wstream.check_args("quant_matmul", x, q, s, torch.float32, (N,))
    out = quant_gemv(x, q, s, out_f32) if M == 1 else quant_mm(x, q, s, out_f32)
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
