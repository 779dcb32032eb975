"""Decode attention with the in-flight token (kernel K1), and over a cache
that already holds the token's row (`fused_decode_attend`).

CUDA kernels: easykv_tpu_torch/csrc/decode_attention.cu, entries
`decode_attend_inflight` and `decode_attend` on one kernel body, which
replace the TPU kernels easykv_tpu/ops/pallas/decode_attention.py
`fused_decode_attend_inflight` and `fused_decode_attend`. Both are bound by
the bytes of K and V; the source note says what the design does about that:
S splits over a thread-block cluster whose run of cache tiles `split_plan`
sizes, and every warp copies the run's K / V tiles into shared memory by
16-byte cp.async, counted on each tile's mbarrier.

`fused_decode_attend_inflight` launches the kernel for CUDA tensors and runs
the plain version, ops.attention.attend_inflight, for CPU tensors. The
kernel keeps p in fp32 through the PV product, as the TPU kernel does; the
plain version rounds p to the cache dtype first, as the JAX package's XLA
path does, so with a bf16 cache the two differ by bf16 rounding of `out`.
With an int8 cache both fold the per-slot scales in fp32 as the TPU kernel
does (k_scale into the logits, v_scale into p) and agree to fp32 rounding.
With `rot` (the ordered StreamingLLM variant) both rotate each cached K
row by its slot from the same f32 cos/sin tables, products rounded one by
one, before the QK product; with `rot` and `rank` (the `rank` variant, the
unordered StreamingLLM cache) by the table row of its age rank.

`fused_decode_attend` launches `decode_attend` for CUDA tensors and runs
its plain version, ops.attention.decode_attend, for CPU tensors; both keep
p in fp32 through the PV product, as the TPU kernel does.

`fused_decode_attend_inflight_sharded` is K1 under a (data, model) mesh
(the TPU wrapper decode_attention.py:338 `fused_decode_attend_inflight_sharded`,
a shard_map of the kernel): every (row, kv-head) program is independent,
so each rank launches K1 on its own (B/d, Hkv/m) shard, with no
collective.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ...parallel.mesh import local_dims
from ..attention import attend_inflight, decode_attend
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

fused_decode_attend_inflight_plain = attend_inflight
fused_decode_attend_plain = decode_attend

_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "decode_attend_inflight": ([_vp] * 15 + [_int] * 5 + [ctypes.c_float] + [_int] * 6 + [_vp],
                               _int),
    "decode_attend": ([_vp] * 9 + [_int] * 5 + [ctypes.c_float] + [_int] * 6 + [_vp], _int),
    "decode_attend_inflight_smem": ([_int] * 9, ctypes.c_size_t),
}

# The kernel's geometry (csrc/decode_attention.cu): 8 warps a block, cache
# tiles of 32 rows, clusters of at most 8 blocks, at most 4 rep rows a PV
# thread. A plan aims at about one block an SM of an H100 (132 SMs) and
# keeps a block's shared memory within half an SM's, so that two blocks fit
# an SM and every cluster of the grid is resident at once (clusters of 4
# blocks one an SM did not all fit the card's GPCs: the grid ran in two
# waves).
THREADS = 256
WARPS = 8
TILE = 32
MAX_CLUSTER = 8
MAX_PASSES = 4
SMS = 132
SM_SMEM = 233472          # shared memory of an SM; a block reserves 1 KB of it
TWO_A_SM = SM_SMEM // 2 - 1024
KV_BYTES = {"f32": 4, "bf16": 2, "int8": 1}
ROT = {None: 0, "ordered": 1, "rank": 2}


class SplitPlan(NamedTuple):
    cluster: int   # blocks a (batch, kv head) splits its slots over
    nk: int        # K ring slots (tiles) a block
    nv: int        # V ring slots
    smem: int      # shared memory of a block, bytes


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


def split_smem(rep: int, S: int, D: int, kv: str, rot: int, c: int, nk: int, nv: int) -> int:
    """Shared memory of one block (csrc/decode_attention.cu geometry): the
    K ring (or the PV partials, whichever is larger), the V ring, q, the
    logits, the run's pos (int8 scales, ranks), the softmax and PV
    scratch, the slots' mbarriers, 128 bytes of alignment."""
    ekv = KV_BYTES[kv]
    lpr = D // (16 // ekv)
    rpt = min(rep, THREADS // lpr)
    groups = THREADS // (lpr * rpt)
    nmax = -(-(-(-S // TILE)) // c) * TILE
    kslot = _align(TILE * D * ekv + (TILE * D * 4 if rot else 0), 128)
    vslot = _align(TILE * D * ekv, 128)
    meta = nmax * 4 * (1 + (2 if ekv == 1 else 0) + (1 if rot == 2 else 0))
    o = _align(max(nk * kslot, groups * rep * D * 4), 128) + nv * vslot
    o += rep * D * 4 + rep * nmax * 4 + meta + (6 + WARPS) * rep * 4 + rep * D * 4
    return 128 + _align(o, 8) + (nk + nv) * 8


@functools.lru_cache(maxsize=None)
def split_plan(B: int, Hkv: int, rep: int, S: int, D: int, kv: str, rot: int = 0) -> SplitPlan:
    """K1's launch for B x Hkv (batch, kv head) pairs of rep query rows over
    S slots of D (kv: "f32", "bf16" or "int8"; rot: 0, or 1 / 2 for the
    ordered / rank tables): the largest power-of-two cluster up to 8 (and
    up to the 32-row tiles) that keeps the grid within one block an SM,
    then as many ring slots as fit half an SM's shared memory (every tile
    of the run where it fits: the copies of the whole run in flight at
    once), or a whole block's where not even one fits there. Raises
    ValueError for what the kernel does not take."""
    V = 16 // KV_BYTES[kv]
    lpr = D // V
    if D % V or not 1 <= lpr <= 32 or lpr & (lpr - 1):
        raise ValueError(f"head_dim {D}: a row must be 1, 2, 4, 8, 16 or 32 16-byte loads")
    if rot and D % 8:
        raise ValueError(f"head_dim {D}: the rotated variants take D % 8 == 0")
    if -(-rep // min(rep, THREADS // lpr)) > MAX_PASSES:
        raise ValueError(f"rep={rep}: at most {MAX_PASSES * (THREADS // lpr)} query heads a "
                         f"KV head at head_dim {D} with a {kv} cache")
    nt = -(-S // TILE)
    c = 1
    while 2 * c <= min(MAX_CLUSTER, nt) and B * Hkv * 2 * c <= SMS:
        c *= 2
    for budget in (TWO_A_SM, _build.SMEM_LIMIT):
        n = -(-nt // c)
        while n >= 1 and split_smem(rep, S, D, kv, rot, c, n, n) > budget:
            n -= 1
        if n >= 1:
            return SplitPlan(c, n, n, split_smem(rep, S, D, kv, rot, c, n, n))
    need = split_smem(rep, S, D, kv, rot, c, 1, 1)
    raise ValueError(f"rep*S={rep * S} logits need {need} bytes of shared memory "
                     f"(limit {_build.SMEM_LIMIT})")


def block_rows(plan: SplitPlan, rank: int, S: int) -> Tuple[int, int]:
    """Slots [s0, s1) that block `rank` of a (batch, kv head)'s cluster
    takes: the kernel's tiles [rank * nt / c, (rank + 1) * nt / c)."""
    nt = -(-S // TILE)
    t0, t1 = rank * nt // plan.cluster, (rank + 1) * nt // plan.cluster
    return t0 * TILE, min(S, t1 * TILE)


def _prepare(q, k, v, kv_pos, q_pos, k_scale, v_scale, extra, rot=None, rank=None):
    """Checks the arguments both entries share, plus `extra` (name, tensor,
    dtype, shape); returns (library, quantized, plan)."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if T != 1 or Hq % Hkv != 0:
        raise ValueError(f"bad decode shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, got {q.dtype}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V come with k_scale and v_scale; a float cache with neither")
    kv_dtype = torch.int8 if quant else q.dtype
    checks = [("k", k, kv_dtype, (B, Hkv, S, D)), ("v", v, kv_dtype, (B, Hkv, S, D)),
              ("kv_pos", kv_pos, torch.int32, (B, Hkv, S)), ("q_pos", q_pos, torch.int32, (B,))]
    if quant:
        checks += [("k_scale", k_scale, torch.float32, (B, Hkv, S)),
                   ("v_scale", v_scale, torch.float32, (B, Hkv, S))]
    checks += extra
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    tensors = [q] + [c[1] for c in checks]
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("decode attention takes contiguous tensors on one device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    if rot is not None and (rot[0].data_ptr() % 16 or rot[1].data_ptr() % 16):
        raise ValueError("the rot tables must be 16-byte aligned")
    kv = "int8" if quant else ("bf16" if q.dtype == torch.bfloat16 else "f32")
    kind = None if rot is None else ("ordered" if rank is None else "rank")
    plan = split_plan(B, Hkv, Hq // Hkv, S, D, kv, ROT[kind])
    return _build.load("decode_attention", SIGNATURES), quant, plan


def fused_decode_attend_inflight(
    q: torch.Tensor,        # (B, Hq, 1, D) rotated
    k_new: torch.Tensor,    # (B, Hkv, 1, D) rotated, not yet cached
    v_new: torch.Tensor,    # (B, Hkv, 1, D)
    k: torch.Tensor,        # (B, Hkv, S, D) q's dtype, or int8 with scales
    v: torch.Tensor,        # (B, Hkv, S, D)
    kv_pos: torch.Tensor,   # (B, Hkv, S) int32
    q_pos: torch.Tensor,    # (B,) int32, -1 = dead row
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 (int8 K/V)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
    rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (S, D/2) f32 cos, sin
    rank: Optional[torch.Tensor] = None,    # (B, Hkv, S) int32 age ranks, 0 <= rank < S
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out (B, Hq, 1, D) in q's dtype, probs (B, Hkv, 1, S) f32,
    p_new (B, Hkv, 1) f32); see ops.attention.attend_inflight. The
    in-flight k_new / v_new are in q's dtype whatever the cache's. With
    `rot` the cached K row at slot s is rotated by (cos[s], sin[s]) first
    (ordered StreamingLLM decoding over the rotate-at-read cache); with
    `rank` too, by (cos[rank], sin[rank]) (the unordered StreamingLLM cache
    of the encoding family)."""
    if q.device.type == "cpu":
        return attend_inflight(q, k_new, v_new, k, v, kv_pos, q_pos, k_scale, v_scale,
                               sliding_window=sliding_window, rot=rot, rank=rank)
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if rank is not None and rot is None:
        raise ValueError("rank= rotates by the rot tables: pass rot too")
    extra = [("k_new", k_new, q.dtype, (B, Hkv, 1, D)), ("v_new", v_new, q.dtype, (B, Hkv, 1, D))]
    if rot is not None:
        extra += [("rot cos", rot[0], torch.float32, (S, D // 2)),
                  ("rot sin", rot[1], torch.float32, (S, D // 2))]
    if rank is not None:
        extra += [("rank", rank, torch.int32, (B, Hkv, S))]
    lib, quant, plan = _prepare(q, k, v, kv_pos, q_pos, k_scale, v_scale, extra, rot, rank)
    out = torch.empty_like(q)
    probs = torch.empty((B, Hkv, 1, S), dtype=torch.float32, device=q.device)
    p_new = torch.empty((B, Hkv, 1), dtype=torch.float32, device=q.device)
    err = lib.decode_attend_inflight(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_pos.data_ptr(), q_pos.data_ptr(), k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, None if rot is None else rot[0].data_ptr(),
        None if rot is None else rot[1].data_ptr(), None if rank is None else rank.data_ptr(),
        out.data_ptr(), probs.data_ptr(), p_new.data_ptr(), B, Hkv, Hq // Hkv, S, D, D ** -0.5,
        _window(sliding_window), _DTYPES[q.dtype], int(quant), *plan[:3], _build.stream_of(q))
    _build.check(err, "decode_attend_inflight")
    fused_decode_attend_inflight.launches += 1
    if rank is not None:
        fused_decode_attend_inflight.rank_launches += 1
    elif rot is not None:
        fused_decode_attend_inflight.ordered_launches += 1
    return out, probs, p_new


fused_decode_attend_inflight.launches = 0
fused_decode_attend_inflight.ordered_launches = 0   # those of the `ordered` variant
fused_decode_attend_inflight.rank_launches = 0      # those of the `rank` variant


def fused_decode_attend_inflight_sharded(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_pos: torch.Tensor,
    q_pos: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    *,
    mesh,
    data_axis: str = "data",
    model_axis: str = "model",
    sliding_window: Optional[int] = None,
    rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rank: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """fused_decode_attend_inflight on this rank's shards. in_specs: q,
    k_new, v_new, k, v (d, m, ., .); kv_pos, the scales, rank (d, m, .);
    q_pos (d); the rot tables replicated. out_specs: out, probs (d, m, ., .),
    p_new (d, m, .). The arguments are this rank's shards (the global batch
    and kv-heads are d and m times theirs); it returns this rank's
    outputs."""
    d, m = data_axis, model_axis
    p4, p3 = (d, m, None, None), (d, m, None)
    pq = (d, None, None, None)      # q's heads: rep for each local kv-head
    local_dims("fused_decode_attend_inflight_sharded", mesh, d, m, [
        ("q", q, pq), ("k_new", k_new, p4), ("v_new", v_new, p4), ("k", k, p4), ("v", v, p4),
        ("kv_pos", kv_pos, p3), ("q_pos", q_pos, (d,)), ("k_scale", k_scale, p3),
        ("v_scale", v_scale, p3), ("rank", rank, p3)])
    res = fused_decode_attend_inflight(q, k_new, v_new, k, v, kv_pos, q_pos, k_scale, v_scale,
                                       sliding_window=sliding_window, rot=rot, rank=rank)
    if q.is_cuda:
        fused_decode_attend_inflight_sharded.launches += 1
    return res


fused_decode_attend_inflight_sharded.launches = 0


def fused_decode_attend(
    q: torch.Tensor,        # (B, Hq, 1, D) rotated
    k: torch.Tensor,        # (B, Hkv, S, D) q's dtype, or int8 with scales; holds q's row
    v: torch.Tensor,        # (B, Hkv, S, D)
    kv_pos: torch.Tensor,   # (B, Hkv, S) int32
    q_pos: torch.Tensor,    # (B,) int32, -1 = dead row
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 (int8 K/V)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Hq, 1, D) in q's dtype, probs (B, Hkv, 1, S) f32);
    see ops.attention.decode_attend."""
    if q.device.type == "cpu":
        return decode_attend(q, k, v, kv_pos, q_pos, k_scale, v_scale,
                             sliding_window=sliding_window)
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    lib, quant, plan = _prepare(q, k, v, kv_pos, q_pos, k_scale, v_scale, [])
    out = torch.empty_like(q)
    probs = torch.empty((B, Hkv, 1, S), dtype=torch.float32, device=q.device)
    err = lib.decode_attend(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        out.data_ptr(), probs.data_ptr(), B, Hkv, Hq // Hkv, S, D, D ** -0.5,
        _window(sliding_window), _DTYPES[q.dtype], int(quant), *plan[:3], _build.stream_of(q))
    _build.check(err, "decode_attend")
    fused_decode_attend.launches += 1
    return out, probs


fused_decode_attend.launches = 0


def _window(sliding_window: Optional[int]) -> int:
    return 0 if sliding_window is None else int(sliding_window)
