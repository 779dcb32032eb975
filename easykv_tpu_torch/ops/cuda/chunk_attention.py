"""C-query chunk attention over the ring buffer, with the per-slot score
statistics (kernel K5), and the strided encode's chunk write + attend
(kernel K6).

CUDA kernel: easykv_tpu_torch/csrc/chunk_attention.cu, which replaces the
TPU kernel easykv_tpu/ops/pallas/chunk_attention.py `fused_chunk_attend`:
both of its variants, the 1-pass `_onepass_kernel` and the 2-pass
`_flash_kernel` + `_score_kernel`, compute one function, and the CUDA design
computes it once. The source note says what bounds it and what its design
does about that.

`fused_chunk_attend` launches the kernel for CUDA tensors and runs
`fused_chunk_attend_plain` for CPU tensors. The attention launch splits the
slot tiles into `attend_splits` runs whose partials a combine launch adds in
run order. The plain version repeats the
TPU kernel's arithmetic in float32: logits = (q . k) * D^-1/2 (* k_scale),
a masked softmax whose masked entries are exactly 0, out = (p (* v_scale))
. v cast to q's dtype, and with need_scores the GQA mean of p over the rep
query heads of each KV head, summed over the chunk (ssum), summed squared
(ssq), and its row C-1 (last).

K6 `fused_chunk_write_attend` (same source, entry `chunk_write_attend`)
replaces easykv_tpu/ops/pallas/chunk_attention.py `fused_chunk_write_attend`
(`_wa_kernel`, `_wa_flash_kernel` and the `_score_kernel` second pass): it
writes the chunk into caller-given slots, in place, then computes K5's
function over the updated cache. Its plain version is
`cache.write_tokens_at` followed by `fused_chunk_attend_plain`. Unlike the
TPU kernel, whose max-based pick clamps negative initial counters to 0, it
writes `counter_init` exactly, as the JAX package's XLA path does.

K7 `fused_chunk_step` (same source, entry `chunk_step`) replaces
easykv_tpu/ops/pallas/chunk_attention.py `fused_chunk_step` (`_step_kernel`):
the whole strided-encode chunk of roco or h2o_head in one call. It writes
the chunk at the slots of a carried write mask, attends as K6 does, applies
the gated score update and the gated eviction (counter bump, encode-phase
selection, pos = -1 at the victims) and returns the next chunk's write
mask. Its plain version is a masked write_tokens_at, fused_chunk_attend_plain
and `chunk_step_evict_plain` (policies.update_scores_reduced, the bump,
policies.select_evictions, cache.evict_slots). Like K6 it writes negative
initial counters exactly, where the TPU kernel's pick clamps them to 0;
a row whose eviction gate is off keeps its counters bit for bit.

`fused_chunk_attend_sharded`, `fused_chunk_write_attend_sharded` and
`fused_chunk_step_sharded` are K5, K6 and K7 under a (data, model) mesh
(the TPU wrappers chunk_attention.py:348, :844 and :1199, a shard_map of
each kernel): the (row, kv-head) programs are independent, so each rank
launches the kernel on its own (B/d, Hkv/m) shard, with no collective.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...cache import KVCache, evict_slots, write_tokens_at
from ...parallel.mesh import local_dims
from ...policies import PHASE_ENCODE, PolicySpec, select_evictions, update_scores_reduced
from ..attention import NEG_INF
from . import _build

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_REP = 32   # query heads per KV head (a 64-row attention tile holds two queries of each)

_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "chunk_attend": ([_vp] * 13 + [_int] * 7 + [ctypes.c_float] + [_int] * 3 + [_vp], _int),
    "chunk_attend_smem": ([_int] * 3, ctypes.c_size_t),
    "chunk_write_attend": ([_vp] * 20 + [_int] * 7 + [ctypes.c_float] + [_int] * 3 + [_vp],
                           _int),
    "chunk_step": ([_vp] * 25 + [_int] * 7 + [ctypes.c_float] + [_int] * 7 + [_vp], _int),
    "chunk_step_smem": ([_int], ctypes.c_size_t),
}

# The attention launch's tiles (csrc/chunk_attention.cu): 64 query rows by
# 64 slots; its slot tiles split into runs until about two blocks per SM of
# an H100 (132 SMs) are in flight.
TILE_ROWS = 64
TILE_SLOTS = 64
TARGET_BLOCKS = 2 * 132


def attend_splits(B: int, Hkv: int, rep: int, C: int, S: int, exact: bool = False) -> int:
    """The runs the attention launch splits S's 64-slot tiles into: the
    fewest of equal length that bring the blocks to TARGET_BLOCKS, at most
    one a tile. `exact` (f32 queries): one run, whose block computes each
    softmax entry as the plain version does (no run or tile rescaling)."""
    if exact:
        return 1
    tiles = -(-S // TILE_SLOTS)
    blocks = B * Hkv * -(-rep * C // TILE_ROWS)
    n = min(tiles, max(1, -(-TARGET_BLOCKS // blocks)))
    per = -(-tiles // n)
    return -(-tiles // per)

STEP_POLICIES = ("roco", "h2o_head")

# The JAX package's VMEM budget of its fused write + attend (and step)
# kernels (easykv_tpu/ops/pallas/chunk_attention.py:402-413 there). The
# port takes K7 exactly where the JAX package does, so it keeps the same
# predicate; it is not a limit of the CUDA kernel.
_WA_VMEM_CAP = 15 * 1024 * 1024


def wa_fits(rows: int, C: int, S: int, D: int, kv_bytes: int) -> bool:
    """The JAX package's VMEM predicate for its fused write + attend: K/V
    blocks in and out, f32 logits and probs, the (C, S) one-hot and one
    f32 (S, D) spread."""
    S_pad = ((S + 127) // 128) * 128
    kv = 4 * S_pad * D * kv_bytes
    work = 2 * rows * S_pad * 4
    onehot = C * S_pad * 4
    spread = 2 * S_pad * D * 4
    return kv + work + onehot + spread <= _WA_VMEM_CAP


def fused_chunk_attend_plain(
    q, k, v, kv_pos, q_pos, k_scale=None, v_scale=None, *,
    need_scores: bool = True, sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel; same arguments and results."""
    B, Hq, C, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    qg = q.reshape(B, Hkv, rep, C, D).to(torch.float32)
    logits = torch.einsum("bhrcd,bhsd->bhrcs", qg, k.to(torch.float32)) * D ** -0.5
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, None, :]
    kp = kv_pos[:, :, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if sliding_window is not None:
        mask &= kp > qp - sliding_window
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    p = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)     # (B, Hkv, rep, C, S)
    pv = p if v_scale is None else p * v_scale[:, :, None, None, :]
    out = torch.einsum("bhrcs,bhsd->bhrcd", pv, v.to(torch.float32))
    out = out.to(q.dtype).reshape(B, Hq, C, D)
    if not need_scores:
        return out, None, None, None
    p_kv = p.mean(dim=2)                                     # (B, Hkv, C, S)
    return out, p_kv.sum(dim=2), (p_kv * p_kv).sum(dim=2), p_kv[:, :, C - 1]


def fused_chunk_attend(
    q: torch.Tensor,         # (B, Hq, C, D) compute dtype, rotated
    k: torch.Tensor,         # (B, Hkv, S, D) q's dtype, or int8 with scales
    v: torch.Tensor,         # (B, Hkv, S, D)
    kv_pos: torch.Tensor,    # (B, Hkv, S) int32, -1 = invalid slot
    q_pos: torch.Tensor,     # (B, C) int32, -1 = padding query
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 (int8 K/V)
    v_scale: Optional[torch.Tensor] = None,
    *,
    need_scores: bool = True,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Returns (out (B, Hq, C, D) in q's dtype, ssum, ssq, last (B, Hkv, S)
    f32); the three statistics are None without need_scores. Padding query
    rows give an out of exactly 0. One launch is counted per call (with
    need_scores, the statistics launch follows the attention's on the
    current stream)."""
    if q.device.type == "cpu":
        return fused_chunk_attend_plain(q, k, v, kv_pos, q_pos, k_scale, v_scale,
                                        need_scores=need_scores,
                                        sliding_window=sliding_window)
    lib, quant, out, stats, ml, part, nsplit = _prepare(q, k, v, kv_pos, q_pos, k_scale,
                                                        v_scale, need_scores)
    B, Hq, C, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    err = lib.chunk_attend(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), out.data_ptr(), *map(_ptr, stats), _ptr(ml), _ptr(part),
        B, Hkv, Hq // Hkv, C, S, D, nsplit, D ** -0.5, _window(sliding_window),
        _Q_DTYPES[q.dtype], int(quant), _build.stream_of(q))
    _build.check(err, "chunk_attend")
    fused_chunk_attend.launches += 1
    return (out, *stats)


fused_chunk_attend.launches = 0


def _ptr(t):
    return None if t is None else t.data_ptr()


def _window(sliding_window) -> int:
    return 0 if sliding_window is None else int(sliding_window)


def _check(checks, device) -> None:
    """checks: (name, tensor, dtype, shape); all contiguous on `device`."""
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: chunk attention takes contiguous tensors on one device")


def _prepare(q, k, v, kv_pos, q_pos, k_scale, v_scale, need_scores):
    """Checks K5's arguments (K6's cache half too) and allocates its
    results: (library, quantized, out, [ssum, ssq, last] or Nones, the
    statistics launch's (B, Hq, C, 2) f32 scratch of each query row's final
    softmax max and sum or None, the (nsplit, B Hq C, D + 2) f32 scratch of
    the attention runs' partials or None, nsplit)."""
    B, Hq, C, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if Hq % Hkv != 0 or not 1 <= Hq // Hkv <= MAX_REP:
        raise ValueError(f"chunk attention takes 1..{MAX_REP} query heads per KV head, "
                         f"got Hq={Hq} Hkv={Hkv}")
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"chunk attention takes float32 or bfloat16 queries, got {q.dtype}")
    if D not in (64, 128):
        raise ValueError(f"chunk attention takes head_dim 64 or 128, got {D}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V come with k_scale and v_scale; a float cache with neither")
    checks = [("q", q, q.dtype, (B, Hq, C, D)),
              ("k", k, k.dtype if quant else q.dtype, (B, Hkv, S, D)),
              ("v", v, k.dtype, (B, Hkv, S, D)),
              ("kv_pos", kv_pos, torch.int32, (B, Hkv, S)),
              ("q_pos", q_pos, torch.int32, (B, C))]
    if quant:
        checks += [("k_scale", k_scale, torch.float32, (B, Hkv, S)),
                   ("v_scale", v_scale, torch.float32, (B, Hkv, S))]
    _check(checks, q.device)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    lib = _build.load("chunk_attention", SIGNATURES)
    smem = lib.chunk_attend_smem(D, _Q_DTYPES[q.dtype], int(quant))
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"head_dim {D} needs {smem} bytes of shared memory "
                         f"(limit {_build.SMEM_LIMIT})")
    out = torch.empty_like(q)
    nsplit = attend_splits(B, Hkv, Hq // Hkv, C, S, q.dtype == torch.float32)
    part = (torch.empty((nsplit, B * Hq * C, D + 2), dtype=torch.float32, device=q.device)
            if nsplit > 1 else None)
    if not need_scores:
        return lib, quant, out, [None] * 3, None, part, nsplit
    stats = list(torch.zeros((3, B, Hkv, S), dtype=torch.float32, device=q.device).unbind(0))
    ml = torch.empty((B, Hq, C, 2), dtype=torch.float32, device=q.device)
    return lib, quant, out, stats, ml, part, nsplit


def fused_chunk_write_attend_plain(
    q, k_c, v_c, ids, q_pos, counter_init, k, v, kv_pos, score, score_sq, counter,
    k_scale=None, v_scale=None, *, need_scores: bool = True,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K6; same arguments and results."""
    write_tokens_at(KVCache(k, v, kv_pos, score, score_sq, counter, k_scale, v_scale),
                    k_c, v_c, q_pos, counter_init, ids)
    return fused_chunk_attend_plain(q, k, v, kv_pos, q_pos, k_scale, v_scale,
                                    need_scores=need_scores, sliding_window=sliding_window)


def fused_chunk_write_attend(
    q: torch.Tensor,             # (B, Hq, C, D) compute dtype, rotated
    k_c: torch.Tensor,           # (B, Hkv, C, D) the chunk's keys, q's dtype, rotated
    v_c: torch.Tensor,           # (B, Hkv, C, D)
    ids: torch.Tensor,           # (B, Hkv, C) int32 distinct target slots per head
    q_pos: torch.Tensor,         # (B, C) int32 positions of the chunk's tokens
    counter_init: torch.Tensor,  # (B, C) f32 initial counters, any sign
    k: torch.Tensor,             # (B, Hkv, S, D) cache, q's dtype or int8; in place
    v: torch.Tensor,
    kv_pos: torch.Tensor,        # (B, Hkv, S) int32; in place
    score: torch.Tensor,         # (B, Hkv, S) f32; in place
    score_sq: torch.Tensor,
    counter: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 (int8 K/V); in place
    v_scale: Optional[torch.Tensor] = None,
    *,
    need_scores: bool = True,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, ...]:
    """Writes the chunk into the cache at `ids` (int8: quantized, with its
    scales), sets pos = q_pos, counter = counter_init, score = score_sq = 0
    there, then attends over the updated cache. Returns (out (B, Hq, C, D),
    ssum, ssq, last (B, Hkv, S) f32 or Nones), as fused_chunk_attend. One
    launch is counted per call (the row write, the attention and, with
    need_scores, the statistics run back to back on the current stream)."""
    if q.device.type == "cpu":
        return fused_chunk_write_attend_plain(
            q, k_c, v_c, ids, q_pos, counter_init, k, v, kv_pos, score, score_sq, counter,
            k_scale, v_scale, need_scores=need_scores, sliding_window=sliding_window)
    lib, quant, out, stats, ml, part, nsplit = _prepare(q, k, v, kv_pos, q_pos, k_scale,
                                                        v_scale, need_scores)
    B, Hq, C, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    _check([("k_c", k_c, q.dtype, (B, Hkv, C, D)), ("v_c", v_c, q.dtype, (B, Hkv, C, D)),
            ("ids", ids, torch.int32, (B, Hkv, C)),
            ("counter_init", counter_init, torch.float32, (B, C)),
            ("score", score, torch.float32, (B, Hkv, S)),
            ("score_sq", score_sq, torch.float32, (B, Hkv, S)),
            ("counter", counter, torch.float32, (B, Hkv, S))], q.device)
    err = lib.chunk_write_attend(
        q.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), ids.data_ptr(), q_pos.data_ptr(),
        counter_init.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(),
        score.data_ptr(), score_sq.data_ptr(), counter.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), out.data_ptr(), *map(_ptr, stats), _ptr(ml), _ptr(part), B, Hkv,
        Hq // Hkv, C, S, D, nsplit, D ** -0.5, _window(sliding_window), _Q_DTYPES[q.dtype],
        int(quant), _build.stream_of(q))
    _build.check(err, "chunk_write_attend")
    fused_chunk_write_attend.launches += 1
    return (out, *stats)


fused_chunk_write_attend.launches = 0


def _write_masked(cache: KVCache, k_c, v_c, q_pos, counter_init, write_mask) -> None:
    """write_tokens_at into the slots of write_mask: row r into the r-th set
    slot in ascending order; rows past the mask's count are dropped, set
    slots past the C-th are left alone. No host sync (a CUDA graph can
    capture it): a dropped row goes to a slot outside the mask and that
    slot's old values are put back."""
    B, H, C, _ = k_c.shape
    S = write_mask.shape[-1]
    iota = torch.arange(S, dtype=torch.int32, device=write_mask.device)
    key = torch.where(write_mask != 0, iota, S + iota)
    ids = key.sort(dim=-1).values[..., :C]
    live = ids < S                                                     # (B, H, C)
    ids = torch.where(live, ids, ids - S).to(torch.int32)
    idx = (torch.arange(B, device=k_c.device)[:, None, None],
           torch.arange(H, device=k_c.device)[None, :, None], ids.long())
    before = [None if t is None else t[idx].clone() for t in (
        cache.k, cache.v, cache.pos, cache.score, cache.score_sq, cache.counter,
        cache.k_scale, cache.v_scale)]
    write_tokens_at(cache, k_c, v_c, q_pos, counter_init, ids)
    for t, old in zip((cache.k, cache.v, cache.pos, cache.score, cache.score_sq,
                       cache.counter, cache.k_scale, cache.v_scale), before):
        if t is not None:
            keep = live if old.dim() == 3 else live[..., None]
            t[idx] = torch.where(keep, t[idx], old)


def chunk_step_evict_plain(cache: KVCache, ssum, ssq, update_gate, evict_gate, next_pos,
                           next_start, *, policy: str, C: int, feasible_k: int = 0,
                           sink: int = 0, recent_window: int = 0) -> torch.Tensor:
    """K7's second half on one layer's cache, in place, from a chunk's
    statistics: the score update under update_gate, counter += C under
    evict_gate (rows whose gate is off keep their counters bit for bit), the
    encode-phase selection of `policy`, pos = -1 at the victims of the gated
    rows. Returns the next write mask (B, H, S) int32: the victims, or
    [next_start, next_start + C) where the gate is off."""
    spec = PolicySpec(policy, PHASE_ENCODE, C, sink, recent_window, feasible_k=feasible_k)
    update_scores_reduced(cache, ssum, ssq, ssum, spec, update_gate)
    eg = evict_gate[:, None, None]
    cache.counter.copy_(torch.where(eg, cache.counter + float(C), cache.counter))
    zero = torch.zeros_like(next_pos)
    ids = select_evictions(cache, spec, next_pos, zero, zero)
    evict_slots(cache, ids, evict_gate)
    victims = torch.zeros_like(cache.pos).scatter_(-1, ids.long(), 1)
    iota = torch.arange(cache.pos.shape[-1], dtype=torch.int32, device=cache.pos.device)
    start = next_start[:, None, None]
    window = ((iota >= start) & (iota < start + C)).to(torch.int32)
    return torch.where(eg, victims, window)


def fused_chunk_step_plain(
    q, k_c, v_c, write_mask, q_pos, counter_init, update_gate, evict_gate, next_pos,
    next_start, k, v, kv_pos, score, score_sq, counter, k_scale=None, v_scale=None, *,
    policy: str, feasible_k: int = 0, sink: int = 0, recent_window: int = 0,
    sliding_window: Optional[int] = None,
):
    """Plain PyTorch version of K7; same arguments and results."""
    cache = KVCache(k, v, kv_pos, score, score_sq, counter, k_scale, v_scale)
    _write_masked(cache, k_c, v_c, q_pos, counter_init, write_mask)
    out, ssum, ssq, _ = fused_chunk_attend_plain(q, k, v, kv_pos, q_pos, k_scale, v_scale,
                                                 sliding_window=sliding_window)
    wm = chunk_step_evict_plain(cache, ssum, ssq, update_gate, evict_gate, next_pos,
                                next_start, policy=policy, C=q.shape[2],
                                feasible_k=feasible_k, sink=sink, recent_window=recent_window)
    return out, _cache_arrays(cache), wm


def _cache_arrays(cache: KVCache) -> Tuple[torch.Tensor, ...]:
    arrs = (cache.k, cache.v, cache.pos, cache.score, cache.score_sq, cache.counter)
    return arrs if cache.k_scale is None else arrs + (cache.k_scale, cache.v_scale)


def fused_chunk_step(
    q: torch.Tensor,             # (B, Hq, C, D) compute dtype, rotated
    k_c: torch.Tensor,           # (B, Hkv, C, D) the chunk's keys, q's dtype, rotated
    v_c: torch.Tensor,           # (B, Hkv, C, D)
    write_mask: torch.Tensor,    # (B, Hkv, S) int32, nonzero at this chunk's slots
    q_pos: torch.Tensor,         # (B, C) int32
    counter_init: torch.Tensor,  # (B, C) f32, any sign
    update_gate: torch.Tensor,   # (B,) bool
    evict_gate: torch.Tensor,    # (B,) bool
    next_pos: torch.Tensor,      # (B,) int32 the position the next token gets
    next_start: torch.Tensor,    # (B,) int32 the next contiguous window's start
    k: torch.Tensor,             # (B, Hkv, S, D) cache, q's dtype or int8; in place
    v: torch.Tensor,
    kv_pos: torch.Tensor,        # (B, Hkv, S) int32; in place
    score: torch.Tensor,         # (B, Hkv, S) f32; in place
    score_sq: torch.Tensor,
    counter: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 (int8 K/V); in place
    v_scale: Optional[torch.Tensor] = None,
    *,
    policy: str,                 # 'roco' or 'h2o_head'
    feasible_k: int = 0,
    sink: int = 0,
    recent_window: int = 0,
    sliding_window: Optional[int] = None,
):
    """One strided-encode chunk of roco or h2o_head: write, attend, score
    update, gated eviction of C slots a (batch, kv-head). Returns (out
    (B, Hq, C, D), the cache arrays (k, v, pos, score, score_sq, counter
    [, k_scale, v_scale]) updated in place, the next write mask (B, Hkv, S)
    int32). One launch is counted per call (the row write, the attention,
    the statistics and the step run back to back on the current stream)."""
    if policy not in STEP_POLICIES:
        raise ValueError(f"the chunk step takes policies {STEP_POLICIES}, got {policy!r}")
    if q.device.type == "cpu":
        return fused_chunk_step_plain(
            q, k_c, v_c, write_mask, q_pos, counter_init, update_gate, evict_gate, next_pos,
            next_start, k, v, kv_pos, score, score_sq, counter, k_scale, v_scale,
            policy=policy, feasible_k=feasible_k, sink=sink, recent_window=recent_window,
            sliding_window=sliding_window)
    lib, quant, out, stats, ml, part, nsplit = _prepare(q, k, v, kv_pos, q_pos, k_scale,
                                                        v_scale, True)
    B, Hq, C, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if C > S:
        raise ValueError(f"the chunk step writes {C} rows into {S} slots")
    smem = lib.chunk_step_smem(S)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"the chunk step's block holds S={S} slots in {smem} bytes of shared "
                         f"memory (limit {_build.SMEM_LIMIT})")
    _check([("k_c", k_c, q.dtype, (B, Hkv, C, D)), ("v_c", v_c, q.dtype, (B, Hkv, C, D)),
            ("write_mask", write_mask, torch.int32, (B, Hkv, S)),
            ("counter_init", counter_init, torch.float32, (B, C)),
            ("update_gate", update_gate, torch.bool, (B,)),
            ("evict_gate", evict_gate, torch.bool, (B,)),
            ("next_pos", next_pos, torch.int32, (B,)),
            ("next_start", next_start, torch.int32, (B,)),
            ("score", score, torch.float32, (B, Hkv, S)),
            ("score_sq", score_sq, torch.float32, (B, Hkv, S)),
            ("counter", counter, torch.float32, (B, Hkv, S))], q.device)
    wm_next = torch.empty_like(write_mask)
    err = lib.chunk_step(
        q.data_ptr(), k_c.data_ptr(), v_c.data_ptr(), write_mask.data_ptr(), q_pos.data_ptr(),
        counter_init.data_ptr(), update_gate.data_ptr(), evict_gate.data_ptr(),
        next_pos.data_ptr(), next_start.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_pos.data_ptr(), score.data_ptr(), score_sq.data_ptr(), counter.data_ptr(),
        _ptr(k_scale), _ptr(v_scale), out.data_ptr(), *map(_ptr, stats), _ptr(ml), _ptr(part),
        wm_next.data_ptr(), B, Hkv, Hq // Hkv, C, S, D, nsplit, D ** -0.5,
        _window(sliding_window),
        _Q_DTYPES[q.dtype], int(quant), int(policy == "roco"), int(feasible_k), int(sink),
        int(recent_window), _build.stream_of(q))
    _build.check(err, "chunk_step")
    fused_chunk_step.launches += 1
    cache = KVCache(k, v, kv_pos, score, score_sq, counter, k_scale, v_scale)
    return out, _cache_arrays(cache), wm_next


fused_chunk_step.launches = 0


def _sharded_specs(d, m):
    """(p4, p3, pB, p1, pq): q's heads are rep for each local kv-head, so
    only its batch is checked against the others."""
    return (d, m, None, None), (d, m, None), (d, None), (d,), (d, None, None, None)


def fused_chunk_attend_sharded(q, k, v, kv_pos, q_pos, k_scale=None, v_scale=None, *, mesh,
                               data_axis: str = "data", model_axis: str = "model",
                               need_scores: bool = True, sliding_window: Optional[int] = None):
    """fused_chunk_attend on this rank's shards. in_specs: q, k, v
    (d, m, ., .); kv_pos and the scales (d, m, .); q_pos (d, .). out_specs:
    out (d, m, ., .), ssum, ssq, last (d, m, .)."""
    p4, p3, pB, _, pq = _sharded_specs(data_axis, model_axis)
    local_dims("fused_chunk_attend_sharded", mesh, data_axis, model_axis, [
        ("q", q, pq), ("k", k, p4), ("v", v, p4), ("kv_pos", kv_pos, p3), ("q_pos", q_pos, pB),
        ("k_scale", k_scale, p3), ("v_scale", v_scale, p3)])
    res = fused_chunk_attend(q, k, v, kv_pos, q_pos, k_scale, v_scale,
                             need_scores=need_scores, sliding_window=sliding_window)
    if q.is_cuda:
        fused_chunk_attend_sharded.launches += 1
    return res


fused_chunk_attend_sharded.launches = 0


def fused_chunk_write_attend_sharded(q, k_c, v_c, ids, q_pos, counter_init, k, v, kv_pos, score,
                                     score_sq, counter, k_scale=None, v_scale=None, *, mesh,
                                     data_axis: str = "data", model_axis: str = "model",
                                     need_scores: bool = True,
                                     sliding_window: Optional[int] = None):
    """fused_chunk_write_attend on this rank's shards. in_specs: q, k_c, v_c,
    k, v (d, m, ., .); ids, kv_pos, score, score_sq, counter, the scales
    (d, m, .); q_pos, counter_init (d, .). out_specs as fused_chunk_attend's;
    the cache arrays are updated in place."""
    p4, p3, pB, _, pq = _sharded_specs(data_axis, model_axis)
    local_dims("fused_chunk_write_attend_sharded", mesh, data_axis, model_axis, [
        ("q", q, pq), ("k_c", k_c, p4), ("v_c", v_c, p4), ("ids", ids, p3), ("q_pos", q_pos, pB),
        ("counter_init", counter_init, pB), ("k", k, p4), ("v", v, p4), ("kv_pos", kv_pos, p3),
        ("score", score, p3), ("score_sq", score_sq, p3), ("counter", counter, p3),
        ("k_scale", k_scale, p3), ("v_scale", v_scale, p3)])
    res = fused_chunk_write_attend(q, k_c, v_c, ids, q_pos, counter_init, k, v, kv_pos, score,
                                   score_sq, counter, k_scale, v_scale,
                                   need_scores=need_scores, sliding_window=sliding_window)
    if q.is_cuda:
        fused_chunk_write_attend_sharded.launches += 1
    return res


fused_chunk_write_attend_sharded.launches = 0


def fused_chunk_step_sharded(q, k_c, v_c, write_mask, q_pos, counter_init, update_gate,
                             evict_gate, next_pos, next_start, k, v, kv_pos, score, score_sq,
                             counter, k_scale=None, v_scale=None, *, mesh,
                             data_axis: str = "data", model_axis: str = "model", policy: str,
                             feasible_k: int = 0, sink: int = 0, recent_window: int = 0,
                             sliding_window: Optional[int] = None):
    """fused_chunk_step on this rank's shards. in_specs: q, k_c, v_c, k, v
    (d, m, ., .); write_mask, kv_pos, score, score_sq, counter, the scales
    (d, m, .); q_pos, counter_init (d, .); update_gate, evict_gate,
    next_pos, next_start (d). out_specs: out (d, m, ., .), the cache arrays
    as their inputs, the next write mask (d, m, .)."""
    p4, p3, pB, p1, pq = _sharded_specs(data_axis, model_axis)
    local_dims("fused_chunk_step_sharded", mesh, data_axis, model_axis, [
        ("q", q, pq), ("k_c", k_c, p4), ("v_c", v_c, p4), ("write_mask", write_mask, p3),
        ("q_pos", q_pos, pB), ("counter_init", counter_init, pB),
        ("update_gate", update_gate, p1), ("evict_gate", evict_gate, p1),
        ("next_pos", next_pos, p1), ("next_start", next_start, p1), ("k", k, p4), ("v", v, p4),
        ("kv_pos", kv_pos, p3), ("score", score, p3), ("score_sq", score_sq, p3),
        ("counter", counter, p3), ("k_scale", k_scale, p3), ("v_scale", v_scale, p3)])
    res = fused_chunk_step(q, k_c, v_c, write_mask, q_pos, counter_init, update_gate, evict_gate,
                           next_pos, next_start, k, v, kv_pos, score, score_sq, counter, k_scale,
                           v_scale, policy=policy, feasible_k=feasible_k, sink=sink,
                           recent_window=recent_window, sliding_window=sliding_window)
    if q.is_cuda:
        fused_chunk_step_sharded.launches += 1
    return res


fused_chunk_step_sharded.launches = 0
