"""Per-step sidecar pass with the folded eviction (kernel K2) and the
stand-alone gated eviction event (kernel K4).

CUDA kernels: easykv_tpu_torch/csrc/sidecar_update.cu, which replace the
TPU kernels easykv_tpu/ops/pallas/sidecar_update.py `fused_write_update`
(decode phase, k = 1; with an int8 cache it also writes the new rows'
dequant scales; with `compact` it also shifts the sidecars down at each
row's victim, for ordered StreamingLLM decoding) and `fused_evict` (decode
phase, k = 1). Given the step's K and V rows, K2 also writes them at each
row's write slot: the TPU kernel easykv_tpu/ops/pallas/row_write.py
`write_rows`, whose own kernel (K3, ops/cuda/row_write.py) was bound by its
launch, so K2 takes that work into its launch. Both are bound by the bytes
a slot they read and write; the source note says what their design does
about that. Their launch plan,
`row_plan`, gives each row of up to 768 slots a warp that holds it in
registers, and past that a block that holds it in shared memory.

`fused_write_update` and `fused_evict` launch their kernels for CUDA
tensors and run `fused_write_update_plain` / `fused_evict_plain` for CPU
tensors. The plain versions repeat the TPU kernels' arithmetic op by op
(`_first_min_idx`, `_kth_smallest_bits`, `_select_victim`, `_write_kernel`,
`_evict_kernel`; the rows by row_write.write_rows_plain), so the kernels
are held to them bit for bit. All update the sidecars (the scale rows, the
K / V rows) in place.

`fused_write_update_sharded` and `fused_evict_sharded` are K2 and K4 under
a (data, model) mesh (the TPU wrappers sidecar_update.py:360 and :472, a
shard_map of each kernel): every (layer, row, kv-head) is independent, so
each rank launches the kernel on its own (L, B/d, Hkv/m, S) shard, with no
collective. As there, the sharded K2 does not fold the eviction: the
engine runs fused_evict_sharded after it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ...cache import free_slot_ids
from ...parallel.mesh import local_dims
from ...policies import (INT_MAX, PHASE_DECODE, ROCO_STD_GUARD, STD_EXCLUDE,
                         STD_FORCE, PolicySpec)
from . import _build
from .row_write import write_rows_plain

POLICY_CODES = {None: 0, "full": 0, "h2o_head": 1, "roco": 2, "tova": 3,
                "recency": 4, "random": 5}

_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "write_update": ([_vp] * 24 + [_int] * 14 + [_vp], _int),
    "sidecar_smem": ([_int] * 2, ctypes.c_size_t),
    "evict": ([_vp] * 8 + [_int] * 11 + [_vp], _int),
}

LANE_CHUNKS = (2, 4, 6)   # 4-slot chunks a lane holds: the kernel's instantiations
WIDE_WARPS = 8            # the wide path's block: 8 warps a row
ROWS_A_BLOCK = 4          # rows a block where one warp owns a row


class RowPlan(NamedTuple):
    warps: int     # warps that own a row
    chunks: int    # 4-slot chunks a lane holds in registers; 0: the wide path
    rows: int      # rows a block
    threads: int   # threads a block
    smem: int      # dynamic shared memory a block, bytes


def row_plan(S: int) -> RowPlan:
    """K2's and K4's launch plan for rows of S slots (sidecar_update.cu
    takes it and checks it). Up to 768 slots a row lies in one warp's
    registers, 24 a lane at most: each lane the fewest chunks of
    LANE_CHUNKS that cover it, ROWS_A_BLOCK rows a block. Past that, the
    wide path: a block of WIDE_WARPS warps a row, the row in shared memory
    (20 bytes a slot)."""
    if S > 128 * LANE_CHUNKS[-1]:
        return RowPlan(WIDE_WARPS, 0, 1, 32 * WIDE_WARPS, 20 * S)
    chunks = next(c for c in LANE_CHUNKS if 128 * c >= S)
    return RowPlan(1, chunks, ROWS_A_BLOCK, 32 * ROWS_A_BLOCK, 0)


def lane_slots(plan: RowPlan, S: int, warp: int, lane: int) -> list:
    """The slots of a row that one lane of the register path holds, in its
    order: chunk j of lane t covers slots 4 (t + 32 j) .. 4 (t + 32 j) + 3
    (those at or past S are padding); the wide path strides a thread
    t = 32 warp + lane's slots by the block."""
    t, T = 32 * warp + lane, 32 * plan.warps
    if plan.chunks == 0:
        return list(range(t, S, T))
    return [s for j in range(plan.chunks) for s in range(4 * (t + T * j), 4 * (t + T * j) + 4)
            if s < S]


def _plan_for(S: int) -> RowPlan:
    plan = row_plan(S)
    if plan.smem > _build.SMEM_LIMIT:
        raise ValueError(f"S={S} slots need {plan.smem} bytes of shared memory "
                         f"(limit {_build.SMEM_LIMIT})")
    return plan


def evict_supported(spec: Optional[PolicySpec]) -> bool:
    """Decode-phase k=1 selections, the ones the kernels implement."""
    return (spec is not None and spec.phase == PHASE_DECODE and spec.k == 1
            and spec.policy in POLICY_CODES and spec.policy != "full")


def _check_espec(espec: Optional[PolicySpec]) -> None:
    if espec is not None and not evict_supported(espec):
        raise NotImplementedError(
            f"folded eviction covers decode-phase k=1 policies, got {espec}")


def _shift_down(x: torch.Tensor, ge: torch.Tensor) -> torch.Tensor:
    """x[..., s] <- x[..., (s + 1) % S] where ge, along the last axis (the
    TPU kernels' roll by -1 and select)."""
    return torch.where(ge, torch.roll(x, -1, dims=-1), x)


def _first_min_idx(val: torch.Tensor) -> torch.Tensor:
    """Index of the first occurrence of the minimum along the last axis
    (NaN-propagating: a NaN minimum matches nothing and gives S)."""
    S = val.shape[-1]
    m = val.amin(dim=-1, keepdim=True)
    iota = torch.arange(S, dtype=torch.int32, device=val.device)
    return torch.where(val == m, iota, S).amin(dim=-1, keepdim=True)


def _kth_smallest_bits(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th smallest of non-negative int32 `bits` along the last axis,
    by a 31-step bisection over the bit pattern. k broadcasts to (..., 1)."""
    prefix = torch.zeros(bits.shape[:-1] + (1,), dtype=torch.int32, device=bits.device)
    for i in range(31):
        cand = prefix | (1 << (30 - i))
        cnt = (bits < cand).sum(dim=-1, keepdim=True, dtype=torch.int32)
        prefix = torch.where(cnt >= k, prefix, cand)
    return prefix


def _select_victim(pos, score, ssq, counter, next_pos, prompt_len, rand_rank,
                   spec: PolicySpec) -> torch.Tensor:
    """Per-row eviction victim (..., 1) over (..., S); `counter` already
    bumped. Per-b scalars come shaped to broadcast over (L, B, H, 1)."""
    S = pos.shape[-1]
    iota = torch.arange(S, dtype=torch.int32, device=pos.device)
    inf = float("inf")
    base = pos >= 0
    if spec.protect_prompt:
        base = base & (pos >= prompt_len)
    if spec.policy in ("h2o_head", "tova"):
        cand = base
        if spec.policy == "h2o_head":
            cand = cand & (pos < next_pos - spec.recent_window)
        return _first_min_idx(torch.where(cand, score, inf))
    if spec.policy == "recency":
        return _first_min_idx(torch.where(base, pos.to(torch.float32), inf))
    if spec.policy == "random":
        p_masked = torch.where(base, pos, INT_MAX)
        target = _kth_smallest_bits(p_masked, rand_rank + 1)
        return _first_min_idx(torch.where(p_masked == target, iota, S))
    # roco
    mean = score / counter
    var = ssq / counter - mean * mean
    std = torch.sqrt(var.clamp(min=0.0))    # clamp keeps NaN, as jnp.maximum
    forced = pos >= next_pos - ROCO_STD_GUARD
    force_val = STD_FORCE + pos.to(torch.float32) * 1024.0
    std = torch.where(forced, force_val, std)
    std = torch.where(base, std, STD_EXCLUDE)
    bits = std.view(torch.int32)   # stds are >= 0: the bit pattern keeps order
    kth = _kth_smallest_bits(bits, max(spec.feasible_k, 1))
    avg = score / counter
    return _first_min_idx(torch.where(bits <= kth, avg, inf))


def fused_write_update_plain(
    pos, score, score_sq, counter, probs, p_new, q_pos, token_valid,
    update_gate, counter_init, policy: Optional[str],
    espec: Optional[PolicySpec] = None, evict_gate=None, next_pos=None,
    prompt_len=None, rand_rank=None, k_sc_new=None, v_sc_new=None, k_scale=None,
    v_scale=None, compact: bool = False, k=None, v=None, kn=None, vn=None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel; same arguments and results:
    the sidecar pass, then with the rows write_rows_plain at the write
    slot of each live row."""
    _check_espec(espec)
    if compact and espec is None:
        raise ValueError("compact needs espec")
    S = pos.shape[-1]

    def per_b(x):
        return x[None, :, None, None]

    slot = free_slot_ids(pos, 1)                                    # (L, B, H, 1)
    g_upd = per_b(update_gate)
    gf = g_upd.to(torch.float32)
    pn = p_new
    s_new = torch.zeros_like(pn)
    sq_new = torch.zeros_like(pn)
    sc, sq = score, score_sq
    if policy in ("h2o_head", "roco"):
        sc = sc + probs * gf
        s_new = pn * gf
        if policy == "roco":
            sq = sq + probs * probs * gf
            sq_new = pn * pn * gf
    elif policy == "tova":
        sc = torch.where(g_upd, probs, sc)
        s_new = pn * gf

    iota = torch.arange(S, dtype=torch.int32, device=pos.device)
    at_slot = (iota == slot) & per_b(token_valid)
    if k_scale is not None:
        k_scale.copy_(torch.where(at_slot, k_sc_new, k_scale))
        v_scale.copy_(torch.where(at_slot, v_sc_new, v_scale))
    new_pos = torch.where(at_slot, per_b(q_pos), pos)
    new_cnt = torch.where(at_slot, per_b(counter_init), counter)
    sc = torch.where(at_slot, s_new, sc)
    sq = torch.where(at_slot, sq_new, sq)

    vslot = None
    if espec is not None:
        g_evt = per_b(evict_gate)
        cb = new_cnt + 1.0
        victim = _select_victim(new_pos, sc, sq, cb, per_b(next_pos),
                                per_b(prompt_len), per_b(rand_rank), espec)
        if compact:
            ge = g_evt & (iota >= victim)
            new_pos = torch.where(g_evt & (iota == S - 1), -1, _shift_down(new_pos, ge))
            sc, sq = _shift_down(sc, ge), _shift_down(sq, ge)
            vslot = torch.where(g_evt, victim, S).to(torch.int32)
        else:
            new_pos = torch.where(g_evt & (iota == victim), -1, new_pos)
        new_cnt = torch.where(g_evt, cb, new_cnt)
        if compact:
            new_cnt = _shift_down(new_cnt, ge)

    pos.copy_(new_pos)
    score.copy_(sc)
    score_sq.copy_(sq)
    counter.copy_(new_cnt)
    if k is not None:
        # a dead row writes back the rows its write slot holds
        at = slot[..., None].long().expand(kn.shape)
        live = per_b(token_valid)[..., None]
        write_rows_plain(k, v, torch.where(live, kn, k.gather(3, at)),
                         torch.where(live, vn, v.gather(3, at)), slot[..., 0])
    res = (pos, score, score_sq, counter, slot)
    if k_scale is not None:
        res += (k_scale, v_scale)
    return res + ((vslot,) if compact else ())


def fused_write_update(
    pos: torch.Tensor,          # (L, B, H, S) int32
    score: torch.Tensor,        # (L, B, H, S) f32
    score_sq: torch.Tensor,     # (L, B, H, S) f32
    counter: torch.Tensor,      # (L, B, H, S) f32
    probs: torch.Tensor,        # (L, B, H, S) f32 GQA-mean attention mass
    p_new: torch.Tensor,        # (L, B, H, 1) f32 in-flight token's probability
    q_pos: torch.Tensor,        # (B,) int32
    token_valid: torch.Tensor,  # (B,) bool
    update_gate: torch.Tensor,  # (B,) bool
    counter_init: torch.Tensor,  # (B,) f32
    policy: Optional[str],
    espec: Optional[PolicySpec] = None,       # fold the gated eviction event
    evict_gate: Optional[torch.Tensor] = None,  # (B,) bool
    next_pos: Optional[torch.Tensor] = None,    # (B,) int32
    prompt_len: Optional[torch.Tensor] = None,  # (B,) int32
    rand_rank: Optional[torch.Tensor] = None,   # (B,) int32
    k_sc_new: Optional[torch.Tensor] = None,    # (L, B, H, 1) f32 new rows' K
    v_sc_new: Optional[torch.Tensor] = None,    # and V dequant scales (int8 KV)
    k_scale: Optional[torch.Tensor] = None,     # (L, B, H, S) f32, updated
    v_scale: Optional[torch.Tensor] = None,     # in place
    compact: bool = False,                      # ordered streaming: shift at the victim
    k: Optional[torch.Tensor] = None,           # (L, B, H, S, Dh) cache K and V: with
    v: Optional[torch.Tensor] = None,           # kn, vn the rows are written
    kn: Optional[torch.Tensor] = None,          # (L, B, H, 1, Dh) the step's rows, the
    vn: Optional[torch.Tensor] = None,          # cache's dtype
) -> Tuple[torch.Tensor, ...]:
    """Slot select, score update, new-row sidecar write, (with espec) the
    gated eviction and (with k, v, kn, vn) the step's K / V rows at the
    write slot, whether the row is live or not, in place. Returns (pos, score, score_sq, counter,
    write_slot (L, B, H, 1) int32), then (k_scale, v_scale) when the scale
    rows are given, then with `compact` the victim slot (L, B, H, 1) int32
    (S: no eviction). pos and counter are post-eviction (and post-shift);
    the write slot stays the pre-shift one, where the caller writes the
    step's K/V rows before shifting them with fused_kv_compact. A dead row
    (token_valid off) is left as it was: no sidecar, scale or K / V row is
    written (the JAX package's XLA decode write; its TPU kernel writes the
    scales and rows of a dead row into a slot whose pos stays < 0)."""
    if pos.device.type == "cpu":
        return fused_write_update_plain(
            pos, score, score_sq, counter, probs, p_new, q_pos, token_valid,
            update_gate, counter_init, policy, espec, evict_gate, next_pos,
            prompt_len, rand_rank, k_sc_new, v_sc_new, k_scale, v_scale, compact, k, v, kn, vn)
    _check_espec(espec)
    if compact and espec is None:
        raise ValueError("compact needs espec")
    L, B, H, S = pos.shape
    full = (L, B, H, S)
    checks = [(pos, torch.int32, full), (score, torch.float32, full),
              (score_sq, torch.float32, full), (counter, torch.float32, full),
              (probs, torch.float32, full), (p_new, torch.float32, (L, B, H, 1)),
              (q_pos, torch.int32, (B,)), (token_valid, torch.bool, (B,)),
              (update_gate, torch.bool, (B,)), (counter_init, torch.float32, (B,))]
    if espec is not None:
        checks += [(evict_gate, torch.bool, (B,)), (next_pos, torch.int32, (B,)),
                   (prompt_len, torch.int32, (B,)), (rand_rank, torch.int32, (B,))]
    scales = (k_sc_new, v_sc_new, k_scale, v_scale)
    with_scales = k_scale is not None
    if any((t is None) == with_scales for t in scales):
        raise ValueError("scale rows: pass all of k_sc_new, v_sc_new, k_scale, v_scale or none")
    if with_scales:
        checks += [(k_sc_new, torch.float32, (L, B, H, 1)), (v_sc_new, torch.float32, (L, B, H, 1)),
                   (k_scale, torch.float32, full), (v_scale, torch.float32, full)]
    rows = (k, v, kn, vn)
    with_rows = k is not None
    if any((t is None) == with_rows for t in rows):
        raise ValueError("rows: pass all of k, v, kn, vn or none")
    if with_rows:
        Dh = k.shape[-1]
        checks += [(k, k.dtype, full + (Dh,)), (v, k.dtype, full + (Dh,)),
                   (kn, k.dtype, (L, B, H, 1, Dh)), (vn, k.dtype, (L, B, H, 1, Dh))]
        row_bytes = Dh * k.element_size()
        if row_bytes % 16 or any(t.data_ptr() % 16 for t in rows):
            raise ValueError(f"rows: {row_bytes} bytes a row and every base must be "
                             "multiples of 16")
    for t, dtype, shape in checks:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != pos.device
                or not t.is_contiguous()):
            raise ValueError(f"sidecar pass: expected contiguous {dtype} {shape} on "
                             f"{pos.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown policy {policy!r}")
    plan = _plan_for(S)
    lib = _build.load("sidecar_update", SIGNATURES)

    slot = torch.empty((L, B, H, 1), dtype=torch.int32, device=pos.device)
    vslot = torch.empty((L, B, H, 1), dtype=torch.int32, device=pos.device) if compact else None
    ev = espec is not None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.write_update(
        pos.data_ptr(), score.data_ptr(), score_sq.data_ptr(), counter.data_ptr(),
        probs.data_ptr(), p_new.data_ptr(), q_pos.data_ptr(), token_valid.data_ptr(),
        update_gate.data_ptr(), counter_init.data_ptr(), ptr(evict_gate), ptr(next_pos),
        ptr(prompt_len), ptr(rand_rank), *map(ptr, scales), slot.data_ptr(), ptr(vslot),
        *map(ptr, rows), L, B, H, S, POLICY_CODES[policy], int(ev), int(compact),
        espec.recent_window if ev else 0,
        max(espec.feasible_k, 1) if ev else 1, int(bool(espec.protect_prompt)) if ev else 0,
        row_bytes if with_rows else 0, plan.warps, plan.chunks, plan.rows,
        _build.stream_of(pos))
    _build.check(err, "write_update")
    fused_write_update.launches += 1
    if compact:
        fused_write_update.compact_launches += 1
    if with_rows:
        fused_write_update.rows_launches += 1
    res = (pos, score, score_sq, counter, slot)
    if with_scales:
        res += (k_scale, v_scale)
    return res + ((vslot,) if compact else ())


fused_write_update.launches = 0
fused_write_update.compact_launches = 0   # those with `compact`
fused_write_update.rows_launches = 0      # those that write the step's K / V rows


def fused_evict_plain(pos, score, score_sq, counter, evict_gate, next_pos, prompt_len,
                      rand_rank, spec: PolicySpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4; same arguments and results."""
    if not evict_supported(spec):
        raise NotImplementedError(f"fused_evict covers decode-phase k=1 policies, got {spec}")
    S = pos.shape[-1]

    def per_b(x):
        return x[None, :, None, None]

    g = per_b(evict_gate)
    cnt = counter + float(spec.k) * g.to(torch.float32)
    victim = _select_victim(pos, score, score_sq, cnt, per_b(next_pos), per_b(prompt_len),
                            per_b(rand_rank), spec)
    iota = torch.arange(S, dtype=torch.int32, device=pos.device)
    pos.copy_(torch.where(g & (iota == victim), -1, pos))
    counter.copy_(cnt)
    return pos, counter


def fused_evict(
    pos: torch.Tensor,         # (L, B, H, S) int32, updated in place
    score: torch.Tensor,       # (L, B, H, S) f32, read only
    score_sq: torch.Tensor,    # (L, B, H, S) f32, read only
    counter: torch.Tensor,     # (L, B, H, S) f32, updated in place
    evict_gate: torch.Tensor,  # (B,) bool
    next_pos: torch.Tensor,    # (B,) int32
    prompt_len: torch.Tensor,  # (B,) int32
    rand_rank: torch.Tensor,   # (B,) int32
    spec: PolicySpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gated eviction event (decode phase, k = 1) over every layer:
    counter += 1 on the rows whose gate fires, then each such row's victim
    gets pos = -1. Returns (pos, counter). The gate is applied inside the
    kernel: no host check of any(gate)."""
    if pos.device.type == "cpu":
        return fused_evict_plain(pos, score, score_sq, counter, evict_gate, next_pos,
                                 prompt_len, rand_rank, spec)
    if not evict_supported(spec):
        raise NotImplementedError(f"fused_evict covers decode-phase k=1 policies, got {spec}")
    L, B, H, S = pos.shape
    full = (L, B, H, S)
    for t, dtype, shape in ((pos, torch.int32, full), (score, torch.float32, full),
                            (score_sq, torch.float32, full), (counter, torch.float32, full),
                            (evict_gate, torch.bool, (B,)), (next_pos, torch.int32, (B,)),
                            (prompt_len, torch.int32, (B,)), (rand_rank, torch.int32, (B,))):
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != pos.device
                or not t.is_contiguous()):
            raise ValueError(f"fused_evict: expected contiguous {dtype} {shape} on "
                             f"{pos.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    plan = _plan_for(S)
    lib = _build.load("sidecar_update", SIGNATURES)
    err = lib.evict(pos.data_ptr(), score.data_ptr(), score_sq.data_ptr(), counter.data_ptr(),
                    evict_gate.data_ptr(), next_pos.data_ptr(), prompt_len.data_ptr(),
                    rand_rank.data_ptr(), L, B, H, S, POLICY_CODES[spec.policy],
                    spec.recent_window, max(spec.feasible_k, 1), int(bool(spec.protect_prompt)),
                    plan.warps, plan.chunks, plan.rows, _build.stream_of(pos))
    _build.check(err, "evict")
    fused_evict.launches += 1
    return pos, counter


fused_evict.launches = 0


def fused_write_update_sharded(*args, mesh, data_axis: str = "data", model_axis: str = "model",
                               **kw) -> Tuple[torch.Tensor, ...]:
    """fused_write_update (its positional arguments, then policy and its
    keywords) on this rank's shards. in_specs: pos, score, score_sq,
    counter, probs, p_new, the scale rows (., d, m, .), k, v, kn, vn
    (., d, m, ., .); q_pos, token_valid, update_gate, counter_init (d).
    out_specs: each output as its input, the write slot (., d, m, .). No
    folded eviction (espec, compact)."""
    if kw.get("espec") is not None or kw.get("compact"):
        raise ValueError("fused_write_update_sharded does not fold the eviction: run "
                         "fused_evict_sharded after it")
    d, m = data_axis, model_axis
    p4, p5, pb = (None, d, m, None), (None, d, m, None, None), (d,)
    names = ("pos", "score", "score_sq", "counter", "probs", "p_new", "q_pos", "token_valid",
             "update_gate", "counter_init")
    specs = (p4,) * 6 + (pb,) * 4
    checks = [(n, t, s) for n, t, s in zip(names, args, specs) if isinstance(t, torch.Tensor)]
    checks += [(n, kw.get(n), p4) for n in ("k_sc_new", "v_sc_new", "k_scale", "v_scale")]
    checks += [(n, kw.get(n), p5) for n in ("k", "v", "kn", "vn")]
    local_dims("fused_write_update_sharded", mesh, d, m, checks)
    res = fused_write_update(*args, **kw)
    if args[0].is_cuda:
        fused_write_update_sharded.launches += 1
    return res


fused_write_update_sharded.launches = 0


def fused_evict_sharded(pos, score, score_sq, counter, evict_gate, next_pos, prompt_len,
                        rand_rank, *, mesh, data_axis: str = "data", model_axis: str = "model",
                        spec: PolicySpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """fused_evict on this rank's shards. in_specs: pos, score, score_sq,
    counter (., d, m, .); the four row vectors (d). out_specs: pos, counter
    (., d, m, .)."""
    d, m = data_axis, model_axis
    p4, pb = (None, d, m, None), (d,)
    local_dims("fused_evict_sharded", mesh, d, m, [
        ("pos", pos, p4), ("score", score, p4), ("score_sq", score_sq, p4),
        ("counter", counter, p4), ("evict_gate", evict_gate, pb), ("next_pos", next_pos, pb),
        ("prompt_len", prompt_len, pb), ("rand_rank", rand_rank, pb)])
    res = fused_evict(pos, score, score_sq, counter, evict_gate, next_pos, prompt_len,
                      rand_rank, spec)
    if pos.is_cuda:
        fused_evict_sharded.launches += 1
    return res


fused_evict_sharded.launches = 0
