"""Per-step sidecar pass with the folded eviction (kernel K2).

CUDA kernel: easykv_tpu_torch/csrc/sidecar_update.cu, which replaces the
TPU kernel easykv_tpu/ops/pallas/sidecar_update.py `fused_write_update`
(decode phase, k = 1, no compaction; with an int8 cache it also writes the
new rows' dequant scales). It is bound by the 36 bytes a slot it reads and
writes; the source note says what its design does about that.

`fused_write_update` launches the kernel for CUDA tensors and runs
`fused_write_update_plain` for CPU tensors. The plain version repeats the
TPU kernel's arithmetic op by op (`_first_min_idx`, `_kth_smallest_bits`,
`_select_victim`, `_write_kernel`), so the kernel is held to it bit for bit.
Both update pos / score / score_sq / counter (and the scale rows) in place.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...cache import free_slot_ids
from ...policies import (INT_MAX, PHASE_DECODE, ROCO_STD_GUARD, STD_EXCLUDE,
                         STD_FORCE, PolicySpec)
from . import _build

POLICY_CODES = {None: 0, "full": 0, "h2o_head": 1, "roco": 2, "tova": 3,
                "recency": 4, "random": 5}

_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "write_update": ([_vp] * 19 + [_int] * 9 + [_vp], _int),
    "write_update_smem": ([_int], ctypes.c_size_t),
}


def _check_espec(espec: Optional[PolicySpec]) -> None:
    if espec is not None and not (espec.phase == PHASE_DECODE and espec.k == 1
                                  and espec.policy in POLICY_CODES
                                  and espec.policy != "full"):
        raise NotImplementedError(
            f"folded eviction covers decode-phase k=1 policies, got {espec}")


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
    v_scale=None,
) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the kernel; same arguments and results."""
    _check_espec(espec)
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
    if k_scale is not None:
        # unconditional, as in the TPU kernel: a dead row's slot keeps pos < 0
        k_scale.copy_(torch.where(iota == slot, k_sc_new, k_scale))
        v_scale.copy_(torch.where(iota == slot, v_sc_new, v_scale))
    at_slot = (iota == slot) & per_b(token_valid)
    new_pos = torch.where(at_slot, per_b(q_pos), pos)
    new_cnt = torch.where(at_slot, per_b(counter_init), counter)
    sc = torch.where(at_slot, s_new, sc)
    sq = torch.where(at_slot, sq_new, sq)

    if espec is not None:
        g_evt = per_b(evict_gate)
        cb = new_cnt + 1.0
        victim = _select_victim(new_pos, sc, sq, cb, per_b(next_pos),
                                per_b(prompt_len), per_b(rand_rank), espec)
        new_pos = torch.where(g_evt & (iota == victim), -1, new_pos)
        new_cnt = torch.where(g_evt, cb, new_cnt)

    pos.copy_(new_pos)
    score.copy_(sc)
    score_sq.copy_(sq)
    counter.copy_(new_cnt)
    if k_scale is not None:
        return pos, score, score_sq, counter, slot, k_scale, v_scale
    return pos, score, score_sq, counter, slot


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
) -> Tuple[torch.Tensor, ...]:
    """Slot select, score update, new-row sidecar write and (with espec) the
    gated eviction, in place. Returns (pos, score, score_sq, counter,
    write_slot (L, B, H, 1) int32), then (k_scale, v_scale) when the scale
    rows are given; pos and counter are post-eviction. The new scales land
    at the write slot whether or not the row is live."""
    if pos.device.type == "cpu":
        return fused_write_update_plain(
            pos, score, score_sq, counter, probs, p_new, q_pos, token_valid,
            update_gate, counter_init, policy, espec, evict_gate, next_pos,
            prompt_len, rand_rank, k_sc_new, v_sc_new, k_scale, v_scale)
    _check_espec(espec)
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
    for t, dtype, shape in checks:
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != pos.device
                or not t.is_contiguous()):
            raise ValueError(f"sidecar pass: expected contiguous {dtype} {shape} on "
                             f"{pos.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if policy not in POLICY_CODES:
        raise ValueError(f"unknown policy {policy!r}")
    lib = _build.load("sidecar_update", SIGNATURES)
    smem = lib.write_update_smem(S)
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"S={S} slots need {smem} bytes of shared memory "
                         f"(limit {_build.SMEM_LIMIT})")

    slot = torch.empty((L, B, H, 1), dtype=torch.int32, device=pos.device)
    ev = espec is not None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.write_update(
        pos.data_ptr(), score.data_ptr(), score_sq.data_ptr(), counter.data_ptr(),
        probs.data_ptr(), p_new.data_ptr(), q_pos.data_ptr(), token_valid.data_ptr(),
        update_gate.data_ptr(), counter_init.data_ptr(), ptr(evict_gate), ptr(next_pos),
        ptr(prompt_len), ptr(rand_rank), *map(ptr, scales), slot.data_ptr(), L, B, H, S,
        POLICY_CODES[policy], int(ev), espec.recent_window if ev else 0,
        max(espec.feasible_k, 1) if ev else 1, int(bool(espec.protect_prompt)) if ev else 0,
        _build.stream_of(pos))
    _build.check(err, "write_update")
    fused_write_update.launches += 1
    if with_scales:
        return pos, score, score_sq, counter, slot, k_scale, v_scale
    return pos, score, score_sq, counter, slot


fused_write_update.launches = 0
