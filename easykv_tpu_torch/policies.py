"""Eviction policies over the static KV ring buffer (counterpart of
easykv_tpu/policies.py).

The five policies (random / recency / h2o_head / tova / roco, reference
easykv.py:288-362 decode, :443-499 encode, :694-747 encoding_decoding
decode) select slots per (layer, kv-head) from the sidecars. The
reference's buffer-order semantics translate to position tests:

  * recent-window protection  "scores[:, :, :-w]"  -> pos <  next_pos - w
  * roco std guard            "std[:, :, -10:]=1e9" -> pos >= next_pos - 10
  * sink protection           "scores[:, :, :4]"    -> pos <  sink_length
  * decode prompt protection  (easykv.py:290,311)   -> pos >= prompt_len

The decode-phase k=1 selection runs in the sidecar kernels
(ops/cuda/sidecar_update.py): folded into K2, or as K4 through evict_cache.
Everything else here is plain PyTorch on tensors, where the JAX package
leaves the same work to XLA, and updates the cache's sidecars in place.

Tie order: the JAX package breaks ties toward the lower slot (top_k for
k <= 8, a stable sort above); here a stable ascending torch.sort serves
both branches (torch.topk's tie order is unspecified). Rows with fewer
than k candidates fill up with inf-masked slots in slot order, as there.

Deviation kept from the JAX package: the reference's `random` branch in
encoding_decoding decode references an undefined variable
(easykv.py:744); the evident intent (uniform over non-sink slots) is
implemented.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .cache import KVCache, evict_slots

INT_MAX = 2**31 - 1
STD_FORCE = 1e9      # reference's 1e9 std override (easykv.py:321)
STD_EXCLUDE = 1e30   # strictly above STD_FORCE: never feasible
ROCO_STD_GUARD = 10  # "last 10 slots" guard (easykv.py:321, 472)

# Phase determines candidate masks and the score-update flavour.
PHASE_DECODE = "decode"                # reference easykv.py:288-362
PHASE_ENCODE = "encode"                # reference easykv.py:443-499
PHASE_ENCDEC_DECODE = "encdec_decode"  # reference easykv.py:694-747

_U32 = 0xFFFFFFFF
_SIGN = 0x80000000


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Static policy configuration for one engine run."""

    policy: str               # canonical: random|recency|h2o_head|tova|roco|full
    phase: str                # PHASE_*
    k: int                    # slots evicted per event (1 decode, stride encode)
    sink_length: int          # temp_length, reference easykv.py:206
    recent_window: int        # int(budget * recent_ratio), phase-specific
    feasible_k: int = 0       # roco stage-1 top-k size
    protect_prompt: bool = False  # decode mode: only generated slots evictable


def _kth_smallest(values: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th smallest value (1-indexed) along the last axis: a 32-step
    bisection over the order-preserving bit pattern of f32 (sign bit flipped
    for positives, all bits for negatives). The unsigned patterns are held
    in int64. Returns (..., 1) f32."""
    bits = values.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _U32
    bits = bits ^ torch.where(bits >> 31 == 1, _U32, _SIGN)
    prefix = torch.zeros(bits.shape[:-1] + (1,), dtype=torch.int64, device=bits.device)
    for i in range(32):
        cand = prefix | (1 << (31 - i))
        cnt = (bits < cand).sum(dim=-1, keepdim=True)
        prefix = torch.where(cnt >= k, prefix, cand)
    kth = prefix ^ torch.where(prefix >> 31 == 0, _U32, _SIGN)
    kth = torch.where(kth >= 2**31, kth - 2**32, kth)
    return kth.to(torch.int32).view(torch.float32)


def _smallest_k(values: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., k) int32 of the k smallest `values` where `mask`, ties
    toward the lower slot."""
    masked = torch.where(mask, values.to(torch.float32), float("inf"))
    _, ids = torch.sort(masked, dim=-1, stable=True)
    return ids[..., :k].to(torch.int32)


def _slots_at_ranks(pos: torch.Tensor, cand: torch.Tensor, start_rank: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Slots holding the candidates with age-rank start_rank..start_rank+k-1
    (rank 0 = oldest candidate). pos (B, H, S); start_rank (B,). Used by
    recency (easykv.py:492) and random (easykv.py:494-499)."""
    B, H, S = pos.shape
    sorted_pos = torch.sort(torch.where(cand, pos, INT_MAX), dim=-1).values
    start = start_rank.to(torch.int32).expand(B).clamp(0, S - k).long()
    lo = sorted_pos.gather(-1, start[:, None, None].expand(B, H, 1))
    hi = sorted_pos.gather(-1, (start + k - 1)[:, None, None].expand(B, H, 1))
    span = cand & (pos >= lo) & (pos <= hi)
    iota = torch.arange(S, dtype=torch.int32, device=pos.device)
    key = span.to(torch.int32) * (2 * S) - iota      # distinct: no ties
    _, ids = torch.sort(-key, dim=-1, stable=True)
    return ids[..., :k].to(torch.int32)


def select_evictions(cache: KVCache, spec: PolicySpec, next_pos: torch.Tensor,
                     prompt_len: torch.Tensor, rand_rank: torch.Tensor) -> torch.Tensor:
    """Select spec.k slots per (B, H) to evict; (B, H, k) int32. Rows whose
    eviction gate is off get ids too (possibly from NaN scores); evict_slots
    discards them."""
    pos = cache.pos
    valid = pos >= 0
    npos = next_pos[:, None, None]
    base = valid
    if spec.phase == PHASE_DECODE and spec.protect_prompt:
        base = base & (pos >= prompt_len[:, None, None])

    if spec.policy == "h2o_head":
        cand = base
        if spec.phase == PHASE_ENCODE:
            cand = cand & (pos >= spec.sink_length)
        # decode easykv.py:311, encode :463, encdec :712: the newest
        # recent_window slots are excluded in every phase
        cand = cand & (pos < npos - spec.recent_window)
        return _smallest_k(cache.score, cand, spec.k)

    if spec.policy == "tova":
        cand = base
        if spec.phase == PHASE_ENCODE:
            # easykv.py:485: sink and recent window excluded
            cand = cand & (pos >= spec.sink_length) & (pos < npos - spec.recent_window)
        # decode (easykv.py:335) and encdec decode (:734): plain argmin
        return _smallest_k(cache.score, cand, spec.k)

    if spec.policy == "roco":
        # Stage 1: feasible set = the feasible_k lowest stds (guard on the 10
        # newest and, in encode, the sink; easykv.py:320-322, :471-473,
        # :720-722). Forced slots carry position-scaled values so that the
        # oldest fill the set deterministically (see the JAX package).
        counter = cache.counter
        mean = cache.score / counter
        var = cache.score_sq / counter - mean * mean
        std = torch.sqrt(torch.clamp(var, min=0.0))
        forced = pos >= npos - ROCO_STD_GUARD
        if spec.phase == PHASE_ENCODE:
            forced = forced | (pos < spec.sink_length)
        force_val = STD_FORCE + pos.to(torch.float32) * 1024.0
        std = torch.where(forced, force_val, std)
        std = torch.where(base, std, torch.full_like(std, STD_EXCLUDE))
        feasible = std <= _kth_smallest(std, spec.feasible_k)
        # Stage 2: lowest time-averaged score in the feasible set
        # (easykv.py:323, :475, :723)
        return _smallest_k(cache.score / counter, feasible, spec.k)

    B = pos.shape[0]
    if spec.policy == "recency":
        if spec.phase == PHASE_DECODE:
            # oldest generated token (easykv.py:343-352)
            return _smallest_k(pos.to(torch.float32), base, spec.k)
        # encode / encdec decode: the oldest span after the sink
        # (easykv.py:491-493, :741-742)
        start = torch.full((B,), spec.sink_length, dtype=torch.int32, device=pos.device)
        return _slots_at_ranks(pos, valid, start, spec.k)

    if spec.policy == "random":
        if spec.phase == PHASE_DECODE:
            # uniform over generated tokens (easykv.py:353-362)
            return _slots_at_ranks(pos, base, rand_rank, spec.k)
        if spec.phase == PHASE_ENCODE:
            # uniform span start over buffer ranks (easykv.py:494-499; the
            # reference does not sink-protect random in encode)
            return _slots_at_ranks(pos, valid, rand_rank, spec.k)
        # encdec decode: uniform over non-sink candidates
        return _slots_at_ranks(pos, valid, rand_rank + spec.sink_length, spec.k)

    raise ValueError(f"policy {spec.policy!r} does not evict")


def row_gate(update_gate: torch.Tensor) -> torch.Tensor:
    """A scalar or per-row (B,) gate, shaped to broadcast over (B, H, S)."""
    if update_gate.dim() == 1:
        return update_gate[:, None, None]
    return update_gate


def update_scores(cache: KVCache, probs_kv: torch.Tensor, spec: Optional[PolicySpec],
                  update_gate: torch.Tensor, bootstrap: bool = False) -> None:
    """Fold a chunk's attention probabilities (B, H, T, S) into the score
    sidecars, in place. bootstrap=True is the keep_attention prefix
    accumulation (reference h2o_head_score, easykv.py:173-186): sum and sum
    of squares whatever the policy. Otherwise h2o accumulates mass, roco
    mass and squared mass, tova overwrites with the last query row (the
    head mean in encode, easykv.py:456-457)."""
    gate_b = row_gate(update_gate)
    gate = gate_b.to(torch.float32)
    policy = None if spec is None else spec.policy
    if bootstrap or policy in ("h2o_head", "roco"):
        cache.score.copy_(cache.score + probs_kv.sum(dim=2) * gate)
        if bootstrap or policy == "roco":
            cache.score_sq.copy_(cache.score_sq + (probs_kv * probs_kv).sum(dim=2) * gate)
    elif policy == "tova":
        last = probs_kv[:, :, -1, :]
        if spec.phase == PHASE_ENCODE:
            last = last.mean(dim=1, keepdim=True).expand_as(cache.score)
        cache.score.copy_(torch.where(gate_b, last, cache.score))


def update_scores_reduced(cache: KVCache, ssum: torch.Tensor, ssq: torch.Tensor,
                          last: torch.Tensor, spec: Optional[PolicySpec],
                          update_gate: torch.Tensor, bootstrap: bool = False) -> None:
    """update_scores from the statistics a chunk kernel reduced on chip
    (ssum, ssq, last: (B, H, S)); same semantics, in place."""
    gate_b = row_gate(update_gate)
    gate = gate_b.to(torch.float32)
    policy = None if spec is None else spec.policy
    if bootstrap or policy in ("h2o_head", "roco"):
        cache.score.copy_(cache.score + ssum * gate)
        if bootstrap or policy == "roco":
            cache.score_sq.copy_(cache.score_sq + ssq * gate)
    elif policy == "tova":
        if spec.phase == PHASE_ENCODE:
            last = last.mean(dim=1, keepdim=True).expand_as(cache.score)
        cache.score.copy_(torch.where(gate_b, last, cache.score))


def bump_counters(cache: KVCache, amount: float, gate: Optional[torch.Tensor] = None) -> None:
    """Age every slot by `amount` (easykv.py:304, :460-461), in place; gate
    (B,) restricts it to the rows whose eviction event fires."""
    if gate is None:
        cache.counter.add_(amount)
    else:
        cache.counter.copy_(cache.counter + amount * gate[:, None, None].to(torch.float32))


def evict_layer(cache: KVCache, spec: PolicySpec, next_pos: torch.Tensor,
                prompt_len: torch.Tensor, rand_rank: torch.Tensor,
                gate: torch.Tensor) -> torch.Tensor:
    """One gated eviction event on one layer's cache, in place: bump the
    counters, select, invalidate (the order of evict_cache). Returns the
    selected ids (B, H, k), meaningful for rows whose gate is on. The JAX
    package skips the event under `lax.cond(any(gate))`; the caller here
    knows from its static schedule whether any row fires, and calls this
    only then."""
    bump_counters(cache, float(spec.k), gate)
    ids = select_evictions(cache, spec, next_pos, prompt_len, rand_rank)
    evict_slots(cache, ids, gate)
    return ids


def evict_cache(cache: KVCache, spec: PolicySpec, next_pos: torch.Tensor,
                prompt_len: torch.Tensor, rand_rank: torch.Tensor,
                gate: torch.Tensor) -> None:
    """One gated eviction event across all layers, in place. A decode-phase
    k=1 spec runs kernel K4 (ops/cuda/sidecar_update.fused_evict: bump,
    select and invalidate per row, its plain version for CPU tensors), as
    the JAX package's evict_cache takes `fused_evict` there; any other spec
    folds the layer axis into the batch axis for one plain selection over
    (L*B, H, S). Either runs whatever the gate: rows whose gate is off are
    left as they were (their counters too), so no host sync decides whether
    to run it."""
    from .ops.cuda.sidecar_update import evict_supported, fused_evict

    if evict_supported(spec):
        fused_evict(cache.pos, cache.score, cache.score_sq, cache.counter, gate, next_pos,
                    prompt_len, rand_rank, spec)
        return
    L, B = cache.pos.shape[:2]
    sidecars = KVCache(*(None,) * 2, *(x.reshape((L * B,) + x.shape[2:]) for x in (
        cache.pos, cache.score, cache.score_sq, cache.counter)))
    tile = lambda x: x.repeat(L)  # noqa: E731
    evict_layer(sidecars, spec, tile(next_pos), tile(prompt_len), tile(rand_rank), tile(gate))
