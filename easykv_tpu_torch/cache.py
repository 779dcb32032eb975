"""Static-shape budgeted KV cache (counterpart of easykv_tpu/cache.py).

  * K/V live in fixed-size buffers `(L, B, H_kv, S, D)`; a slot is valid iff
    its `pos` sidecar is >= 0.
  * Eviction sets pos[slot] = -1 (no data movement); insertion writes the
    lowest-index invalid slot.
  * Score sidecars (cumulative attention mass, squared mass, observation
    counter — reference easykv.py:242-247) are per-(layer, head, slot) and
    reset at insertion.

  * The encoding family writes each strided chunk into caller-given slots
    per head (write_tokens_at): contiguous while the cache fills, the
    previous eviction's slots afterwards. The chunk-major forward (the
    StreamingLLM encode) writes a chunk into the lowest free slots
    (write_tokens).

  * An int8 cache (`init_cache(..., quantized=True)`) stores K/V as int8
    with one f32 dequant scale per (layer, batch, head, slot), the JAX
    package's compressed-KV mode (cache.py:93-140 there).

Unlike the JAX package, whose arrays are immutable, the cache here is
updated in place: the decode step and the prefill write into the buffers
they were given, so no step allocates a second multi-GB copy.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# the scale multiplier as float32, written as a multiply so that it rounds
# as the JAX package's quantize_kv does (cache.py:124-128 there)
INV_127 = float(np.float32(1.0 / 127.0))


@dataclasses.dataclass
class KVCache:
    """k, v:      (L, B, H_kv, S, D)  compute dtype, or int8 (quantized KV)
    pos:       (L, B, H_kv, S) int32   original token position; -1 = invalid
    score:     (L, B, H_kv, S) f32     cumulative attention mass
    score_sq:  (L, B, H_kv, S) f32     cumulative squared attention mass
    counter:   (L, B, H_kv, S) f32     per-slot observation counter
    k_scale:   (L, B, H_kv, S) f32     per-slot dequant scales of an int8
    v_scale:                           cache; None for a float cache

    `layer(l)` gives the same record for one layer, as views, so writes
    through it land in the stacked buffers."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    score: torch.Tensor
    score_sq: torch.Tensor
    counter: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k.dtype == torch.int8

    def layer(self, l: int) -> "KVCache":
        return KVCache(*(None if t is None else t[l]
                         for t in (getattr(self, f.name) for f in dataclasses.fields(self))))


def init_cache(
    num_layers: int,
    batch: int,
    num_kv_heads: int,
    num_slots: int,
    head_dim: int,
    dtype: torch.dtype,
    device: torch.device,
    quantized: bool = False,
) -> KVCache:
    """quantized=True stores K/V as int8 with per-slot f32 dequant scales:
    half the K/V bytes of a bf16 cache."""
    shape = (num_layers, batch, num_kv_heads, num_slots)
    kv_dtype = torch.int8 if quantized else dtype

    def scales():
        return torch.zeros(shape, dtype=torch.float32, device=device) if quantized else None

    return KVCache(
        k=torch.zeros(shape + (head_dim,), dtype=kv_dtype, device=device),
        v=torch.zeros(shape + (head_dim,), dtype=kv_dtype, device=device),
        pos=torch.full(shape, -1, dtype=torch.int32, device=device),
        score=torch.zeros(shape, dtype=torch.float32, device=device),
        score_sq=torch.zeros(shape, dtype=torch.float32, device=device),
        counter=torch.zeros(shape, dtype=torch.float32, device=device),
        k_scale=scales(),
        v_scale=scales(),
    )


def quantize_kv(x: torch.Tensor):
    """Per-row symmetric int8 quantization over the head dim, bit-exact with
    the JAX package's quantize_kv: scale = max(amax, 1e-8) * f32(1/127);
    values divided by the scale, rounded half to even, clipped to +-127.
    x: (..., D) -> (int8 (..., D), scale f32 (...))."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    scale = amax.clamp(min=1e-8) * INV_127
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def kv_dequant(cache: KVCache, dtype: torch.dtype):
    """(k, v) in compute dtype, dequantizing if the cache is int8; a float
    cache is returned as it is, as in the JAX package."""
    if cache.quantized:
        k = cache.k.to(dtype) * cache.k_scale[..., None].to(dtype)
        v = cache.v.to(dtype) * cache.v_scale[..., None].to(dtype)
        return k, v
    return cache.k, cache.v


def free_slot_ids(pos: torch.Tensor, count: int) -> torch.Tensor:
    """Per (..., H): indices of the `count` lowest-index invalid slots.

    pos: (..., S) -> (..., count) int32. Invalid slots get a key of
    2S - slot so lower indices come first; valid slots sort last (key 0), in
    slot order — the tie order of the JAX package's top_k."""
    S = pos.shape[-1]
    slot_idx = torch.arange(S, device=pos.device, dtype=torch.int32).expand_as(pos)
    sort_key = torch.where(pos < 0, 2 * S - slot_idx, torch.zeros_like(slot_idx))
    _, ids = torch.sort(-sort_key, dim=-1, stable=True)
    return ids[..., :count].to(torch.int32)


def write_tokens(
    cache: KVCache,              # one layer: k (B, H, S, D), pos (B, H, S)
    new_k: torch.Tensor,         # (B, H, C, D) post-RoPE (raw K under streaming)
    new_v: torch.Tensor,         # (B, H, C, D)
    new_pos: torch.Tensor,       # (B, C) int32
    counter_init: torch.Tensor,  # (B, C) f32
    token_valid: Optional[torch.Tensor] = None,  # (B, C) bool; False = padding
) -> None:
    """Write C tokens into the lowest-index free slots of each (B, H), in
    place (the JAX package's write_tokens, cache.py:165-248 there). Valid
    tokens take the lowest free slots in column order whatever their column;
    padding columns take the remaining ids and write nothing. A written slot
    gets its row (quantized once, with its scale, in an int8 cache), pos,
    the initial counter and zero scores. With fewer free slots than C the
    remaining ids are valid slots in slot order, as the JAX package's
    free_slot_ids gives them, and are overwritten the same way."""
    B, H, C, _ = new_k.shape
    ids = free_slot_ids(cache.pos, C)                                  # (B, H, C)
    if token_valid is None:
        write_tokens_at(cache, new_k, new_v, new_pos, counter_init, ids)
        return
    tv = token_valid.to(torch.int32)
    order = torch.where(token_valid, tv.cumsum(1) - 1,
                        tv.sum(1, keepdim=True) + (1 - tv).cumsum(1) - 1)
    ids = ids.gather(2, order[:, None, :].expand(B, H, C))
    dev = new_k.device
    idx = (torch.arange(B, device=dev)[:, None, None],
           torch.arange(H, device=dev)[None, :, None], ids.long())
    live = token_valid[:, None, :]                                     # (B, 1, C)

    def put(buf, new):
        buf[idx] = torch.where(live if new.dim() == 3 else live[..., None], new, buf[idx])

    if cache.quantized:
        qk, k_sc = quantize_kv(new_k)
        qv, v_sc = quantize_kv(new_v)
        put(cache.k_scale, k_sc)
        put(cache.v_scale, v_sc)
    else:
        qk, qv = new_k.to(cache.k.dtype), new_v.to(cache.v.dtype)
    put(cache.k, qk)
    put(cache.v, qv)
    put(cache.pos, new_pos[:, None, :].expand(B, H, C))
    put(cache.counter, counter_init[:, None, :].expand(B, H, C))
    zeros = torch.zeros((B, H, C), dtype=torch.float32, device=dev)
    put(cache.score, zeros)
    put(cache.score_sq, zeros)


def write_tokens_slice(
    cache: KVCache,              # one layer: k (B, H, S, D), pos (B, H, S)
    new_k: torch.Tensor,         # (B, H, C, D)
    new_v: torch.Tensor,         # (B, H, C, D)
    new_pos: torch.Tensor,       # (B, C) int32
    counter_init: torch.Tensor,  # (B, C) f32
    start: int,                  # slot offset, the same for all (B, H)
) -> None:
    """Contiguous write of C tokens into slots [start, start+C) of every
    head, in place. Used by the layer-major prefill, whose targets are always
    virgin slots at the chunk offset (token j -> slot j). An int8 cache
    stores the chunk quantized, with its scales."""
    C = new_k.shape[2]
    sl = slice(start, start + C)
    if cache.quantized:
        cache.k[:, :, sl], cache.k_scale[:, :, sl] = quantize_kv(new_k)
        cache.v[:, :, sl], cache.v_scale[:, :, sl] = quantize_kv(new_v)
    else:
        cache.k[:, :, sl] = new_k.to(cache.k.dtype)
        cache.v[:, :, sl] = new_v.to(cache.v.dtype)
    cache.pos[:, :, sl] = new_pos[:, None, :]
    cache.score[:, :, sl] = 0.0
    cache.score_sq[:, :, sl] = 0.0
    cache.counter[:, :, sl] = counter_init[:, None, :]


def write_tokens_at(
    cache: KVCache,              # one layer: k (B, H, S, D), pos (B, H, S)
    new_k: torch.Tensor,         # (B, H, C, D)
    new_v: torch.Tensor,         # (B, H, C, D)
    new_pos: torch.Tensor,       # (B, C) int32
    counter_init: torch.Tensor,  # (B, C) f32, any sign
    ids: torch.Tensor,           # (B, H, C) int32 distinct target slots per head
) -> None:
    """Write C tokens at caller-given slots, in place (all tokens valid):
    the row (quantized with its scale in an int8 cache), pos, the initial
    counter, and zero scores. Equal to both write_tokens_at and
    write_tokens_dense of the JAX package. Also the plain version of the
    write half of K6 (ops/cuda/chunk_attention.py)."""
    B, H, C, _ = new_k.shape
    dev = new_k.device
    idx = (torch.arange(B, device=dev)[:, None, None],
           torch.arange(H, device=dev)[None, :, None], ids.long())
    if cache.quantized:
        qk, k_sc = quantize_kv(new_k)
        qv, v_sc = quantize_kv(new_v)
        cache.k_scale[idx] = k_sc
        cache.v_scale[idx] = v_sc
    else:
        qk, qv = new_k.to(cache.k.dtype), new_v.to(cache.v.dtype)
    cache.k[idx] = qk
    cache.v[idx] = qv
    zeros = torch.zeros((B, H, C), dtype=torch.float32, device=dev)
    cache.pos[idx] = new_pos[:, None, :].expand(B, H, C)
    cache.score[idx] = zeros
    cache.score_sq[idx] = zeros
    cache.counter[idx] = counter_init[:, None, :].expand(B, H, C)


def evict_slots(cache: KVCache, evict_ids: torch.Tensor,
                gate: Optional[torch.Tensor] = None) -> None:
    """Invalidate per-(B, H) slots, in place: pos = -1 at evict_ids (B, H,
    k); rows whose gate (B,) is off are untouched. The K/V data stays; the
    next write reuses the slots (reference truncate_kv_cache_silo,
    easykv.py:56-82, as a validity change)."""
    ids = evict_ids.long()
    new = torch.full(ids.shape, -1, dtype=cache.pos.dtype, device=ids.device)
    if gate is not None:
        new = torch.where(gate[:, None, None], new, cache.pos.gather(-1, ids))
    cache.pos.scatter_(-1, ids, new)


def evict_slots_merged(cache: KVCache, evict_ids: torch.Tensor,
                       gate: Optional[torch.Tensor] = None) -> None:
    """Evict with merge, in place (the JAX package's evict_slots_merged,
    cache.py:436-475 there; the reference's unused
    truncate_kv_cache_liso_mean, easykv.py:84-102): the evicted slots of
    each (B, H), evict_ids (B, H, k), are replaced by one slot holding their
    mean K / V (in f32, stored in the cache's dtype) in the first evicted
    slot, which keeps its position id; the other k - 1 are invalidated.
    Rows whose gate (B,) is off are untouched. A float cache only."""
    assert not cache.quantized, "merged eviction requires a float cache"
    B, H, _ = evict_ids.shape
    ids = evict_ids.long()
    D = cache.k.shape[-1]
    gather = lambda t: t.gather(2, ids[..., None].expand(B, H, ids.shape[-1], D))  # noqa: E731
    k_mean = gather(cache.k).to(torch.float32).mean(dim=2).to(cache.k.dtype)       # (B, H, D)
    v_mean = gather(cache.v).to(torch.float32).mean(dim=2).to(cache.v.dtype)
    first = ids[:, :, :1]                                                          # (B, H, 1)
    pos_first = cache.pos.gather(-1, first)
    evict_slots(cache, evict_ids, gate)
    idx = (torch.arange(B, device=ids.device)[:, None],
           torch.arange(H, device=ids.device)[None, :], first[..., 0])
    if gate is not None:
        g = gate[:, None, None]
        k_mean = torch.where(g, k_mean, cache.k[idx])
        v_mean = torch.where(g, v_mean, cache.v[idx])
    cache.k[idx] = k_mean
    cache.v[idx] = v_mean
    cache.pos.scatter_(-1, first, pos_first)
