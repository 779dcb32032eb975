"""Static-shape budgeted KV cache (counterpart of easykv_tpu/cache.py).

  * K/V live in fixed-size buffers `(L, B, H_kv, S, D)`; a slot is valid iff
    its `pos` sidecar is >= 0.
  * Eviction sets pos[slot] = -1 (no data movement); insertion writes the
    lowest-index invalid slot.
  * Score sidecars (cumulative attention mass, squared mass, observation
    counter — reference easykv.py:242-247) are per-(layer, head, slot) and
    reset at insertion.

Unlike the JAX package, whose arrays are immutable, the cache here is
updated in place: the decode step and the prefill write into the buffers
they were given, so no step allocates a second multi-GB copy.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class KVCache:
    """k, v:      (L, B, H_kv, S, D)  compute dtype
    pos:       (L, B, H_kv, S) int32   original token position; -1 = invalid
    score:     (L, B, H_kv, S) f32     cumulative attention mass
    score_sq:  (L, B, H_kv, S) f32     cumulative squared attention mass
    counter:   (L, B, H_kv, S) f32     per-slot observation counter

    `layer(l)` gives the same record for one layer, as views, so writes
    through it land in the stacked buffers."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    score: torch.Tensor
    score_sq: torch.Tensor
    counter: torch.Tensor

    def layer(self, l: int) -> "KVCache":
        return KVCache(*(getattr(self, f.name)[l] for f in dataclasses.fields(self)))


def init_cache(
    num_layers: int,
    batch: int,
    num_kv_heads: int,
    num_slots: int,
    head_dim: int,
    dtype: torch.dtype,
    device: torch.device,
) -> KVCache:
    shape = (num_layers, batch, num_kv_heads, num_slots)
    return KVCache(
        k=torch.zeros(shape + (head_dim,), dtype=dtype, device=device),
        v=torch.zeros(shape + (head_dim,), dtype=dtype, device=device),
        pos=torch.full(shape, -1, dtype=torch.int32, device=device),
        score=torch.zeros(shape, dtype=torch.float32, device=device),
        score_sq=torch.zeros(shape, dtype=torch.float32, device=device),
        counter=torch.zeros(shape, dtype=torch.float32, device=device),
    )


def kv_dequant(cache: KVCache, dtype: torch.dtype):
    """(k, v) in compute dtype. The int8 cache waits for its slice; a float
    cache is returned as it is, as in the JAX package."""
    if cache.k.dtype == torch.int8:
        raise NotImplementedError("int8 KV cache: ROADMAP.md open item 7")
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
    virgin slots at the chunk offset (token j -> slot j)."""
    C = new_k.shape[2]
    sl = slice(start, start + C)
    cache.k[:, :, sl] = new_k.to(cache.k.dtype)
    cache.v[:, :, sl] = new_v.to(cache.v.dtype)
    cache.pos[:, :, sl] = new_pos[:, None, :]
    cache.score[:, :, sl] = 0.0
    cache.score_sq[:, :, sl] = 0.0
    cache.counter[:, :, sl] = counter_init[:, None, :]
