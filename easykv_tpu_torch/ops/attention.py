"""Slot-masked attention over the budgeted KV ring buffer, emitting the
per-KV-head probabilities the eviction policies read (counterpart of
easykv_tpu/ops/attention.py:25-139).

Softmax is in float32 (reference llama_patch.py:218-219); invalid and
causally hidden slots get exactly zero probability. Logits take float32
products of the inputs, as the JAX package's preferred_element_type=f32.
`attend_inflight` and `decode_attend` are also the plain versions of the
two decode kernels (ops/cuda/decode_attention.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .rope import rotate

NEG_INF = -1e30


def attend(
    q: torch.Tensor,         # (B, Hq, T, D), already rotated
    k: torch.Tensor,         # (B, Hkv, S, D) cached keys
    v: torch.Tensor,         # (B, Hkv, S, D)
    kv_pos: torch.Tensor,    # (B, Hkv, S) int32, -1 = invalid slot
    q_pos: torch.Tensor,     # (B, T) int32, -1 = padding query
    *,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Hq, T, D), probs_kv (B, Hkv, T, S) float32).

    probs_kv is the mean over the rep query heads sharing each KV head
    (reference process_for_mqa_gqa, easykv.py:188-196)."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    qg = q.reshape(B, Hkv, rep, T, D).to(torch.float32)
    logits = torch.einsum("bhrtd,bhsd->bhrts", qg, k.to(torch.float32)) * scale

    kp = kv_pos[:, :, None, :]
    qp = q_pos[:, None, :, None]
    mask = (kp >= 0) & (kp <= qp)
    if sliding_window is not None:
        mask &= kp > (qp - sliding_window)
    mask = mask[:, :, None]                                  # (B, Hkv, 1, T, S)

    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    probs = e / denom.clamp(min=1e-30)                       # (B, Hkv, rep, T, S)

    out = torch.einsum("bhrts,bhsd->bhrtd", probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.reshape(B, Hq, T, D), probs.mean(dim=2)


def decode_attend(
    q: torch.Tensor,         # (B, Hq, 1, D), rotated
    k: torch.Tensor,         # (B, Hkv, S, D) cached keys, the new token's row included
    v: torch.Tensor,         # (B, Hkv, S, D)
    kv_pos: torch.Tensor,    # (B, Hkv, S) int32, -1 = invalid slot
    q_pos: torch.Tensor,     # (B,) int32, -1 = dead row
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32: k, v are int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """`attend` at T = 1 over a cache that already holds the query token's
    row, computed as the TPU kernel computes it (the JAX package's
    `fused_decode_attend`, decode_attention.py:38-78 there): p stays in
    float32 through the PV product, and with scales (an int8 cache) k_scale
    folds into the logits and v_scale into p. Returns (out (B, Hq, 1, D)
    in q's dtype, probs_kv (B, Hkv, 1, S) f32, the GQA mean of p). Also the
    plain version of ops/cuda/decode_attention.fused_decode_attend."""
    B, Hq, T, D = q.shape
    if T != 1:
        raise ValueError(f"decode_attend takes one query token, got {T}")
    Hkv = k.shape[1]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    qg = q.reshape(B, Hkv, rep, D).to(torch.float32)
    logits = torch.einsum("bhrd,bhsd->bhrs", qg, k.to(torch.float32)) * scale
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    qp = q_pos[:, None, None]
    mask = (kv_pos >= 0) & (kv_pos <= qp)
    if sliding_window is not None:
        mask &= kv_pos > (qp - sliding_window)
    mask = mask[:, :, None, :]                               # (B, Hkv, 1, S)
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    p = e / e.sum(dim=-1, keepdim=True).clamp(min=1e-30)     # (B, Hkv, rep, S)
    pv = p if v_scale is None else p * v_scale[:, :, None, :]
    out = torch.einsum("bhrs,bhsd->bhrd", pv, v.to(torch.float32))
    return out.to(q.dtype).reshape(B, Hq, 1, D), p.mean(dim=2)[:, :, None, :]


def attend_inflight(
    q: torch.Tensor,         # (B, Hq, 1, D), rotated
    k_new: torch.Tensor,     # (B, Hkv, 1, D) this step's key (rotated, uncached)
    v_new: torch.Tensor,     # (B, Hkv, 1, D)
    k: torch.Tensor,         # (B, Hkv, S, D) cached keys
    v: torch.Tensor,         # (B, Hkv, S, D)
    kv_pos: torch.Tensor,    # (B, Hkv, S) int32, -1 = invalid slot
    q_pos: torch.Tensor,     # (B,) int32, -1 = dead row
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32: k, v are int8
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    rank: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode attention where the current token's K/V is not
    yet in the cache: its logit joins the softmax directly (late write).

    Returns (out (B, Hq, 1, D), probs_kv (B, Hkv, 1, S), p_new (B, Hkv, 1)):
    probs_kv covers the cached slots, p_new is the GQA-mean probability of
    the in-flight token. With scales (an int8 cache) the dequantization
    folds into the logits and into p, in float32, as in the TPU kernel
    (decode_attention.py:171-197 of the JAX package). rot = (cos, sin),
    each (S, D/2) f32: the ordered StreamingLLM variant, which rotates the
    cached K at slot s by R(s) in float32 (an int8 row raw, before its
    scale) ahead of the QK product (the TPU kernel's `ordered=True`). With
    rank (B, Hkv, S) int32 as well, the row at slot s rotates by the table
    row rank[s] (0 <= rank < S), not by row s: the unordered StreamingLLM
    cache of the encoding family, each slot rotated by its age rank (the
    TPU kernel's `rank=`)."""
    B, Hq, T, D = q.shape
    if T != 1:
        raise ValueError(f"attend_inflight takes one query token, got {T}")
    if rank is not None and rot is None:
        raise ValueError("rank= rotates by the rot tables: pass rot too")
    Hkv = k.shape[1]
    rep = Hq // Hkv
    if scale is None:
        scale = 1.0 / (D ** 0.5)

    qg = q.reshape(B, Hkv, rep, D).to(torch.float32)
    kf = k.to(torch.float32)
    if rot is not None:
        cos, sin = rot
        if rank is not None:
            cos, sin = cos[rank.long()], sin[rank.long()]
        kf = rotate(kf, cos, sin)
    logits = torch.einsum("bhrd,bhsd->bhrs", qg, kf) * scale
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    logit_new = torch.einsum("bhrd,bhsd->bhrs", qg, k_new.to(torch.float32)) * scale

    qp = q_pos[:, None, None]                                # (B, 1, 1)
    mask = (kv_pos >= 0) & (kv_pos <= qp)                    # (B, Hkv, S)
    if sliding_window is not None:
        mask &= kv_pos > (qp - sliding_window)
    mask_r = mask[:, :, None, :]                             # (B, Hkv, 1, S)
    live = (q_pos >= 0)[:, None, None, None]                 # (B, 1, 1, 1)

    logits = torch.where(mask_r, logits, NEG_INF)
    logit_new = torch.where(live, logit_new, NEG_INF)
    m = torch.maximum(logits.amax(dim=-1, keepdim=True), logit_new)
    e = torch.where(mask_r, torch.exp(logits - m), 0.0)
    e_new = torch.where(live, torch.exp(logit_new - m), 0.0)
    denom = (e.sum(dim=-1, keepdim=True) + e_new).clamp(min=1e-30)
    p = e / denom                                            # (B, Hkv, rep, S)
    p_new = e_new / denom                                    # (B, Hkv, rep, 1)

    if v_scale is None:
        out = (torch.einsum("bhrs,bhsd->bhrd", p.to(v.dtype).to(torch.float32),
                            v.to(torch.float32))
               + (p_new.to(v.dtype) * v_new).to(torch.float32))
    else:
        out = (torch.einsum("bhrs,bhsd->bhrd", p * v_scale[:, :, None, :], v.to(torch.float32))
               + p_new * v_new.to(torch.float32))
    out = out.to(v_new.dtype).reshape(B, Hq, 1, D)
    return out, p.mean(dim=2)[:, :, None, :], p_new.mean(dim=2)
