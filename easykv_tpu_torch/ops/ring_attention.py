"""Ring attention: sequence-parallel causal attention over the sp mesh
(counterpart of easykv_tpu/ops/ring_attention.py: _block_attend,
ring_attention, ring_attention_scores).

Each rank holds its own T / n columns of q, K, V and the positions (the
JAX package's shard_map over `axis`; here the functions run on the rank's
shard directly). K / V blocks travel around the ring (parallel.mesh.
ring_shift: rank i sends to i + 1) while every rank folds the visiting
block into an online-softmax accumulator for its own queries. For the
keep_attention score bootstrap a second function takes each query row's
exact softmax statistics (m, l) in a first pass, then rotates K once more
with the per-key accumulators Σp / Σp² travelling beside it: every rank adds
its queries' probability mass for the visiting keys, and after n shifts
each block's accumulators are home again, summed over all queries.

The JAX package computes the block in XLA einsums and has no Pallas kernel
for it (ring_attention.py:15-16 there), so the block here is plain PyTorch
in f32 (torch.matmul) on every device. Its logits, (B, Hkv, rep, Tq, Tk)
f32, are the largest temporary; each block's are freed before the next
shift. A shift the result does not read (the last one of the attention and
of the first scores pass) is not made; the values are the JAX package's.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.mesh import ring_shift

NEG_INF = -1e30
INT_MAX = 2**31 - 1


def _logits(q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's causal logits (B, Hkv, rep, Tq, Tk) f32, NEG_INF where
    masked, and the mask (B, 1, 1, Tq, Tk). q (B, Hkv, rep, Tq, D) f32, k
    (B, Hkv, Tk, D)."""
    logits = torch.matmul(q, k.to(torch.float32)[:, :, None].transpose(-1, -2)) * scale
    mask = (k_pos[:, None, None, None, :] <= q_pos[:, None, None, :, None])
    return logits.masked_fill_(~mask, NEG_INF), mask


def _block_attend(q, k, v, q_pos, k_pos, scale):
    """One (local-q x visiting-kv) block: (numer, denom, m) of the
    unnormalised exp(logits - m) with the row maximum m. q (B, Hkv, rep,
    Tq, D); k / v (B, Hkv, Tk, D); the positions mask causally."""
    logits, mask = _logits(q, k, q_pos, k_pos, scale)
    m = logits.amax(dim=-1)                                     # (B, Hkv, rep, Tq)
    e = torch.exp(logits.sub_(m[..., None])).masked_fill_(~mask, 0.0)
    return torch.matmul(e, v.to(torch.float32)[:, :, None]), e.sum(dim=-1), m


def ring_attention(
    q: torch.Tensor,        # (B, Hq, Tq, D): this rank's columns
    k: torch.Tensor,        # (B, Hkv, Tk, D); Hkv divides Hq (GQA)
    v: torch.Tensor,
    q_pos: torch.Tensor,    # (B, Tq) global positions of this rank's columns
    mesh,
    axis_name: str = "sp",
    collect_scores: bool = False,
    k_pos: Optional[torch.Tensor] = None,   # (B, Tk) key positions; default q_pos
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Causal self-attention with the sequence sharded over `axis_name`:
    this rank's (out (B, Hq, Tq, D) in q's dtype, score_sum, score_sq_sum),
    the sums the per-key GQA-mean Σp / Σp² over all queries (B, Hkv, Tk) of
    this rank's keys (ring_attention_scores), or None unless collect_scores.
    Give padding keys k_pos = INT_MAX to hide them (a -1 would be causally
    visible to every query)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    scale = D ** -0.5
    n = mesh.shape[axis_name]
    if k_pos is None:
        k_pos = q_pos
    qf = q.to(torch.float32).reshape(B, Hkv, rep, Tq, D)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    m = torch.full(qf.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    blk = (k, v, k_pos)
    for step in range(n):
        k_cur, v_cur, kpos_cur = blk
        numer, denom, m_new = _block_attend(qf, k_cur, v_cur, q_pos, kpos_cur, scale)
        # online softmax merge
        m_tot = torch.maximum(m, m_new)
        c_old, c_new = torch.exp(m - m_tot), torch.exp(m_new - m_tot)
        acc = acc * c_old[..., None] + numer * c_new[..., None]
        l = l * c_old + denom * c_new
        m = m_tot
        del numer, denom, m_new, k_cur, v_cur, kpos_cur
        if step < n - 1:
            blk = ring_shift(blk, mesh, axis_name)
    out = (acc / l.clamp(min=1e-30)[..., None]).reshape(B, Hq, Tq, D).to(q.dtype)
    if not collect_scores:
        return out, None, None
    del acc
    ssum, ssq = ring_attention_scores(q, k, q_pos, mesh, axis_name, k_pos=k_pos)
    return out, ssum, ssq


def ring_attention_scores(
    q: torch.Tensor, k: torch.Tensor, q_pos: torch.Tensor, mesh, axis_name: str = "sp",
    k_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-key attention-mass sums Σp / Σp² (B, Hkv, Tk) f32 over every
    query of every rank, for this rank's keys: the h2o / roco prefill score
    bootstrap with the sequence sharded over `axis_name`. GQA: the
    probabilities are averaged over the rep query heads of a KV head BEFORE
    squaring, as update_scores does with attend()'s GQA-mean probs.

    Pass 1 takes each local query row's exact softmax statistics (m, l)
    over all keys; pass 2 rotates K with the accumulators, every rank
    adding its normalised probabilities for the visiting block, and after n
    shifts the accumulators are home."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    rep = Hq // Hkv
    scale = D ** -0.5
    n = mesh.shape[axis_name]
    if k_pos is None:
        k_pos = q_pos
    qf = q.to(torch.float32).reshape(B, Hkv, rep, Tq, D)
    # pass 1: the softmax statistics of the local queries (per q-head)
    m = torch.full(qf.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    blk = (k, k_pos)
    for step in range(n):
        logits, mask = _logits(qf, blk[0], q_pos, blk[1], scale)
        m_tot = torch.maximum(m, logits.amax(dim=-1))
        e = torch.exp(logits.sub_(m_tot[..., None])).masked_fill_(~mask, 0.0)
        l = l * torch.exp(m - m_tot) + e.sum(dim=-1)
        m = m_tot
        del logits, e
        if step < n - 1:
            blk = ring_shift(blk, mesh, axis_name)
    # pass 2: rotate K and the accumulators; every rank adds its normalised
    # GQA-mean probability mass for the visiting block
    ssum = torch.zeros((B, Hkv, k.shape[2]), dtype=torch.float32, device=q.device)
    ssq = torch.zeros_like(ssum)
    kc, kpc = k, k_pos
    for step in range(n):
        logits, mask = _logits(qf, kc, q_pos, kpc, scale)
        p = torch.exp(logits.sub_(m[..., None])).masked_fill_(~mask, 0.0)
        p = p / l.clamp(min=1e-30)[..., None]                  # exact probabilities
        pm = p.mean(dim=2)                                      # GQA-mean (B, Hkv, Tq, Tk)
        ssum = ssum + pm.sum(dim=2)
        ssq = ssq + (pm * pm).sum(dim=2)
        del logits, p, pm
        if step < n - 1:
            kc, kpc, ssum, ssq = ring_shift((kc, kpc, ssum, ssq), mesh, axis_name)
        else:
            ssum, ssq = ring_shift((ssum, ssq), mesh, axis_name)
    return ssum, ssq
