"""Temperature + nucleus (top-p) sampling on the device (counterpart of
easykv_tpu/sampling.py:125-195).

The kept set reproduces the reference's nucleus semantics (reference
easykv/easykv.py:115-134): sort descending, keep while (cumsum - p) <=
top_p, so the first token crossing top_p is kept. The draw is a Gumbel-max
over the kept tokens with noise from a `torch.Generator`, so it never leaves
the device. jax.random and torch generators give different numbers for one
seed: draws agree with the JAX package in distribution, not token by token.

Greedy decoding is emulated, as in the reference scripts
(test_decoding.py:41), with a temperature of about 1e-9. At or below
GREEDY_TEMPERATURE the draw is the argmax of the logits, the lowest id on
ties, whatever the generator.
"""
from __future__ import annotations

import torch

GREEDY_TEMPERATURE = 1e-6
INT_MAX = 2**31 - 1


def nucleus_mask(prob: torch.Tensor, top_p: float) -> torch.Tensor:
    """Sort-free exact nucleus membership over the last axis: the same kept
    set as sorting descending and keeping while (cumsum - p) <= top_p
    (stable tie order = token id).

    Let c be the prob of the last kept token. A radix-16 bisection over the
    f32 bit patterns (8 rounds of 4 bits) finds the largest pattern t with
    mass(p > t) > top_p; the tokens with p > t form the kept-or-boundary
    group, whose minimum is exactly c. Boundary ties are then kept in id
    order while their running prefix stays <= top_p. Zero-probability
    tokens are never kept."""
    V = prob.shape[-1]
    bits = prob.view(torch.int32)                    # probs >= 0: monotone
    digits = torch.arange(1, 16, dtype=torch.int64, device=prob.device)
    extra = (1,) * (prob.dim())
    prefix = torch.zeros(prob.shape[:-1] + (1,), dtype=torch.int32, device=prob.device)
    for i in range(8):
        shift = 28 - 4 * i
        # round 0's digit spans bits 31..28: digits >= 8 would set the sign
        # bit; those candidates become INT_MAX (mass 0, never counted)
        hi = digits << shift
        cands = torch.where(hi > INT_MAX, INT_MAX, hi).to(torch.int32)
        cands = cands.view((15,) + extra) | prefix[None]           # (15, ..., 1)
        masses = torch.where(bits[None] > cands, prob[None], 0.0).sum(
            dim=-1, keepdim=True)                                   # (15, ..., 1)
        d = (masses > top_p).to(torch.int32).sum(dim=0)
        prefix = prefix | (d << shift)
    above = bits > prefix
    c = torch.where(above, prob, float("inf")).amin(dim=-1, keepdim=True)
    ties = above & (prob == c)
    strict = above & ~ties
    G = torch.where(strict, prob, 0.0).sum(dim=-1, keepdim=True)
    # ties kept while G + rank*c <= top_p  ->  rank < floor((top_p-G)/c)+1
    j = torch.floor((top_p - G) / c) + 1.0
    j = j.clamp(max=float(V)).to(torch.int32)
    ti = ties.to(torch.int32)
    tie_rank = torch.cumsum(ti, dim=-1) - ti
    return strict | (ties & (tie_rank < j))


def sample_topp(generator: torch.Generator, logits: torch.Tensor,
                temperature: float, top_p: float) -> torch.Tensor:
    """Temperature + nucleus sampling. logits (B, V) -> (B,) int32."""
    logits = logits.to(torch.float32)
    if temperature <= GREEDY_TEMPERATURE:
        return logits.argmax(dim=-1).to(torch.int32)
    prob = torch.softmax(logits / max(temperature, 1e-10), dim=-1)
    keep = nucleus_mask(prob, top_p)
    logp = torch.where(keep, torch.log(prob.clamp(min=1e-37)), float("-inf"))
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (logp + gumbel).argmax(dim=-1).to(torch.int32)
