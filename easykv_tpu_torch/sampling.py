"""Temperature + nucleus (top-p) sampling on the device (counterpart of
easykv_tpu/sampling.py: logits_adapter, sample_token, sample_from_logits,
sample_topp_sorted, nucleus_mask, sample_topp).

The kept set reproduces the reference's nucleus semantics (reference
easykv/easykv.py:115-134): sort descending, keep while (cumsum - p) <=
top_p, so the first token crossing top_p is kept. The draw is a Gumbel-max
over the kept tokens with noise from a `torch.Generator`, so it never leaves
the device. jax.random and torch generators give different numbers for one
seed: draws agree with the JAX package in distribution, not token by token.

The engine samples with sample_topp (no V-wide sort). logits_adapter,
sample_token, sample_from_logits and sample_topp_sorted are the JAX
package's other routes to the same distribution, kept for host-driven
callers as there; each draw takes an explicit generator.

Greedy decoding is emulated, as in the reference scripts
(test_decoding.py:41), with a temperature of about 1e-9. At or below
GREEDY_TEMPERATURE the draw is the argmax of the logits, the lowest id on
ties, whatever the generator.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

GREEDY_TEMPERATURE = 1e-6
INT_MAX = 2**31 - 1


def logits_adapter(logits: torch.Tensor, temperature: float,
                   top_p: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (..., V) -> (filtered_probs, raw_probs), both (..., V) f32:
    the reference's exact nucleus (easykv.py:115-134): the temperature
    softmax sorted descending (ties in id order), entries kept while
    (cumsum - p) <= top_p, renormalised and unsorted."""
    logits = logits.to(torch.float32)
    raw = torch.softmax(logits, dim=-1)
    prob = torch.softmax(logits / max(temperature, 1e-10), dim=-1)
    sorted_prob, order = torch.sort(prob, dim=-1, descending=True, stable=True)
    cumsum = torch.cumsum(sorted_prob, dim=-1)
    sorted_prob = torch.where(cumsum - sorted_prob <= top_p, sorted_prob, 0.0)
    sorted_prob = sorted_prob / sorted_prob.sum(dim=-1, keepdim=True)
    return torch.empty_like(prob).scatter_(-1, order, sorted_prob), raw


def _gumbel_argmax(generator: torch.Generator, logp: torch.Tensor) -> torch.Tensor:
    """A categorical draw over the last axis of log-probabilities (-inf:
    never drawn), by Gumbel-max with noise from `generator`."""
    u = torch.rand(logp.shape, generator=generator, device=logp.device)
    return (logp - torch.log(-torch.log(u.clamp(min=1e-20)))).argmax(dim=-1)


def sample_token(generator: torch.Generator, filtered_probs: torch.Tensor) -> torch.Tensor:
    """A draw from the filtered distribution: (..., V) -> (...) int32."""
    logp = torch.where(filtered_probs > 0, torch.log(filtered_probs.clamp(min=1e-37)),
                       float("-inf"))
    return _gumbel_argmax(generator, logp).to(torch.int32)


NUCLEUS_TOPK = 512  # sample_from_logits' top-k width; wider nuclei take the full sort


def sample_from_logits(generator: torch.Generator, logits: torch.Tensor, temperature: float,
                       top_p: float) -> torch.Tensor:
    """Nucleus sampling from the top NUCLEUS_TOPK logits, with the exact
    full sort (logits_adapter + sample_token) where some row's nucleus is
    wider, and the unfiltered draw at top_p >= 1: the distribution of
    logits_adapter + sample_token. (B, V) -> (B,) int32. The choice between
    the two reads one bool back to the host, as the JAX package's lax.cond
    decides on the device: a host-driven caller's function."""
    logits = logits.to(torch.float32)
    scaled = logits / max(temperature, 1e-10)
    if top_p >= 1.0:
        return _gumbel_argmax(generator, scaled).to(torch.int32)
    K = min(NUCLEUS_TOPK, logits.shape[-1])
    top_logits, top_idx = torch.topk(scaled, K, dim=-1)
    mass = torch.exp(torch.logsumexp(top_logits, -1) - torch.logsumexp(scaled, -1))   # (B,)
    p_full = torch.softmax(top_logits, dim=-1) * mass[:, None]
    keep = torch.cumsum(p_full, dim=-1) - p_full <= top_p
    # the nucleus lies inside the top K where the K-th entry is dropped
    if bool((~keep[:, -1] | (mass >= 1.0 - 1e-7)).all()):
        p = torch.where(keep, p_full, 0.0)
        logp = torch.where(p > 0, torch.log(p.clamp(min=1e-37)), float("-inf"))
        choice = _gumbel_argmax(generator, logp)
        return top_idx.gather(-1, choice[:, None])[:, 0].to(torch.int32)
    return sample_token(generator, logits_adapter(logits, temperature, top_p)[0])


def sample_topp_sorted(generator: torch.Generator, logits: torch.Tensor, temperature: float,
                       top_p: float) -> torch.Tensor:
    """Temperature + nucleus sampling with a single sort: the draw in the
    sorted domain, mapped back through the permutation; the distribution of
    logits_adapter + sample_token. (B, V) -> (B,) int32."""
    prob = torch.softmax(logits.to(torch.float32) / max(temperature, 1e-10), dim=-1)
    sp, order = torch.sort(prob, dim=-1, descending=True, stable=True)
    keep = torch.cumsum(sp, dim=-1) - sp <= top_p
    logp = torch.where(keep, torch.log(sp.clamp(min=1e-37)), float("-inf"))
    choice = _gumbel_argmax(generator, logp)
    return order.gather(-1, choice[:, None])[:, 0].to(torch.int32)


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
                temperature: float, top_p: float,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Temperature + nucleus sampling. logits (B, V) -> (B,) int32. With
    rows = (first, total), logits are rows [first, first + B) of a batch of
    `total` (one rank's rows under a data-sharded mesh): the noise is drawn
    for the whole batch and sliced, so each row draws what it draws in the
    unsharded run."""
    logits = logits.to(torch.float32)
    if temperature <= GREEDY_TEMPERATURE:
        return logits.argmax(dim=-1).to(torch.int32)
    prob = torch.softmax(logits / max(temperature, 1e-10), dim=-1)
    keep = nucleus_mask(prob, top_p)
    logp = torch.where(keep, torch.log(prob.clamp(min=1e-37)), float("-inf"))
    if rows is None:
        u = torch.rand(logp.shape, generator=generator, device=logp.device)
    else:
        first, total = rows
        u = torch.rand((total, logp.shape[-1]), generator=generator,
                       device=logp.device)[first:first + logp.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (logp + gumbel).argmax(dim=-1).to(torch.int32)
