"""Auxiliary score math from the reference (counterpart of
easykv_tpu/ops/aux_math.py; reference easykv.py:43-54, 137-171). The
decode loop's confidence (entropy, confidence; easykv.py:279) is the only
one a ported path reads; relu_normalize, h2o_head_decay_score and
h2o_head_prob_score are the variants the reference's main path no longer
calls, kept for API completeness as in the JAX package."""
from __future__ import annotations

from typing import Tuple

import torch


def relu_normalize(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Modified sampling distribution relu(p - q) / sum (reference
    easykv.py:43-48)."""
    t = torch.relu(p - q)
    return t / t.sum(dim=-1, keepdim=True)


def entropy(p: torch.Tensor) -> torch.Tensor:
    """Shannon entropy along the last axis."""
    return -(p * torch.log(p.clamp(min=1e-37))).sum(dim=-1)


def confidence(p: torch.Tensor) -> torch.Tensor:
    """exp(-entropy): the reference's per-step confidence (cache_cur_probs)."""
    return torch.exp(-entropy(p))


def h2o_head_decay_score(probs: torch.Tensor, decay_factor: float) -> torch.Tensor:
    """Exponentially decayed attention mass over query rows (reference
    h2o_head_decay_score, easykv.py:137-145): probs (..., R, S), row r
    weighted by decay_factor^(R-1-r), the sum scaled by (1 - decay_factor);
    (..., S) f32."""
    R = probs.shape[-2]
    w = decay_factor ** torch.arange(R - 1, -1, -1, dtype=torch.float32, device=probs.device)
    return torch.einsum("...rs,r->...s", probs.to(torch.float32), w) * (1.0 - decay_factor)


def h2o_head_prob_score(probs: torch.Tensor, row_probs: torch.Tensor,
                        mode: str = "v1") -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-probability-weighted attention mass (reference
    h2o_head_prob_score, easykv.py:158-171): probs (..., R, S), row_probs
    (R,) the sampled tokens' probabilities; rows weighted by 1 - p ('v1') or
    p ('v2'). Returns (Σ, Σ²) over the rows, (..., S) f32."""
    w = 1.0 - row_probs if mode == "v1" else row_probs
    weighted = probs.to(torch.float32) * w[..., :, None]
    return weighted.sum(dim=-2), (weighted * weighted).sum(dim=-2)
