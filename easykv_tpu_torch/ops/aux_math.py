"""The reference's decode-loop confidence (counterpart of
easykv_tpu/ops/aux_math.py:17-27; reference easykv.py:50-54, 279): the
only auxiliary score a ported path reads."""
from __future__ import annotations

import torch


def entropy(p: torch.Tensor) -> torch.Tensor:
    """Shannon entropy along the last axis."""
    return -(p * torch.log(p.clamp(min=1e-37))).sum(dim=-1)


def confidence(p: torch.Tensor) -> torch.Tensor:
    """exp(-entropy): the reference's per-step confidence (cache_cur_probs)."""
    return torch.exp(-entropy(p))
