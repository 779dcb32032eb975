"""Rotary position embeddings from position ids (counterpart of
easykv_tpu/ops/rope.py:22-89, the experimental variants at its end
included).

cos/sin are computed from the position ids directly: there is no cache to
resize, and positions past the physical KV budget need nothing special.
DynamicNTK follows `set_dynamicntk_rope_length` (reference utils.py:53-57):
the base is fixed once from a configured target length.
"""
from __future__ import annotations

import torch

from ..config import ModelConfig


def rope_base_for(cfg: ModelConfig) -> float:
    """Effective RoPE base, with the DynamicNTK adjustment baked in.

    HF DynamicNTK: base' = theta * (factor * L / L_max - (factor - 1))^(d/(d-2))
    when the pinned length L exceeds max_position_embeddings.
    """
    base = cfg.rope_theta
    if cfg.rope_scaling_type == "dynamic" and cfg.rope_ntk_length:
        L, Lmax = cfg.rope_ntk_length, cfg.max_position_embeddings
        if L > Lmax:
            f = cfg.rope_scaling_factor
            d = cfg.head_dim
            base = base * ((f * L / Lmax) - (f - 1)) ** (d / (d - 2))
    return float(base)


def rope_inv_freq(head_dim: int, base: float, device: torch.device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies, float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (base ** exponents)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """(cos, sin) of positions (...,) x inv_freq, float32 (..., head_dim//2).
    Negative positions (invalid slots) count as 0; the slot is masked out
    downstream anyway."""
    angles = positions.clamp(min=0).to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF "rotate_half" rotation of x (..., T, head_dim) by precomputed
    cos/sin broadcastable to (..., T, head_dim//2):
    [x1, x2] -> [x1*cos - x2*sin, x2*cos + x1*sin], computed in float32."""
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].to(torch.float32)
    x2 = x[..., d2:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate `x` (..., T, head_dim) by `positions`, broadcastable to
    (..., T). Callers that rotate several tensors by the same positions
    compute rope_cos_sin once and call rotate."""
    return rotate(x, *rope_cos_sin(positions, inv_freq))


# --- Experimental RoPE variants --------------------------------------------
# The reference's unused Self-Extend-style experiments (reference
# llama_patch.py:31-44, 101-122): grouped, neighbor and identical rotary
# application. No engine mode uses them, as in the JAX package.


def apply_grouped_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                       group_size: int) -> torch.Tensor:
    """Self-Extend grouped positions: rotate by positions // group_size."""
    return apply_rope(x, torch.div(positions, group_size, rounding_mode="floor"), inv_freq)


def apply_neighbor_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor,
                        window: int) -> torch.Tensor:
    """Clamp the relative distance: rotate by min(position, window)."""
    return apply_rope(x, positions.clamp(max=window), inv_freq)


def apply_identical_rope(x: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """Rotate every element by position 0 (no rotation)."""
    return apply_rope(x, torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device),
                      inv_freq)
