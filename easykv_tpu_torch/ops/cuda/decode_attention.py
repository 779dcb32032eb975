"""Decode attention with the in-flight token (kernel K1), and over a cache
that already holds the token's row (`fused_decode_attend`).

CUDA kernels: easykv_tpu_torch/csrc/decode_attention.cu, entries
`decode_attend_inflight` and `decode_attend` on one kernel body, which
replace the TPU kernels easykv_tpu/ops/pallas/decode_attention.py
`fused_decode_attend_inflight` and `fused_decode_attend`. Both are bound by
the bytes of K and V; the source note says what the design does about that.

`fused_decode_attend_inflight` launches the kernel for CUDA tensors and runs
the plain version, ops.attention.attend_inflight, for CPU tensors. The
kernel keeps p in fp32 through the PV product, as the TPU kernel does; the
plain version rounds p to the cache dtype first, as the JAX package's XLA
path does, so with a bf16 cache the two differ by bf16 rounding of `out`.
With an int8 cache both fold the per-slot scales in fp32 as the TPU kernel
does (k_scale into the logits, v_scale into p) and agree to fp32 rounding.
With `rot` (the ordered StreamingLLM variant) both rotate each cached K
row by its slot from the same f32 cos/sin tables, products rounded one by
one, before the QK product; with `rot` and `rank` (the `rank` variant, the
unordered StreamingLLM cache) by the table row of its age rank.

`fused_decode_attend` launches `decode_attend` for CUDA tensors and runs
its plain version, ops.attention.decode_attend, for CPU tensors; both keep
p in fp32 through the PV product, as the TPU kernel does.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..attention import attend_inflight, decode_attend
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

fused_decode_attend_inflight_plain = attend_inflight
fused_decode_attend_plain = decode_attend

_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "decode_attend_inflight": ([_vp] * 15 + [_int] * 5 + [ctypes.c_float] + [_int] * 3 + [_vp],
                               _int),
    "decode_attend": ([_vp] * 9 + [_int] * 5 + [ctypes.c_float] + [_int] * 3 + [_vp], _int),
    "decode_attend_inflight_smem": ([_int] * 5, ctypes.c_size_t),
}


def _prepare(q, k, v, kv_pos, q_pos, k_scale, v_scale, extra):
    """Checks the arguments both entries share, plus `extra` (name, tensor,
    dtype, shape); returns (library, quantized)."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if T != 1 or Hq % Hkv != 0:
        raise ValueError(f"bad decode shapes q={tuple(q.shape)} k={tuple(k.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode attention takes float32 or bfloat16, got {q.dtype}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V come with k_scale and v_scale; a float cache with neither")
    kv_dtype = torch.int8 if quant else q.dtype
    checks = [("k", k, kv_dtype, (B, Hkv, S, D)), ("v", v, kv_dtype, (B, Hkv, S, D)),
              ("kv_pos", kv_pos, torch.int32, (B, Hkv, S)), ("q_pos", q_pos, torch.int32, (B,))]
    if quant:
        checks += [("k_scale", k_scale, torch.float32, (B, Hkv, S)),
                   ("v_scale", v_scale, torch.float32, (B, Hkv, S))]
    checks += extra
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
    tensors = [q] + [c[1] for c in checks]
    if any(t.device != q.device or not t.is_contiguous() for t in tensors):
        raise ValueError("decode attention takes contiguous tensors on one device")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    rep = Hq // Hkv
    lib = _build.load("decode_attention", SIGNATURES)
    smem = lib.decode_attend_inflight_smem(rep, S, D, _DTYPES[q.dtype], int(quant))
    if smem == 0:
        raise ValueError(f"head_dim {D}: a row must be 1, 2, 4, 8, 16 or 32 16-byte loads")
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"rep*S={rep * S} logits need {smem} bytes of shared memory "
                         f"(limit {_build.SMEM_LIMIT})")
    return lib, quant


def fused_decode_attend_inflight(
    q: torch.Tensor,        # (B, Hq, 1, D) rotated
    k_new: torch.Tensor,    # (B, Hkv, 1, D) rotated, not yet cached
    v_new: torch.Tensor,    # (B, Hkv, 1, D)
    k: torch.Tensor,        # (B, Hkv, S, D) q's dtype, or int8 with scales
    v: torch.Tensor,        # (B, Hkv, S, D)
    kv_pos: torch.Tensor,   # (B, Hkv, S) int32
    q_pos: torch.Tensor,    # (B,) int32, -1 = dead row
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 (int8 K/V)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
    rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (S, D/2) f32 cos, sin
    rank: Optional[torch.Tensor] = None,    # (B, Hkv, S) int32 age ranks, 0 <= rank < S
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (out (B, Hq, 1, D) in q's dtype, probs (B, Hkv, 1, S) f32,
    p_new (B, Hkv, 1) f32); see ops.attention.attend_inflight. The
    in-flight k_new / v_new are in q's dtype whatever the cache's. With
    `rot` the cached K row at slot s is rotated by (cos[s], sin[s]) first
    (ordered StreamingLLM decoding over the rotate-at-read cache); with
    `rank` too, by (cos[rank], sin[rank]) (the unordered StreamingLLM cache
    of the encoding family)."""
    if q.device.type == "cpu":
        return attend_inflight(q, k_new, v_new, k, v, kv_pos, q_pos, k_scale, v_scale,
                               sliding_window=sliding_window, rot=rot, rank=rank)
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    if rank is not None and rot is None:
        raise ValueError("rank= rotates by the rot tables: pass rot too")
    extra = [("k_new", k_new, q.dtype, (B, Hkv, 1, D)), ("v_new", v_new, q.dtype, (B, Hkv, 1, D))]
    if rot is not None:
        extra += [("rot cos", rot[0], torch.float32, (S, D // 2)),
                  ("rot sin", rot[1], torch.float32, (S, D // 2))]
    if rank is not None:
        extra += [("rank", rank, torch.int32, (B, Hkv, S))]
    lib, quant = _prepare(q, k, v, kv_pos, q_pos, k_scale, v_scale, extra)
    out = torch.empty_like(q)
    probs = torch.empty((B, Hkv, 1, S), dtype=torch.float32, device=q.device)
    p_new = torch.empty((B, Hkv, 1), dtype=torch.float32, device=q.device)
    err = lib.decode_attend_inflight(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_pos.data_ptr(), q_pos.data_ptr(), k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, None if rot is None else rot[0].data_ptr(),
        None if rot is None else rot[1].data_ptr(), None if rank is None else rank.data_ptr(),
        out.data_ptr(), probs.data_ptr(), p_new.data_ptr(), B, Hkv, Hq // Hkv, S, D, D ** -0.5,
        _window(sliding_window), _DTYPES[q.dtype], int(quant), _build.stream_of(q))
    _build.check(err, "decode_attend_inflight")
    fused_decode_attend_inflight.launches += 1
    if rank is not None:
        fused_decode_attend_inflight.rank_launches += 1
    elif rot is not None:
        fused_decode_attend_inflight.ordered_launches += 1
    return out, probs, p_new


fused_decode_attend_inflight.launches = 0
fused_decode_attend_inflight.ordered_launches = 0   # those of the `ordered` variant
fused_decode_attend_inflight.rank_launches = 0      # those of the `rank` variant


def fused_decode_attend(
    q: torch.Tensor,        # (B, Hq, 1, D) rotated
    k: torch.Tensor,        # (B, Hkv, S, D) q's dtype, or int8 with scales; holds q's row
    v: torch.Tensor,        # (B, Hkv, S, D)
    kv_pos: torch.Tensor,   # (B, Hkv, S) int32
    q_pos: torch.Tensor,    # (B,) int32, -1 = dead row
    k_scale: Optional[torch.Tensor] = None,  # (B, Hkv, S) f32 (int8 K/V)
    v_scale: Optional[torch.Tensor] = None,
    *,
    sliding_window: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Hq, 1, D) in q's dtype, probs (B, Hkv, 1, S) f32);
    see ops.attention.decode_attend."""
    if q.device.type == "cpu":
        return decode_attend(q, k, v, kv_pos, q_pos, k_scale, v_scale,
                             sliding_window=sliding_window)
    B, Hq, _, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    lib, quant = _prepare(q, k, v, kv_pos, q_pos, k_scale, v_scale, [])
    out = torch.empty_like(q)
    probs = torch.empty((B, Hkv, 1, S), dtype=torch.float32, device=q.device)
    err = lib.decode_attend(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_pos.data_ptr(), q_pos.data_ptr(),
        k_scale.data_ptr() if quant else None, v_scale.data_ptr() if quant else None,
        out.data_ptr(), probs.data_ptr(), B, Hkv, Hq // Hkv, S, D, D ** -0.5,
        _window(sliding_window), _DTYPES[q.dtype], int(quant), _build.stream_of(q))
    _build.check(err, "decode_attend")
    fused_decode_attend.launches += 1
    return out, probs


fused_decode_attend.launches = 0


def _window(sliding_window: Optional[int]) -> int:
    return 0 if sliding_window is None else int(sliding_window)
