"""Age-ordered compaction of the KV cache for ordered StreamingLLM decoding:
the K/V shift with the pre-rotation update (kernel K9) and the shift of
every cache array at the evicted slot (kernel K8).

CUDA kernels: easykv_tpu_torch/csrc/kv_compact.cu, which replace the TPU
kernels easykv_tpu/ops/pallas/sidecar_update.py `fused_kv_compact` and
`fused_compact`. Both are bound by the bytes of the rows at and above each
head's victim, read once and written once; the source note says what their
design does about that. K9 takes each head's tail in rounds of rows held
in shared memory, all of a round's rows in flight at once (`shift_plan`;
`shift_dealing` mirrors the rounds); K8 walks each head's tail in tiles.

`fused_kv_compact` and `fused_compact` launch their kernels for CUDA
tensors and run `fused_kv_compact_plain` / `fused_compact_plain` for CPU
tensors. The plain versions are the TPU kernels' roll + select over the
whole cache, with the rotation and the int8 requant written op by op as
the kernel computes them, so the kernels are held to them bit for bit.
Everything is updated in place. A head with no eviction (victim slot S)
is left as it is; launches need no host check of which heads evict.

`fused_kv_compact_sharded` is K9 on this rank's (L, B/d, Hkv/m, S) shard of
a (data, model) mesh: pre-rotated StreamingLLM decoding under a mesh, where
the JAX package shifts and rotates in XLA (easykv_tpu/engine/generate.py
_compact_one's rot_inv_freq branch, :694-723 there). Every (layer, row,
head) shifts on its own, so the rank launches the kernel on its shard with
no collective.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from ...cache import INV_127
from ...parallel.mesh import local_dims
from . import _build
from .sidecar_update import _shift_down

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "kv_compact": ([_vp] * 7 + [_int] * 7 + [_vp], _int),
    "compact": ([_vp] * 9 + [_int] * 4 + [_vp], _int),
    "kv_compact_smem": ([_int] * 4, ctypes.c_size_t),
    "kv_shift_smem": ([_int] * 3, ctypes.c_size_t),
}


# K9's row kernel (csrc/kv_compact.cu shift_rows_kernel): a block of
# SHIFT_THREADS threads a head, its tail in rounds of rows holding SHIFT_TILE
# bytes of K and V (from `python3 tools/torch_k13_k9_times.py --sweep`,
# PERF.md section 6)
SHIFT_THREADS = 256
SHIFT_TILE = 65536


class ShiftPlan(NamedTuple):
    lanes: int     # lanes a row (G): its 16-byte units, at most 32; 0: the per-head walk
    units: int     # 16-byte units a lane holds of a row (1 or 2)
    threads: int   # threads a block
    rows: int      # rows a round


def shift_smem(rows: int, units: int) -> int:
    """Shared memory of a block of the row kernel (csrc/kv_compact.cu
    shift_smem): its mbarrier, `rows` rows of K and of V and slot 0's, and
    their scales."""
    return 16 + 16 * (2 * rows * units + 2 * units) + 4 * (2 * rows + 2)


def shift_plan(D: int, elem_bytes: int) -> ShiftPlan:
    """K9's launch for rows of D elements of `elem_bytes` bytes: the row
    kernel where a row is a power of two 16-byte units, 2 to 64 (half rows
    whole units; one or two a lane; rows a round: SHIFT_TILE bytes of K and
    V), else the per-head walk (all zero)."""
    units = D * elem_bytes // 16
    if units < 2 or units > 64 or units & (units - 1):
        return ShiftPlan(0, 0, 0, 0)
    lanes = min(units, 32)
    return ShiftPlan(lanes, units // lanes, SHIFT_THREADS, SHIFT_TILE // (2 * 16 * units))


def shift_dealing(p: ShiftPlan, S: int, vs: int) -> List[Tuple[int, int]]:
    """(first row, rows) of every round the row kernel runs in a head whose
    victim is `vs`: its tail [max(vs, 0), S) in rounds of p.rows rows."""
    return [(first, min(p.rows, S - first)) for first in range(max(vs, 0), S, p.rows)]


def shift_rotation(inv_freq: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of inv_freq, f32 (D/2,): the `rot` of fused_kv_compact,
    whose fixed R(-theta) one shift applies. Built once per run; the kernel
    and its plain version read the same tensors."""
    f = inv_freq.to(torch.float32)
    return torch.cos(f).contiguous(), torch.sin(f).contiguous()


def fused_kv_compact_plain(k, v, v_slot, k_scale=None, v_scale=None, rot=None):
    """Plain PyTorch version of K9; same arguments and results."""
    S, D = k.shape[3], k.shape[4]
    ge = torch.arange(S, dtype=torch.int32, device=k.device) >= v_slot[..., None]
    ge5 = ge[..., None]
    quant = k_scale is not None
    k_roll = torch.roll(k, -1, dims=3)
    if rot is not None:
        c, s = rot
        kf = k_roll.to(torch.float32)
        x1, x2 = kf[..., :D // 2], kf[..., D // 2:]
        y = torch.cat([x1 * c + x2 * s, x2 * c - x1 * s], dim=-1)   # R(-theta)
        if quant:
            amax = y.abs().amax(dim=-1)
            f = torch.div(torch.full_like(amax, 127.0), amax.clamp(min=1e-30))
            qn = torch.round(y * f[..., None]).clamp(-127, 127).to(torch.int8)
            nsc = (torch.roll(k_scale, -1, dims=3) * amax).clamp(min=1e-8) * INV_127
            k.copy_(torch.where(ge5, qn, k))
            k_scale.copy_(torch.where(ge, nsc, k_scale))
        else:
            k.copy_(torch.where(ge5, y.to(k.dtype), k))
    else:
        k.copy_(torch.where(ge5, k_roll, k))
        if quant:
            k_scale.copy_(_shift_down(k_scale, ge))
    v.copy_(torch.where(ge5, torch.roll(v, -1, dims=3), v))
    if quant:
        v_scale.copy_(_shift_down(v_scale, ge))
        return k, v, k_scale, v_scale
    return k, v


def _check(tensors, dev):
    for name, t, dtype, shape in tensors:
        if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_kv(k, v, k_scale, v_scale):
    L, B, H, S, D = k.shape
    if k.dtype not in _DTYPES:
        raise TypeError(f"K/V compaction takes float32, bfloat16 or int8, got {k.dtype}")
    if (k.dtype == torch.int8) != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("an int8 cache comes with k_scale and v_scale; a float cache with neither")
    if (D * k.element_size()) % 16 or D % 2 or D > 256:
        raise ValueError(f"head_dim {D}: a row must be a multiple of 16 bytes, D even, <= 256")
    t = [("k", k, k.dtype, k.shape), ("v", v, k.dtype, k.shape)]
    if k_scale is not None:
        t += [("k_scale", k_scale, torch.float32, (L, B, H, S)),
              ("v_scale", v_scale, torch.float32, (L, B, H, S))]
    _check(t, k.device)
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")


def _lib(k, S, with_row):
    lib = _build.load("kv_compact", SIGNATURES)
    smem = lib.kv_compact_smem(S, k.shape[-1], _DTYPES[k.dtype], int(with_row))
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"{smem} bytes of shared memory (limit {_build.SMEM_LIMIT})")
    return lib


def fused_kv_compact(
    k: torch.Tensor,          # (L, B, H, S, D) bf16 / f32 / int8, shifted in place
    v: torch.Tensor,
    v_slot: torch.Tensor,     # (L, B, H) int32 victim slot per head; S = no eviction
    k_scale: Optional[torch.Tensor] = None,   # (L, B, H, S) f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    rot: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (cos, sin) (D/2,) f32
):
    """Shifts each head's K/V rows (and scales) at and above its victim down
    by one; with `rot` (shift_rotation(inv_freq)), each shifted K row takes
    R(-theta) (an int8 row is requantized, its scale rebuilt from the old
    one). Returns (k, v[, k_scale, v_scale])."""
    if k.device.type == "cpu":
        return fused_kv_compact_plain(k, v, v_slot, k_scale, v_scale, rot)
    L, B, H, S, D = k.shape
    _check_kv(k, v, k_scale, v_scale)
    _check([("v_slot", v_slot, torch.int32, (L, B, H))], k.device)
    cos, sin = (None, None) if rot is None else rot
    if rot is not None:
        _check([("cos", cos, torch.float32, (D // 2,)), ("sin", sin, torch.float32, (D // 2,))],
               k.device)
    lib = _lib(k, S, False)
    plan = shift_plan(D, k.element_size())

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.kv_compact(k.data_ptr(), v.data_ptr(), v_slot.data_ptr(), ptr(k_scale),
                         ptr(v_scale), ptr(cos), ptr(sin), L * B * H, S, D, _DTYPES[k.dtype],
                         int(rot is not None), plan.threads, plan.rows, _build.stream_of(k))
    _build.check(err, "kv_compact")
    fused_kv_compact.launches += 1
    return (k, v) if k_scale is None else (k, v, k_scale, v_scale)


fused_kv_compact.launches = 0


def fused_kv_compact_sharded(k, v, v_slot, k_scale=None, v_scale=None, rot=None, *, mesh,
                             data_axis: str = "data", model_axis: str = "model"):
    """fused_kv_compact on this rank's shards. in_specs: k, v (., d, m, .,
    .); v_slot (., d, m); k_scale, v_scale (., d, m, .); rot replicated.
    out_specs: those of k, v, k_scale, v_scale."""
    d, m = data_axis, model_axis
    p4 = (None, d, m, None)
    local_dims("fused_kv_compact_sharded", mesh, d, m, [
        ("k", k, p4 + (None,)), ("v", v, p4 + (None,)), ("v_slot", v_slot, p4[:3]),
        ("k_scale", k_scale, p4), ("v_scale", v_scale, p4)])
    res = fused_kv_compact(k, v, v_slot, k_scale, v_scale, rot)
    if k.is_cuda:
        fused_kv_compact_sharded.launches += 1
    return res


fused_kv_compact_sharded.launches = 0


def fused_compact_plain(pos_mid, pos, score, score_sq, counter, k, v, k_scale=None,
                        v_scale=None):
    """Plain PyTorch version of K8; same arguments and results."""
    S = pos.shape[-1]
    iota = torch.arange(S, dtype=torch.int32, device=pos.device)
    evicted = (pos_mid >= 0) & (pos < 0)
    v_slot = torch.where(evicted, iota, S).amin(dim=-1, keepdim=True)   # S: none
    ge = iota >= v_slot
    fired = v_slot < S
    pos.copy_(torch.where(fired & (iota == S - 1), -1, _shift_down(pos, ge)))
    side = [score, score_sq, counter] + ([k_scale, v_scale] if k_scale is not None else [])
    for x in side:
        x.copy_(_shift_down(x, ge))
    for x in (k, v):
        x.copy_(torch.where(ge[..., None], torch.roll(x, -1, dims=3), x))
    res = (pos, score, score_sq, counter, k, v)
    return res + ((k_scale, v_scale) if k_scale is not None else ())


def fused_compact(
    pos_mid: torch.Tensor,    # (L, B, H, S) int32: pos before the eviction
    pos: torch.Tensor,        # (L, B, H, S) int32: after it; shifted in place
    score: torch.Tensor,      # (L, B, H, S) f32
    score_sq: torch.Tensor,
    counter: torch.Tensor,
    k: torch.Tensor,          # (L, B, H, S, D) bf16 / f32 / int8
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor] = None,   # (L, B, H, S) f32 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
):
    """Per head, the victim is the first slot that went from valid (pos_mid)
    to invalid (pos); every cache array shifts down by one at and above it,
    and slot S-1 gets pos = -1. Returns (pos, score, score_sq, counter, k,
    v[, k_scale, v_scale])."""
    if pos.device.type == "cpu":
        return fused_compact_plain(pos_mid, pos, score, score_sq, counter, k, v, k_scale,
                                   v_scale)
    L, B, H, S, D = k.shape
    _check_kv(k, v, k_scale, v_scale)
    full = (L, B, H, S)
    _check([("pos_mid", pos_mid, torch.int32, full), ("pos", pos, torch.int32, full),
            ("score", score, torch.float32, full), ("score_sq", score_sq, torch.float32, full),
            ("counter", counter, torch.float32, full)], k.device)
    lib = _lib(k, S, True)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.compact(pos_mid.data_ptr(), pos.data_ptr(), score.data_ptr(), score_sq.data_ptr(),
                      counter.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale),
                      ptr(v_scale), L * B * H, S, D, _DTYPES[k.dtype], _build.stream_of(k))
    _build.check(err, "compact")
    fused_compact.launches += 1
    res = (pos, score, score_sq, counter, k, v)
    return res + ((k_scale, v_scale) if k_scale is not None else ())


fused_compact.launches = 0
