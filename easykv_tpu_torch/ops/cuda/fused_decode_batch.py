"""The batched one-kernel decode step (kernel K15, `fused_decode_step_batch`):
all L layers of a decode token at B rows (1 < B <= 16 for MHA, <= 8 for
GQA: max_rows) over the fused arithmetic-int4 tree (wqkv, wo, wgu, wd as
`q4a` carriers with their bf16 scale pairs `gs3`).

CUDA kernel: easykv_tpu_torch/csrc/fused_decode_batch.cu, one cooperative
launch a step, which replaces the TPU kernel
easykv_tpu/ops/pallas/fused_decode_batch.py `fused_decode_step_batch`. It is
bound by the weight and K/V bytes; the source note says what its design
does about that (tensor-core products, each warp's carrier tiles streamed
through a cp.async ring in shared memory).

It computes the TPU kernel's function, which is not the per-layer scan's:
the residual and every intermediate stay f32 across the layers (h is
rounded to the compute dtype once, at the end), and each product's input row
x is fed per scale group as three rows rounded to the compute dtype (the
TPU kernel's `prep_lhs`, fused_decode_batch.py:201-268 there): A = x_hi,
B = x_lo - x_hi / 16 (formed in f32) and C = x_lo; A is dotted with the
carrier byte p, B and C with u = (p << 4) as int8 = 16 lo, in f32, and a
column adds hi_j (A.p + B.u - C.u) + lo_j C.u over the groups. With an f32
compute dtype nothing rounds, and the step equals the per-layer scan up to
the order of its sums. The K2 / K3 / quantize_kv (and, under streaming, K9)
tail stays outside, in models/llama.py.

`fused_decode_step_batch` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; a CUDA call that cannot launch raises.
It shares K14's per-layer pointer table (fused_decode._layer_table) and the
per-stream workspace (_wstream.workspace).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..rope import rope_base_for
from . import _build, _wstream
from .fused_decode import (_DTYPES, _inv_freq, carrier_planes, check_step_args, scale_groups,
                           step_plain)

MAX_ROWS = 16                     # rows the kernel takes

_vp, _int, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "fused_decode_step_batch": ([_vp] * 16 + [_int] * 13 + [_f, _f] + [_int] * 3 + [_vp], _int),
    "fused_decode_step_batch_smem": ([_int] * 13, ctypes.c_size_t),
    "fused_decode_step_batch_ws": ([_int] * 11, ctypes.c_size_t),
}


def max_rows(cfg) -> int:
    """The most rows a step of `cfg` decodes through K15: 16 for MHA, 8 for
    GQA (the JAX package's bmax, llama.py:827-830)."""
    return MAX_ROWS if cfg.num_attention_heads == cfg.num_key_value_heads else 8


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _product(x: torch.Tensor, w, dt: torch.dtype) -> torch.Tensor:
    """x (B, K) f32 @ the arithmetic carrier w["q4a"] (K/2, N) with its pair
    w["gs3"], through the feed rounded to dt -> (B, N) f32."""
    pf, uf, gs3 = carrier_planes(w)
    gch, kh = pf.shape[0], pf.shape[0] * pf.shape[1]
    xl, xh = x[:, :kh].unflatten(1, (gch, -1)), x[:, kh:].unflatten(1, (gch, -1))

    def dot(X, W):
        return torch.einsum("bgk,gkn->bgn", X.to(dt).to(torch.float32), W)

    a, b, c = dot(xh, pf), dot(xl - xh * 0.0625, uf), dot(xl, uf)
    return scale_groups(a + b - c, c, gs3)


def fused_decode_step_batch_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale=None,
                                  v_scale=None, rope_pos=None):
    """Plain PyTorch version of K15; same arguments and results."""
    return step_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale, v_scale, rope_pos,
                      functools.partial(_product, dt=h0.dtype))


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

_GRID = 0   # blocks of the cooperative launch; 0: as many as are co-resident


def fused_decode_step_batch(
    layers: Sequence,           # per layer: wqkv, wo, wgu, wd QuantLinear (q4a, gs3); ln_attn, ln_mlp
    cfg,                        # ModelConfig
    k: torch.Tensor,            # (L, B, Hkv, S, Dh) int8 or the compute dtype
    v: torch.Tensor,
    pos: torch.Tensor,          # (L, B, Hkv, S) int32
    h0: torch.Tensor,           # (B, D) embedded tokens, compute dtype
    q_pos: torch.Tensor,        # (B,) int32 positions (-1: dead row)
    k_scale: Optional[torch.Tensor] = None,   # (L, B, Hkv, S) f32 with int8 K/V
    v_scale: Optional[torch.Tensor] = None,
    rope_pos: Optional[torch.Tensor] = None,  # (B,) int32 RoPE angle positions (streaming
                                              # pre-rotated); the mask still compares q_pos
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (h (B, D) compute dtype, before the final norm; kn (L, B, Hkv,
    1, Dh) rotated and vn, compute dtype; probs (L, B, Hkv, 1, S) f32; p_new
    (L, B, Hkv) f32)."""
    if h0.device.type == "cpu":
        return fused_decode_step_batch_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale,
                                             v_scale, rope_pos)
    L, B, Hkv, S, Dh = k.shape
    D, F_, Hq = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    dt, dev = h0.dtype, h0.device
    table, groups, quant = check_step_args("K15", MAX_ROWS, layers, cfg, k, v, pos, h0, q_pos,
                                           k_scale, v_scale, rope_pos)
    lib = _build.load("fused_decode_batch", SIGNATURES)
    shape = (B, D, F_, Hq, Hkv, Dh, S, *groups)
    smem = lib.fused_decode_step_batch_smem(*shape, _DTYPES[dt], int(quant))
    if smem == 0:
        raise ValueError(f"head_dim {Dh}: a cache row must be 1, 2, 4, 8, 16 or 32 16-byte loads")
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"K15 needs {smem} bytes of shared memory a block "
                         f"(limit {_build.SMEM_LIMIT})")
    stream = _build.stream_of(h0)
    ws = _wstream.workspace(dev, stream, lib.fused_decode_step_batch_ws(*shape))
    h = torch.empty((B, D), dtype=dt, device=dev)
    kn = torch.empty((L, B, Hkv, 1, Dh), dtype=dt, device=dev)
    vn = torch.empty_like(kn)
    probs = torch.empty((L, B, Hkv, 1, S), dtype=torch.float32, device=dev)
    p_new = torch.empty((L, B, Hkv), dtype=torch.float32, device=dev)
    window = 0 if cfg.sliding_window is None else int(cfg.sliding_window)
    ptr = _wstream.ptr
    err = lib.fused_decode_step_batch(
        table.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), ptr(k_scale),
        ptr(v_scale), h0.data_ptr(), q_pos.data_ptr(), ptr(rope_pos),
        _inv_freq(Dh, rope_base_for(cfg), dev).data_ptr(), h.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), probs.data_ptr(), p_new.data_ptr(), ws.data_ptr(), L, B, D, F_, Hq, Hkv,
        Dh, S, *groups, window, cfg.rms_norm_eps, Dh ** -0.5, _DTYPES[dt], int(quant), _GRID,
        stream)
    _build.check(err, "fused_decode_step_batch")
    fused_decode_step_batch.launches += 1
    return h, kn, vn, probs, p_new


fused_decode_step_batch.launches = 0
