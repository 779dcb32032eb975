"""The one-kernel decode step (kernel K14, `fused_decode_step`): all L
layers of a B = 1 decode token over the fused arithmetic-int4 tree (wqkv,
wo, wgu, wd as `q4a` carriers with their bf16 scale pairs `gs3`).

CUDA kernel: easykv_tpu_torch/csrc/fused_decode.cu, one cooperative launch
a step, which replaces the TPU kernel easykv_tpu/ops/pallas/fused_decode.py
`fused_decode_step`. It is bound by the weight bytes; the source note says
what its design does about that.

It computes the TPU kernel's function, which is not the per-layer scan's:
the residual and every intermediate stay f32 across the layers (h is
rounded to the compute dtype once, at the end), and each product's input
row is fed as two int8 planes per scale group (the TPU kernel's default
two-plane feed, fused_decode.py:176-257 there): per group the rows A = x_hi,
B = x_lo - x_hi / 16 and C = x_lo, each with sr = max(max|X|, 1e-30) *
f32(1/127), P1 = clip(round(X / sr), +-127) and P2 = clip(round((X / sr -
P1) * 127), +-127), round half to even. A group's integer dots are at most
127 * 127 * 128 < 2^24 in magnitude, so the plain version forms them as
exact f32 products of integer values (one einsum per plane); only the f32
sum over groups and the elementwise steps depend on the order of
operations. The K2 / K3 / quantize_kv (and, under streaming, K9) tail stays
outside, in models/llama.py.

`fused_decode_step` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; a CUDA call that cannot launch raises. The
kernel reads each layer's weights through a device table of per-layer
pointers, built once per layer list and kept while every tensor it points
at is still the one the layers name (the tensors are held with it; moving
the weights elsewhere, or putting a new layer, weight or norm storage in
place of one, builds a new table).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import Optional, Sequence, Tuple

import torch

from ..rope import rope_base_for, rope_inv_freq
from . import _build, _wstream
from .w4_stream import unpack_int4_arith

NEG_INF = -1e30
R127 = 1.0 / 127.0
PRODUCTS = ("wqkv", "wo", "wgu", "wd")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _int, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "fused_decode_step": ([_vp] * 16 + [_int] * 12 + [_f, _f] + [_int] * 3 + [_vp], _int),
    "fused_decode_step_smem": ([_int] * 12, ctypes.c_size_t),
    "fused_decode_step_ws": ([_int] * 10, ctypes.c_size_t),
}


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.to(torch.float32)


def _planes(X: torch.Tensor):
    """(gch, G) f32 rows -> (P1, P2) integer-valued f32 and sr (gch, 1)."""
    sr = X.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) * R127
    q = X / sr
    p1 = torch.round(q).clamp(-127, 127)
    p2 = torch.round((q - p1) * 127.0).clamp(-127, 127)
    return p1, p2, sr


def _product(x: torch.Tensor, w) -> torch.Tensor:
    """x (1, K) f32 @ the arithmetic carrier w["q4a"] (K/2, N) with its pair
    w["gs3"], through the two-plane feed -> (1, N) f32."""
    p, gs3 = w["q4a"], w["gs3"]
    kh, N = p.shape
    gch = gs3.shape[0] // 2
    G = kh // gch
    xl, xh = x[0, :kh].reshape(gch, G), x[0, kh:].reshape(gch, G)
    lo, _ = unpack_int4_arith(p)
    pf = p.to(torch.float32).reshape(gch, G, N)
    uf = (16 * lo.to(torch.float32)).reshape(gch, G, N)    # (p << 4) as int8: 16 lo

    def part(X, W):
        p1, p2, sr = _planes(X)
        dot = lambda P: torch.einsum("gk,gkn->gn", P, W)  # noqa: E731
        return (dot(p1) + dot(p2) * R127) * sr

    af, bf, cf = part(xh, pf), part(xl - xh * 0.0625, uf), part(xl, uf)
    r = torch.cat([af + bf - cf, cf])
    return (r * gs3.to(torch.float32)).sum(dim=0, keepdim=True)


def _rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def fused_decode_step_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale=None, v_scale=None,
                            rope_pos=None):
    """Plain PyTorch version of K14; same arguments and results."""
    L, _, Hkv, S, Dh = k.shape
    Hq, F_ = cfg.num_attention_heads, cfg.intermediate_size
    rep, nq = Hq // Hkv, Hq * Dh
    eps, scale, window = cfg.rms_norm_eps, Dh ** -0.5, cfg.sliding_window
    quant = k_scale is not None
    dev, dt = h0.device, h0.dtype
    inv_freq = rope_inv_freq(Dh, rope_base_for(cfg), dev)
    rp = q_pos if rope_pos is None else rope_pos
    ang = rp[0].clamp(min=0).to(torch.float32) * inv_freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    qp = q_pos[0]
    live = qp >= 0

    h = h0.to(torch.float32)
    kn_o = torch.empty((L, Hkv, 1, Dh), dtype=dt, device=dev)
    vn_o = torch.empty_like(kn_o)
    probs_o = torch.empty((L, Hkv, 1, S), dtype=torch.float32, device=dev)
    pnew_o = torch.empty((L, Hkv), dtype=torch.float32, device=dev)
    for l, p in enumerate(layers):
        qkv = _product(_rms(h, p.ln_attn, eps), p.wqkv)
        q_rot = _rot(qkv[0, :nq].reshape(Hkv, rep, Dh), cos, sin)
        kn_rot = _rot(qkv[0, nq:nq + Hkv * Dh].reshape(Hkv, 1, Dh), cos, sin)
        vn = qkv[0, nq + Hkv * Dh:].reshape(Hkv, 1, Dh)
        logits = torch.einsum("hrd,hsd->hrs", q_rot, k[l, 0].to(torch.float32)) * scale
        if quant:
            logits = logits * k_scale[l, 0][:, None, :]
        logit_new = (q_rot * kn_rot).sum(dim=-1, keepdim=True) * scale
        pv = pos[l, 0][:, None, :]
        mask = (pv >= 0) & (pv <= qp)
        if window is not None:
            mask &= pv > qp - window
        logits = torch.where(mask, logits, NEG_INF)
        logit_new = torch.where(live, logit_new, NEG_INF)
        m = torch.maximum(logits.amax(dim=-1, keepdim=True), logit_new)
        e = torch.where(mask, torch.exp(logits - m), 0.0)
        e_new = torch.where(live, torch.exp(logit_new - m), 0.0)
        denom = (e.sum(dim=-1, keepdim=True) + e_new).clamp(min=1e-30)
        pr, p_new = e / denom, e_new / denom
        pvv = pr * v_scale[l, 0][:, None, :] if quant else pr
        out = torch.einsum("hrs,hsd->hrd", pvv, v[l, 0].to(torch.float32)) + p_new * vn
        probs_o[l] = pr.mean(dim=1, keepdim=True)
        pnew_o[l] = p_new.mean(dim=1)[:, 0]
        kn_o[l] = kn_rot.to(dt)
        vn_o[l] = vn.to(dt)

        h = h + _product(out.reshape(1, nq), p.wo)
        gu = _product(_rms(h, p.ln_mlp, eps), p.wgu)
        g, up = gu[:, :F_], gu[:, F_:]
        h = h + _product(g * torch.sigmoid(g) * up, p.wd)
    return h.to(dt), kn_o, vn_o, probs_o, pnew_o


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

_tables: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_GRID = 0   # blocks of the cooperative launch; 0: as many as are co-resident


def _layer_key(layers) -> Tuple[int, ...]:
    """What a layer list's table depends on: each product's carrier and
    scale pair by identity (QuantLinear buffers are replaced, not changed in
    place, when a module moves or converts), each norm weight by address (a
    Parameter keeps its identity when `.to` swaps its storage). The table
    holds the tensors, so no identity is reused while it is kept. Read
    through the modules' dicts: ~50 us at L = 32 against ~250 through
    attribute access on a slow host core."""
    key = []
    for p in layers:
        mods, prms = p._modules, p._parameters
        for n in PRODUCTS:
            b = mods[n]._buffers
            key += (id(b["q4a"]), id(b["gs3"]))
        key += (prms["ln_attn"].data_ptr(), prms["ln_mlp"].data_ptr())
    return tuple(key)


def _layer_table(layers, carriers, dt: torch.dtype, dev: torch.device):
    """(table (L, 10) int64 of device pointers, group counts (gq, go, gg,
    gd)) for a layer list whose products have the carrier shapes
    `carriers`, built once and kept while the compute dtype, the device and
    _layer_key stay the same: a layer, a weight or a norm's storage put in
    place of one, in any layer, builds a new table."""
    key = (dt, dev) + _layer_key(layers)
    hit = _tables.get(layers)
    if hit is not None and hit[2] == key:
        return hit[:2]
    D = carriers["wqkv"][0] * 2
    groups = tuple(getattr(layers[0], n)["gs3"].shape[0] // 2 for n in PRODUCTS)
    held, rows = [], []
    for l, p in enumerate(layers):
        row = []
        for n, gch in zip(PRODUCTS, groups):
            w = getattr(p, n)
            kh, N = carriers[n]
            for leaf, dtype, shape in (("q4a", torch.int8, (kh, N)),
                                       ("gs3", torch.bfloat16, (2 * gch, N))):
                t = w[leaf]
                if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
                        or t.data_ptr() % 16 or tuple(t.shape) != shape):
                    raise ValueError(f"layer {l} {n}[{leaf}]: {t.dtype} {tuple(t.shape)} on "
                                     f"{t.device}; K14 takes a contiguous 16-byte aligned "
                                     f"{dtype} {shape} on {dev}")
                held.append(t)
                row.append(t.data_ptr())
        for n in ("ln_attn", "ln_mlp"):
            t = getattr(p, n)
            if t.dtype != dt or t.device != dev or tuple(t.shape) != (D,) or not t.is_contiguous():
                raise ValueError(f"layer {l} {n}: expected {dt} ({D},) on {dev}")
            held.append(t.detach())
            row.append(t.data_ptr())
        rows.append(row)
    table = torch.tensor(rows, dtype=torch.int64).to(dev)
    _tables[layers] = (table, groups, key, held)
    return table, groups


@functools.lru_cache(maxsize=None)
def _inv_freq(Dh: int, base: float, dev: torch.device) -> torch.Tensor:
    return rope_inv_freq(Dh, base, dev)


def fused_decode_step(
    layers: Sequence,           # per layer: wqkv, wo, wgu, wd QuantLinear (q4a, gs3); ln_attn, ln_mlp
    cfg,                        # ModelConfig
    k: torch.Tensor,            # (L, 1, Hkv, S, Dh) int8 or the compute dtype
    v: torch.Tensor,
    pos: torch.Tensor,          # (L, 1, Hkv, S) int32
    h0: torch.Tensor,           # (1, D) embedded token, compute dtype
    q_pos: torch.Tensor,        # (1,) int32 position (-1: dead row)
    k_scale: Optional[torch.Tensor] = None,   # (L, 1, Hkv, S) f32 with int8 K/V
    v_scale: Optional[torch.Tensor] = None,
    rope_pos: Optional[torch.Tensor] = None,  # (1,) int32 RoPE angle position (streaming
                                              # pre-rotated); the mask still compares q_pos
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (h (1, D) compute dtype, before the final norm; kn (L, Hkv, 1,
    Dh) rotated and vn, compute dtype; probs (L, Hkv, 1, S) f32; p_new (L,
    Hkv) f32)."""
    if h0.device.type == "cpu":
        return fused_decode_step_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale, v_scale,
                                       rope_pos)
    L, B, Hkv, S, Dh = k.shape
    D, F_, Hq = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    dt, dev = h0.dtype, h0.device
    if dt not in _DTYPES:
        raise TypeError(f"K14 takes float32 or bfloat16 activations, got {dt}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V come with k_scale and v_scale; a float cache with neither")
    if B != 1 or len(layers) != L or Hq % Hkv or Dh != cfg.head_dim:
        raise ValueError(f"K14 takes B = 1 and one cache layer per layer: k {tuple(k.shape)}, "
                         f"{len(layers)} layers, {Hq} query heads, head_dim {cfg.head_dim}")
    checks = [("k", k, torch.int8 if quant else dt, (L, 1, Hkv, S, Dh)),
              ("v", v, torch.int8 if quant else dt, (L, 1, Hkv, S, Dh)),
              ("pos", pos, torch.int32, (L, 1, Hkv, S)), ("h0", h0, dt, (1, D)),
              ("q_pos", q_pos, torch.int32, (1,))]
    if quant:
        checks += [("k_scale", k_scale, torch.float32, (L, 1, Hkv, S)),
                   ("v_scale", v_scale, torch.float32, (L, 1, Hkv, S))]
    if rope_pos is not None:
        checks.append(("rope_pos", rope_pos, torch.int32, (1,)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: K14 takes contiguous tensors on {dev}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    nq = (Hq + 2 * Hkv) * Dh
    carriers = {"wqkv": (D // 2, nq), "wo": (Hq * Dh // 2, D), "wgu": (D // 2, 2 * F_),
                "wd": (F_ // 2, D)}
    table, groups = _layer_table(layers, carriers, dt, dev)
    lib = _build.load("fused_decode", SIGNATURES)
    smem = lib.fused_decode_step_smem(D, F_, Hq, Hkv, Dh, S, *groups, _DTYPES[dt], int(quant))
    if smem == 0:
        raise ValueError(f"head_dim {Dh}: a cache row must be 1, 2, 4, 8, 16 or 32 16-byte loads")
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"K14 needs {smem} bytes of shared memory a block "
                         f"(limit {_build.SMEM_LIMIT})")
    stream = _build.stream_of(h0)
    ws = _wstream.workspace(dev, stream, lib.fused_decode_step_ws(D, F_, Hq, Hkv, Dh, S, *groups))
    h = torch.empty((1, D), dtype=dt, device=dev)
    kn = torch.empty((L, Hkv, 1, Dh), dtype=dt, device=dev)
    vn = torch.empty_like(kn)
    probs = torch.empty((L, Hkv, 1, S), dtype=torch.float32, device=dev)
    p_new = torch.empty((L, Hkv), dtype=torch.float32, device=dev)
    window = 0 if cfg.sliding_window is None else int(cfg.sliding_window)
    ptr = _wstream.ptr
    err = lib.fused_decode_step(
        table.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), ptr(k_scale),
        ptr(v_scale), h0.data_ptr(), q_pos.data_ptr(), ptr(rope_pos),
        _inv_freq(Dh, rope_base_for(cfg), dev).data_ptr(), h.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), probs.data_ptr(), p_new.data_ptr(), ws.data_ptr(), L, D, F_, Hq, Hkv,
        Dh, S, *groups, window, cfg.rms_norm_eps, Dh ** -0.5, _DTYPES[dt], int(quant),
        _GRID, stream)
    _build.check(err, "fused_decode_step")
    fused_decode_step.launches += 1
    return h, kn, vn, probs, p_new


fused_decode_step.launches = 0
