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
place of one, builds a new table), and each carrier through a tensor map
made from that table once (`_tensor_maps`). `items` mirrors how the
kernel deals each product's items (a scale group of 128 columns) to
its blocks and warps, `slot_layout` its shared memory.
The plain layer loop (step_plain), the argument checks (check_step_args)
and the layer table are shared with the batched step K15
(ops/cuda/fused_decode_batch.py).
"""
from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple, Optional, Sequence, Tuple

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
    "fused_decode_step": ([_vp] * 17 + [_int] * 13 + [_f, _f] + [_int] * 3 + [_vp], _int),
    "fused_decode_step_smem": ([_int] * 12, ctypes.c_size_t),
    "fused_decode_step_slots": ([_int] * 12, _int),
    "fused_decode_step_grid": ([_int] * 12, _int),
    "fused_decode_step_ws": ([_int] * 10, ctypes.c_size_t),
    "fused_decode_maps": ([_vp] + [_int] * 10 + [_vp], _int),
}
# csrc/fused_decode.cu's item geometry (the kernel's layout_of and prod_of)
TILE = 128            # columns of an item (kTN)
THREADS = 512         # threads of a block (fused_step.cuh kThreads)
MAX_SLOTS = 12        # warps with a carrier slot (kMaxSlots)
MAX_CHUNKS = 8        # attention chunks of a KV head (fused_step.cuh kMaxChunks)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    var = (x * x).mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w.to(torch.float32)


def _planes(X: torch.Tensor):
    """(..., G) f32 rows -> (P1, P2) integer-valued f32 and sr (..., 1)."""
    sr = X.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) * R127
    q = X / sr
    p1 = torch.round(q).clamp(-127, 127)
    p2 = torch.round((q - p1) * 127.0).clamp(-127, 127)
    return p1, p2, sr


def scale_groups(r_hi: torch.Tensor, r_lo: torch.Tensor, gs3: torch.Tensor) -> torch.Tensor:
    """Per-group sums (B, gch, N) of the hi and lo halves -> (B, N) f32:
    each group's sums times its scale pair [hi; lo] / 16, added over the
    groups."""
    gch = gs3.shape[0] // 2
    g = gs3.to(torch.float32)
    return (r_hi * g[:gch] + r_lo * g[gch:]).sum(dim=1)


def carrier_planes(w):
    """The carrier w["q4a"] (K/2, N) as f32 (gch, G, N) planes p (the byte,
    16 hi + lo) and u = (p << 4) as int8 = 16 lo, with w["gs3"]."""
    p, gs3 = w["q4a"], w["gs3"]
    gch, N = gs3.shape[0] // 2, p.shape[1]
    lo, _ = unpack_int4_arith(p)
    return (p.to(torch.float32).reshape(gch, -1, N),
            (16 * lo.to(torch.float32)).reshape(gch, -1, N), gs3)


def _product(x: torch.Tensor, w) -> torch.Tensor:
    """x (B, K) f32 @ the arithmetic carrier w["q4a"] (K/2, N) with its pair
    w["gs3"], through the two-plane feed -> (B, N) f32."""
    pf, uf, gs3 = carrier_planes(w)
    gch, kh = pf.shape[0], pf.shape[0] * pf.shape[1]
    xl, xh = x[:, :kh].unflatten(1, (gch, -1)), x[:, kh:].unflatten(1, (gch, -1))

    def part(X, W):
        p1, p2, sr = _planes(X)
        dot = lambda P: torch.einsum("bgk,gkn->bgn", P, W)  # noqa: E731
        return (dot(p1) + dot(p2) * R127) * sr

    af, bf, cf = part(xh, pf), part(xl - xh * 0.0625, uf), part(xl, uf)
    return scale_groups(af + bf - cf, cf, gs3)


def _rot(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def step_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale, v_scale, rope_pos, product,
               rms=None):
    """The layers of one decode step at B rows, in plain PyTorch, with
    `product(x (B, K) f32, w) -> (B, N) f32` for each quantized product:
    K14's and K15's plain versions are this loop with their feeds. `rms(x,
    w, eps)` replaces the RMSNorm (a check that needs the kernel's order of
    its sums). The
    residual and every intermediate stay f32; h is rounded to h0's dtype
    once, at the end. Returns (h (B, D), kn (L, B, Hkv, 1, Dh) rotated, vn,
    probs (L, B, Hkv, 1, S) f32 averaged over each KV head's query heads,
    p_new (L, B, Hkv) f32)."""
    L, B, Hkv, S, Dh = k.shape
    Hq, F_ = cfg.num_attention_heads, cfg.intermediate_size
    rep, nq = Hq // Hkv, Hq * Dh
    eps, scale, window = cfg.rms_norm_eps, Dh ** -0.5, cfg.sliding_window
    quant = k_scale is not None
    dev, dt = h0.device, h0.dtype
    rms = rms or _rms
    inv_freq = rope_inv_freq(Dh, rope_base_for(cfg), dev)
    rp = q_pos if rope_pos is None else rope_pos
    ang = rp.clamp(min=0).to(torch.float32)[:, None, None, None] * inv_freq   # (B, 1, 1, Dh/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    qp = q_pos[:, None, None, None]
    live = qp >= 0

    h = h0.to(torch.float32)
    kn_o = torch.empty((L, B, Hkv, 1, Dh), dtype=dt, device=dev)
    vn_o = torch.empty_like(kn_o)
    probs_o = torch.empty((L, B, Hkv, 1, S), dtype=torch.float32, device=dev)
    pnew_o = torch.empty((L, B, Hkv), dtype=torch.float32, device=dev)
    for l, p in enumerate(layers):
        qkv = product(rms(h, p.ln_attn, eps), p.wqkv)
        q_rot = _rot(qkv[:, :nq].reshape(B, Hkv, rep, Dh), cos, sin)
        kn_rot = _rot(qkv[:, nq:nq + Hkv * Dh].reshape(B, Hkv, 1, Dh), cos, sin)
        vn = qkv[:, nq + Hkv * Dh:].reshape(B, Hkv, 1, Dh)
        logits = torch.einsum("bhrd,bhsd->bhrs", q_rot, k[l].to(torch.float32)) * scale
        if quant:
            logits = logits * k_scale[l][:, :, None, :]
        logit_new = (q_rot * kn_rot).sum(dim=-1, keepdim=True) * scale
        pv = pos[l][:, :, None, :]
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
        pvv = pr * v_scale[l][:, :, None, :] if quant else pr
        out = torch.einsum("bhrs,bhsd->bhrd", pvv, v[l].to(torch.float32)) + p_new * vn
        probs_o[l] = pr.mean(dim=2, keepdim=True)
        pnew_o[l] = p_new.mean(dim=2)[..., 0]
        kn_o[l] = kn_rot.to(dt)
        vn_o[l] = vn.to(dt)

        h = h + product(out.reshape(B, nq), p.wo)
        gu = product(rms(h, p.ln_mlp, eps), p.wgu)
        g, up = gu[:, :F_], gu[:, F_:]
        h = h + product(g * torch.sigmoid(g) * up, p.wd)
    return h.to(dt), kn_o, vn_o, probs_o, pnew_o


def fused_decode_step_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale=None, v_scale=None,
                            rope_pos=None):
    """Plain PyTorch version of K14; same arguments and results."""
    h, kn, vn, probs, p_new = step_plain(layers, cfg, k, v, pos, h0, q_pos, k_scale, v_scale,
                                         rope_pos, _product)
    return h, kn[:, 0], vn[:, 0], probs[:, 0], p_new[:, 0]


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

_tables: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_maps: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_GRID = 0   # blocks of the cooperative launch; 0: as many as are co-resident
MAP_BYTES = 128   # a CUtensorMap


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
                                     f"{t.device}; the one-kernel step takes a contiguous "
                                     f"16-byte aligned {dtype} {shape} on {dev}")
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


def _tensor_maps(layers, table: torch.Tensor, dims, lib) -> Tuple[torch.Tensor, int]:
    """(the (L, 4) tensor maps of the layers' carriers on the table's device,
    the mask of the products that have them), made by the C side from the
    table's pointers once per layer table and kept beside it."""
    hit = _maps.get(layers)
    if hit is not None and hit[0] is table:
        return hit[1], hit[2]
    host = table.cpu()
    buf = torch.zeros(host.shape[0] * 4 * MAP_BYTES, dtype=torch.uint8)
    mask = lib.fused_decode_maps(host.data_ptr(), host.shape[0], *dims, buf.data_ptr())
    if mask < 0:
        _build.check(-mask, "fused_decode_maps")
    maps = buf.to(table.device)
    _maps[layers] = (table, maps, mask)
    return maps, mask


@functools.lru_cache(maxsize=None)
def _inv_freq(Dh: int, base: float, dev: torch.device) -> torch.Tensor:
    return rope_inv_freq(Dh, base, dev)


class Product(NamedTuple):
    """One product of a layer as K14 streams it: its carrier (kh, N) in gch
    groups of G rows, its N columns in `tiles` tiles of TILE columns; an
    item is one group of one tile."""
    kh: int
    N: int
    gch: int
    G: int
    tiles: int


def products(D: int, F_: int, Hq: int, Hkv: int, Dh: int, groups) -> Tuple[Product, ...]:
    """wqkv, wo, wgu, wd as csrc/fused_decode.cu's prod_of."""
    out = []
    for kh, N, gch in ((D // 2, (Hq + 2 * Hkv) * Dh, groups[0]), (Hq * Dh // 2, D, groups[1]),
                       (D // 2, 2 * F_, groups[2]), (F_ // 2, D, groups[3])):
        out.append(Product(kh, N, gch, kh // gch, -(-N // TILE)))
    return tuple(out)


def items(P: Product, blocks: int, slots: int):
    """The items (group, tile) each (block, warp) of a grid of `blocks` takes
    of product P, in order, as csrc/fused_decode.cu deals them (deal_of):
    block b takes group b mod gch (or b, b + blocks, ... where the groups
    outnumber the blocks), the blocks of a group its tiles in turn, warp w
    of them (w < slots) tiles rank + nb w, rank + nb (w + slots), ...
    Returns {(block, warp): [(j, t), ...]}."""
    out = {}
    spread = blocks >= P.gch
    for b in range(blocks):
        j0 = b % P.gch if spread else b
        rank = b // P.gch if spread else 0
        step = P.gch if spread else blocks
        for w in range(slots):
            taken = []
            for j in range(j0, P.gch, step):
                nb = (blocks - j + P.gch - 1) // P.gch if spread else 1
                taken += [(j, t) for t in range(rank + nb * w, P.tiles, nb * slots)]
                if spread:
                    break
            out[(b, w)] = taken
    return out


def _group_floats(rep: int, S: int, Dh: int, kv_bytes: int) -> int:
    G = THREADS // (Dh // (16 // kv_bytes))
    return rep * Dh + rep * S + rep + THREADS // 32 + G * Dh + 3 * Dh + (rep + 2) * Dh


def slot_layout(prods: Sequence[Product], Hq: int, Hkv: int, Dh: int, S: int,
                kv_bytes: int) -> Tuple[int, int, int]:
    """(slot bytes, warps with a slot, shared memory bytes of a block) as
    csrc/fused_decode.cu's layout_of: the slots (two bf16 scale rows and
    an item's carrier rows, padded to 16, of TILE bytes), which the
    attention's chunk shares, their barriers, and the input prep (staged
    input rows, planes, the row table)."""
    up = lambda n, a: -(-n // a) * a  # noqa: E731
    gp = max(up(P.G, 16) for P in prods)
    gmax = max(P.G for P in prods)
    slot = up(4 * TILE + gp * TILE, 128)
    prep = 4 * (2 * gmax + THREADS // 32 + 4 + Hq * (3 + MAX_CHUNKS)) + 6 * gp
    att = 4 * _group_floats(Hq // Hkv, S, Dh, kv_bytes)
    fixed = 128 + up(prep, 16) + 8 * MAX_SLOTS
    slots = min(MAX_SLOTS, max(1, (_build.SMEM_LIMIT - fixed) // slot))
    region = up(max(slots * slot, att), 128)
    return slot, slots, 128 + up(region + 8 * slots, 16) + prep


def check_step_args(key, max_rows, layers, cfg, k, v, pos, h0, q_pos, k_scale, v_scale,
                    rope_pos):
    """What the C side of a one-kernel step (K14, K15) cannot check: types,
    shapes, devices and layout of its arguments for 1 .. max_rows rows.
    Returns (the layer table, its group counts, whether the cache is
    int8)."""
    L, B, Hkv, S, Dh = k.shape
    D, F_, Hq = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    dt, dev = h0.dtype, h0.device
    if dt not in _DTYPES:
        raise TypeError(f"{key} takes float32 or bfloat16 activations, got {dt}")
    quant = k.dtype == torch.int8
    if quant != (k_scale is not None) or (k_scale is None) != (v_scale is None):
        raise ValueError("int8 K/V come with k_scale and v_scale; a float cache with neither")
    if not 1 <= B <= max_rows or len(layers) != L or Hq % Hkv or Dh != cfg.head_dim:
        raise ValueError(f"{key} takes 1 to {max_rows} rows and one cache layer per layer: k "
                         f"{tuple(k.shape)}, {len(layers)} layers, {Hq} query heads, head_dim "
                         f"{cfg.head_dim}")
    checks = [("k", k, torch.int8 if quant else dt, (L, B, Hkv, S, Dh)),
              ("v", v, torch.int8 if quant else dt, (L, B, Hkv, S, Dh)),
              ("pos", pos, torch.int32, (L, B, Hkv, S)), ("h0", h0, dt, (B, D)),
              ("q_pos", q_pos, torch.int32, (B,))]
    if quant:
        checks += [("k_scale", k_scale, torch.float32, (L, B, Hkv, S)),
                   ("v_scale", v_scale, torch.float32, (L, B, Hkv, S))]
    if rope_pos is not None:
        checks.append(("rope_pos", rope_pos, torch.int32, (B,)))
    for name, t, dtype, shape in checks:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {key} takes contiguous tensors on {dev}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("k and v must be 16-byte aligned")
    carriers = {"wqkv": (D // 2, (Hq + 2 * Hkv) * Dh), "wo": (Hq * Dh // 2, D),
                "wgu": (D // 2, 2 * F_), "wd": (F_ // 2, D)}
    return (*_layer_table(layers, carriers, dt, dev), quant)


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
    table, groups, quant = check_step_args("K14", 1, layers, cfg, k, v, pos, h0, q_pos,
                                           k_scale, v_scale, rope_pos)
    lib = _build.load("fused_decode", SIGNATURES)
    dims = (D, F_, Hq, Hkv, Dh, S, *groups, _DTYPES[dt], int(quant))
    smem = lib.fused_decode_step_smem(*dims)
    if smem == 0:
        raise ValueError(f"head_dim {Dh}: a cache row must be 1, 2, 4, 8, 16 or 32 16-byte loads")
    if smem > _build.SMEM_LIMIT:
        raise ValueError(f"K14 needs {smem} bytes of shared memory a block "
                         f"(limit {_build.SMEM_LIMIT})")
    maps, mask = _tensor_maps(layers, table, (D, F_, Hq, Hkv, Dh, *groups), lib)
    blocks = _GRID or lib.fused_decode_step_grid(*dims)
    if blocks < 1:
        _build.check(-blocks, "fused_decode_step")
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
        table.data_ptr(), maps.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        ptr(k_scale), ptr(v_scale), h0.data_ptr(), q_pos.data_ptr(), ptr(rope_pos),
        _inv_freq(Dh, rope_base_for(cfg), dev).data_ptr(), h.data_ptr(), kn.data_ptr(),
        vn.data_ptr(), probs.data_ptr(), p_new.data_ptr(), ws.data_ptr(), L, D, F_, Hq, Hkv, Dh,
        S, *groups, window, mask, cfg.rms_norm_eps, Dh ** -0.5, _DTYPES[dt], int(quant), blocks,
        stream)
    _build.check(err, "fused_decode_step")
    fused_decode_step.launches += 1
    return h, kn, vn, probs, p_new


fused_decode_step.launches = 0
