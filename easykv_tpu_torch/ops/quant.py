"""Int8 / int4 weight formats (w8a16, w4a16) and the quantized product
(counterpart of easykv_tpu/ops/quant.py: quantize_linear, pack_int4,
unpack_int4, pack_int4_arith, unpack_int4_arith, _arith_to_rows,
quantize_linear_int4, _mm_int4, _mm_w4a, mm, dequantize, concat_linears,
fuse_gemv_params, quantize_params, _fit_group, quantize_params_int4; and
arith_scale_pair of easykv_tpu/ops/pallas/w4_stream.py).

A quantized linear is a `QuantLinear`: an nn.Module whose buffers carry
the JAX package's leaf keys, so `"q4a" in w` and `w["gs"]` read as they do
on the JAX tree:

  int8:             {"q":   int8 (in, out),    "s":  f32 (out,)}
  int4, halves:     {"q4p": int8 (in/2, out),  "gs": f32 (in/G, out)}
                    low nibble = row r, high nibble = row r + in/2
  int4, arithmetic: {"q4a": int8 (in/2, out),  "gs": f32 (in/G, out),
                     "gs3": bf16 (in/G, out) = [gs_hi; gs_lo] / 16}
                    carrier = 16 * q[r + in/2] + q[r], nibbles in [-7, 7]
  dual:             "q8" / "s8" (int8 per channel) beside either int4 leaf

`gs3` is built once, when the QuantLinear is made (the JAX package's
materialize_params adds it per run). A `q4p` leaf stays packed: PyTorch has
no s4 type, so the JAX package's s4 path (materialize_params' "w4" leaves,
_mm_w4, _s4_boundary_ok, materialize_params_resident) has no counterpart;
K12 and the plain `_mm_int4` compute its function.

`mm(x, w)` picks its branch by the shape of x (M = rows of x), the leaf
and its group G, before any launch, the same way on the CPU and on the
card; each kernel wrapper runs its plain version for CPU tensors:

  "q8" present, M > 1     -> the int8 copy (as "q"/"s" below)
  "q4a", M == 1, G % 8 == 0 -> K10 w4a16_gemv_arith
  "q4a", 1 < M <= 512, group 128, (in/2) % 128 == 0 -> K11 w4a16_gemm_arith
  "q4a", otherwise        -> dense dequant-dot (M > 32) or grouped product
  "q4p", M <= 8, G % 8 == 0 -> K12 w4a16_gemv
  "q4p", otherwise        -> `_mm_int4` (M <= 32) or dense dequant-dot
  "q"/"s", M <= 256       -> K13 quant_matmul
  "q"/"s", M > 256        -> x @ q.to(x.dtype) * s, the JAX package's formula

A group that is not a multiple of 8 rows (`_fit_group` makes them for odd
in-dims, e.g. 86 for an in-dim of 1376) takes the grouped product, which
is K10's and K12's function: the kernels' row chunks lie in one group.

Under a (data, model) mesh (flags.tp_mesh) the row-parallel products wo and
wd go through `mm_row_parallel`: `mm` over this rank's rows of the weight
(bf16, int8 {q, s} with s replicated, int4 with whole groups a rank:
parallel/sharding.py) and this rank's slice of x, then the all-reduce over
`model` that GSPMD inserts after them in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Union

import torch
from torch import nn

from .cuda._wstream import group_ok
from .cuda.quant_matmul import quant_matmul, quant_matmul_plain
from .cuda.w4_matmul import unpack_int4, w4a16_gemv, w4a16_gemv_plain
from .cuda.w4_stream import (unpack_int4_arith, w4a16_gemm_arith, w4a16_gemm_arith_plain,
                             w4a16_gemv_arith)

LEAF_KEYS = ("q", "s", "q4p", "q4a", "gs", "gs3", "q8", "s8")
K13_MAX_M = 256     # quant_matmul.py's MAX_M
K12_MAX_M = 8
K11_MAX_M = 512
DENSE_MIN_M = 33    # above 32 rows the int4 paths dequantize to one dense product


class QuantLinear(nn.Module):
    """A quantized (in, out) linear: its leaves as buffers under the JAX
    package's keys, read like the JAX leaf dict (`in`, `[]`, `keys()`)."""

    def __init__(self, **leaves: torch.Tensor):
        super().__init__()
        unknown = set(leaves) - set(LEAF_KEYS)
        if unknown or not ({"q", "q4p", "q4a"} & set(leaves)):
            raise ValueError(f"not a quantized linear: keys {sorted(leaves)}")
        if "q4a" in leaves and "gs3" not in leaves:
            leaves["gs3"] = arith_scale_pair(leaves["gs"])
        for k, t in leaves.items():
            self.register_buffer(k, t.contiguous())

    def keys(self) -> List[str]:
        return [k for k, _ in self.named_buffers()]

    def __contains__(self, key: str) -> bool:
        return key in self._buffers

    def __getitem__(self, key: str) -> torch.Tensor:
        return self._buffers[key]

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={tuple(t.shape)} {t.dtype}" for k, t in self._buffers.items())


Linear = Union[torch.Tensor, QuantLinear]


# ---------------------------------------------------------------------------
# quantizers (bit-exact with the JAX package's)
# ---------------------------------------------------------------------------

def _quantize_int8(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-2, keepdim=True)       # reduce the `in` dim
    scale = amax.clamp(min=1e-8) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.squeeze(-2)}


def quantize_linear(w: torch.Tensor) -> QuantLinear:
    """Symmetric per-output-channel int8 quantization of (in, out)."""
    return QuantLinear(**_quantize_int8(w))


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(.., K, N) int8 nibbles in [-8, 7] -> (.., K/2, N) with halves
    packing: packed row r = (row r) | (row r + K/2 << 4)."""
    K = q.shape[-2]
    lo, hi = q[..., : K // 2, :], q[..., K // 2:, :]
    return (lo & 0x0F) | (hi << 4)


def pack_int4_arith(q: torch.Tensor) -> torch.Tensor:
    """(.., K, N) int8 nibbles in [-7, 7] -> (.., K/2, N) arithmetic
    carrier: row r = 16 * q[r + K/2] + q[r]."""
    K = q.shape[-2]
    return (16 * q[..., K // 2:, :] + q[..., : K // 2, :]).to(torch.int8)


def _arith_to_rows(p: torch.Tensor) -> torch.Tensor:
    """Arithmetic carrier -> (.., K, N) int8 row values in [-7, 7]."""
    return torch.cat(unpack_int4_arith(p), dim=-2)


def arith_scale_pair(gs: torch.Tensor) -> torch.Tensor:
    """(.., gc, N) group scales -> (.., gc, N) bf16 pair [gs_hi; gs_lo] / 16.
    Exact in bf16 for the scales quantize_linear_int4 makes (bf16-
    representable; / 16 moves the exponent only)."""
    gch = gs.shape[-2] // 2
    return (torch.cat([gs[..., gch:, :], gs[..., :gch, :]], dim=-2) * 0.0625).to(torch.bfloat16)


def _quantize_int4(w: torch.Tensor, group_size: int, layout: str) -> Dict[str, torch.Tensor]:
    *lead, K, N = w.shape
    if K % group_size != 0 or (K // 2) % group_size != 0:
        raise ValueError(f"in dim {K}: need K and K/2 divisible by group {group_size}")
    gc = K // group_size
    wf = w.to(torch.float32).reshape(*lead, gc, group_size, N)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    # bf16-representable scales, as the JAX package stores them (quant.py:117-124)
    scale = (amax.clamp(min=1e-8) / 7.0).to(torch.bfloat16).to(torch.float32)
    q = torch.round(wf / scale).clamp(-7, 7).to(torch.int8).reshape(*lead, K, N)
    gs = scale.squeeze(-2)
    if layout == "arith":
        return {"q4a": pack_int4_arith(q), "gs": gs}
    if layout != "halves":
        raise ValueError(f"unknown int4 layout {layout!r}")
    return {"q4p": pack_int4(q), "gs": gs}


def quantize_linear_int4(w: torch.Tensor, group_size: int = 128,
                         layout: str = "halves") -> QuantLinear:
    """Symmetric group-wise int4 quantization of (in, out): one scale per
    (group of `group_size` input rows, output channel), values in [-7, 7];
    layout "halves" ({"q4p", "gs"}) or "arith" ({"q4a", "gs", "gs3"})."""
    return QuantLinear(**_quantize_int4(w, group_size, layout))


def _fit_group(K: int, group_size: int) -> int:
    """Largest group <= group_size dividing K/2 and K."""
    g = min(group_size, K // 2)
    while g > 1 and ((K // 2) % g != 0 or K % g != 0):
        g -= 1
    return max(g, 1)


# ---------------------------------------------------------------------------
# the product
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> int:
    return x.numel() // x.shape[-1]


def _dense_int4(x: torch.Tensor, rows: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """x @ (int4 row values (K, N) times their group scales), dequantized to
    x.dtype first, one dense product (the JAX package's M > 32 branch)."""
    K, N = rows.shape
    gc = gs.shape[0]
    wf = (rows.to(x.dtype).reshape(gc, K // gc, N) * gs[:, None, :].to(x.dtype)).reshape(K, N)
    return x @ wf


def _mm_int4(x: torch.Tensor, q4p: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """x (.., K) @ dequant(q4p (K/2, N), gs (gc, N)), one grouped product per
    half with the scales on the f32 group partials (quant.py:135): the
    function of K12's plain version."""
    y = w4a16_gemv_plain(x.reshape(-1, x.shape[-1]), q4p, gs)
    return y.reshape(x.shape[:-1] + (q4p.shape[-1],))


def _mm_w4a(x: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    p, gs = w["q4a"], w["gs"]
    Kh, N = p.shape
    gc = gs.shape[0]
    M = _rows(x)
    x2 = x.reshape(M, 2 * Kh).contiguous()
    if M == 1 and group_ok(2 * Kh // gc):
        y = w4a16_gemv_arith(x2, p, w["gs3"])
    elif M <= K11_MAX_M and 2 * Kh == gc * 128 and Kh % 128 == 0:
        y = w4a16_gemm_arith(x2, p, gs)
    elif M >= DENSE_MIN_M:
        y = _dense_int4(x2, _arith_to_rows(p), gs)
    else:
        y = w4a16_gemm_arith_plain(x2, p, gs)    # the grouped product
    return y.reshape(x.shape[:-1] + (N,))


def _mm_w4p(x: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    q4p, gs = w["q4p"], w["gs"]
    M = _rows(x)
    if M <= K12_MAX_M and group_ok(2 * q4p.shape[0] // gs.shape[0]):
        y = w4a16_gemv(x.reshape(M, x.shape[-1]).contiguous(), q4p, gs)
        return y.reshape(x.shape[:-1] + (q4p.shape[-1],))
    if M >= DENSE_MIN_M:
        return _dense_int4(x, torch.cat(unpack_int4(q4p), dim=-2), gs)
    return _mm_int4(x, q4p, gs)


def _mm_int8(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    M = _rows(x)
    if M <= K13_MAX_M:
        y = quant_matmul(x.reshape(M, x.shape[-1]).contiguous(), q, s)
        return y.reshape(x.shape[:-1] + (q.shape[-1],))
    return (x @ q.to(x.dtype)) * s.to(x.dtype)


def mm(x: torch.Tensor, w: Linear) -> torch.Tensor:
    """x @ w for a plain tensor or a QuantLinear (branches in the module
    docstring)."""
    if not isinstance(w, QuantLinear):
        return x @ w
    if "q8" in w and _rows(x) > 1:
        return _mm_int8(x, w["q8"], w["s8"])
    if "q4a" in w:
        return _mm_w4a(x, w)
    if "q4p" in w:
        return _mm_w4p(x, w)
    return _mm_int8(x, w["q"], w["s"])


def mm_row_parallel(x: torch.Tensor, w: Linear) -> torch.Tensor:
    """x @ w for a row-parallel product: under a mesh, x and w are this
    rank's in-slices and the partial products are summed over `model`
    (parallel.mesh.all_reduce_sum, in f32); without one, `mm`."""
    from .. import flags
    from ..parallel.mesh import all_reduce_sum

    y = mm(x, w)
    tp = flags.tp_mesh()
    return y if tp is None else all_reduce_sum(y, tp[0], tp[2])


def lm_head_mm(h: torch.Tensor, head: QuantLinear) -> torch.Tensor:
    """A quantized LM head, float32 logits (the JAX package's _lm_head): an
    int4 head through `mm`; an int8 head as K13 with a float32 result, the
    whole contraction accumulated in f32 and scaled once."""
    if "q4p" in head or "q4a" in head:
        return mm(h, head).to(torch.float32)
    M = _rows(h)
    h2 = h.reshape(M, h.shape[-1]).contiguous()
    fn = quant_matmul if M <= K13_MAX_M else quant_matmul_plain
    y = fn(h2, head["q"], head["s"], out_f32=True)
    return y.reshape(h.shape[:-1] + (head["q"].shape[-1],))


def dequantize(w: Linear, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    if not isinstance(w, QuantLinear):
        return w.to(dtype)
    if "q4p" in w or "q4a" in w:
        rows = (torch.cat(unpack_int4(w["q4p"]), dim=-2) if "q4p" in w
                else _arith_to_rows(w["q4a"]))
        K, N = rows.shape
        gc = w["gs"].shape[0]
        wf = rows.to(torch.float32).reshape(gc, K // gc, N) * w["gs"][:, None, :]
        return wf.reshape(K, N).to(dtype)
    return (w["q"].to(torch.float32) * w["s"][None, :]).to(dtype)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

SPLIT_LINEARS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")


def concat_linears(ws: List[Linear]) -> Linear:
    """Concatenate plain or quantized linears along the output dim (scales
    concatenate 1:1; int4 linears share a group count)."""
    if isinstance(ws[0], QuantLinear):
        return QuantLinear(**{k: torch.cat([w[k] for w in ws], dim=-1) for k in ws[0].keys()})
    return torch.cat(ws, dim=-1)


def _layer_dict(p: nn.Module) -> Dict[str, Linear]:
    out = dict(p.named_parameters(recurse=False))
    out.update(p.named_children())
    return out


def _rebuild(params, layer_fn, head_fn=None):
    from ..models.llama import LlamaParams

    head = params.lm_head
    if head is not None and head_fn is not None:
        head = head_fn(head)
    return LlamaParams(params.embed, params.final_norm,
                       [layer_fn(_layer_dict(p)) for p in params.layers], head)


@torch.no_grad()
def fuse_gemv_params(params):
    """wq|wk|wv -> wqkv, wg|wu -> wgu (and bq|bk|bv -> bqkv): 4 long
    products per layer instead of 7."""
    def fuse(d):
        d["wqkv"] = concat_linears([d.pop("wq"), d.pop("wk"), d.pop("wv")])
        d["wgu"] = concat_linears([d.pop("wg"), d.pop("wu")])
        if "bq" in d:
            d["bqkv"] = torch.cat([d.pop("bq"), d.pop("bk"), d.pop("bv")], dim=-1)
        return d
    return _rebuild(params, fuse)


@torch.no_grad()
def quantize_params(params):
    """Every layer linear and the LM head to int8; norms and the embedding
    stay as they are."""
    def layer(d):
        return {k: quantize_linear(v) if k in SPLIT_LINEARS else v for k, v in d.items()}
    return _rebuild(params, layer, quantize_linear)


@torch.no_grad()
def quantize_params_int4(params, group_size: int = 128, lm_head_int8: bool = True,
                         dual_int8: bool = False, layout: str = "halves"):
    """int4 variant of quantize_params: every layer linear group-wise int4
    in `layout` (the group shrinks to _fit_group for odd in-dims); with
    dual_int8 each also keeps an int8 per-channel copy ("q8", "s8") of the
    original weights; the LM head int8 (lm_head_int8) or int4 halves."""
    def linear(w):
        leaves = _quantize_int4(w, _fit_group(w.shape[-2], group_size), layout)
        if dual_int8:
            q8 = _quantize_int8(w)
            leaves.update(q8=q8["q"], s8=q8["s"])
        return QuantLinear(**leaves)

    def layer(d):
        return {k: linear(v) if k in SPLIT_LINEARS else v for k, v in d.items()}

    def head(w):
        if lm_head_int8:
            return quantize_linear(w)
        return quantize_linear_int4(w, _fit_group(w.shape[-2], group_size))
    return _rebuild(params, layer, head)

