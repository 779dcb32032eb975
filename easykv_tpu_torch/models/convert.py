"""Parameter conversion from the JAX package's tree.

`from_jax_params` takes the tree that easykv_tpu.models.llama.init_params
builds (or a checkpoint of it), as numpy arrays — embed (V, D), final_norm
(D,), lm_head (D, V), layers.{wq, wk, wv, wo, wg, wu, wd} stacked (L, in,
out), layers.{ln_attn, ln_mlp} (L, D), optional layers.{bq, bk, bv} — and
returns the port's parameters, one module per layer with the same
(in, out) orientation, so both packages compute the same function. Nothing
of JAX is imported: pass numpy arrays (e.g. `jax.tree.map(np.asarray,
params)`).

It also carries the fused tree of easykv_tpu.ops.quant.fuse_gemv_params
(layers.{wqkv, wo, wgu, wd}, optional bqkv) and every quantized leaf of
easykv_tpu.ops.quant, stacked (L, ...) per linear, into one QuantLinear
per layer (and one for a quantized lm_head):

  int8 ({"q", "s"}), int4 halves ({"q4p", "gs"}), int4 arithmetic
  ({"q4a", "gs"}, and "gs3" if the tree was materialized; otherwise the
  QuantLinear computes it), each int4 leaf optionally with the int8 copy
  ({"q8", "s8"}) of dual_int8. The JAX package's in-jit s4 leaves ("w4")
  have no counterpart: PyTorch has no s4 type; convert the tree before
  materialize_params.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..config import resolve_device
from ..ops.quant import QuantLinear
from .llama import BIAS_KEYS, FUSED_BIAS_KEYS, FUSED_LAYER_KEYS, LAYER_KEYS, LlamaParams


def _tensor(x: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(x)  # a writable copy that torch may share
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def _linear(w: Any, l: Optional[int], device, dtype: Optional[torch.dtype]):
    """Layer l's slice (l None: the whole leaf) of a plain or quantized
    linear; a quantized leaf keeps its own dtypes."""
    if isinstance(w, Mapping):
        if "w4" in w:
            raise ValueError("s4 leaves (materialize_params' 'w4') have no counterpart: "
                             "convert the packed tree")
        return QuantLinear(**{k: _tensor(np.asarray(v) if l is None else np.asarray(v)[l],
                                         device, None) for k, v in w.items()})
    return _tensor(np.asarray(w) if l is None else np.asarray(w)[l], device, dtype)


def from_jax_params(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> LlamaParams:
    """JAX parameter tree (numpy leaves) -> LlamaParams on `device`; plain
    leaves in `dtype` (default: each leaf's own), quantized leaves as they
    are."""
    device = resolve_device(device)
    lt = tree["layers"]
    fused = "wqkv" in lt
    keys = (FUSED_LAYER_KEYS if fused else LAYER_KEYS) + tuple(
        k for k in (FUSED_BIAS_KEYS if fused else BIAS_KEYS) if k in lt)
    n_layers = np.asarray(lt["ln_attn"]).shape[0]
    layers = [{k: _linear(lt[k], l, device, dtype) for k in keys} for l in range(n_layers)]
    lm_head = tree.get("lm_head")
    return LlamaParams(
        _tensor(tree["embed"], device, dtype),
        _tensor(tree["final_norm"], device, dtype),
        layers,
        None if lm_head is None else _linear(lm_head, None, device, dtype),
    )
