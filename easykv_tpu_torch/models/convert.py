"""Parameter conversion from the JAX package's tree.

`from_jax_params` takes the tree that easykv_tpu.models.llama.init_params
builds (or a checkpoint of it), as numpy arrays — embed (V, D), final_norm
(D,), lm_head (D, V), layers.{wq, wk, wv, wo, wg, wu, wd} stacked (L, in,
out), layers.{ln_attn, ln_mlp} (L, D), optional layers.{bq, bk, bv} — and
returns the port's parameters, one module per layer with the same
(in, out) orientation, so both packages compute the same function. Nothing of JAX is imported: pass
numpy arrays (e.g. `jax.tree.map(np.asarray, params)`).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from ..config import resolve_device
from .llama import BIAS_KEYS, LAYER_KEYS, LlamaParams


def _tensor(x: Any, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(x)  # a writable copy that torch may share
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def from_jax_params(tree: Mapping[str, Any], device=None,
                    dtype: Optional[torch.dtype] = None) -> LlamaParams:
    """JAX parameter tree (numpy leaves) -> LlamaParams on `device`, in
    `dtype` (default: each leaf's own)."""
    device = resolve_device(device)
    lt = tree["layers"]
    if isinstance(lt.get("wq"), Mapping):
        raise NotImplementedError("quantized weight trees: ROADMAP.md open item 11")
    keys = LAYER_KEYS + tuple(k for k in BIAS_KEYS if k in lt)
    stacked = {k: np.asarray(lt[k]) for k in keys}
    layers = [{k: _tensor(w[l], device, dtype) for k, w in stacked.items()}
              for l in range(stacked["wq"].shape[0])]
    lm_head = tree.get("lm_head")
    return LlamaParams(
        _tensor(tree["embed"], device, dtype),
        _tensor(tree["final_norm"], device, dtype),
        layers,
        None if lm_head is None else _tensor(lm_head, device, dtype),
    )
