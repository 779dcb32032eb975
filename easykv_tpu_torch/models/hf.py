"""HF checkpoint -> LlamaParams (counterpart of easykv_tpu/models/hf.py:
params_from_hf_state_dict, params_from_hf_model,
params_from_hf_state_dict_streamed, load_hf_checkpoint), and back
(hf_state_dict).

HF LlamaForCausalLM / MistralForCausalLM / Qwen2ForCausalLM weights (a live
module, a state dict of torch tensors or numpy arrays, or a local
safetensors directory) become the port's layout: one module per layer, each
linear (in, out) as HF's (out, in) transposed, the `model.` prefix optional,
Qwen2's q/k/v biases carried. A tied model has no LM head; an untied
checkpoint without `lm_head.weight` takes embed.T.

The conversion works a layer at a time: the layer's raw tensors are
uploaded as stored, transposed, cast and (optionally) quantized on the
device, and freed before the next layer. Device memory peaks at the final
tree plus one layer's raw weights and the quantizer's temporaries for one
weight (the LM head, whose are the largest, goes first). Quantizing uses ops/quant.py's own functions, so a loaded tree is
bit-identical to the same bf16 tree quantized in memory. Every function
runs on the card unless given `device`; on the CPU each leaf is a copy,
never a view of a file.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig, resolve_device
from ..ops.quant import QuantLinear, _fit_group, _quantize_int4, _quantize_int8
from .llama import BIAS_KEYS, LAYER_KEYS, LlamaParams

QUANTIZE = (None, "int8", "int4", "int4_dual")
# port key -> HF suffix of layer i, and whether HF stores it (out, in)
HF_LAYER = {
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "wg": ("mlp.gate_proj.weight", True),
    "wu": ("mlp.up_proj.weight", True),
    "wd": ("mlp.down_proj.weight", True),
    "ln_attn": ("input_layernorm.weight", False),
    "ln_mlp": ("post_attention_layernorm.weight", False),
    "bq": ("self_attn.q_proj.bias", False),
    "bk": ("self_attn.k_proj.bias", False),
    "bv": ("self_attn.v_proj.bias", False),
}


def _host(x: Any) -> torch.Tensor:
    """A torch tensor of a state-dict entry (numpy arrays, an ml_dtypes
    bfloat16 included, become tensors over the same bytes)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _quantize(w: torch.Tensor, mode: Optional[str], group_size: int, layout: str):
    if mode is None:
        return w
    if mode == "int8":
        return QuantLinear(**_quantize_int8(w))
    leaves = _quantize_int4(w, _fit_group(w.shape[-2], group_size), layout)
    if mode == "int4_dual":
        q8 = _quantize_int8(w)
        leaves.update(q8=q8["q"], s8=q8["s"])
    return QuantLinear(**leaves)


@torch.no_grad()
def params_from_hf_state_dict_streamed(
    cfg: ModelConfig, sd: Mapping[str, Any], dtype: torch.dtype = torch.bfloat16,
    quantize: Optional[str] = None, group_size: int = 128, int4_layout: str = "arith",
    device=None,
) -> LlamaParams:
    """Layer-at-a-time device assembly of an HF state dict (torch tensors,
    numpy arrays or the mmap views of load_safetensors_dir).

    quantize: None (plain `dtype` leaves) | "int8" (per-channel, as
    quantize_params) | "int4" (group-wise int4 in `int4_layout`, as
    quantize_params_int4) | "int4_dual" (int4 plus the int8 copy of every
    layer linear, as quantize_params_int4(dual_int8=True)). Under any
    quantize mode the LM head is int8; norms, biases and the embedding stay
    `dtype`."""
    if quantize not in QUANTIZE:
        raise ValueError(f"quantize {quantize!r}: expected one of {QUANTIZE}")
    device = resolve_device(device)
    prefix = "model." if "model.embed_tokens.weight" in sd else ""

    def put(name):
        # copy=True: on the CPU too, no leaf may share memory with a file
        return _host(sd[name]).to(device=device, copy=True)

    def leaf(raws, key, transpose, mode=None):
        """raws[key] taken out, cast, transposed and quantized; the raw
        upload is freed before the quantizer runs."""
        w = raws.pop(key).to(dtype)
        w = w.t().contiguous() if transpose else w.contiguous()
        return _quantize(w, mode, group_size, int4_layout)

    top = {"embed": put(f"{prefix}embed_tokens.weight"), "norm": put(f"{prefix}norm.weight")}
    embed, final_norm = leaf(top, "embed", False), leaf(top, "norm", False)
    # the head first, as ops/quant.py's _rebuild does: its quantizer's f32
    # temporaries (the largest of the load) come while the tree is small
    lm_head = None
    if not cfg.tie_word_embeddings:
        head_q = "int8" if quantize else None
        if "lm_head.weight" in sd:
            lm_head = leaf({"w": put("lm_head.weight")}, "w", True, head_q)
        else:   # an untied checkpoint without an explicit head
            lm_head = _quantize(embed.t().contiguous(), head_q, group_size, int4_layout)
    keys = LAYER_KEYS + (BIAS_KEYS if f"{prefix}layers.0.self_attn.q_proj.bias" in sd else ())
    layers = []
    for i in range(cfg.num_hidden_layers):
        raws = {k: put(f"{prefix}layers.{i}.{HF_LAYER[k][0]}") for k in keys}
        layers.append({k: leaf(raws, k, HF_LAYER[k][1], quantize if k.startswith("w") else None)
                       for k in keys})
    return LlamaParams(embed, final_norm, layers, lm_head)


def params_from_hf_state_dict(cfg: ModelConfig, sd: Mapping[str, Any],
                              dtype: torch.dtype = torch.float32, device=None) -> LlamaParams:
    """Convert an HF LlamaForCausalLM / MistralForCausalLM state dict (HF
    linears are (out, in); the port's are (in, out))."""
    return params_from_hf_state_dict_streamed(cfg, sd, dtype=dtype, device=device)


def params_from_hf_model(model: Any, dtype: torch.dtype = torch.float32,
                         device=None) -> Tuple[ModelConfig, LlamaParams]:
    """Convert a live transformers *ForCausalLM module: only its `.config`
    and `.state_dict()` are read."""
    cfg = ModelConfig.from_hf_config(model.config)
    return cfg, params_from_hf_state_dict(cfg, dict(model.state_dict()), dtype=dtype,
                                          device=device)


def load_hf_checkpoint(
    path: str, dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None,
    group_size: int = 128, int4_layout: str = "arith", device=None,
) -> Tuple[ModelConfig, LlamaParams]:
    """Load a local HF checkpoint directory (config.json and *.safetensors)
    through the native mmap reader (native/loader.py), assembled a layer at
    a time on the device, optionally quantized (see
    params_from_hf_state_dict_streamed). No other reader is tried: a file
    the reader refuses raises."""
    from ..native import load_safetensors_dir

    with open(os.path.join(path, "config.json")) as f:
        cfg = ModelConfig.from_hf_config(json.load(f))
    sd, _files = load_safetensors_dir(path)
    return cfg, params_from_hf_state_dict_streamed(
        cfg, sd, dtype=dtype, quantize=quantize, group_size=group_size,
        int4_layout=int4_layout, device=device)


def hf_state_dict(params: LlamaParams) -> Dict[str, torch.Tensor]:
    """A plain (unquantized, split) tree under HF names in HF's (out, in)
    orientation (transposed views of the tree's tensors: nothing is copied):
    the inverse of params_from_hf_state_dict."""
    sd = {"model.embed_tokens.weight": params.embed.detach(),
          "model.norm.weight": params.final_norm.detach()}
    plain = "hf_state_dict takes a plain split tree: quantized or fused leaves have no HF name"
    for i, layer in enumerate(params.layers):
        if next(layer.children(), None) is not None:
            raise ValueError(plain)
        for k, w in layer.named_parameters(recurse=False):
            if k not in HF_LAYER:
                raise ValueError(plain)
            name, transposed = HF_LAYER[k]
            sd[f"model.layers.{i}.{name}"] = w.detach().t() if transposed else w.detach()
    if params.lm_head is not None:
        if isinstance(params.lm_head, QuantLinear):
            raise ValueError(plain)
        sd["lm_head.weight"] = params.lm_head.detach().t()
    return sd
