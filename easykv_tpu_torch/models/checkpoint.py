"""Native checkpoint save / load (counterpart of
easykv_tpu/models/checkpoint.py: save_checkpoint, load_checkpoint).

A checkpoint is a directory: `config.json`, dataclasses.asdict of the
ModelConfig (the file the JAX package's save_checkpoint writes, so either
package's config.json loads here), and `params.safetensors`, the whole tree
in one file written by native/loader.py's save_safetensors and read back
through the mmap reader. Leaves are named by path: `embed`, `final_norm`,
`layers.{i}.{name}`, `layers.{i}.{name}.{leaf}` for a QuantLinear (its
buffers under the JAX leaf keys), `lm_head` or `lm_head.{leaf}`. Plain,
fused, int8, int4 (either layout) and dual trees round-trip bit for bit.

The JAX package's checkpoints are Orbax directories, which the port does not
read: convert such a tree with models/convert.py's from_jax_params. The
mesh-aware restore (abstract_params, mesh, mesh_config) waits for the
parallel layer.
"""
from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

from ..config import ModelConfig, resolve_device
from ..native import SafetensorsFile, save_safetensors
from ..ops.quant import QuantLinear
from .llama import BIAS_KEYS, FUSED_BIAS_KEYS, FUSED_LAYER_KEYS, LAYER_KEYS, LlamaParams

PARAMS_FILE = "params.safetensors"


def _flat(params: LlamaParams) -> Dict[str, torch.Tensor]:
    """The tree's leaves by path name."""
    out = {"embed": params.embed, "final_norm": params.final_norm}
    for i, layer in enumerate(params.layers):
        for k, w in layer.named_parameters(recurse=False):
            out[f"layers.{i}.{k}"] = w
        for k, ql in layer.named_children():
            for leaf, t in ql.named_buffers():
                out[f"layers.{i}.{k}.{leaf}"] = t
    head = params.lm_head
    if isinstance(head, QuantLinear):
        out.update({f"lm_head.{leaf}": t for leaf, t in head.named_buffers()})
    elif head is not None:
        out["lm_head"] = head
    return {k: t.detach() for k, t in out.items()}


def save_checkpoint(path: str, cfg: ModelConfig, params: LlamaParams) -> int:
    """Writes `path`/config.json and `path`/params.safetensors (the tree on
    any device); returns the bytes of the tensor file."""
    os.makedirs(path, exist_ok=True)
    n = save_safetensors(os.path.join(path, PARAMS_FILE), _flat(params), {"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return n


def _linear(leaves: Dict[str, torch.Tensor]):
    return leaves[""] if "" in leaves else QuantLinear(**leaves)


@torch.no_grad()
def load_checkpoint(path: str, dtype: Optional[torch.dtype] = None,
                    device=None) -> Tuple[ModelConfig, LlamaParams]:
    """(cfg, params) of a checkpoint save_checkpoint wrote, on `device` (the
    card unless given). `dtype` casts the plain floating leaves (embed,
    norms, biases, plain linears); quantized leaves keep their own dtypes."""
    device = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        cfg = ModelConfig(**json.load(f))

    def load(t: torch.Tensor, leaf: str) -> torch.Tensor:
        t = t.to(device=device, copy=True)
        plain = not leaf and dtype is not None and t.is_floating_point()
        return t.to(dtype) if plain else t

    # top-level name -> {sub-leaf ("" for a plain tensor): tensor}; layers by index
    top: Dict[str, Dict[str, torch.Tensor]] = defaultdict(dict)
    layers: Dict[int, Dict[str, Dict[str, torch.Tensor]]] = defaultdict(lambda: defaultdict(dict))
    with SafetensorsFile(os.path.join(path, PARAMS_FILE)) as f:
        for name in f.keys():
            parts = name.split(".")
            if parts[0] == "layers":
                leaf = ".".join(parts[3:])
                layers[int(parts[1])][parts[2]][leaf] = load(f.tensor(name), leaf)
            else:
                leaf = ".".join(parts[1:])
                top[parts[0]][leaf] = load(f.tensor(name), leaf)
    if sorted(layers) != list(range(cfg.num_hidden_layers)):
        raise ValueError(f"{path}: layers {sorted(layers)} for a "
                         f"{cfg.num_hidden_layers}-layer config")
    fused = "wqkv" in layers[0]
    order = (FUSED_LAYER_KEYS + FUSED_BIAS_KEYS) if fused else (LAYER_KEYS + BIAS_KEYS)
    tree = [{k: _linear(layers[i][k]) for k in order if k in layers[i]}
            for i in range(cfg.num_hidden_layers)]
    head = _linear(top["lm_head"]) if "lm_head" in top else None
    return cfg, LlamaParams(top["embed"][""], top["final_norm"][""], tree, head)
