"""Split rules for the parameters and the budgeted KV cache, and the shards
each rank keeps (counterpart of easykv_tpu/parallel/sharding.py:
param_pspecs, cache_pspecs, param_pspecs_tree, shard_params, shard_cache).

A spec is a tuple with one entry per dimension: the mesh axis the
dimension is split over, or None where every rank holds all of it (a
PartitionSpec's entries). The port keeps each layer in its own module, so a
layer weight's spec has no leading L entry. Weights split over attention
heads / the FFN on the `model` axis (column-parallel wq, wk, wv, wg, wu and
their biases; row-parallel wo and wd, whose outputs the model all-reduces),
the LM head over its vocab; the embedding and the norms are replicated. The
KV ring buffer and its sidecars split over KV heads on `model` and over the
batch on `data`, so per-head eviction never crosses a rank.

shard_params / shard_cache return this rank's shards as new tensors (the
rest is freed with the caller's global tree): each split dimension holds
1 / size of the global one, taken in axis order.

Quantized linears (a QuantLinear) expand as the JAX package's
param_pspecs_tree does: int8 {q, s}: q takes the weight's spec and the
per-output-channel s the out dim's (replicated under a row-parallel
weight); int4 {q4p | q4a, gs}: both take the weight's spec, and a
row-parallel shard holds whole groups: its in-rows must be a multiple of
2 x the group size (sharding.py:78-86 there). The int4 carrier pairs row r
with row r + K/2, so a row-parallel shard is this rank's rows re-packed in
the tree's layout (a slice of the global carrier would pair rows of other
ranks); gs3 is rebuilt from the shard's gs. The dual int8 copy (q8, s8)
follows q and s. A fused tree (wqkv / wgu) has no spec in the JAX package
either (easykv_tpu/ops/quant.py:444-449): shard the split tree.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..cache import KVCache
from ..config import MeshConfig, ModelConfig
from .mesh import Mesh

Spec = Tuple[Any, ...]


def param_pspecs(cfg: ModelConfig, mc: MeshConfig) -> Dict[str, Any]:
    m = mc.axis_model
    return {
        "embed": (None, None),
        "final_norm": (None,),
        "layers": {
            "wq": (None, m),    # (D, Hq*Dh): heads on model
            "wk": (None, m),    # (D, Hkv*Dh)
            "wv": (None, m),
            "wo": (m, None),    # row-parallel: the model all-reduces its output
            "wg": (None, m),    # (D, F)
            "wu": (None, m),
            "wd": (m, None),
            "ln_attn": (None,),
            "ln_mlp": (None,),
            "bq": (m,),         # Qwen2-style biases follow their weights' out dim
            "bk": (m,),
            "bv": (m,),
        },
        "lm_head": (None, m),   # vocab-sharded; the model gathers the logits
    }


def cache_pspecs(mc: MeshConfig) -> KVCache:
    d, m = mc.axis_data, mc.axis_model
    return KVCache(k=(None, d, m, None, None), v=(None, d, m, None, None),
                   pos=(None, d, m, None), score=(None, d, m, None),
                   score_sq=(None, d, m, None), counter=(None, d, m, None),
                   k_scale=(None, d, m, None), v_scale=(None, d, m, None))


def _out_spec(spec: Spec) -> Spec:
    """The spec of a per-output-channel scale row: the weight's without its
    in (contracted) dim."""
    return spec[:-2] + spec[-1:]


def _expand(spec: Spec, leaf) -> Any:
    from ..ops.quant import QuantLinear

    if not isinstance(leaf, QuantLinear):
        return spec
    if "q4p" in leaf or "q4a" in leaf:
        key = "q4p" if "q4p" in leaf else "q4a"
        d = {key: spec, "gs": spec}
        if "q8" in leaf:
            d.update(q8=spec, s8=_out_spec(spec))
        return d
    return {"q": spec, "s": _out_spec(spec)}


def param_pspecs_tree(params, cfg: ModelConfig, mc: MeshConfig) -> Dict[str, Any]:
    """param_pspecs expanded to a concrete tree: {"embed", "final_norm",
    "layers": [per layer {name: spec or leaf dict}], "lm_head"} (absent
    entries pruned). A fused tree raises."""
    specs = param_pspecs(cfg, mc)
    out = {"embed": specs["embed"], "final_norm": specs["final_norm"], "layers": []}
    for p in params.layers:
        names = [k for k, _ in p.named_parameters(recurse=False)] + [k for k, _ in
                                                                      p.named_children()]
        fused = [k for k in names if k not in specs["layers"]]
        if fused:
            raise ValueError(f"no split rule for {sorted(fused)}: a fused tree (wqkv / wgu) is "
                             "not sharded; shard the split tree (before fuse_gemv_params)")
        out["layers"].append({k: _expand(specs["layers"][k], getattr(p, k)) for k in names})
    if params.lm_head is not None:
        out["lm_head"] = _expand(specs["lm_head"], params.lm_head)
    return out


def _shard(t: torch.Tensor, spec: Spec, mesh: Mesh, device) -> torch.Tensor:
    """This rank's shard of t under spec, as a new tensor on device."""
    if t.dim() != len(spec):
        raise ValueError(f"spec {spec} for a {t.dim()}-dim tensor {tuple(t.shape)}")
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, i = mesh.shape[ax], mesh.index(ax)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split evenly over "
                             f"{ax}={n}")
        per = t.shape[dim] // n
        t = t.narrow(dim, i * per, per)
    return t.to(device=device, copy=True).contiguous()


def _row_parallel_int4(leaf, key: str, mesh: Mesh, ax: str, device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a row-parallel int4 linear, re-packed in its
    layout, with the shard's group scales."""
    from ..ops.quant import _arith_to_rows, pack_int4, pack_int4_arith
    from ..ops.cuda.w4_matmul import unpack_int4

    carrier, gs = leaf[key], leaf["gs"]
    K = 2 * carrier.shape[0]
    G = K // gs.shape[0]
    n = mesh.shape[ax]
    if K % (2 * G * n):
        raise ValueError(f"a row-parallel int4 shard of {K // n} in-rows over {ax}={n} is not "
                         f"a multiple of 2 x its group of {G}: the halves would split a group")
    rows = _arith_to_rows(carrier) if key == "q4a" else torch.cat(unpack_int4(carrier), dim=-2)
    mine = _shard(rows, (ax, None), mesh, device)
    packed = pack_int4_arith(mine) if key == "q4a" else pack_int4(mine)
    return {key: packed.contiguous(), "gs": _shard(gs, (ax, None), mesh, device)}


def _shard_leaf(leaf, spec, mesh: Mesh, device):
    from ..ops.quant import QuantLinear

    if not isinstance(spec, dict):
        return _shard(leaf.detach(), spec, mesh, device)
    key = next((k for k in ("q4p", "q4a") if k in spec), None)
    ax = spec[key][0] if key is not None else None
    if key is not None and ax is not None:
        leaves = _row_parallel_int4(leaf, key, mesh, ax, device)
        leaves.update({k: _shard(leaf[k], spec[k], mesh, device)
                       for k in ("q8", "s8") if k in spec})
        return QuantLinear(**leaves)
    return QuantLinear(**{k: _shard(leaf[k], s, mesh, device) for k, s in spec.items()})


@torch.no_grad()
def shard_params(params, cfg: ModelConfig, mc: MeshConfig, mesh: Mesh, device=None):
    """This rank's LlamaParams (param_pspecs_tree's shards), on `device`
    (the mesh's by default)."""
    from ..models.llama import LlamaParams

    device = mesh.device if device is None else device
    specs = param_pspecs_tree(params, cfg, mc)
    layers = [{k: _shard_leaf(getattr(p, k), s, mesh, device) for k, s in ls.items()}
              for p, ls in zip(params.layers, specs["layers"])]
    head = (None if params.lm_head is None
            else _shard_leaf(params.lm_head, specs["lm_head"], mesh, device))
    return LlamaParams(_shard(params.embed.detach(), specs["embed"], mesh, device),
                       _shard(params.final_norm.detach(), specs["final_norm"], mesh, device),
                       layers, head)


@torch.no_grad()
def shard_cache(cache: KVCache, mc: MeshConfig, mesh: Mesh, device=None) -> KVCache:
    """This rank's (L, B/d, Hkv/m, S[, D]) shard of every cache array."""
    device = mesh.device if device is None else device
    specs = cache_pspecs(mc)
    return KVCache(*(None if t is None else _shard(t, getattr(specs, f), mesh, device)
                     for f, t in ((f, getattr(cache, f)) for f in KVCache.__dataclass_fields__)))


def local_config(cfg: ModelConfig, mc: MeshConfig) -> ModelConfig:
    """The ModelConfig one rank's shards compute: Hq / m query heads, Hkv / m
    KV heads and an FFN of F / m (head_dim, the hidden width and the vocab
    stay). Raises unless they split evenly."""
    import dataclasses

    m = mc.model
    for what, n in (("num_attention_heads", cfg.num_attention_heads),
                    ("num_key_value_heads", cfg.num_key_value_heads),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % m:
            raise ValueError(f"{what}={n} does not split over {mc.axis_model}={m}")
    return dataclasses.replace(cfg, num_attention_heads=cfg.num_attention_heads // m,
                               num_key_value_heads=cfg.num_key_value_heads // m,
                               intermediate_size=cfg.intermediate_size // m,
                               head_dim=cfg.head_dim)
