"""Configuration dataclasses for the PyTorch port (counterpart of
easykv_tpu/config.py: ModelConfig, GenerationConfig, MeshConfig).

Knob names mirror the reference generation_config dict (reference
easykv/easykv.py:200-210): budget, kv_policy, stride, temp_length,
recent_ratio, keep_attention, streaming, temperature, top_p,
max_new_tokens, eos_token_ids.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import torch

# Eviction policies. `h2o_head_std_avg` and `h2o_head_decay_avg_std` are
# legacy aliases of `roco` (reference easykv.py:320-324).
POLICIES = ("random", "recency", "h2o_head", "tova", "roco", "full")
POLICY_ALIASES = {
    "h2o_head_std_avg": "roco",
    "h2o_head_decay_avg_std": "roco",
}


def canonical_policy(name: str) -> str:
    name = POLICY_ALIASES.get(name, name)
    if name not in POLICIES:
        raise ValueError(f"unknown kv_policy {name!r}; expected one of {POLICIES}")
    return name


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """LLaMa-family architecture (LLaMa/Vicuna/TinyLlama, Mistral/Zephyr
    with GQA and an optional sliding window, Qwen2-style QKV biases)."""

    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    # rope_scaling: None, or "dynamic" with a factor. DynamicNTK follows the
    # reference's `set_dynamicntk_rope_length` (reference utils.py:53-57):
    # the base is fixed once from `rope_ntk_length`.
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_ntk_length: Optional[int] = None
    sliding_window: Optional[int] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False

    def __post_init__(self):
        if self.num_key_value_heads is None:
            object.__setattr__(self, "num_key_value_heads", self.num_attention_heads)
        if self.head_dim is None:
            object.__setattr__(
                self, "head_dim", self.hidden_size // self.num_attention_heads
            )

    @classmethod
    def from_hf_config(cls, hf: Any) -> "ModelConfig":
        """Build from a HuggingFace LlamaConfig / MistralConfig object or dict."""
        get = (lambda k, d=None: hf.get(k, d)) if isinstance(hf, Mapping) else (
            lambda k, d=None: getattr(hf, k, d)
        )
        scaling = get("rope_scaling") or {}
        scaling_type = scaling.get("type") or scaling.get("rope_type")
        # Qwen2 configs carry no `attention_bias` field but always have Q/K/V
        # biases; LLaMa-family configs carry the explicit flag.
        attn_bias = get("attention_bias", None)
        if attn_bias is None:
            attn_bias = get("model_type") == "qwen2"
        return cls(
            vocab_size=get("vocab_size"),
            hidden_size=get("hidden_size"),
            intermediate_size=get("intermediate_size"),
            num_hidden_layers=get("num_hidden_layers"),
            num_attention_heads=get("num_attention_heads"),
            num_key_value_heads=get("num_key_value_heads"),
            head_dim=get("head_dim"),
            rms_norm_eps=get("rms_norm_eps", 1e-5),
            rope_theta=get("rope_theta", 10000.0),
            max_position_embeddings=get("max_position_embeddings", 4096),
            rope_scaling_type=scaling_type,
            rope_scaling_factor=scaling.get("factor", 1.0),
            sliding_window=get("sliding_window"),
            tie_word_embeddings=get("tie_word_embeddings", False),
            attention_bias=bool(attn_bias),
        )


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """Sampling and budget knobs; defaults mirror reference easykv.py:200-210."""

    temperature: float = 1.0
    top_p: float = 1.0
    max_new_tokens: int = 1024
    budget: float = 0.5  # float = fraction of prompt; int = token count
    kv_policy: str = "recency"
    temp_length: int = 4  # attention-sink length (StreamingLLM)
    recent_ratio: float = 0.1
    keep_attention: bool = False
    eos_token_ids: Tuple[int, ...] = ()
    streaming: bool = False
    seed: int = 0

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "GenerationConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        if "eos_token_ids" in kwargs and kwargs["eos_token_ids"] is not None:
            kwargs["eos_token_ids"] = tuple(kwargs["eos_token_ids"])
        return cls(**kwargs)

    def with_policy(self) -> "GenerationConfig":
        return dataclasses.replace(self, kv_policy=canonical_policy(self.kv_policy))


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout (easykv_tpu/config.py:138-153): `data` shards the
    batch, `model` shards attention heads, the MLP, the LM head's vocab and
    the budgeted KV ring buffer. Eviction is per (layer, kv-head), so the
    score / evict / attend loop never crosses a model shard
    (parallel/mesh.py)."""

    data: int = 1
    model: int = 1
    axis_data: str = "data"
    axis_model: str = "model"

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data, self.model)


def resolve_device(device=None):
    """The device an entry point runs on: the one asked for, else the card.
    Without a card and without an explicit device it raises: the port never
    falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
