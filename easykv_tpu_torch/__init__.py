"""easykv_tpu_torch: the PyTorch/CUDA port of easykv_tpu, for NVIDIA Hopper.

It follows easykv_tpu module for module and never imports it (nor JAX):
the JAX package is the reference the port is held against. Its hot path
runs hand-written CUDA kernels built from csrc/ at first use; on CPU
tensors each kernel's plain PyTorch version runs instead.
`CausalLM(cfg, params, kv_quant=True)` keeps the KV cache in int8 with
per-slot scales, as the JAX package's compressed-KV mode does.

Public API mirrors the reference (reference easykv/__init__.py:1-2):
    enable_fixed_kv(model, tokenizer, mode, stride)
    set_dynamicntk_rope_length(model, max_length)
and `generate(model, ids, config, kv_mode=...)` runs the kv_modes decoding,
encoding (the default), auto, encoding_decoding and ppl.
"""
from .config import GenerationConfig, ModelConfig, canonical_policy
from .engine.generate import (
    CausalLM,
    enable_fixed_kv,
    generate,
    set_dynamicntk_rope_length,
    stride_align,
    stride_align_encdec,
)

__version__ = "0.1.0"

__all__ = [
    "CausalLM",
    "GenerationConfig",
    "ModelConfig",
    "canonical_policy",
    "enable_fixed_kv",
    "generate",
    "set_dynamicntk_rope_length",
    "stride_align",
    "stride_align_encdec",
]
