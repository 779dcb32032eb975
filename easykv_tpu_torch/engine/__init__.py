from .generate import CausalLM, enable_fixed_kv, generate, set_dynamicntk_rope_length

__all__ = ["CausalLM", "enable_fixed_kv", "generate", "set_dynamicntk_rope_length"]
