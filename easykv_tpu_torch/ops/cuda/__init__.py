"""Hand-written CUDA kernels of the decode path and of the int8-cache
prefill, one wrapper module each, with the plain PyTorch version beside
every wrapper."""
from __future__ import annotations

import importlib
from typing import Callable, List, Tuple

WRAPPER_MODULES = ("chunk_attention", "decode_attention", "fused_decode", "fused_decode_batch",
                   "kv_compact", "quant_matmul", "row_write", "sidecar_update", "w4_matmul",
                   "w4_stream")


def launch_counters() -> List[Tuple[Callable, str]]:
    """(wrapper, attribute) of every launch count the wrappers keep: each
    wrapper's `launches` and its variants' `*_launches`, each a plain int
    that the wrapper bumps where it launches its kernel."""
    found = []
    for name in WRAPPER_MODULES:
        mod = importlib.import_module(f"{__name__}.{name}")
        for fn in vars(mod).values():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                found += [(fn, attr) for attr, val in vars(fn).items()
                          if attr.endswith("launches") and type(val) is int]
    return found
