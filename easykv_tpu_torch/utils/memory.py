"""Device memory accounting (counterpart of easykv_tpu/utils/memory.py; the
reference's `cache_size` / `gpu_stats`, easykv/easykv.py:10-25)."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..cache import KVCache
from ..config import resolve_device


def cache_size_mb(cache: KVCache) -> float:
    """Bytes of every tensor the KV cache allocates (K/V, positions, the
    score sidecars and int8 scales), in MB (2**20 bytes)."""
    total = sum(t.numel() * t.element_size()
                for t in (getattr(cache, f.name) for f in dataclasses.fields(cache))
                if t is not None)
    return total / (1024**2)


def device_memory_stats(device=None) -> Dict[str, float]:
    """Current and peak allocated device memory and the card's total, in GB
    (2**30 bytes), from torch.cuda.memory_stats; the card unless `device` is
    given. {} for a device without such statistics (the CPU)."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    total = torch.cuda.get_device_properties(device).total_memory
    out = {}
    for value, name in [
        (stats.get("allocated_bytes.all.current"), "current_gb"),
        (stats.get("allocated_bytes.all.peak"), "peak_gb"),
        (total, "limit_gb"),
    ]:
        if value is not None:
            out[name] = round(value / (1024**3), 3)
    return out


def print_device_stats(device=None) -> None:
    stats = device_memory_stats(device)
    if stats:
        print(f"Current device memory usage: {stats.get('current_gb', '?')} GB")
        print(f"Peak device memory usage: {stats.get('peak_gb', '?')} GB")
