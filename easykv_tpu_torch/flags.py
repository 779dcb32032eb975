"""Runtime switches of the port (counterpart of easykv_tpu/flags.py:141-152
and :216-246, which holds many more; only the ones the port's paths read
are here).

use_mega / mega_kernel_enabled switch the one-kernel decode step K14
(ops/cuda/fused_decode.py) for the fused arithmetic-int4 tree at B == 1,
as EASYKV_TPU_MEGA does in the JAX package: on by default; off, that tree
decodes through K10 per product, the JAX package's per-layer scan.

use_prerot / prerot_enabled choose between the two strategies of ordered
StreamingLLM decoding, exactly as in the JAX package:
  * on (the default): the cache stores K already rotated by its slot
    (== age rank), attention reads it with no rotation, and each
    compaction shift applies one fixed R(-theta) to the rows it moves;
  * off: the cache stores the raw K and decode attention rotates every
    slot by its index at read time.
Both give the same greedy tokens up to float rounding and int8 requant.
"""
from __future__ import annotations

import os
from typing import Optional

_PREROT_OVERRIDE: Optional[bool] = None
_MEGA_OVERRIDE: Optional[bool] = None


def _env_on(name: str) -> bool:
    return os.environ.get(name, "1") not in ("0", "false", "off")


def use_prerot(enabled: Optional[bool]) -> None:
    """Force the pre-rotated ordered streaming cache on or off; None goes
    back to the environment variable EASYKV_TPU_PREROT (default on)."""
    global _PREROT_OVERRIDE
    _PREROT_OVERRIDE = enabled


def prerot_enabled() -> bool:
    if _PREROT_OVERRIDE is not None:
        return _PREROT_OVERRIDE
    return _env_on("EASYKV_TPU_PREROT")


def use_mega(enabled: Optional[bool]) -> None:
    """Force the one-kernel decode step on or off; None goes back to the
    environment variable EASYKV_TPU_MEGA (default on)."""
    global _MEGA_OVERRIDE
    _MEGA_OVERRIDE = enabled


def mega_kernel_enabled() -> bool:
    if _MEGA_OVERRIDE is not None:
        return _MEGA_OVERRIDE
    return _env_on("EASYKV_TPU_MEGA")
