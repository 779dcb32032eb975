"""Runtime switches of the port (counterpart of easykv_tpu/flags.py:141-152
and :216-246, which holds many more; only the ones the port's paths read
are here).

use_mega / mega_kernel_enabled switch the one-kernel decode step K14
(ops/cuda/fused_decode.py) for the fused arithmetic-int4 tree at B == 1,
as EASYKV_TPU_MEGA does in the JAX package: on by default; off, that tree
decodes through K10 per product, the JAX package's per-layer scan.
use_mega_batch / mega_batch_enabled switch its batched twin K15
(ops/cuda/fused_decode_batch.py) for that tree at 1 < B <= 16 (MHA) or
<= 8 (GQA), as EASYKV_TPU_MEGA_BATCH does (easykv_tpu/flags.py:155-166):
on wherever the mega flag is, off with it; off, those rows decode through
K11 per product.

use_prerot / prerot_enabled choose between the two strategies of ordered
StreamingLLM decoding, exactly as in the JAX package:
  * on (the default): the cache stores K already rotated by its slot
    (== age rank), attention reads it with no rotation, and each
    compaction shift applies one fixed R(-theta) to the rows it moves;
  * off: the cache stores the raw K and decode attention rotates every
    slot by its index at read time.
Both give the same greedy tokens up to float rounding and int8 requant.

use_chunk_kernel / chunk_kernel_mode pick the chunk kernels (K5 for the
prefill and the chunk-major forward, K6 for the strided encode) as
EASYKV_TPU_CHUNK_KERNEL does in the JAX package (easykv_tpu/flags.py:96-117
there, without its pallas_enabled() test: the port's kernels are chosen by
device): 'auto' (the default) takes them for an int8 cache only, 'on' for
every cache, 'off' for none (the chunk is written, the cache dequantized
and the plain `attend` run). use_step_kernel / step_kernel_enabled switch
the strided encode's one-call chunk step K7 (write + attend + score update
+ eviction, ops/cuda/chunk_attention.fused_chunk_step) as
EASYKV_TPU_STEP_KERNEL does (flags.py:286-295 there): off by default, and
taken only where the chunk kernels are (models/llama.use_step_kernel).

eager_decode_loop (a context manager) runs the decode loop eagerly on the
card too, every kernel of every step launched from the host, for an A/B
against the default there: one step captured as a CUDA graph and replayed
(engine/generate._decode_loop). No environment variable sets it, and on the
CPU the loop is always eager.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

_PREROT_OVERRIDE: Optional[bool] = None
_MEGA_OVERRIDE: Optional[bool] = None
_MEGA_BATCH_OVERRIDE: Optional[bool] = None
_CHUNK_KERNEL_OVERRIDE: Optional[bool] = None
_STEP_KERNEL_OVERRIDE: Optional[bool] = None
_EAGER_DECODE = False


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


def use_mega_batch(enabled: Optional[bool]) -> None:
    """Force the batched one-kernel decode step on or off; None goes back to
    the environment variable EASYKV_TPU_MEGA_BATCH (default on). Either
    way it runs only where mega_kernel_enabled() holds."""
    global _MEGA_BATCH_OVERRIDE
    _MEGA_BATCH_OVERRIDE = enabled


def mega_batch_enabled() -> bool:
    if _MEGA_BATCH_OVERRIDE is not None:
        return _MEGA_BATCH_OVERRIDE and mega_kernel_enabled()
    return _env_on("EASYKV_TPU_MEGA_BATCH") and mega_kernel_enabled()


def use_chunk_kernel(enabled: Optional[bool]) -> None:
    """Force the chunk kernels on or off; None goes back to the environment
    variable EASYKV_TPU_CHUNK_KERNEL (default 'auto')."""
    global _CHUNK_KERNEL_OVERRIDE
    _CHUNK_KERNEL_OVERRIDE = enabled


def chunk_kernel_mode() -> str:
    """'on' | 'off' | 'auto'. EASYKV_TPU_CHUNK_KERNEL: 0/false/off, auto,
    anything else on; unset, auto."""
    if _CHUNK_KERNEL_OVERRIDE is not None:
        return "on" if _CHUNK_KERNEL_OVERRIDE else "off"
    env = os.environ.get("EASYKV_TPU_CHUNK_KERNEL")
    if env is None or env == "auto":
        return "auto"
    return "off" if env in ("0", "false", "off") else "on"


def use_step_kernel(enabled: Optional[bool]) -> None:
    """Force the one-call chunk step K7 on or off; None goes back to the
    environment variable EASYKV_TPU_STEP_KERNEL (default off)."""
    global _STEP_KERNEL_OVERRIDE
    _STEP_KERNEL_OVERRIDE = enabled


def step_kernel_enabled() -> bool:
    if _STEP_KERNEL_OVERRIDE is not None:
        return _STEP_KERNEL_OVERRIDE
    return os.environ.get("EASYKV_TPU_STEP_KERNEL", "0") not in ("0", "false", "off")


@contextlib.contextmanager
def eager_decode_loop() -> Iterator[None]:
    """Inside: the decode loop runs every step eagerly on the card too."""
    global _EAGER_DECODE
    before, _EAGER_DECODE = _EAGER_DECODE, True
    try:
        yield
    finally:
        _EAGER_DECODE = before


def decode_graph_enabled() -> bool:
    """Whether a decode loop on the card replays a CUDA graph of its step
    (outside eager_decode_loop)."""
    return not _EAGER_DECODE
