"""Per-stream state of the kernels that split a sum over blocks and add the
partials in a second step: the split tickets that pick the block adding
them (K11's split groups, csrc/w4_gemm.cu) and the workspace of the
partials (K11; K14 and K15, csrc/fused_decode*.cu), one of each per stream
and, inside a CUDA graph capture, of their own for the graph; and the
argument checks of a weight product (K10-K13). K13 (both of its
kernels), K10 and K12 keep no such state: their row splits add through a
thread-block cluster's distributed shared memory. K10 and K12 share
`group_ok`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

MAX_TICKETS = 4096        # column tiles of one launch whose rows split
MAX_STREAMS = 64          # streams a device keeps ticket rows for
GROUP_ROWS = 8            # the int4 kernels' groups: a multiple of this many rows
DTYPES = (torch.float32, torch.bfloat16)

_pools: Dict[torch.device, torch.Tensor] = {}
_rows: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_capture_row: Dict[torch.device, Tuple[int, torch.Tensor]] = {}
_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def group_ok(G: int) -> bool:
    """Whether the int4 kernels K10 and K12 take groups of G rows: a
    multiple of 8."""
    return G % GROUP_ROWS == 0


def tickets(device: torch.device, stream: int, capture: int = 0) -> torch.Tensor:
    """A row of zeroed tickets on `device` for a launch on `stream`. The
    adding block of each tile puts its ticket back to 0, so a row stays
    zeroed between launches that run one after the other.

    Outside a capture (capture == 0) that is the stream's row, zeroed once,
    when the device's first split launch makes it. Inside a CUDA graph
    capture (`capture` the id of the capture under way, csrc/w4_gemm.cu
    `capture_id`) it is the capture's own row, allocated zeroed in the
    graph's memory pool at the capture's first split launch: the zeroing is
    a node of the graph, run by every replay before that launch. Graphs
    captured on one stream then hold rows of their own, and may be replayed
    at once on two streams; a stream's row would be shared by them."""
    if capture:
        hit = _capture_row.get(device)
        if hit is None or hit[0] != capture:
            hit = _capture_row[device] = (
                capture, torch.zeros(MAX_TICKETS, dtype=torch.int32, device=device))
        return hit[1]
    row = _rows.get((device, stream))
    if row is None:
        pool = _pools.get(device)
        if pool is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the first quantized product on a device with split rows "
                                   "must run outside a CUDA graph capture")
            pool = torch.zeros((MAX_STREAMS, MAX_TICKETS), dtype=torch.int32, device=device)
            torch.cuda.synchronize(device)          # zeroed before any stream reads it
            _pools[device] = pool
        n = sum(1 for d, _ in _rows if d == device)
        if n == MAX_STREAMS:
            raise RuntimeError(f"quantized products ran on more than {MAX_STREAMS} streams")
        row = _rows[(device, stream)] = pool[n]
    return row


def workspace(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    """At least `numel` f32 of the stream's workspace for split partials.
    One per stream, grown on demand and kept (launches on one stream run one
    after the other); inside a CUDA graph capture a fresh one, which the
    graph's memory pool keeps for its replays."""
    ws = _workspaces.get((device, stream))
    if ws is not None and ws.numel() >= numel:
        return ws
    ws = torch.empty(numel, dtype=torch.float32, device=device)
    if not torch.cuda.is_current_stream_capturing():
        _workspaces[(device, stream)] = ws
    return ws


def check_args(entry: str, x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               scale_dtype: torch.dtype, scale_shape) -> None:
    """What the C side of a weight product cannot check: types, shapes,
    devices, layout (w 16-byte aligned)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"{entry} takes float32 or bfloat16 activations, got {x.dtype}")
    if (x.dim() != 2 or w.dtype != torch.int8 or w.dim() != 2
            or scale.dtype != scale_dtype or tuple(scale.shape) != tuple(scale_shape)):
        raise ValueError(f"{entry}: x {x.dtype} {tuple(x.shape)}, w {w.dtype} "
                         f"{tuple(w.shape)}, scale {scale.dtype} {tuple(scale.shape)} "
                         f"(expected {scale_dtype} {tuple(scale_shape)})")
    dev = x.device
    if (w.device != dev or scale.device != dev or not x.is_contiguous()
            or not w.is_contiguous() or not scale.is_contiguous() or w.data_ptr() % 16):
        raise ValueError(f"{entry}: x, w and scale must be contiguous and on {dev}, w "
                         "16-byte aligned")


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
