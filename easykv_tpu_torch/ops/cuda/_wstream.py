"""Launch of the weight-streaming kernel K13 at 1 < M <= 256
(csrc/weight_stream.cuh; K13 and K10 at M = 1 have their own stream,
csrc/quant_gemv.cu, and share only `check_args`): the plan (how many rows a
warp takes, how many row blocks a block walks, and over how many blocks
the rows split, so that the grid holds about two blocks per SM), the
workspace of the split rows' partial sums and the tickets that pick the
block adding them (one of each per stream; K11, csrc/w4_gemm.cu, uses them
too, and K14 / K15 the workspace), and the call. The int4 kernels K10 and
K12 share `group_ok`.

The C entry over weight_stream.cuh has the signature (x, w, scale, out,
ws, tickets, M, K, N, rc, passes, ksplit, x_bf16, out_f32, stream)."""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from . import _build

TARGET_BLOCKS = 264       # two blocks per SM of an H100 (132 SMs)
FILL = 0.9                # a plan within 10% of the target fills the card
WARPS = 8
ROW_CHUNKS = (64, 32, 16, 8)   # rows per warp chunk
MAX_TICKETS = 4096        # column tiles of one launch whose rows split
MAX_STREAMS = 64          # streams a device keeps ticket rows for
DTYPES = (torch.float32, torch.bfloat16)
_vp, _int = ctypes.c_void_p, ctypes.c_int
SIGNATURE = ([_vp] * 6 + [_int] * 8 + [_vp], _int)

_pools: Dict[torch.device, torch.Tensor] = {}
_rows: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_workspaces: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def group_ok(G: int) -> bool:
    """Whether the int4 kernels K10 and K12 take groups of G rows: a
    multiple of 8."""
    return G % ROW_CHUNKS[-1] == 0


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int) -> Tuple[int, int, int, int]:
    """(column tiles, rows per warp chunk, passes, row splits) for a weight
    of K rows by N columns and M rows of x. The tile is weight_stream.cuh's
    (launch_mt): mt rows of x per block, 16 columns per lane."""
    mt = 1 if M == 1 else 4
    tiles = -(-N // (32 * 16)) * -(-M // mt)
    for rc in ROW_CHUNKS:
        nb = -(-K // (WARPS * rc))
        if tiles * nb >= FILL * TARGET_BLOCKS:   # the largest chunks that fill the card
            break
    passes = max(1, tiles * nb // TARGET_BLOCKS)
    ksplit = -(-nb // passes)
    if ksplit > 1 and tiles > MAX_TICKETS:
        raise ValueError(f"{tiles} column tiles with split rows (at most {MAX_TICKETS})")
    return tiles, rc, -(-nb // ksplit), ksplit


def tickets(device: torch.device, stream: int) -> torch.Tensor:
    """The stream's row of zeroed tickets on `device`. The rows are zeroed
    once, when the device's first split launch makes them (not inside a
    CUDA graph capture); the adding block of each tile puts its ticket back
    to 0, so each row stays zeroed between the launches of its stream."""
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


def launch(source: str, entry: str, signatures, x: torch.Tensor, w: torch.Tensor,
           scale: torch.Tensor, scale_dtype: torch.dtype, scale_shape,
           out_f32: bool = False) -> torch.Tensor:
    """Checks what the C side cannot (types, shapes, devices, layout),
    plans, and launches `entry` of `source` on x's current stream:
    out (M, N) = x (M, K) @ dequant(w, scale), in x's dtype or f32."""
    check_args(entry, x, w, scale, scale_dtype, scale_shape)
    M, K = x.shape
    N = w.shape[1]
    tiles, rc, passes, ksplit = plan(M, K, N)
    stream = _build.stream_of(x)
    dev = x.device
    ws = tk = None
    if ksplit > 1:
        ws, tk = workspace(dev, stream, ksplit * M * N), tickets(dev, stream)
    out = torch.empty((M, N), dtype=torch.float32 if out_f32 else x.dtype, device=dev)
    fn = getattr(_build.load(source, signatures), entry)
    err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), ptr(ws), ptr(tk),
             M, K, N, rc, passes, ksplit, int(x.dtype == torch.bfloat16), int(out_f32), stream)
    _build.check(err, entry)
    return out


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
