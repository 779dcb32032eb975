#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (easykv_tpu_torch) on one NVIDIA GPU and
checks it. Usage, from the root of the repository:

    python3 chip_smoke.py

Phases, each printing its lines before the last:

  1. the device, and the build of every CUDA kernel from easykv_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (LLaMa-2-7B width, S=768): K1 decode attention (bf16
     MHA, GQA with B=2, a dead row, f32; int8 cache MHA, GQA with B=2, a dead
     row), K2 sidecar pass (all six policies, eviction gate on and off,
     without and with the int8 scale rows: bit-exact; and, with K4, at the
     edges of their launch plan, K2_EDGES: S=16, 777 and 2304, B=16, every
     policy, with and without scale rows and `compact`, tied, NaN and -0.0
     scores, a row without a candidate, a dead row; and at K2_EDGES, K2
     given the step's K / V rows, bf16 and int8, bit-identical on every
     output, k and v to K2 without them followed by K3), K3 row write
     (Dh=128 and 64, bf16 and int8: exact), K5 chunk attention (C=128: int8 and bf16
     caches, statistics on and off, MHA, GQA with B=2 and padding rows, a
     sliding window, f32; and at the strided encode's S=2304, C=96: int8
     MHA, bf16 GQA rep 4 at B=2 with padding rows), K6 chunk write + attend (S=2304, C=96: int8 and
     bf16 caches, contiguous and scattered write slots, statistics on and
     off, GQA with B=2, a sliding window, f32, negative initial counters;
     cache arrays bit-exact); K7 chunk step (S=2304, C=96: int8 and bf16
     caches, roco and h2o_head, gates (on, on), (on, off), (off, on);
     Mistral-7B widths, GQA rep 4, B=2 with mixed row gates, a 512-slot
     window; the `ppl` runs' S=2176, bf16 roco; negative initial counters,
     holes, a partly filled cache):
     out within K6's limit, the scores within 1e-5 and the written rows
     exact against its plain version (the agreement share of pos,
     counter and the next mask printed), and every array bit-identical to
     K6 followed by the plain update and selection on K6's own statistics;
     the ordered StreamingLLM kernels: K4 gated
     eviction (five policies, gate on and off by row, B=2), K2 `compact`
     (five policies, with and without the scale rows), K9 K/V shift (bf16
     and int8, rotate on and off, at the main path's shape, S=777 and 2304
     and B=4; victims at slot 0, inside, S-1, none, negative and among the
     generated tokens) and K8 compaction (bf16 and int8) bit-exact on
     every array; K1 `ordered` (bf16 and int8, MHA, GQA with B=2) within
     K1's limit; the quantized-weight kernels at the 7B products (x bf16 and
     f32): K10 at M=1 and K12 at M=1..8 (launched twice, bit-identical)
     over the split tree's widths and the head, K11 at M=2, 4,
     16, 96, 128, 512 over the split and the fused tree's widths (both of
     its tile configurations and its group split), K13 at M=1 (its own
     kernel) and at M=2, 3, 4, 5, 16, 17, 128, 255, 256 (the edges of its
     tensor-core tiles), each launched twice, bit-identical, over the fused
     tree's widths and the LM head
     (N=32000, with f32 logits), each within 1e-5 of max|ref| (plus
     one bf16 ulp of the value in bf16) of its plain version; K14, the
     one-kernel decode step, at 7B width with L=2 (bf16 activations; bf16
     and int8 KV; RoPE at q_pos and at rope_pos; the main path's holes and
     scattered dead slots), each output within 1e-3 of its largest |value|
     (plus one bf16 ulp of the value for h, kn, vn) of its plain version
     (held again at L=32 in phase 5, see there); K15, the batched step, at
     LLaMa-2-7B width (B=4 and 16; B=2, 3, 5, 9 at RoPE at q_pos) and
     Mistral-7B's widths (GQA, B=8, a
     512-slot window), L=2, bf16 and int8 KV, RoPE at q_pos and rope_pos,
     holes and a dead row: each output within the larger of that limit and
     twice the plain version's reorder spread (k15_spread), and its bf16
     feed rounded as the plain version rounds it (k15_feed_check); K1's
     rank variant and fused_decode_attend at the `encoding` decode's shapes
     (S=2304, 2144 valid slots a head scattered over the cache, their age
     ranks; bf16, int8 and f32; MHA B=1, GQA rep 4 B=2 with a dead row;
     fused_decode_attend also with a 512-slot window) within K1's limits;
     and every K1 variant and fused_decode_attend, their slots split over a
     thread-block cluster, at the split's edges (runs that see no slot, a
     dead row, S=777, B=16 with one block a head, GQA rep 4 with a 512-slot
     window over the decode cache's positions and over the encoding
     family's; bf16 and int8 KV, f32 at S=777 and with the windows) within
     K1's limits of the plain version and of an f64 value (k1_exact);
  3. the main path end to end at full LLaMa-2-7B width (L=32, D=4096,
     32 heads, F=11008, V=32000; bf16 weights drawn on the card from a seed):
     a 512-token prompt, then 384 new tokens with roco at budget 200, then
     with the full cache, through CausalLM / enable_fixed_kv / generate, with
     a bf16 KV cache and then an int8 one (kv_quant=True: the prefill runs
     K5), and int8 roco at B=4; then StreamingLLM `decoding`
     (streaming=True) on the same prompt and budget: bf16 and int8 over the
     pre-rotated cache (K2 `compact` + K9 every step), int8 over the
     rotate-at-read cache (K1 `ordered`, K4, K8 every step) and bf16 `full`,
     each with its launch counts, retained tokens, printed ratio and the
     age-ordered final cache; then the encoding family on a 4096-token
     prompt with stride 96 and 128 new tokens: int8 and bf16 `encoding` (roco
     at budget 0.5: the strided encode runs K6 with the int8 cache), int8
     `encoding_decoding` (roco at budget 2048: an eviction every decode step)
     and int8 `ppl`, then the same four with streaming=True (StreamingLLM:
     the chunk-major encode over the unordered cache, K rotated by its age
     rank, the decode through K1's rank variant with carried ranks, checked
     against _age_ranks of the final cache) and a streaming int8 `encoding`
     at stride 1 (every encode chunk a decode step through K1 rank), and
     llama.forward at C=1 with the keep_attention bootstrap (32
     fused_decode_attend launches, each held to its plain version on its
     own inputs), and the one-call chunk step K7 (flags.use_step_kernel)
     against its twin without it: int8 `encoding` roco (704 K7, no K6, no
     plain selection), int8 `ppl` h2o_head and bf16 `ppl` roco with the
     chunk kernels on (1344 K7 against 1344 K6): equal tokens or ppl and
     bit-identical final cache arrays; then quantized weights, quantized on the card from the
     same bf16 weights by the port's quantize_params(_int4) and
     fuse_gemv_params, on the 512-token prompt with 384 new tokens: int4
     arithmetic fused, bench.py's headline tree (K14 once a decode step for
     all layers, K11 in the prefill, K13 for the head): int8 KV roco and
     `full`, bf16 KV roco, StreamingLLM roco over the pre-rotated int8
     cache (K2 compact + K9 every step); the same tree through K15 (one
     launch a step for all rows) at B=4 (int8 and bf16 KV roco, streaming
     roco) and B=16 (int8 and bf16 KV roco, int8 `full`); int4 arithmetic split with an int8
     KV cache (roco, `full`, roco at B=4: K10, or K11 at B=4, for the
     layers, K13 for the head, K11 in the B=1 prefill), int8 fused with an
     int8 KV cache (K13) and int4 halves split with a bf16 KV cache (K12),
     each with its launch counts, weight bytes per step and retained
     tokens (row 0's kv_len, and the valid slots of every (layer, row,
     head) of the final cache). Every decode replays a CUDA graph of its
     step (the capture's seconds and the graph's nodes on each line; K3 0
     launches: K2, given the rows, writes them in its launch, "K2 rows"
     counts those); the bf16 and int8 roco runs have eager twins
     (flags.eager_decode_loop), tok/s side by side, equal tokens, final pos
     / k / v (and scales) bit-identical. Then the serving engines
     (easykv_tpu_torch.serving, phase_serving): (a) ScheduledBatchEngine at
     benchmarks/bench_serving.py's configuration (the int4 arithmetic fused
     tree, int8 KV, 8 slots, 16 requests of 128-512 tokens, 128 new, roco
     b=200, chunk 128, T=1.0, top_p 0.95: decode ticks through K15 at B=8);
     (b) ScheduledBatchEngine, bf16 weights, bf16 and then int8 KV, 4 slots,
     8 requests, 128 new, greedy, roco b=64 (every row evicts); (c)
     ContinuousBatchEngine, bf16 KV, (b)'s requests, its decode tick
     replayed and eager: equal tokens, bit-identical final cache arrays.
     Each run: exactly 128 tokens a request, the finishing row's valid
     slots per (layer, head) before it is cleared equal to the
     single-request rule (prompt + min(forwarded tokens, budget)), every
     pos -1 at the end, each tick kind's exact launches (a pure-decode tick
     of (b) / (c): 32 K1, one K2 with the rows; of (a): one K15, K13 and
     K2; a merged tick: 32 K5 with int8 KV and one K4); aggregate tok/s,
     inter-token p50 / p95, ticks by kind and their ms, the decode tick
     replayed and eager, capture s and graph nodes printed. Launch counters
     are zeroed just before each run and read just after;
  4. the kernel path against the plain path on the card: full width, L=2,
     float32, 32 new tokens with roco at budget 8, float and int8 caches:
     equal greedy tokens and final positions; StreamingLLM `decoding` over
     the pre-rotated and the rotate-at-read cache, float and int8: equal
     tokens and final positions (int8: layer 0, K/V within one int8 step
     elsewhere); then `encoding` (also with
     keep_attention), `encoding_decoding` and `ppl` with roco on a
     1024-token prompt, stride 96: equal tokens and kv_len; equal final
     positions (an int8 cache: in layer 0, and K/V within one int8 step
     elsewhere); ppl within 1e-5 relative; the same for StreamingLLM
     `encoding` at stride 96 and 1 and `ppl`;
     then the int4 arithmetic fused (K14; K15 at B=4), int8 fused, int4
     arithmetic split and int4 halves split trees of those weights, f32 KV:
     equal tokens and final positions; the fused tree with an int8 KV cache
     too (B=1 and 4): equal tokens, layer 0's positions equal, K/V within
     one int8 step elsewhere; then the decode loop replayed as a CUDA graph
     against the same loop eager (GRAPH_CASES: full width, L=2, bf16
     weights; bf16 and int8 KV roco at B=1 and 4, `full`, `random`,
     StreamingLLM pre-rotated, rotate-at-read and rank, the split int4 tree
     at B=4, K14, K15 at B=4, a sampled run at temperature 0.7): every row's
     tokens, kv_len, final cache arrays and carried ranks bit-identical,
     launch counts equal; then serving (phase_plain_vs_kernel_serving), f32
     and int8 KV: ScheduledBatchEngine and ContinuousBatchEngine over (b)'s
     requests (32 new, roco b=8) through the kernels and with
     plain_kernels(): equal tokens; a sampled ScheduledBatchEngine
     snapshotted mid-flight (its decode graph already replayed) and
     resumed: the uninterrupted run's outputs;
  5. per-kernel device times (CUDA graphs of many launches, timed with CUDA
     events) beside each one's plain version, library call and bound, for
     each cache dtype the main path gives the kernel (K1's rank variant
     and fused_decode_attend at S=2304, each K1 entry beside
     scaled_dot_product_attention over the same cache, the attention half
     alone, as its library yardstick; K2 also at B=4 and 16 (S=768) and at
     the encoding family's S=2304, K4 also at S=2304, K9 also at B=4; K3
     as K2 given the rows less K2 alone, the stand-alone kernel beside it; K7 roco at a
     triggered chunk, int8 and bf16, each call from its untouched state); K10-K13
     at each 7B product of their phase-3 trees (bf16 activations; K11 at the split
     and the fused widths, M=4 and 512; K13 at M=1, 4, 16, 128 and 256, each
     record naming the source that serves its M) with enough weight copies cycled that L2 is
     cold, the library call torch.matmul over a bf16 copy dequantized
     beforehand; K14 for a whole decode step at 7B width (L=32, S=768),
     bf16 and int8 KV, first held to its plain version on the same
     arguments within the larger of phase 2's limit and twice the plain
     version's own spread when its input moves by one f32 ulp (the
     record's max_abs_err), then timed with CUDA events over back-to-back
     launches, its bound from the bytes the step reads and writes; K15 the
     same way at B=4, 8 (serving run (a), int8 KV) and 16 (bar: twice its
     reorder spread), then
     k15_control: at f32 activations, B=4 and 16, f32 and int8 KV, K15
     within the bar and the plain K15 with its residual rounded to bf16
     between the layers over it;
  6. the phase-3 tree (bf16, seed 0, L=32) through disk: written as an HF
     checkpoint (HF names, (out, in), BF16, three shards, the index and an
     HF-keyed config.json) into a temporary directory, with the free space,
     the bytes and the seconds; load_hf_checkpoint through the port's mmap
     reader in bf16 (seconds, GB/s, peak device memory over the tree),
     then with quantize="int4" and "int8" (each fused, bit-identical to
     fuse_gemv_params of phase 3's quantize_params_int4(layout="arith") /
     quantize_params; the int4 load's peak over the tree it returns at most
     3 GB, beside the in-memory quantize's own); the loaded bf16 tree (bf16
     KV) and int4 fused tree (int8 KV) decode phase 3's prompt with roco at
     budget 200 to phase 3's tokens with its launch counts (32 K1 and one K2
     a step; one K14), tok/s beside phase 3's; save_checkpoint /
     load_checkpoint of the int4 fused tree bit-identical; and
     `python3 -m easykv_tpu_torch` info, generate (`decoding`, 16 tokens,
     budget 8: the same call's tokens in-process) and ppl (the in-process
     value) as subprocesses. The phase adds no kernel: it runs K1, K2, K11,
     K13 and K14 on trees that came from disk;
  7. tensor / data parallelism over (data, model) meshes of spawned ranks
     (phase_parallel: gloo with several ranks a card), the seven sharded
     wrappers against their unsharded launches and timed on a shard;
  8. the sequence-parallel ring prefill on sp meshes of spawned ranks
     (phase_sp: sp = 2 runs the 7B bf16 `decoding` and int8 `encoding`
     with exact launches, the ranks' tokens and final caches equal by
     bits, and the L=2 f32 ring against the one-card chunked prefill;
     sp = 4 the latter), and pre-rotated StreamingLLM `decoding` under a
     (1, 2) mesh (L=2 f32 exactness; 7B bf16 with one K9s a step a rank).

It exits non-zero, without a result line, when there is no CUDA device, a
kernel does not build, or any check fails. The last line is
{"ok": true, "device": {...}}; the line before it holds `nvidia-smi`'s card
name and power limit, and the one before that the per-kernel JSON record.
"""
import contextlib
import copy
import dataclasses
import hashlib
import importlib
import io
import json
import math
import pickle
import re
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np
import torch

import easykv_tpu_torch
from easykv_tpu_torch import cli, flags
from easykv_tpu_torch import policies as policies_mod
from easykv_tpu_torch.cache import KVCache, init_cache, quantize_kv
from easykv_tpu_torch import parallel as parallel_mod
from easykv_tpu_torch.config import MeshConfig, ModelConfig
from easykv_tpu_torch.parallel import mesh as parallel_mesh
from easykv_tpu_torch.parallel import sharding as parallel_sharding
from easykv_tpu_torch.models import checkpoint as ckpt_mod
from easykv_tpu_torch.models import hf as hf_mod
from easykv_tpu_torch.models.llama import StepCtx, age_ranks_all, init_params, rotation_tables
from easykv_tpu_torch.native import save_safetensors
from easykv_tpu_torch.ops.cuda import _build
from easykv_tpu_torch.ops.cuda import sidecar_update as sidecar_mod
from easykv_tpu_torch.ops.cuda.kv_compact import (
    fused_compact as k8, fused_compact_plain as k8_plain, fused_kv_compact as k9,
    fused_kv_compact_plain as k9_plain, fused_kv_compact_sharded as k9s, shift_rotation)
from easykv_tpu_torch.ops.rope import rope_inv_freq
from easykv_tpu_torch.ops.cuda import chunk_attention as chunk_mod
from easykv_tpu_torch.ops.cuda.chunk_attention import (
    chunk_step_evict_plain, fused_chunk_attend as k5, fused_chunk_attend_plain as k5_plain,
    fused_chunk_attend_sharded as k5s, fused_chunk_step as k7,
    fused_chunk_step_plain as k7_plain, fused_chunk_step_sharded as k7s,
    fused_chunk_write_attend as k6, fused_chunk_write_attend_plain as k6_plain,
    fused_chunk_write_attend_sharded as k6s)
from easykv_tpu_torch.ops.cuda import decode_attention as da_mod
from easykv_tpu_torch.ops.cuda.decode_attention import (
    fused_decode_attend as kda, fused_decode_attend_inflight as k1,
    fused_decode_attend_inflight_plain as k1_plain, fused_decode_attend_inflight_sharded as k1s,
    fused_decode_attend_plain as kda_plain)
from easykv_tpu_torch.ops.cuda import fused_decode as k14_fd
from easykv_tpu_torch.ops.cuda.fused_decode import (fused_decode_step as k14,
                                                    fused_decode_step_plain as k14_plain)
from easykv_tpu_torch.ops.cuda.fused_decode_batch import (
    fused_decode_step_batch as k15, fused_decode_step_batch_plain as k15_plain)
from easykv_tpu_torch.ops.cuda.step_bars import (STEP_OUTPUTS, k14_ulp_spread, k15_feed_share,
                                                 k15_spread, step_shares)
from easykv_tpu_torch.ops.cuda.row_write import write_rows as k3, write_rows_plain as k3_plain
from easykv_tpu_torch.ops.cuda.sidecar_update import (
    fused_evict as k4, fused_evict_plain as k4_plain, fused_evict_sharded as k4s,
    fused_write_update as k2, fused_write_update_plain as k2_plain,
    fused_write_update_sharded as k2s)
from easykv_tpu_torch.ops import quant as quant_mod
from easykv_tpu_torch.ops.cuda.quant_matmul import (quant_matmul as k13,
                                                    quant_matmul_plain as k13_plain)
from easykv_tpu_torch.ops.cuda.w4_matmul import w4a16_gemv as k12, w4a16_gemv_plain as k12_plain
from easykv_tpu_torch.ops.cuda.w4_stream import (
    w4a16_gemm_arith as k11, w4a16_gemm_arith_plain as k11_plain, w4a16_gemv_arith as k10,
    w4a16_gemv_arith_plain as k10_plain)
from easykv_tpu_torch.policies import PHASE_DECODE, PolicySpec
from easykv_tpu_torch.serving import engine as serving_engine
from easykv_tpu_torch.serving import scheduled as serving_sched

gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
llama_mod = importlib.import_module("easykv_tpu_torch.models.llama")

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
F32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12          # H100 SXM bf16 tensor cores, dense
LLAMA2_7B = ModelConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                        num_hidden_layers=32, num_attention_heads=32,
                        num_key_value_heads=32, max_position_embeddings=4096)
PROMPT, BUDGET, NEW = 512, 200, 384
S_MAIN = 768                 # the engine's slot count for that run: 512 + 201 -> 768
CHUNK = 128                  # the prefill's chunk width (engine PREFILL_CHUNK)
B_WIDE = 4                   # the batched int8 run
B_MAX = 16                   # the widest K15 run
POLICIES = [None, "h2o_head", "tova", "roco", "recency", "random"]
# the encoding family's runs: a 4096-token prompt encoded in chunks of 96
ENC_PROMPT, STRIDE, ENC_NEW = 4096, 96, 128
ENC_IDX, ENC_RIDX, ENC_S = 2080, 1984, 2304    # encoding at budget 0.5
ENCDEC_RIDX, ENCDEC_S = 64, 2176               # encoding_decoding at budget 2048
STREAM_SHAPE = (32, 32, S_MAIN, 128)           # L, H, S, D of the streaming kernels' checks
# serving, benchmarks/bench_serving.py:38-78: 8 slots, 16 requests, prompts of
# 128-512 tokens, 128 new, roco b=200, chunk 128, T=1.0, top_p 0.95
SERVE_SLOTS, SERVE_REQS, SERVE_NEW, SERVE_MAX_PROMPT = 8, 16, 128, 512
# serving runs (b) and (c): 4 slots, 8 requests, roco at budget 64 (every row
# evicts from its 65th generated token), greedy
SMALL_SLOTS, SMALL_REQS, SMALL_BUDGET = 4, 8, 64


def k1_out_limit(ref):
    """Limit on |K1 out - plain out|. bf16: the plain version rounds p to
    bf16 before PV and the kernel keeps it in fp32, so the two round to the
    same or adjacent bf16 values: one bf16 ulp of the reference value plus
    a margin for values near 0, never above 1e-2. f32: 1e-5. (probs and
    p_new: 1e-5 in both.)"""
    if ref.dtype == torch.bfloat16:
        return (1e-3 + 2**-7 * ref.float().abs()).clamp(max=1e-2)
    return torch.full_like(ref, 1e-5, dtype=torch.float32)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# inputs at the main path's shapes
# ---------------------------------------------------------------------------

def slot_positions(L, B, H, S, n_valid, gen, dev):
    """Ring-buffer positions as the decode path leaves them: the prompt in
    slots [0, PROMPT), generated tokens (with holes) after it, the rest free."""
    pos = torch.full((L, B, H, S), -1, dtype=torch.int32)
    pos[..., :PROMPT] = torch.arange(PROMPT, dtype=torch.int32)
    n_gen = n_valid - PROMPT
    for idx in range(L * B * H):
        keep = torch.randperm(NEW - 1, generator=gen)[:n_gen].sort().values
        pos.view(-1, S)[idx, PROMPT:n_valid] = (PROMPT + keep).to(torch.int32)
    return pos.to(dev)


def k1_case(B, Hq, Hkv, S, D, dtype, q_pos, dev, seed, quant=False):
    """K1's arguments; with quant the cache is int8 and its two scale rows
    follow the seven arguments."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)  # noqa: E731
    pos = slot_positions(1, B, Hkv, S, PROMPT + BUDGET, torch.Generator().manual_seed(seed),
                         dev)[0]
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    scales = ()
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    return (rnd(B, Hq, 1, D), rnd(B, Hkv, 1, D), rnd(B, Hkv, 1, D), k, v, pos,
            torch.tensor(q_pos, dtype=torch.int32, device=dev)) + scales


def k5_case(B, Hq, Hkv, n_valid, dtype, quant, pad, dev, seed, S=S_MAIN, C=CHUNK, D=128):
    """The prefill's chunk at n_valid: slots [0, n_valid) hold positions
    0..n_valid-1 (the chunk's own tokens are the last C), the rest are free;
    the queries sit at n_valid-C .. n_valid-1. pad: the last batch row's
    final 17 queries are padding. With quant the cache is int8 and its two
    scale rows follow the five arguments."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    pos = torch.full((B, Hkv, S), -1, dtype=torch.int32, device=dev)
    pos[..., :n_valid] = torch.arange(n_valid, dtype=torch.int32, device=dev)
    q_pos = torch.arange(n_valid - C, n_valid, dtype=torch.int32, device=dev).repeat(B, 1)
    if pad:
        q_pos[-1, C - 17:] = -1
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return rnd(B, Hq, C, D).to(dtype), k, v, pos, q_pos, ks, vs
    return rnd(B, Hq, C, D).to(dtype), k.to(dtype), v.to(dtype), pos, q_pos


def k2_case(L, B, H, S, dev, seed):
    """(sidecar state, per-row arguments, eviction arguments, int8 scale
    rows: k_sc_new, v_sc_new, k_scale, v_scale). Below ENC_S the decode
    cache of phase 3 (slot_positions); at ENC_S the encoding family's
    scattered cache midway through its decode (RANK_VALID slots a head)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if S >= ENC_S:
        pos = torch.stack([scrambled_positions(B, H, S, RANK_VALID, dev, seed + l)
                           for l in range(L)])
        nxt = ENC_PROMPT + ENC_NEW
    else:
        pos = slot_positions(L, B, H, S, PROMPT + BUDGET, torch.Generator().manual_seed(seed),
                             dev)
        nxt = PROMPT + NEW
    valid = pos >= 0
    u = lambda: torch.rand((L, B, H, S), generator=g, device=dev)  # noqa: E731
    score = torch.where(valid, u() * 4, 0.0)
    ssq = score * u() * 0.1
    counter = torch.where(valid, (u() * 200).floor(), 0.0)
    probs = torch.where(valid, u() / S, 0.0)
    p_new = torch.rand((L, B, H, 1), generator=g, device=dev) * 0.05
    per_b = dict(q_pos=torch.full((B,), nxt - 1, dtype=torch.int32, device=dev),
                 token_valid=torch.ones(B, dtype=torch.bool, device=dev),
                 update_gate=torch.ones(B, dtype=torch.bool, device=dev),
                 counter_init=torch.zeros(B, device=dev))
    ev = dict(next_pos=torch.full((B,), nxt, dtype=torch.int32, device=dev),
              prompt_len=torch.full((B,), PROMPT, dtype=torch.int32, device=dev),
              rand_rank=torch.full((B,), 57, dtype=torch.int32, device=dev))
    scales = (torch.rand((L, B, H, 1), generator=g, device=dev) * 0.02,
              torch.rand((L, B, H, 1), generator=g, device=dev) * 0.02,
              torch.where(valid, u() * 0.02, 0.0), torch.where(valid, u() * 0.02, 0.0))
    return (pos, score, ssq, counter, probs, p_new), per_b, ev, scales


def k2_spec(policy):
    rw = int(BUDGET * 0.3)
    return PolicySpec(policy, PHASE_DECODE, 1, 4, rw, feasible_k=BUDGET - rw,
                      protect_prompt=True)


SCALE_NAMES = ("k_sc_new", "v_sc_new", "k_scale", "v_scale")
# K2's and K4's timed shapes (L = H = 32): phase 3's decode at B = 1, 4 and 16
# (S = 768), and the encoding family's decode (S = 2304)
K2_SHAPES = {"B=1": (1, S_MAIN), "B=4": (B_WIDE, S_MAIN), "B=16": (B_MAX, S_MAIN),
             "S=2304": (1, ENC_S)}
K2_VARIANTS = ("bf16", "int8", "compact bf16", "compact int8")   # int8: with the scale rows


def k2_time_sets(dev, B, S, variant, policy="roco", seed=50, n=4, rows=False, Dh=128):
    """K2's timed inputs at L = H = 32: n copies of k2_case (113 MB at B = 1,
    S = 768, so that L2 is cold when they are cycled), the eviction gate on;
    `variant` one of K2_VARIANTS. Returns (copies, run, nbytes, flops): run(fn)
    calls K2's fn (k2, k2_plain) on a copy; the bound's bytes: pos, score,
    score_sq, counter and probs read and score, score_sq and counter written
    (32 a slot); a row's p_new read, its write slot written and pos at that
    slot (and at the victim); with `compact` pos from the victim on instead
    (at least slot S-1's -1; the victims of the plain version on each copy,
    averaged over the copies) and the victim slot written; the two new
    scales read and written with the scale rows; flops 8 a slot for the
    update and the selection's keys, 31 for the bisection, 4 for the
    minimum. With `rows`, K2 also writes the step's K / V rows (int8 with
    the scale rows, else bf16; Dh elements), read and written once more."""
    L, H = 32, 32
    compact, int8 = variant.startswith("compact"), variant.endswith("int8")
    kv_dtype = torch.int8 if int8 else torch.bfloat16
    copies = []
    for c in range(n):
        state, per_b, ev, scales = k2_case(L, B, H, S, dev, seed + c)
        kw = dict(ev, espec=k2_spec(policy), evict_gate=torch.ones(B, dtype=torch.bool, device=dev))
        if compact:
            kw["compact"] = True
        if int8:
            kw.update(zip(SCALE_NAMES, scales))
        if rows:
            kw.update(k=torch.empty((L, B, H, S, Dh), dtype=kv_dtype, device=dev),
                      v=torch.empty((L, B, H, S, Dh), dtype=kv_dtype, device=dev),
                      kn=torch.ones((L, B, H, 1, Dh), dtype=kv_dtype, device=dev),
                      vn=torch.ones((L, B, H, 1, Dh), dtype=kv_dtype, device=dev))
        copies.append((state, per_b, kw))

    def run(fn):
        return lambda state, per_b, kw: fn(*state, *per_b.values(), policy, **kw)
    slots, n_rows = L * B * H * S, L * B * H
    nbytes = 32 * slots + n_rows * (12 + 4 + (16 if int8 else 0))
    if rows:
        nbytes += n_rows * 4 * Dh * (1 if int8 else 2)
    if compact:   # pos from each row's victim on, not the victim's alone
        tail = 0
        for state, per_b, kw in copies:
            victim = run(k2_plain)([x.clone() for x in state], per_b,
                                   {k: v.clone() if torch.is_tensor(v) else v
                                    for k, v in kw.items()})[-1]
            tail += int((S - victim.to(torch.int64)).clamp(min=1).sum())
        nbytes += 4 * tail // n - 4 * n_rows
    return copies, run, nbytes, slots * (8 + 31 + 4)


def k4_time_sets(dev, B, S, gate=True, policy="roco", seed=170, n=4):
    """K4's timed inputs at L = H = 32: n copies of k2_case's sidecars, every
    row's gate `gate`. K4 works in place, so each call evicts one more slot a
    row (the selection reads every slot whatever was evicted before).
    Returns (copies, nbytes, flops): with the gate on K4 reads pos, score,
    score_sq and counter and writes counter (20 bytes a slot) and one pos a
    row; with it off it reads and writes the counters alone."""
    L, H = 32, 32
    copies = []
    for c in range(n):
        state, _, ev, _ = k2_case(L, B, H, S, dev, seed + c)
        copies.append((*state[:4], torch.full((B,), gate, dtype=torch.bool, device=dev),
                       ev["next_pos"], ev["prompt_len"], ev["rand_rank"], k2_spec(policy)))
    slots, rows = L * B * H * S, L * B * H
    if gate:
        return copies, 20 * slots + rows * 4 + 16 * B, slots * (8 + 31 + 4)
    return copies, 8 * slots + 16 * B, slots


# K2 and K4 at the edges of their launch plan (sidecar_update.row_plan) in
# phase 2: (L, B, H, S)
K2_EDGES = {"S=777": (2, 2, 32, 777), "S=2304": (2, 2, 32, ENC_S), "S=16": (2, 2, 32, 16),
            "B=16": (2, B_MAX, 32, S_MAIN)}


def k2_edge_case(L, B, H, S, dev, seed):
    """K2's and K4's inputs at an edge of their plan: an age-ordered cache
    (slots [0, 3S/4) valid, the prompt's positions and then generated ones
    with gaps, the rest free) with odd rows in layer 0, batch row 0: head 0
    every score, score_sq and counter tied; head 1 a NaN score (the minimum
    is NaN: no victim among the scores); head 2 a -0.0 score before a +0.0
    one (the first zero wins); head 3 no candidate (every position in the
    prompt); head 4 a NaN score_sq (roco's std is NaN). The last batch row
    is dead (no token, every slot free). Gates by batch row: eviction on in
    even rows and the dead one (at B > 2), the score update off in every
    third. Returns (state, per_b,
    ev, scales, spec) with state, per_b, ev and scales as k2_case's and
    spec(policy) the policy's PolicySpec."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cpu = torch.Generator().manual_seed(seed)
    n_valid = S * 3 // 4
    plen = n_valid // 2
    pos = torch.full((L, B, H, S), -1, dtype=torch.int32)
    pos[..., :plen] = torch.arange(plen, dtype=torch.int32)
    gen = torch.stack([plen + torch.randperm(2 * n_valid, generator=cpu)[:n_valid - plen]
                       .sort().values for _ in range(L * B * H)])
    pos[..., plen:n_valid] = gen.view(L, B, H, -1).to(torch.int32)
    pos[0, 0, 3, plen:] = -1
    if B > 1:
        pos[:, -1] = -1
    pos = pos.to(dev)
    valid = pos >= 0
    u = lambda: torch.rand((L, B, H, S), generator=g, device=dev)  # noqa: E731
    score = torch.where(valid, u() * 4, 0.0)
    ssq = score * u() * 0.1
    counter = torch.where(valid, (u() * 50).floor() + 1, 0.0)
    probs = torch.where(valid, u() / S, 0.0)
    score[0, 0, 0], ssq[0, 0, 0], counter[0, 0, 0] = 0.5, 0.125, 8.0
    probs[0, 0, 0] = 1.0 / S
    score[0, 0, 1, plen + 1], probs[0, 0, 1, plen + 1] = float("nan"), float("nan")
    score[0, 0, 2, plen + 2], probs[0, 0, 2, plen + 2] = -0.0, -0.0
    score[0, 0, 2, plen + 3], probs[0, 0, 2, plen + 3] = 0.0, 0.0
    ssq[0, 0, 4, plen + 1] = float("nan")
    b = torch.arange(B, device=dev)
    nxt = 3 * S + 1
    per_b = dict(q_pos=torch.full((B,), nxt - 1, dtype=torch.int32, device=dev),
                 token_valid=b != B - 1 if B > 1 else b >= 0,
                 update_gate=b % 3 != 1, counter_init=(b % 2).float())
    ev = dict(next_pos=torch.full((B,), nxt, dtype=torch.int32, device=dev),
              prompt_len=torch.full((B,), plen, dtype=torch.int32, device=dev),
              rand_rank=(3 + 7 * b).to(torch.int32) % max(n_valid - plen, 1),
              evict_gate=(b % 2 == 0) | ((b == B - 1) & (B > 2)))
    scales = (torch.rand((L, B, H, 1), generator=g, device=dev),
              torch.rand((L, B, H, 1), generator=g, device=dev), u(), u())
    rw, fk = max(S // 8, 1), max(S // 4, 1)

    def spec(policy):
        return PolicySpec(policy, PHASE_DECODE, 1, 4, rw, feasible_k=fk, protect_prompt=True)
    return (pos, score, ssq, counter, probs, torch.rand((L, B, H, 1), generator=g,
                                                        device=dev) * 0.1), per_b, ev, scales, spec


def same_bits(a, b):
    """a and b hold the same bits (NaN payloads and signed zeros included)."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def k2_edge_results(L, B, H, S, dev, seed):
    """K2 (every policy, with and without the scale rows, and `compact` for
    the evicting ones) and K4 (every evicting policy) against their plain
    versions on k2_edge_case's inputs: yields (label, the kernel's outputs,
    the plain version's), each call on copies."""
    state, per_b, ev, scales, spec = k2_edge_case(L, B, H, S, dev, seed)
    clone = lambda xs: [x.clone() for x in xs]  # noqa: E731
    for policy in POLICIES:
        for compact in ((False,) if policy is None else (False, True)):
            for with_scales in (False, True):
                kw = {} if policy is None else dict(ev, espec=spec(policy), compact=compact)
                if with_scales:
                    kw.update(zip(SCALE_NAMES, scales))
                res = [fn(*clone(state), *per_b.values(), policy,
                          **{n: x.clone() if torch.is_tensor(x) and x.dim() == 4 else x
                             for n, x in kw.items()}) for fn in (k2, k2_plain)]
                yield (f"K2 {policy}{' compact' if compact else ''}"
                       f"{' scale rows' if with_scales else ''}", *res)
        if policy is not None:
            args = (ev["evict_gate"], ev["next_pos"], ev["prompt_len"], ev["rand_rank"],
                    spec(policy))
            res = [fn(*clone(state[:4]), *args) for fn in (k4, k4_plain)]
            yield f"K4 {policy}", *res


def k2_rows_results(L, B, H, S, dev, seed, Dh=128):
    """K2 given the step's K / V rows against K2 without them followed by
    K3 at the write slot it returns for the live rows (the decode step's
    two launches before K2 took K3's work into its own), on k2_edge_case's inputs, every variant
    K2_EDGES runs: yields (label, K2 with the rows' outputs and k, v, the
    two launches' outputs and k, v). The rows are bf16, int8 with the scale
    rows."""
    state, per_b, ev, scales, spec = k2_edge_case(L, B, H, S, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    rows = {}
    for kv, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        rows[kv] = [torch.randint(-127, 128, shape, generator=g, device=dev, dtype=dtype)
                    if dtype == torch.int8 else
                    torch.randn(shape, generator=g, device=dev).to(dtype)
                    for shape in ((L, B, H, S, Dh),) * 2 + ((L, B, H, 1, Dh),) * 2]
    for policy in POLICIES:
        for compact in ((False,) if policy is None else (False, True)):
            for with_scales in (False, True):
                k, v, kn, vn = rows["int8" if with_scales else "bf16"]
                kw = {} if policy is None else dict(ev, espec=spec(policy), compact=compact)
                if with_scales:
                    kw.update(zip(SCALE_NAMES, scales))

                def call(folded):
                    kk, vv = k.clone(), v.clone()
                    args = {n: x.clone() if torch.is_tensor(x) and x.dim() == 4 else x
                            for n, x in kw.items()}
                    if folded:
                        args.update(k=kk, v=vv, kn=kn, vn=vn)
                    res = k2(*[x.clone() for x in state], *per_b.values(), policy, **args)
                    if not folded:
                        k3(kk, vv, kn, vn, res[4][..., 0].contiguous())
                        dead = ~per_b["token_valid"]      # K2 writes no row of a dead row
                        kk[:, dead], vv[:, dead] = k[:, dead], v[:, dead]
                    return (*res, kk, vv)
                yield (f"K2 {policy}{' compact' if compact else ''}"
                       f"{' int8 rows, scale rows' if with_scales else ' bf16 rows'}",
                       call(True), call(False))


def k2_call(fn, state, per_b, ev, policy, gate_on, scales=None):
    """One K2 call on copies of the state (and of the scale rows, if given)."""
    args = [x.clone() for x in state]
    kw = {} if scales is None else dict(zip(SCALE_NAMES, [x.clone() for x in scales]))
    if policy is not None:
        B = per_b["q_pos"].shape[0]
        kw.update(ev, espec=k2_spec(policy),
                  evict_gate=torch.full((B,), gate_on, dtype=torch.bool,
                                        device=state[0].device))
    return fn(*args, per_b["q_pos"], per_b["token_valid"], per_b["update_gate"],
              per_b["counter_init"], policy, **kw)


def k3_case(L, B, H, S, Dh, dev, seed, dtype=torch.bfloat16):
    g = torch.Generator(device=dev).manual_seed(seed)
    if dtype == torch.int8:
        rnd = lambda *shape: torch.randint(-127, 128, shape, generator=g, device=dev,  # noqa
                                           dtype=torch.int8)
    else:
        rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)  # noqa
    slots = torch.randint(0, S, (L, B, H), generator=g, device=dev, dtype=torch.int32)
    return rnd(L, B, H, S, Dh), rnd(L, B, H, S, Dh), rnd(L, B, H, 1, Dh), \
        rnd(L, B, H, 1, Dh), slots


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(dev):
    """Each kernel against its plain version; returns the max |err| of the
    case at each timed entry's shapes, keyed as phase 5 keys its times."""
    errs = {}
    cases = [("bf16 MHA B=1", 1, 32, 32, torch.bfloat16, [PROMPT + NEW - 1], False),
             ("bf16 GQA B=2", 2, 32, 8, torch.bfloat16, [PROMPT + NEW - 1, 700], False),
             ("bf16 dead row", 2, 32, 32, torch.bfloat16, [PROMPT + NEW - 1, -1], False),
             ("f32 MHA B=1", 1, 32, 32, torch.float32, [PROMPT + NEW - 1], False),
             ("int8 MHA B=1", 1, 32, 32, torch.bfloat16, [PROMPT + NEW - 1], True),
             ("int8 GQA B=2", 2, 32, 8, torch.bfloat16, [PROMPT + NEW - 1, 700], True),
             ("int8 dead row", 2, 32, 32, torch.bfloat16, [PROMPT + NEW - 1, -1], True)]
    for i, (name, B, Hq, Hkv, dtype, qp, quant) in enumerate(cases):
        args = k1_case(B, Hq, Hkv, S_MAIN, 128, dtype, qp, dev, 10 + i, quant)
        got, ref = k1(*args), k1_plain(*args)
        torch.cuda.synchronize()
        e = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
        out_ratio = ((got[0].float() - ref[0].float()).abs() / k1_out_limit(ref[0])).max().item()
        print(f"phase 2: K1 {name}: max|err| out {e[0]:.3e} (at most {out_ratio:.2f} of its "
              f"limit) probs {e[1]:.3e} p_new {e[2]:.3e}")
        check(out_ratio <= 1 and max(e[1:]) <= 1e-5, f"K1 {name} disagrees: {e}")
        if qp[-1] < 0:
            check(got[0][1].abs().max().item() == 0 and got[1][1].abs().max().item() == 0,
                  f"K1 {name}: the dead row is not all zero")
        if name in ("bf16 MHA B=1", "int8 MHA B=1"):
            errs[("K1", "int8" if quant else "bf16")] = max(e)
    state, per_b, ev, scales = k2_case(32, 1, 32, S_MAIN, dev, 20)
    for with_scales in (False, True):
        for policy in POLICIES:
            for gate_on in ([False] if policy is None else [True, False]):
                sc = scales if with_scales else None
                got = k2_call(k2, state, per_b, ev, policy, gate_on, sc)
                ref = k2_call(k2_plain, state, per_b, ev, policy, gate_on, sc)
                torch.cuda.synchronize()
                same = [torch.equal(a, b) for a, b in zip(got, ref)]
                grown = ((got[0] >= 0).sum(-1) - (state[0] >= 0).sum(-1)).unique().tolist()
                what = "pos, score, score_sq, counter, slot" + (
                    ", k_scale, v_scale" if with_scales else "")
                print(f"phase 2: K2 policy={policy} evict_gate={gate_on} scale rows "
                      f"{with_scales}: bit-exact {all(same)} ({what} = {same}); "
                      f"valid slots per row grew by {grown}")
                check(all(same) and len(same) == (7 if with_scales else 5),
                      f"K2 policy={policy} gate={gate_on} scales={with_scales} not bit-exact")
                check(grown == [0 if gate_on else 1],
                      f"K2 policy={policy} gate={gate_on}: valid slots grew by {grown}")
    errs[("K2", "bf16")] = errs[("K2", "int8")] = 0.0
    phase_k2_edges(dev)      # bit-exact at B = 16 and S = 2304 too: phase 5's other K2 rows
    errs.update({(f"K2 {shape}", kv): 0.0 for shape in ("B=4", "B=16", "S=2304")
                 for kv in ("bf16", "int8")})
    for dtype in (torch.bfloat16, torch.int8):
        for Dh in (128, 64):
            k, v, kn, vn, slots = k3_case(32, 1, 32, S_MAIN, Dh, dev, 30, dtype)
            ka, va = k3(k.clone(), v.clone(), kn, vn, slots)
            kb, vb = k3_plain(k.clone(), v.clone(), kn, vn, slots)
            torch.cuda.synchronize()
            ok = torch.equal(ka, kb) and torch.equal(va, vb)
            print(f"phase 2: K3 {dtype} Dh={Dh}: exact {ok}")
            check(ok, f"K3 {dtype} Dh={Dh} differs")
    errs[("K3", "bf16")] = errs[("K3", "int8")] = 0.0
    errs[("K5", "int8")] = phase_k5(dev)
    errs[("K6", "int8")] = phase_k6(dev)
    errs.update(phase_streaming_kernels(dev))
    phase_k1_edges(dev)
    return errs


def phase_k2_edges(dev):
    """K2 (every policy, with and without the scale rows, `compact` for the
    evicting ones) and K4 (every evicting policy) bit-exact against their
    plain versions on every array they write, at the edges of their plan
    (K2_EDGES: a scalar tail and S = 2304 on the wide path, a row shorter
    than a warp, B = 16), with tied, NaN and signed-zero scores, a row without a
    candidate and a dead row (k2_edge_case)."""
    for i, (case, (L, B, H, S)) in enumerate(K2_EDGES.items()):
        plan = sidecar_mod.row_plan(S) if hasattr(sidecar_mod, "row_plan") else None
        bad, n, victims = [], 0, set()
        for label, got, ref in k2_edge_results(L, B, H, S, dev, 600 + i):
            torch.cuda.synchronize()
            n += 1
            if len(got) != len(ref) or not all(same_bits(a, b) for a, b in zip(got, ref)):
                bad.append(label)
            if "compact" in label:
                victims.update(got[-1][0, 0, :5, 0].tolist())
        print(f"phase 2: K2 / K4 edge {case} (L={L}, B={B}, H={H}, plan {plan}): {n - len(bad)} "
              f"of {n} calls bit-exact; layer 0 row 0's odd heads' victims (compact) "
              f"{sorted(victims)}")
        check(not bad, f"K2 / K4 edge {case}: not bit-exact: {bad}")
        check(S in victims, f"K2 / K4 edge {case}: no row without a victim")
        before = k2.rows_launches
        bad, n = [], 0
        for label, got, ref in k2_rows_results(L, B, H, S, dev, 640 + i):
            torch.cuda.synchronize()
            n += 1
            if len(got) != len(ref) or not all(same_bits(a, b) for a, b in zip(got, ref)):
                bad.append(label)
        print(f"phase 2: K2 with the rows edge {case}: {n - len(bad)} of {n} calls bit-exact "
              f"with K2 then K3 (every output, k, v)")
        check(not bad and k2.rows_launches == before + n,
              f"K2 with the rows edge {case}: not bit-exact with K2 then K3: {bad}")


# K1's split edges in phase 2: (B, Hq, Hkv, S, window, positions, cluster
# of the plan); positions: the encoding family's scattered ones (q_pos 4224),
# 300 of them in the first slots and the rest free, or the decode cache's
# (q_pos 895)
K1_EDGES = {
    "masked runs": (1, 32, 32, S_MAIN, None, "first 300", 4),   # blocks 2, 3 see no slot
    "dead row": (2, 32, 32, S_MAIN, None, "scattered", 2),
    "S=777": (1, 32, 32, 777, None, "scattered", 4),             # 25 tiles, the last of 9 rows
    "B=16": (16, 32, 32, S_MAIN, None, "scattered", 1),          # one block a (batch, kv head)
    "GQA rep 4 window 512": (2, 32, 8, S_MAIN, 512, "decode", 8),
    "GQA rep 4 window 512 scattered": (2, 32, 8, S_MAIN, 512, "scattered", 8),  # ~80 slots seen
}


def k1_exact(args, window=None, rot=None, rank=None, inflight=True):
    """out of K1 (inflight) or of fused_decode_attend on K1's arguments (q,
    kn, vn, k, v, pos, q_pos[, k_scale, v_scale]) in f64, p unrounded
    through PV as the kernels (and the TPU kernel) keep it; K1's plain
    version rounds p to a bf16 cache's dtype first. The second witness of
    phase 2's K1 edges."""
    f = lambda t: t.to(torch.float64)  # noqa: E731
    q, kn, vn, k, v, pos, qp = args[:7]
    B, Hq, _, D = q.shape
    Hkv = k.shape[1]
    kf, vf = f(k), f(v)
    if rot is not None:
        cos, sin = f(rot[0]), f(rot[1])
        if rank is not None:
            cos, sin = cos[rank.long()], sin[rank.long()]
        h = D // 2
        kf = torch.cat([kf[..., :h] * cos - kf[..., h:] * sin,
                        kf[..., h:] * cos + kf[..., :h] * sin], dim=-1)
    if len(args) > 7:                                   # int8: the rows' scales
        kf, vf = kf * f(args[7])[..., None], vf * f(args[8])[..., None]
    qg = f(q).reshape(B, Hkv, Hq // Hkv, D)
    logits = torch.einsum("bhrd,bhsd->bhrs", qg, kf) * D ** -0.5
    qpb = qp[:, None, None]
    mask = (pos >= 0) & (pos <= qpb)
    if window is not None:
        mask &= pos > qpb - window
    mask = mask[:, :, None, :]
    m = torch.where(mask, logits, -1e30).amax(dim=-1, keepdim=True)
    if inflight:
        live = (qp >= 0)[:, None, None, None]
        l_new = torch.where(live, torch.einsum("bhrd,bhsd->bhrs", qg, f(kn)) * D ** -0.5, -1e30)
        m = torch.maximum(m, l_new)
    e = torch.where(mask, torch.exp(logits - m), 0.0)
    num, den = torch.einsum("bhrs,bhsd->bhrd", e, vf), e.sum(dim=-1, keepdim=True)
    if inflight:
        e_new = torch.where(live, torch.exp(l_new - m), 0.0)
        num, den = num + e_new * f(vn), den + e_new
    return (num / den.clamp(min=1e-300)).reshape(B, Hq, 1, D)


def k1_out_share(out, ref):
    """The largest |out - ref| as a share of K1's out limit around ref."""
    return ((out.double() - ref.double()).abs() / k1_out_limit(ref.to(out.dtype))).max().item()


def k1_edge_results(case, kind, dev):
    """Every K1 variant (plain, ordered, rank) and fused_decode_attend at
    one of K1_EDGES, bf16, int8 or f32 KV: a list of (entry, the kernel's
    outputs, the plain version's, k1_exact's out)."""
    i = list(K1_EDGES).index(case)
    B, Hq, Hkv, S, window, where, _ = K1_EDGES[case]
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    qp = [PROMPT + NEW - 1] * B if where == "decode" else [ENC_PROMPT + ENC_NEW] * B
    args = k1_case(B, Hq, Hkv, S, 128, dtype, qp, dev, 500 + i, kind == "int8")
    pos = args[5]                                       # k1_case's decode cache positions
    if where == "first 300":
        pos = torch.full((B, Hkv, S), -1, dtype=torch.int32, device=dev)
        pos[..., :300] = torch.randperm(300, generator=torch.Generator().manual_seed(i)
                                        ).to(device=dev, dtype=torch.int32)
    elif where == "scattered":
        pos = scrambled_positions(B, Hkv, S, S * 7 // 8, dev, 510 + i, case == "dead row")
    q_pos = args[6].clone()
    if case == "dead row":
        q_pos[-1] = -1
    args = args[:5] + (pos, q_pos) + args[7:]
    rot, ranks = rotation_tables(S, LLAMA2_7B, dev), age_ranks_all(pos[None])[0]
    da_args = (args[0],) + args[3:]
    kw = dict(sliding_window=window)
    res = [(key, k1(*args, **kw, **opt), k1_plain(*args, **kw, **opt),
            k1_exact(args, window, **opt))
           for key, opt in (("K1", {}), ("K1 ordered", dict(rot=rot)),
                            ("K1 rank", dict(rot=rot, rank=ranks)))]
    return res + [("decode_attend", kda(*da_args, **kw), kda_plain(*da_args, **kw),
                   k1_exact(args, window, inflight=False))]


def phase_k1_edges(dev):
    """K1 (plain, ordered, rank) and fused_decode_attend, their slots split
    over a thread-block cluster (ops/cuda/decode_attention.split_plan), at
    the split's edges (K1_EDGES): runs that see no slot, a dead row, S not a
    multiple of the 32-row tiles or the cluster, B = 16 (one block a head),
    GQA rep 4 with a 512-slot window over the decode cache's positions and
    over the encoding family's; bf16 and int8 KV (f32 too at S=777 and with
    the windows). probs and p_new within 1e-5 of the plain version; out
    within K1's limit (k1_out_limit) of k1_exact's f64 value, and of the
    plain version's out unless that itself lies outside the limit of the
    f64 value (with a bf16 cache the plain version rounds p to bf16; over a
    window that leaves few slots this moves out by more than one bf16 ulp);
    a dead row all zero, the probabilities of unseen slots exactly 0. Each
    line gives, per entry, the share of the limit against the plain
    version, against the f64 value, and the plain version's own against
    the f64 value, and the largest probability error."""
    for case, (B, Hq, Hkv, S, window, _, cluster) in K1_EDGES.items():
        for kind in ("bf16", "int8") + (("f32",) if S == 777 or window else ()):
            res = k1_edge_results(case, kind, dev)
            torch.cuda.synchronize()
            worst = []
            for key, got, ref, exact in res:
                e = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
                to_plain, to_exact = k1_out_share(got[0], ref[0]), k1_out_share(got[0], exact)
                plain_off = k1_out_share(ref[0], exact)
                check(to_exact <= 1 and (to_plain <= 1 or plain_off > 1) and max(e[1:]) <= 1e-5,
                      f"{key} {case} {kind} disagrees: out {to_plain:.2f} of its limit against "
                      f"the plain version, {to_exact:.2f} against f64 (the plain version "
                      f"{plain_off:.2f}), probs {e[1:]}")
                if case == "dead row":
                    check(got[0][1].abs().max().item() == 0 and got[1][1].abs().max().item() == 0,
                          f"{key} {case} {kind}: the dead row is not all zero")
                if case == "masked runs":
                    check(got[1][..., 300:].abs().max().item() == 0,
                          f"{key} {case} {kind}: unseen slots have probability")
                worst.append(f"{key} {to_plain:.2f} / {to_exact:.2f} (plain {plain_off:.2f}) / "
                             f"{max(e[1:]):.1e}")
            plan = da_mod.split_plan(B, Hkv, Hq // Hkv, S, 128, kind, 0)
            check(plan.cluster == cluster, f"K1 {case}: cluster {plan.cluster}, not {cluster}")
            print(f"phase 2: K1 split edge {case}, {kind} KV (cluster {plan.cluster}, {plan.nk} "
                  f"tiles a ring): out's share of its limit against the plain version / f64 "
                  f"(the plain version's against f64) / probs max|err|: " + ", ".join(worst))


def kv_rows(L, B, H, S, D, kind, dev, seed):
    """Random K/V buffers of one cache: bf16, or int8 with its scales."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn((L, B, H, S, D), generator=g, device=dev)
    v = torch.randn((L, B, H, S, D), generator=g, device=dev)
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return [k, v, ks, vs]
    return [k.to(torch.bfloat16), v.to(torch.bfloat16)]


def stream_victims(L, B, H, S, dev, seed, edges=False):
    """(L, B, H) int32 victim slots among the generated tokens of the
    ordered cache, [PROMPT, PROMPT + BUDGET); one in six heads none (S).
    edges: a few at the first slot, in the middle, at the last tile, S."""
    g = torch.Generator(device=dev).manual_seed(seed)
    vs = torch.randint(PROMPT, PROMPT + BUDGET, (L, B, H), generator=g, device=dev,
                       dtype=torch.int32)
    vs[torch.rand((L, B, H), generator=g, device=dev) < 1 / 6] = S
    if edges:
        vs.view(-1)[:7] = torch.tensor([0, 5, S // 2, S - 33, S - 1, S, -1], dtype=torch.int32)
    return vs


# K9's phase-2 shapes (L, B, H, S): the main path's, then the edges of its
# row split (a tail past one round of the cluster; S = 777, no multiple of
# a tile) and the fused tree's streaming B = 4
K9_EDGES = ((32, 1, 32, S_MAIN), (2, 1, 8, 777), (2, 1, 8, 2304), (32, B_WIDE, 32, S_MAIN))


def k9_edge_cases(dev, small=False):
    """(label, ((k, v, v_slot[, k_scale, v_scale]), {"rot": ...})) of K9's
    phase-2 cases, each made anew: every shape of K9_EDGES (L cut to 2 and
    H to 8 with `small`), bf16 and int8, rot on and off. Victims among the
    generated tokens, one head in six none, and the first heads' at slots
    0, 5, S/2, S-33, S-1, S (none) and -1 (every row moves)."""
    D = STREAM_SHAPE[3]
    shift = shift_rotation(rope_inv_freq(D, LLAMA2_7B.rope_theta, dev))
    for i, (L, B, H, S) in enumerate(K9_EDGES):
        if small:
            L, H = 2, 8
        for kind in ("bf16", "int8"):
            kv = kv_rows(L, B, H, S, D, kind, dev, 151 + 10 * i)
            vs = stream_victims(L, B, H, S, dev, 152 + 10 * i, edges=True)
            for rotate in (True, False):
                label = f"L={L} B={B} H={H} S={S} {kind} rotate={rotate}"
                yield label, ((kv[0].clone(), kv[1].clone(), vs, *[x.clone() for x in kv[2:]]),
                              {"rot": shift if rotate else None})
            del kv


def phase_streaming_kernels(dev):
    """The ordered StreamingLLM kernels against their plain versions at the
    main path's shapes (L=32, H=32, S=768, D=128), on copies of the same
    inputs: K4, K8, K9 and K2 `compact` bit-exact on every array they
    write; K1 `ordered` within K1's limits. Returns the max |err| keyed as
    phase 5 keys its times."""
    L, H, S, D = STREAM_SHAPE
    errs = {}
    state, per_b, ev, scales = k2_case(L, 2, H, S, dev, 140)
    gate = torch.tensor([True, False], device=dev)
    for policy in POLICIES[1:]:
        a = [x.clone() for x in state[:4]]
        b = [x.clone() for x in state[:4]]
        args = (gate, ev["next_pos"], ev["prompt_len"], ev["rand_rank"], k2_spec(policy))
        k4(*a, *args)
        k4_plain(*b, *args)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        drop = ((state[0] >= 0).sum(-1) - (a[0] >= 0).sum(-1))
        print(f"phase 2: K4 policy={policy} B=2 gate (on, off): bit-exact {all(same)} "
              f"(pos, score, score_sq, counter = {same}); valid slots per row dropped by "
              f"{drop[:, 0].unique().tolist()} / {drop[:, 1].unique().tolist()}")
        check(all(same) and drop[:, 0].unique().tolist() == [1]
              and drop[:, 1].unique().tolist() == [0], f"K4 policy={policy} disagrees")
        for with_scales in (False, True):
            kw = dict(ev, espec=k2_spec(policy), evict_gate=gate, compact=True)
            if with_scales:
                kw.update(zip(SCALE_NAMES, scales))
            got = k2(*[x.clone() for x in state], *per_b.values(), policy,
                     **{n: x.clone() if torch.is_tensor(x) and x.dim() == 4 else x
                        for n, x in kw.items()})
            ref = k2_plain(*[x.clone() for x in state], *per_b.values(), policy,
                           **{n: x.clone() if torch.is_tensor(x) and x.dim() == 4 else x
                              for n, x in kw.items()})
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(got, ref)]
            vs = got[-1][..., 0]
            print(f"phase 2: K2 compact policy={policy} B=2 gate (on, off) scale rows "
                  f"{with_scales}: bit-exact {all(same)} ({len(same)} outputs, victim slot "
                  f"last); victims in [{int(vs[:, 0].min())}, {int(vs[:, 0].max())}], "
                  f"gate off: {vs[:, 1].unique().tolist()}")
            check(all(same) and len(same) == (8 if with_scales else 6)
                  and vs[:, 1].unique().tolist() == [S] and int(vs[:, 0].max()) < S,
                  f"K2 compact policy={policy} scales={with_scales} disagrees")
    errs[("K4", "-")] = errs[("K2 compact", "bf16")] = errs[("K2 compact", "int8")] = 0.0
    errs[("K4 S=2304", "-")] = 0.0      # phase_k2_edges holds K4 at S = 2304 bit-exact
    pos = slot_positions(L, 1, H, S, PROMPT + BUDGET, torch.Generator().manual_seed(150), dev)
    for label, (args, kw) in k9_edge_cases(dev):
        kv, vs = list(args[:2]) + list(args[3:]), args[2]
        a = [x.clone() for x in kv]
        b = [x.clone() for x in kv]
        k9(a[0], a[1], vs, *a[2:], **kw)
        k9_plain(b[0], b[1], vs, *b[2:], **kw)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        moved = not torch.equal(a[1], kv[1])
        print(f"phase 2: K9 {label}: bit-exact {all(same)} (k, v"
              f"{', k_scale, v_scale' if len(kv) == 4 else ''} = {same}); V moved {moved}")
        check(all(same) and moved, f"K9 {label} disagrees")
        del a, b, kv, args
    for kind in ("bf16", "int8"):
        errs[("K9", kind)] = errs[("K9 B=4", kind)] = 0.0
        kv = kv_rows(L, 1, H, S, D, kind, dev, 151)
        # K8: one victim per head among the generated tokens, some heads none
        post = pos.clone()
        victim = stream_victims(L, 1, H, S, dev, 153)
        fires = victim < S
        post.scatter_(-1, victim.clamp(max=S - 1)[..., None].long(),
                      torch.where(fires[..., None], -1, post.gather(
                          -1, victim.clamp(max=S - 1)[..., None].long())))
        side = list(state[1:4])
        side = [x[:, :1].clone() for x in side]
        arrs = [post] + side + [x for x in kv]
        a = [x.clone() for x in arrs]
        b = [x.clone() for x in arrs]
        k8(pos, *a)
        k8_plain(pos, *b)
        torch.cuda.synchronize()
        same = [torch.equal(x, y) for x, y in zip(a, b)]
        n = (a[0] >= 0).sum(-1)
        contiguous = torch.equal(a[0] >= 0, torch.arange(S, device=dev) < n[..., None])
        print(f"phase 2: K8 {kind}: bit-exact {all(same)} ({len(same)} arrays = {same}); "
              f"{int(fires.sum())} of {fires.numel()} heads evicted; valid slots contiguous "
              f"after {contiguous}")
        check(all(same) and contiguous, f"K8 {kind} disagrees")
        errs[("K8", kind)] = 0.0
    rot = rotation_tables(S, LLAMA2_7B, dev)
    cases = [("bf16 MHA B=1", 1, 32, 32, False), ("bf16 GQA B=2", 2, 32, 8, False),
             ("int8 MHA B=1", 1, 32, 32, True), ("int8 GQA B=2", 2, 32, 8, True)]
    for i, (name, B, Hq, Hkv, quant) in enumerate(cases):
        qp = [PROMPT + NEW - 1] + [700] * (B - 1)
        args = k1_case(B, Hq, Hkv, S, D, torch.bfloat16, qp, dev, 160 + i, quant)
        got, ref = k1(*args, rot=rot), k1_plain(*args, rot=rot)
        torch.cuda.synchronize()
        e = [(x.float() - y.float()).abs().max().item() for x, y in zip(got, ref)]
        ratio = ((got[0].float() - ref[0].float()).abs() / k1_out_limit(ref[0])).max().item()
        print(f"phase 2: K1 ordered {name}: max|err| out {e[0]:.3e} (at most {ratio:.2f} of "
              f"its limit) probs {e[1]:.3e} p_new {e[2]:.3e}")
        check(ratio <= 1 and max(e[1:]) <= 1e-5, f"K1 ordered {name} disagrees: {e}")
        if name.endswith("MHA B=1"):
            errs[("K1 ordered", "int8" if quant else "bf16")] = max(e)
    return errs


def phase_k5(dev):
    """K5 against its plain version at the prefill's last chunk (C=128, 512
    of 768 slots) and at the strided encode's (C=96, 2176 of 2304 slots;
    MHA, and GQA rep 4 at B=2): out within 1e-5 (f32) or one bf16 ulp of the
    reference plus 1e-3 (bf16); ssum, ssq, last within 1e-5; padding rows
    exactly 0. Returns the max |err| of the main path's case."""
    n_last = PROMPT          # the prompt's last chunk: 512 visible slots of 768
    cases = [  # name, B, Hq, Hkv, dtype, quant, scores, pad, window
        ("int8 MHA B=1 (main path)", 1, 32, 32, torch.bfloat16, True, False, False, None),
        ("int8 MHA B=1 scores", 1, 32, 32, torch.bfloat16, True, True, False, None),
        ("bf16 MHA B=1", 1, 32, 32, torch.bfloat16, False, False, False, None),
        ("bf16 MHA B=1 scores", 1, 32, 32, torch.bfloat16, False, True, False, None),
        ("int8 GQA B=2 padding scores", 2, 32, 8, torch.bfloat16, True, True, True, None),
        ("bf16 GQA B=2 padding", 2, 32, 8, torch.bfloat16, False, False, True, None),
        ("int8 window 200 scores", 1, 32, 32, torch.bfloat16, True, True, False, 200),
        ("f32 int8 MHA scores", 1, 32, 32, torch.float32, True, True, False, None),
        ("f32 MHA window 200 scores", 1, 32, 32, torch.float32, False, True, False, 200),
        ("int8 MHA B=1 scores at the encode shape", 1, 32, 32, torch.bfloat16, True, True, False,
         None, ENC_S, STRIDE, ENC_IDX + STRIDE),
        ("bf16 Mistral-7B widths GQA rep 4 B=2 padding scores at the encode shape", 2, 32, 8,
         torch.bfloat16, False, True, True, None, ENC_S, STRIDE, ENC_IDX + STRIDE),
    ]
    main_err = None
    for i, (name, B, Hq, Hkv, dtype, quant, scores, pad, window, *shape) in enumerate(cases):
        S, C, n_valid = shape or (S_MAIN, CHUNK, n_last)
        args = k5_case(B, Hq, Hkv, n_valid, dtype, quant, pad, dev, 70 + i, S=S, C=C)
        got = k5(*args, need_scores=scores, sliding_window=window)
        ref = k5_plain(*args, need_scores=scores, sliding_window=window)
        torch.cuda.synchronize()
        e_out = (got[0].float() - ref[0].float()).abs().max().item()
        ratio = ((got[0].float() - ref[0].float()).abs() / k1_out_limit(ref[0])).max().item()
        e_st = [(a - b).abs().max().item() for a, b in zip(got[1:], ref[1:])] if scores else []
        line = f"phase 2: K5 {name}: max|err| out {e_out:.3e} (at most {ratio:.2f} of its limit)"
        if scores:
            line += " ssum {:.3e} ssq {:.3e} last {:.3e}".format(*e_st)
        ok = ratio <= 1 and all(x <= 1e-5 for x in e_st)
        if pad:
            zero = got[0][-1, :, C - 17:].abs().max().item() == 0
            line += f"; padding rows exactly 0: {zero}"
            ok = ok and zero
        print(line)
        check(ok and all(torch.isfinite(x).all() for x in got if x is not None),
              f"K5 {name} disagrees")
        if i == 0:
            main_err = max([e_out] + e_st)
    return main_err


def k6_case(B, Hq, Hkv, dtype, quant, scattered, negative, dev, seed, S=ENC_S, C=STRIDE,
            D=128):
    """One strided chunk of the int8 `encoding` run. Contiguous ids: the
    first chunk, writing slots [r_idx, r_idx + C) after the r_idx prefix
    slots. Scattered ids: a triggered chunk, writing the C sorted slots the
    previous eviction freed among the idx + C occupied ones, so idx + C
    slots are valid after the write. Positions are sorted and below 4000;
    the chunk's tokens sit at 4000..4000+C-1; negative initial counters are
    the engine's -((pos - idx) % stride). Returns K6's arguments: q, k_c,
    v_c, ids, q_pos, counter_init, k, v, pos, score, score_sq, counter
    (+ k_scale, v_scale)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cpu = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    n_valid = ENC_IDX + C if scattered else ENC_RIDX
    pos = torch.full((B, Hkv, S), -1, dtype=torch.int32)
    pos[..., :n_valid] = torch.randperm(4000, generator=cpu)[:n_valid].sort().values.to(
        torch.int32)
    if scattered:
        ids = torch.stack([torch.randperm(n_valid, generator=cpu)[:C].sort().values
                           for _ in range(B * Hkv)]).reshape(B, Hkv, C).to(torch.int32)
        pos.scatter_(-1, ids.long(), -1)
    else:
        ids = (n_valid + torch.arange(C, dtype=torch.int32)).expand(B, Hkv, C).contiguous()
    q_pos = (4000 + torch.arange(C, dtype=torch.int32)).repeat(B, 1)
    cinit = (-((q_pos - ENC_IDX) % C).float() if negative
             else (torch.rand((B, C), generator=cpu) * 30).floor())
    u = lambda: torch.rand((B, Hkv, S), generator=g, device=dev)  # noqa: E731
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    else:
        k, v, scales = k.to(dtype), v.to(dtype), ()
    return (rnd(B, Hq, C, D).to(dtype), rnd(B, Hkv, C, D).to(dtype),
            rnd(B, Hkv, C, D).to(dtype), ids.to(dev), q_pos.to(dev), cinit.to(dev), k, v,
            pos.to(dev), u(), u() * 0.1, (u() * 50).floor()) + scales


K6_CACHE = ("k", "v", "pos", "score", "score_sq", "counter", "k_scale", "v_scale")


def phase_k6(dev):
    """K6 against its plain version on copies of the same cache: every cache
    array bit-exact (int8 bytes and scales included); out within K5's limit
    (one bf16 ulp of the reference plus 1e-3, or 1e-5 in f32); ssum, ssq,
    last within 1e-5. Returns the max |err| of the triggered-chunk case
    (the phase 5 shape)."""
    cases = [  # name, B, Hq, Hkv, dtype, quant, scattered, scores, negative, window
        ("int8 MHA B=1 triggered chunk (main path)", 1, 32, 32, torch.bfloat16, True, True,
         True, True, None),
        ("int8 MHA B=1 first chunk", 1, 32, 32, torch.bfloat16, True, False, True, False,
         None),
        ("int8 MHA B=1 no scores", 1, 32, 32, torch.bfloat16, True, True, False, True, None),
        ("bf16 MHA B=1 triggered chunk", 1, 32, 32, torch.bfloat16, False, True, True, True,
         None),
        ("bf16 MHA B=1 first chunk no scores", 1, 32, 32, torch.bfloat16, False, False, False,
         False, None),
        ("int8 GQA rep 4 B=2", 2, 32, 8, torch.bfloat16, True, True, True, True, None),
        ("int8 window 512", 1, 32, 32, torch.bfloat16, True, True, True, True, 512),
        ("f32 int8", 1, 32, 32, torch.float32, True, True, True, True, None),
        ("f32 window 512", 1, 32, 32, torch.float32, False, True, True, False, 512),
    ]
    main_err = None
    for i, (name, B, Hq, Hkv, dtype, quant, scattered, scores, negative, window) in \
            enumerate(cases):
        args = k6_case(B, Hq, Hkv, dtype, quant, scattered, negative, dev, 110 + i)
        ka, kb = [a.clone() for a in args], [a.clone() for a in args]
        got = k6(*ka, need_scores=scores, sliding_window=window)
        ref = k6_plain(*kb, need_scores=scores, sliding_window=window)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(ka[6:], kb[6:]))
        neg = bool((ka[11].gather(-1, args[3].long()) < 0).any())
        e_out = (got[0].float() - ref[0].float()).abs().max().item()
        ratio = ((got[0].float() - ref[0].float()).abs() / k1_out_limit(ref[0])).max().item()
        e_st = [(a - b).abs().max().item() for a, b in zip(got[1:], ref[1:])] if scores else []
        line = (f"phase 2: K6 {name}: cache arrays ({', '.join(K6_CACHE[:len(args) - 6])}) "
                f"bit-exact {same}; max|err| out {e_out:.3e} (at most {ratio:.2f} of its limit)")
        if scores:
            line += " ssum {:.3e} ssq {:.3e} last {:.3e}".format(*e_st)
        if negative:
            line += f"; negative counters written: {neg}"
        print(line)
        check(same and ratio <= 1 and all(x <= 1e-5 for x in e_st) and neg == negative
              and all(torch.isfinite(x).all() for x in got if x is not None),
              f"K6 {name} disagrees")
        if i == 0:
            main_err = max([e_out] + e_st)
    return main_err


def enc_step_statics(policy, mode="encoding"):
    """The encode spec's statics of the `encoding` (or `ppl`) run at budget
    0.5 (the engine's EngineStatics.encode_spec): feasible_k, sink,
    recent_window."""
    b = int(ENC_PROMPT * 0.5) + STRIDE
    align = gen_mod.stride_align_encdec if mode == "ppl" else gen_mod.stride_align
    idx, r_idx = align(ENC_PROMPT, b, STRIDE)
    spec = gen_mod.EngineStatics(cfg=LLAMA2_7B, policy=policy, mode=mode,
                                 length=ENC_PROMPT, budget=b, idx=idx, r_idx=r_idx,
                                 stride=STRIDE, recent_window=int(b * 0.1),
                                 recent_window_dec=int(b * 0.3)).encode_spec()
    return dict(feasible_k=spec.feasible_k, sink=spec.sink_length,
                recent_window=spec.recent_window)


def k7_case(B, Hq, Hkv, kv, gates, dev, seed, dtype=torch.bfloat16, S=ENC_S):
    """K7's arguments at a triggered chunk of the `encoding` run (k6_case's
    scattered slots as a write mask: holes among 2176 valid slots of a
    partly filled cache, the engine's negative initial counters), with
    gates (update, evict) per row, next_pos after the chunk and the next
    contiguous window at 2176: q, k_c, v_c, write_mask, q_pos,
    counter_init, update_gate, evict_gate, next_pos, next_start, k, v, pos,
    score, score_sq, counter (+ k_scale, v_scale). S=ENCDEC_S is the `ppl`
    run's triggered chunk: the holes among a full cache of 2176 slots (its
    next window lies past S, so only an evicting row is meaningful there)."""
    a = k6_case(B, Hq, Hkv, dtype, kv == "int8", True, True, dev, seed, S=S)
    q, k_c, v_c, ids, q_pos, cinit = a[:6]
    wm = torch.zeros((B, Hkv, S), dtype=torch.int32, device=dev).scatter_(-1, ids.long(), 1)
    return (q, k_c, v_c, wm, q_pos, cinit, torch.tensor([g[0] for g in gates], device=dev),
            torch.tensor([g[1] for g in gates], device=dev), (q_pos[:, -1] + 1).contiguous(),
            torch.full((B,), ENC_IDX + STRIDE, dtype=torch.int32, device=dev)) + a[6:]


def k7_via_k6(args, policy, window, statics):
    """K6 on the card, then the plain score update and selection on K6's
    own statistics (chunk_step_evict_plain): (out, cache arrays, next
    mask), on copies of args."""
    b = [a.clone() for a in args]
    q, k_c, v_c, wm, q_pos, cinit, ug, eg, npos, nstart = b[:10]
    S = wm.shape[-1]
    iota = torch.arange(S, dtype=torch.int32, device=wm.device)
    ids = torch.where(wm != 0, iota, S + iota).sort(dim=-1).values[..., :q.shape[2]]
    out, ssum, ssq, _ = k6(q, k_c, v_c, ids.contiguous(), q_pos, cinit, *b[10:],
                           sliding_window=window)
    cache = KVCache(*b[10:16], *(b[16:] or (None, None)))
    nxt = chunk_step_evict_plain(cache, ssum, ssq, ug, eg, npos, nstart, policy=policy,
                                 C=q.shape[2], **statics)
    return out, tuple(b[10:]), nxt


def phase_k7(dev):
    """K7 against its plain version at the strided encode's shapes (S=2304,
    C=96, D=128; bf16 and int8 caches, roco and h2o_head, gates (on, on),
    (on, off) and (off, on); Mistral-7B widths, GQA rep 4, B=2 with mixed
    row gates and a 512-slot window; the `ppl` runs' shape, S=2176, bf16
    roco with the gates on). Bar (a), against
    fused_chunk_step_plain: out within K6's output limit, score and score_sq
    within K6's statistics limit (1e-5), the written rows (K, V, scales)
    exact; the agreement share of pos, counter and the next mask is printed
    (the plain statistics differ in their last bits, which may move a
    near-tie). Bar (b), against K6 on the card followed by the plain update
    and selection on K6's own statistics: out, every cache array and the
    next mask bit-identical. Returns the max |err| of bar (a) in the
    (on, on) roco case of each cache dtype (the phase 5 shape)."""
    cases = [(f"{kv} {policy} MHA B=1 gates ({u}, {e})", 1, 32, 32, kv, policy, [(u, e)], None,
              "encoding") for kv in ("int8", "bf16") for policy in ("roco", "h2o_head")
             for u, e in ((True, True), (True, False), (False, True))]
    cases += [(f"{kv} {policy} Mistral-7B widths GQA rep 4 B=2 mixed gates window 512", 2, 32,
               8, kv, policy, [(True, False), (False, True)], 512, "encoding")
              for kv, policy in (("int8", "roco"), ("bf16", "h2o_head"))]
    cases += [(f"bf16 roco MHA B=1 gates (True, True) at the ppl shape S={ENCDEC_S}", 1, 32, 32,
               "bf16", "roco", [(True, True)], None, "ppl")]
    errs = {}
    for i, (name, B, Hq, Hkv, kv, policy, gates, window, mode) in enumerate(cases):
        st = enc_step_statics(policy, mode)
        args = k7_case(B, Hq, Hkv, kv, gates, dev, 300 + i,
                       S=ENCDEC_S if mode == "ppl" else ENC_S)
        ka, kb = [a.clone() for a in args], [a.clone() for a in args]
        got = k7(*ka, policy=policy, sliding_window=window, **st)
        ref = k7_plain(*kb, policy=policy, sliding_window=window, **st)
        bar = k7_via_k6(args, policy, window, st)
        torch.cuda.synchronize()
        e_out = (got[0].float() - ref[0].float()).abs().max().item()
        ratio = ((got[0].float() - ref[0].float()).abs() / k1_out_limit(ref[0])).max().item()
        e_sc = [(got[1][j] - ref[1][j]).abs().max().item() for j in (3, 4)]
        rows = [j for j, n in enumerate(K6_CACHE[:len(got[1])]) if n in
                ("k", "v", "k_scale", "v_scale")]
        written = all(torch.equal(got[1][j], ref[1][j]) for j in rows)
        share = [(got[1][2] == ref[1][2]).float().mean().item(),
                 (got[1][5] == ref[1][5]).float().mean().item(),
                 (got[2] == ref[2]).float().mean().item()]
        exact = (torch.equal(got[0], bar[0]) and torch.equal(got[2], bar[2])
                 and all(torch.equal(a, b) for a, b in zip(got[1], bar[1])))
        eg = args[7][:, None, None]
        victims = got[2].bool() & eg
        evicted = bool((got[1][2][victims] == -1).all()) and int(victims.sum()) == int(
            eg.sum()) * Hkv * STRIDE and bool((got[2].sum(-1) == STRIDE).all())
        neg = bool((got[1][5][~eg.expand_as(got[2]) & args[3].bool()] < 0).any())
        print(f"phase 2: K7 {name}: (a) max|err| out {e_out:.3e} (at most {ratio:.2f} of its "
              f"limit) score {e_sc[0]:.3e} score_sq {e_sc[1]:.3e}, written rows exact {written}, "
              f"agreement pos {share[0]:.6f} counter {share[1]:.6f} next mask {share[2]:.6f}; "
              f"(b) bit-identical to K6 + the plain selection {exact}; {STRIDE} victims a "
              f"gated (row, head) {evicted}; negative counters kept where the gate is off "
              f"{neg if not bool(eg.all()) else 'n/a'}")
        check(ratio <= 1 and max(e_sc) <= 1e-5 and written and exact and evicted
              and (neg or bool(eg.all())) and bool(torch.isfinite(got[0].float()).all()),
              f"K7 {name} disagrees")
        if policy == "roco" and gates == [(True, True)] and mode == "encoding":
            errs[("K7", kv)] = max([e_out] + e_sc)
    return errs


KERNELS = {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K5": k5, "K6": k6, "K7": k7, "K8": k8, "K9": k9,
           "K10": k10, "K11": k11, "K12": k12, "K13": k13, "K14": k14, "K15": k15,
           "decode_attend": kda, "K1s": k1s, "K2s": k2s, "K4s": k4s, "K5s": k5s, "K6s": k6s,
           "K7s": k7s, "K9s": k9s}
# launches of a kernel's variant, counted by its wrapper beside the total
VARIANTS = {"K1 ordered": (k1, "ordered_launches"), "K1 rank": (k1, "rank_launches"),
            "K2 compact": (k2, "compact_launches"), "K2 rows": (k2, "rows_launches")}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    for fn, attr in VARIANTS.values():
        setattr(fn, attr, 0)


def counts():
    c = {key: fn.launches for key, fn in KERNELS.items()}
    c.update({key: getattr(fn, attr) for key, (fn, attr) in VARIANTS.items()})
    return c


def zero_counts(**want):
    """Expected launch counts: the ones given, every other kernel 0."""
    return {**{key: 0 for key in list(KERNELS) + list(VARIANTS)}, **want}


def graph_note(name, st):
    """The decode's CUDA graph on a phase-3 line, checked: every phase-3
    decode replays one."""
    check(st.graph_nodes > 0, f"{name}: the decode did not replay a CUDA graph")
    return f"graph captured in {st.capture_s:.3f} s, {st.graph_nodes} nodes"


def kv_cache_mb(cfg, B, S, quant):
    """Bytes of the K/V buffers (and int8 scales) of one run's cache, MB."""
    rows = cfg.num_hidden_layers * B * cfg.num_key_value_heads * S
    return rows * (2 * cfg.head_dim * (1 if quant else 2) + (8 if quant else 0)) / 1e6


def phase_end_to_end(dev):
    cfg = LLAMA2_7B
    L = cfg.num_hidden_layers
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    print(f"phase 3: LLaMa-2-7B width, {n_par / 1e9:.3f}B bf16 parameters drawn on the "
          f"card in {time.perf_counter() - t0:.1f} s")
    models = {kv: easykv_tpu_torch.enable_fixed_kv(
        easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8"), None,
        "decoding") for kv in ("bf16", "int8")}
    g = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab_size, (B_WIDE, PROMPT), generator=g)
    gc = dict(budget=BUDGET, kv_policy="roco", max_new_tokens=NEW, temperature=1e-9,
              top_p=1.0, eos_token_ids=[], seed=0)
    for model in models.values():
        model.easykv_generate(prompts[0].tolist(), dict(gc, max_new_tokens=8))  # warm-up
    runs, finals = {}, {}
    for kv, policy, B in (("bf16", "roco", 1), ("bf16", "full", 1), ("int8", "roco", 1),
                          ("int8", "full", 1), ("int8", "roco", B_WIDE)):
        name = f"{kv} {policy}" + (f" B={B}" if B > 1 else "")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with engine_caches() as made:
            out = models[kv].easykv_generate(
                prompts[0].tolist() if B == 1 else prompts[:B].numpy(), dict(gc, kv_policy=policy))
        c = counts()
        st = models[kv].last_run
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        tok_s = B * st.n_tokens / st.decode_s
        S = gen_mod._round_up(PROMPT + (BUDGET + 1 if policy == "roco" else NEW), 128)
        print(f"phase 3: {name}: prefill {st.prefill_s:.3f} s, decode {B}x{st.n_tokens} "
              f"tokens in {st.decode_s:.3f} s = {tok_s:.2f} tok/s ({graph_note(name, st)}), "
              f"kv_len {st.kv_len}, KV cache {kv_cache_mb(cfg, B, S, kv == 'int8'):.1f} MB "
              f"(S={S}), peak memory {peak:.2f} GiB, launches {c}")
        check(len(out) == NEW and st.logits_finite, f"{name}: bad output / NaN logits")
        n_k5 = L * PROMPT // CHUNK if kv == "int8" else 0
        check(c["K1"] == L * NEW and c["K2"] == c["K2 rows"] == NEW and c["K3"] == 0
              and c["K5"] == n_k5, f"{name}: launch counts {c}")
        if policy == "roco":
            check(st.kv_len - PROMPT == BUDGET,
                  f"{name} kept {st.kv_len - PROMPT} generated tokens, not {BUDGET}")
        runs[name] = dict(counts=c, tok_s=tok_s, prefill_s=st.prefill_s, peak_gib=peak,
                          tokens=out)
        if policy == "roco" and B == 1:
            finals[kv] = (out, made[-1])
        del made
    for kv, (out, cache) in finals.items():
        eager_twin(models[kv], f"{kv} roco", prompts[0].tolist(), dict(gc, kv_policy="roco"),
                   out, cache, runs[f"{kv} roco"])
    del models, finals
    runs.update(phase_streaming(dev, cfg, params))
    runs.update(phase_encoding(dev, cfg, params))
    runs.update(phase_quant(dev, cfg, params))
    runs.update(phase_serving(dev, cfg, params))
    del params
    torch.cuda.empty_cache()
    return runs


def eager_twin(model, name, prompt, gc, out, cache, run):
    """The phase-3 run `name` again with the decode loop eager
    (flags.eager_decode_loop: every kernel launched from the host, as before
    the decode replayed a CUDA graph): decode tok/s side by side with the
    graph's, equal tokens, final pos / k / v (and scales) bit-identical,
    equal launch counts."""
    torch.cuda.synchronize()
    reset_counts()
    with flags.eager_decode_loop(), engine_caches() as made:
        twin = model.easykv_generate(prompt, gc)
    c = counts()
    st = model.last_run
    tok_s = st.n_tokens / st.decode_s
    arrays = [n for n in ("pos", "k", "v", "k_scale", "v_scale") if getattr(cache, n) is not None]
    same = all(same_bits(getattr(cache, n), getattr(made[-1], n)) for n in arrays)
    print(f"phase 3: {name} eager twin: decode {st.n_tokens} tokens in {st.decode_s:.3f} s = "
          f"{tok_s:.2f} tok/s eager against {run['tok_s']:.2f} tok/s replayed; tokens equal "
          f"{twin == out}, final {' / '.join(arrays)} bit-identical {same}, launches equal "
          f"{c == run['counts']}")
    check(st.graph_nodes == 0, f"{name} eager twin: the decode replayed a graph")
    check(twin == out and same and c == run["counts"],
          f"{name}: the eager twin differs from the replayed graph")
    run["eager_tok_s"] = tok_s


def ordered_invariant(pos):
    """In every (layer, batch, head): the valid slots are contiguous from 0
    and their positions strictly increase."""
    valid = pos >= 0
    n = valid.sum(-1)
    contiguous = torch.equal(valid, torch.arange(pos.shape[-1], device=pos.device) < n[..., None])
    both = valid[..., 1:] & valid[..., :-1]
    increasing = bool((pos[..., 1:] > pos[..., :-1])[both].all())
    return contiguous and increasing, (int(n.min()), int(n.max()))


def phase_streaming(dev, cfg, params):
    """StreamingLLM `decoding` (streaming=True) at 7B width: the 512-token
    prompt, 384 new tokens, greedy; roco at budget 200 with a bf16 and an
    int8 KV cache over the pre-rotated cache (K2 compact + K9 every step),
    int8 over the rotate-at-read cache (K1 ordered, then K4 and K8 every
    step), and bf16 `full` (pre-rotated, never compacts). Checks the exact
    launch counts, the retained tokens, the printed budget ratio and the
    ordered invariant of the final cache."""
    L = cfg.num_hidden_layers
    models = {kv: easykv_tpu_torch.enable_fixed_kv(
        easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8"), None,
        "decoding") for kv in ("bf16", "int8")}
    prompt = torch.randint(1, cfg.vocab_size, (PROMPT,),
                           generator=torch.Generator().manual_seed(0)).tolist()
    gc = dict(budget=BUDGET, max_new_tokens=NEW, temperature=1e-9, top_p=1.0,
              eos_token_ids=[], seed=0, streaming=True)
    plan = [("bf16 stream roco prerot", "bf16", "roco", True),
            ("int8 stream roco prerot", "int8", "roco", True),
            ("int8 stream roco rotate-at-read", "int8", "roco", False),
            ("bf16 stream full prerot", "bf16", "full", True)]
    runs = {}
    for name, kv, policy, prerot in plan:
        flags.use_prerot(prerot)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        printed = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(printed), engine_caches() as made:
            out = models[kv].easykv_generate(prompt, dict(gc, kv_policy=policy))
        c = counts()
        flags.use_prerot(None)
        st = models[kv].last_run
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        ordered, held = ordered_invariant(made[-1].pos)
        del made
        tok_s = st.n_tokens / st.decode_s
        line = printed.getvalue().strip().splitlines()[-1]
        print(f"phase 3: {name}: prefill {st.prefill_s:.3f} s, decode {st.n_tokens} tokens in "
              f"{st.decode_s:.3f} s = {tok_s:.2f} tok/s ({graph_note(name, st)}), kv_len "
              f"{st.kv_len}, valid slots per (layer, head) {held}, ordered invariant {ordered}, "
              f"peak memory {peak:.2f} GiB, launches {c}; printed: {line}")
        check(len(out) == NEW and st.logits_finite, f"{name}: bad output / NaN logits")
        want = {"K1": L * NEW, "K2": NEW, "K2 rows": NEW,
                "K5": L * PROMPT // CHUNK if kv == "int8" else 0}
        if policy == "roco" and prerot:
            want.update({"K9": NEW, "K2 compact": NEW})
        elif policy == "roco":
            want.update({"K1 ordered": L * NEW, "K4": NEW, "K8": NEW})
        want = zero_counts(**want)
        check(c == want, f"{name}: launch counts {c}, expected {want}")
        kept = BUDGET if policy == "roco" else NEW
        ratio = f"KV cache budget ratio: {kept / NEW * 100:.2f}%({kept}/{NEW})"
        check(st.kv_len - PROMPT == kept and held == (PROMPT + kept, PROMPT + kept),
              f"{name}: kept {st.kv_len - PROMPT} generated tokens, slots {held}, not {kept}")
        check(line == ratio, f"{name}: printed {line!r}, expected {ratio!r}")
        check(ordered, f"{name}: the final cache is not age-ordered")
        runs[name] = dict(counts=c, tok_s=tok_s, prefill_s=st.prefill_s, peak_gib=peak)
    return runs


@contextlib.contextmanager
def recorded(name, last_only=False):
    """Records the results of the engine's function `name` (every one, or
    the last), so that a run through generate() can be read back after it."""
    made, fn = [], getattr(gen_mod, name)

    def record(*args):
        if last_only:
            made.clear()
        made.append(fn(*args))
        return made[-1]
    with mock.patch.object(gen_mod, name, record):
        yield made


def engine_caches():
    """Every KV cache the engine allocates."""
    return recorded("_engine_cache")


def phase_encoding(dev, cfg, params):
    """The encoding family at 7B width on a 4096-token prompt, stride 96,
    128 new tokens, greedy, through generate() and enable_fixed_kv's
    easykv_ppl: int8 and bf16 `encoding` (budget 0.5), int8
    `encoding_decoding` (budget 2048) and int8 `ppl` (budget 0.5), then the
    same runs with streaming=True (StreamingLLM: the chunk-major encode over
    the unordered cache, K rotated by its age rank, the decode through K1's
    rank variant with carried ranks), then a streaming int8 `encoding` at
    stride 1 on the prompt's first 512 tokens (32 new tokens), whose every
    encode chunk is a decode step through K1's rank variant. Checks the
    exact launch counts, the slot counts, the printed budget ratios and,
    after each streaming decode, that the carried ranks equal _age_ranks of
    the final cache. The slots left by the encode are counted in the final
    cache: `encoding` then adds one per decode step, encoding_decoding
    writes one and evicts one, ppl does not decode. Prints the streaming
    runs' phase times beside the non-streaming ones'."""
    L = cfg.num_hidden_layers
    n_prefix = L * ((ENC_RIDX + CHUNK - 1) // CHUNK)      # K5: 16 chunks of 128 per layer
    n_enc = L * ((ENC_PROMPT - ENC_RIDX) // STRIDE)        # K6: 22 chunks per layer
    n_encdec = L * ((ENC_PROMPT - ENCDEC_RIDX) // STRIDE)  # K6: 42 chunks per layer
    prompt = torch.randint(1, cfg.vocab_size, (ENC_PROMPT,),
                           generator=torch.Generator().manual_seed(0)).tolist()
    gc = dict(kv_policy="roco", max_new_tokens=ENC_NEW, temperature=1e-9, top_p=1.0,
              eos_token_ids=[], seed=0)
    models = {kv: easykv_tpu_torch.enable_fixed_kv(
        easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8"), None,
        "encoding", stride=STRIDE) for kv in ("bf16", "int8")}
    for model in models.values():                                       # warm-up
        for streaming in (False, True):
            model.easykv_generate(prompt[:1024], dict(gc, budget=0.5, max_new_tokens=4,
                                                      streaming=streaming))
    ratio_enc = f"KV cache budget ratio: {ENC_IDX / ENC_PROMPT * 100:.2f}%({ENC_IDX}/{ENC_PROMPT})"
    ratio_encdec = (f"KV Cache Budget ratio {ENC_IDX / (ENC_PROMPT + ENC_NEW) * 100:.2f}%"
                    f"[{ENC_IDX}/({ENC_PROMPT}+{ENC_NEW})]")
    plan = [  # name, kv, mode, budget, K5, K6, decode steps, slots after the run, ratio line
        ("int8 encoding roco", "int8", "encoding", 0.5, n_prefix, n_enc, ENC_NEW,
         ENC_IDX + ENC_NEW, ratio_enc),
        ("bf16 encoding roco", "bf16", "encoding", 0.5, 0, 0, ENC_NEW, ENC_IDX + ENC_NEW,
         ratio_enc),
        ("int8 encoding_decoding roco", "int8", "encoding_decoding", 2048, L, n_encdec,
         ENC_NEW, ENC_IDX, ratio_encdec),
        ("int8 ppl roco", "int8", "ppl", 0.5, L, n_encdec, 0, ENC_IDX, ratio_enc),
    ]
    plan += [(name.replace(" ", " stream ", 1), kv, mode, budget, n5, 0, n_dec, slots, ratio)
             for name, kv, mode, budget, n5, _, n_dec, slots, ratio in plan]
    runs = {}
    for name, kv, mode, budget, n5, n6, n_dec, slots, ratio in plan:
        streaming = " stream " in name
        runs[name] = encoding_run(
            models[kv], name, prompt, dict(gc, budget=budget, streaming=streaming), mode,
            STRIDE, zero_counts(K1=L * n_dec, K2=n_dec, K5=n5, K6=n6,
                                **{"K1 rank": L * n_dec if streaming else 0,
                                   "K2 rows": n_dec}),
            slots, ratio, ENC_S if mode == "encoding" else ENCDEC_S, cfg,
            keep=name == "int8 encoding roco")
    runs.update(step_runs(models, prompt, gc, runs, cfg, n_prefix, n_enc, n_encdec,
                          ratio_enc))
    for name, r in runs.items():
        if " stream " in name:
            base = runs[name.replace(" stream ", " ")]
            print(f"phase 3: {name} against {base['name']}: prefix prefill {r['prefill_s']:.3f} / "
                  f"{base['prefill_s']:.3f} s, strided encode {r['encode_s']:.3f} / "
                  f"{base['encode_s']:.3f} s"
                  + ("" if r["tok_s"] is None else
                     f", decode {r['tok_s']:.2f} / {base['tok_s']:.2f} tok/s"))
    # stride 1: every encode chunk is a decode step (_decode_forward, K1 rank)
    n1, new1 = 512, 32
    idx1, ridx1 = gen_mod.stride_align(n1, int(n1 * 0.5) + 1, 1)
    steps = (n1 - ridx1) + new1
    model = easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=True)
    name = "int8 stream encoding roco stride 1"
    runs[name] = encoding_run(
        model, name, prompt[:n1], dict(gc, budget=0.5, max_new_tokens=new1, streaming=True),
        "encoding", 1, zero_counts(K1=L * steps, K2=steps,
                                   K5=L * ((ridx1 + CHUNK - 1) // CHUNK),
                                   **{"K1 rank": L * steps, "K2 rows": steps}),
        idx1 + new1, f"KV cache budget ratio: {idx1 / n1 * 100:.2f}%({idx1}/{n1})",
        gen_mod._round_up(idx1 + 1 + new1, 128), cfg, n_new=new1)
    for kv in ("bf16", "int8"):
        runs[f"{kv} forward bootstrap"] = forward_bootstrap(dev, cfg, params, kv, prompt)
    return runs


def step_runs(models, prompt, gc, runs, cfg, n_prefix, n_enc, n_encdec, ratio_enc):
    """The one-call chunk step K7 (flags.use_step_kernel) at 7B width against
    its twin without it: int8 `encoding` roco (the twin is phase 3's int8
    `encoding` run, whose result and final cache `runs` keeps), int8 `ppl`
    h2o_head, and bf16 `ppl` roco with the chunk kernels on
    (flags.use_chunk_kernel). Checks each run's exact launch counts (K7
    once a chunk-layer and no K6, or the reverse), that the encode never
    calls the plain selection with K7, and that each pair gives equal
    tokens or ppl and bit-identical final cache arrays; prints the strided
    encode seconds side by side. Returns the new runs' figures."""
    L = cfg.num_hidden_layers
    new = {}
    step_plan = [
        ("int8 encoding roco step", "int8", "encoding", "roco", None, True, "int8 encoding roco"),
        ("int8 ppl h2o_head", "int8", "ppl", "h2o_head", None, False, None),
        ("int8 ppl h2o_head step", "int8", "ppl", "h2o_head", None, True, "int8 ppl h2o_head"),
        ("bf16 ppl roco chunk kernels", "bf16", "ppl", "roco", True, False, None),
        ("bf16 ppl roco step", "bf16", "ppl", "roco", True, True, "bf16 ppl roco chunk kernels"),
    ]
    for name, kv, mode, policy, chunk, step, twin in step_plan:
        enc = mode == "encoding"
        n_chunks, n_dec = (n_enc, ENC_NEW) if enc else (n_encdec, 0)
        flags.use_chunk_kernel(chunk)
        flags.use_step_kernel(step)
        try:
            new[name] = encoding_run(
                models[kv], name, prompt, dict(gc, budget=0.5, kv_policy=policy), mode, STRIDE,
                zero_counts(K1=L * n_dec, K2=n_dec, K5=n_prefix if enc else L,
                            **{"K7" if step else "K6": n_chunks, "K2 rows": n_dec}),
                ENC_IDX + n_dec, ratio_enc, ENC_S if enc else ENCDEC_S, cfg, keep=True)
        finally:
            flags.use_chunk_kernel(None)
            flags.use_step_kernel(None)
        if step:
            check(new[name]["selections"] == 0, f"{name}: the plain selection ran "
                  f"{new[name]['selections']} times")
        if twin is None:
            continue
        a, b = new[name], new.get(twin) or runs[twin]
        same_out = a.pop("out") == b.pop("out")
        ca, cb = a.pop("cache"), b.pop("cache")
        same = [n for n in K6_CACHE if getattr(ca, n) is not None
                and torch.equal(getattr(ca, n), getattr(cb, n))]
        want_same = [n for n in K6_CACHE if getattr(ca, n) is not None]
        del ca, cb
        torch.cuda.empty_cache()
        print(f"phase 3: {name} against {twin}: {'ppl' if mode == 'ppl' else 'tokens'} equal "
              f"{same_out}, bit-identical final arrays {same} of {want_same}, strided encode "
              f"{a['encode_s']:.3f} / {b['encode_s']:.3f} s, plain selections "
              f"{a['selections']} / {b['selections']}")
        check(same_out and same == want_same, f"{name} and {twin} disagree")
    for r in list(runs.values()) + list(new.values()):
        r.pop("out", None)
        r.pop("cache", None)
    return new


def encoding_run(model, name, prompt, gc, mode, stride, want, slots, ratio, S, cfg,
                 n_new=ENC_NEW, keep=False):
    """One run of the encoding family through generate() (ppl through
    enable_fixed_kv's easykv_ppl), checked: launch counts `want`, `slots`
    valid slots in every (layer, head) of the final cache, the printed
    ratio line, and with streaming the decode's carried ranks equal to
    _age_ranks of the final cache. Returns its figures (with keep, also its
    result and final cache), among them the calls of the plain selection
    (policies.select_evictions)."""
    dev = model.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    printed = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(printed), engine_caches() as made, \
            recorded("_carry_ranks", last_only=True) as ranks, \
            mock.patch.object(policies_mod, "select_evictions",
                              wraps=policies_mod.select_evictions) as selections:
        if mode == "ppl":
            out = easykv_tpu_torch.generate(model, prompt, gc, kv_mode="ppl", stride=stride)
        else:
            out = easykv_tpu_torch.generate(model, prompt, gc, kv_mode=mode, stride=stride)
    c = counts()
    st = model.last_run
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    pos = made[-1].pos
    valid = (pos >= 0).sum(dim=-1)
    held = (int(valid.min()), int(valid.max()))
    line = printed.getvalue().strip().splitlines()[-1]
    desc = (f"phase 3: {name}: prefix prefill {st.prefill_s:.3f} s, strided encode "
            f"{st.encode_s:.3f} s")
    if mode == "ppl":
        desc += f", ppl {out:.4f}"
        tok_s = None
        check(math.isfinite(out) and st.logits_finite, f"{name}: ppl {out}")
    else:
        tok_s = st.n_tokens / st.decode_s
        desc += (f", decode {st.n_tokens} tokens in {st.decode_s:.3f} s = {tok_s:.2f} tok/s "
                 f"({graph_note(name, st)})")
        check(len(out) == n_new and st.logits_finite, f"{name}: bad output / NaN logits")
    if gc.get("streaming") and mode != "ppl":
        same = bool(ranks) and torch.equal(ranks[-1], age_ranks_all(pos))
        desc += f", carried ranks equal _age_ranks of the final cache {same}"
        check(same, f"{name}: the carried ranks are not the final cache's age ranks")
    final = made[-1] if keep else None
    del made, ranks, pos
    print(f"{desc}, valid slots per (layer, head) after the run {held}, "
          f"KV cache {kv_cache_mb(cfg, 1, S, model.kv_quant):.1f} MB (S={S}), peak memory "
          f"{peak:.2f} GiB, launches {c}, plain selections {selections.call_count}; "
          f"printed: {line}")
    check(c == want, f"{name}: launch counts {c}, expected {want}")
    check(held == (slots, slots), f"{name}: slots {held}, expected {slots}")
    check(line == ratio, f"{name}: printed {line!r}, expected {ratio!r}")
    if mode == "encoding_decoding":
        check(st.kv_len == ENC_IDX, f"{name}: kv_len {st.kv_len} after decode")
    res = dict(name=name, counts=c, tok_s=tok_s, prefill_s=st.prefill_s,
               encode_s=st.encode_s, peak_gib=peak, selections=selections.call_count)
    if keep:
        res.update(out=out, cache=final)
    return res


def forward_bootstrap(dev, cfg, params, kv, prompt):
    """llama.forward at C == 1 with bootstrap=True, the branch that
    reaches fused_decode_attend (the keep_attention prefix accumulation
    token by token, which no engine path takes today; serving's prefill
    will): the prompt's first 512 tokens prefilled with the bootstrap, then
    one token, at 7B width with a `kv` cache. Counts the launches (32
    fused_decode_attend, nothing else), holds every layer's
    fused_decode_attend to its plain version on that layer's own inputs
    (K1's limits), and the kernel path's cache to the plain path's: pos and
    counters exact in every layer, layer 0's scores within 1e-5 (both paths
    give it the same inputs; later layers' inputs part by the bf16
    rounding of the attention outputs before them, printed)."""
    L = cfg.num_hidden_layers
    st = gen_mod.EngineStatics(cfg=cfg, policy="roco", mode="encoding", length=PROMPT,
                               budget=PROMPT, idx=PROMPT + 1, r_idx=PROMPT, stride=1,
                               kv_quant=kv == "int8", keep_attention=True)
    spec = st.encode_spec()
    cache = gen_mod._engine_cache(st, 1, PROMPT + 1, params.embed.dtype, dev)
    ids = torch.tensor([prompt[:PROMPT]], dtype=torch.int32, device=dev)
    gen_mod._prefill(st, params, cache, ids, torch.full((1,), PROMPT, dtype=torch.int32,
                                                        device=dev), spec, "encode")
    twin = dataclasses.replace(cache, **{f.name: getattr(cache, f.name).clone()
                                         for f in dataclasses.fields(cache)
                                         if getattr(cache, f.name) is not None})
    one = lambda x, dt: torch.tensor([x], dtype=dt, device=dev)  # noqa: E731
    ctx = StepCtx(q_pos=one([PROMPT], torch.int32), token_valid=one([True], torch.bool),
                  counter_init=one([0.0], torch.float32), next_pos=one(PROMPT + 1, torch.int32),
                  prompt_len=one(PROMPT, torch.int32), evict_gate=one(False, torch.bool),
                  update_gate=one(True, torch.bool), rand_rank=one(0, torch.int32))
    tok = one([prompt[PROMPT]], torch.int32)
    seen = []

    def spy(*a, **kw):
        seen.append((a, kw, kda(*a, **kw)))
        return seen[-1][2]
    torch.cuda.synchronize()
    reset_counts()
    with mock.patch.object(llama_mod, "fused_decode_attend", spy):
        logits = llama_mod.forward(params, cfg, cache, tok, ctx, spec, bootstrap=True)
    torch.cuda.synchronize()
    c = counts()
    with mock.patch.object(llama_mod, "fused_decode_attend", kda_plain):
        ref = llama_mod.forward(params, cfg, twin, tok, ctx, spec, bootstrap=True)
    worst = 0.0
    for a, kw, got in seen:
        want = kda_plain(*a, **kw)
        ratio = ((got[0].float() - want[0].float()).abs() / k1_out_limit(want[0])).max().item()
        e_probs = (got[1] - want[1]).abs().max().item()
        worst = max(worst, ratio)
        check(ratio <= 1 and e_probs <= 1e-5,
              f"forward bootstrap {kv}: a layer's fused_decode_attend disagrees "
              f"({ratio:.3f} of the out limit, probs {e_probs:.3e})")
    same_pos = torch.equal(cache.pos, twin.pos) and torch.equal(cache.counter, twin.counter)
    e_score = (cache.score[0] - twin.score[0]).abs().max().item()
    e_logit = ((logits - ref).abs().max() / ref.abs().max()).item()
    print(f"phase 3: forward C=1 bootstrap, {kv} KV, 7B width: launches {c}; every layer's "
          f"fused_decode_attend within {worst:.2f} of its limit of the plain version on its own "
          f"inputs; pos and counters equal to the plain path {same_pos}; layer 0 scores "
          f"max|err| {e_score:.3e}; logits max|diff| {e_logit:.3e} of max|logit|")
    check(c == zero_counts(decode_attend=L) and len(seen) == L,
          f"forward bootstrap {kv}: launches {c}")
    check(same_pos and e_score <= 1e-5, f"forward bootstrap {kv}: the cache disagrees")
    check(bool(torch.isfinite(logits).all()), f"forward bootstrap {kv}: NaN logits")
    return dict(counts=c)


@contextlib.contextmanager
def plain_kernels():
    """The model with each kernel's wrapper swapped for its plain version
    (K4 where policies.evict_cache imports it, K8 in the engine, K10-K13
    where ops.quant.mm calls them, K14 and K15 in the decode step; K3's
    plain version inside K2's, which writes the rows)."""
    with mock.patch.multiple(llama_mod, fused_decode_attend_inflight=k1_plain,
                             fused_decode_attend=kda_plain,
                             fused_write_update=k2_plain,
                             fused_chunk_attend=k5_plain, fused_chunk_write_attend=k6_plain,
                             fused_kv_compact=k9_plain, fused_decode_step=k14_plain,
                             fused_decode_step_batch=k15_plain), \
            mock.patch.object(sidecar_mod, "fused_evict", k4_plain), \
            mock.patch.object(gen_mod, "fused_compact", k8_plain), \
            mock.patch.multiple(quant_mod, quant_matmul=k13_plain, w4a16_gemv=k12_plain,
                                w4a16_gemv_arith=k10_plain, w4a16_gemm_arith=k11_plain):
        yield


def phase_plain_vs_kernel(dev):
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=2)
    params = init_params(cfg, seed=1, dtype=torch.float32, device=dev)
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(1, cfg.vocab_size, (1, PROMPT), generator=g,
                        dtype=torch.int32).to(dev)
    plen = torch.full((1,), PROMPT, dtype=torch.int32, device=dev)
    for quant in (False, True):
        st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=PROMPT, budget=8,
                                   max_new_tokens=32, recent_window_dec=int(8 * 0.3),
                                   kv_quant=quant)
        res = {}
        for plain in (False, True):
            gen = torch.Generator(device=dev).manual_seed(0)
            reset_counts()
            with plain_kernels() if plain else contextlib.nullcontext():
                r, cache, _, _ = gen_mod._run_decoding(st, params, ids, plen, 1e-9, 1.0, gen,
                                                       torch.float32)
            res[plain] = (r.out_ids.cpu(), cache.pos.cpu(), counts())
        same_tok = torch.equal(res[False][0], res[True][0])
        same_pos = torch.equal(res[False][1], res[True][1])
        kv = "int8" if quant else "f32"
        print(f"phase 4: full width L=2 f32 weights, {kv} KV, roco b=8, 32 tokens: tokens "
              f"equal {same_tok}, final pos equal {same_pos}; launches kernel path "
              f"{res[False][2]}, plain path {res[True][2]}")
        check(same_tok and same_pos, f"{kv} KV: kernel path and plain path disagree")
        check(res[False][2]["K5"] == (2 * PROMPT // CHUNK if quant else 0)
              and sum(res[True][2].values()) == 0, f"{kv} KV: launch counts")
    phase_plain_vs_kernel_streaming(dev, cfg, params, ids, plen)
    phase_plain_vs_kernel_encoding(dev, cfg, params)
    phase_plain_vs_kernel_quant(dev, cfg, params, ids, plen)
    phase_plain_vs_kernel_serving(dev, cfg, params)


def phase_plain_vs_kernel_streaming(dev, cfg, params, ids, plen):
    """StreamingLLM `decoding`, full width, L=2, f32 weights, 32 new tokens,
    roco at budget 8 (an eviction and a compaction on each of the last 24
    steps): f32 and int8 caches, each with the pre-rotated and the
    rotate-at-read cache, kernel path against plain path. Equal greedy
    tokens and final pos. An int8 cache: layer 0's K/V and scales
    bit-identical (both paths write its rows from the same embeddings, and
    the kernels are bit-exact, phase 2); in later layers, wherever both
    paths hold the same position, V within one int8 step (a row quantized
    from hidden states that differ in their last f32 bits, as the encoding
    family's check allows), and K over the rotate-at-read cache too, which
    stores each row as quantized once. The pre-rotated cache requantizes
    a K row at _prerotate_cache and at every shift (K9), and a one-step
    gap can grow there (tests/test_torch_streaming.py's witness shows it
    with the plain K9 alone), so its K is held to the bound of
    int8_k_gap_limit, row by row, from the number of requantizations the
    row took."""
    for quant in (False, True):
        kv = "int8" if quant else "f32"
        st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=PROMPT, budget=8,
                                   max_new_tokens=32, recent_window_dec=int(8 * 0.3),
                                   kv_quant=quant, streaming=True)
        for prerot in (True, False):
            res = {}
            flags.use_prerot(prerot)
            for plain in (False, True):
                gen = torch.Generator(device=dev).manual_seed(0)
                reset_counts()
                with plain_kernels() if plain else contextlib.nullcontext():
                    r, cache, _, _ = gen_mod._run_decoding(st, params, ids, plen, 1e-9, 1.0,
                                                           gen, torch.float32)
                res[plain] = (r.out_ids.cpu(), cache.pos.cpu(), cache.k.cpu(), cache.v.cpu(),
                              counts(), cache.k_scale.cpu() if quant else None)
            flags.use_prerot(None)
            (ta, pa, ka, va, k_c, ksa), (tb, pb, kb, vb, p_c, ksb) = res[False], res[True]
            same_tok = torch.equal(ta, tb)
            pos_diff = [int((pa[l] != pb[l]).sum()) for l in range(pa.shape[0])]
            held = (pa >= 0) & (pa == pb)
            ok = same_tok and sum(pos_diff) == 0
            mode = "pre-rotated" if prerot else "rotate-at-read"
            what = f"tokens equal {same_tok}, final pos differing per layer {pos_diff}"
            if quant:
                steps = [[int((x[l].float() - y[l].float()).abs()[held[l]].max())
                          for l in range(pa.shape[0])] for x, y in ((ka, kb), (va, vb))]
                # requantizations after a row's first: one at _prerotate_cache
                # for the prompt's rows, then one per shift; a row written at
                # slot min(pos, prompt + budget) moved once per shift
                slot = torch.arange(pa.shape[-1])
                shifts = pa.clamp(max=PROMPT + st.budget) - slot
                requants = (shifts + (pa < PROMPT).int() if prerot else torch.zeros_like(pa))
                gap_ok, gap = int8_k_gap_limit(ka, ksa, kb, ksb, requants, held)
                ok = (ok and steps[0][0] == steps[1][0] == 0 and torch.equal(ksa[0], ksb[0])
                      and max(steps[1]) <= 1 and (prerot or max(steps[0]) <= 1)
                      and bool((shifts[held] >= 0).all()) and gap_ok)
                what += (f", int8 steps apart at the same positions per layer: K {steps[0]}, "
                         f"V {steps[1]}; {gap}")
            print(f"phase 4: full width L=2 f32 weights, {kv} KV, streaming {mode}, roco b=8, "
                  f"32 tokens: {what}; launches kernel path {k_c}, plain path {p_c}")
            check(ok, f"{kv} KV streaming {mode}: kernel path and plain path disagree")
            new = (("K9", "K2 compact") if prerot else ("K1 ordered", "K4", "K8"))
            check(all(k_c[key] > 0 for key in new) and sum(p_c.values()) == 0,
                  f"{kv} KV streaming {mode}: launch counts")


def int8_k_gap_limit(ka, ksa, kb, ksb, requants, held):
    """Two int8 K caches against each other, row by row at the held slots,
    dequantized: a row of path A and of path B first quantized from nearly
    equal values sit within one step of the larger scale s per value (a
    pair (x1, x2) within sqrt(2) s); each later requantization (a rotation,
    which keeps the pair's gap, then rounding) adds at most sqrt(2) s to
    it, and s never exceeded sqrt(2) times the row's final scale, since
    the rotations keep each pair's norm. So a row that took r
    requantizations stays within 2 (1 + r) steps of the larger final
    scale, and its scales within that over 127 (each scale is the row's
    largest value over 127; 1e-6 relative for the f32 arithmetic of the
    scale). Returns (within the limit, a reading)."""
    smax = torch.maximum(ksa, ksb)
    gap = (ka.float() * ksa[..., None] - kb.float() * ksb[..., None]).abs().amax(-1)
    limit = 2 * (1 + requants).float()
    rel = gap / smax                                       # steps of the larger scale
    sc = (ksa - ksb).abs() / smax
    ok = bool((rel <= limit)[held].all()) and bool((sc <= limit / 127 + 1e-6)[held].all())
    worst = torch.where(held, rel / limit, 0).flatten().argmax()
    reading = (f"K dequantized: largest gap {float(rel[held].max()):.3f} steps, worst against "
               f"its limit {float(rel.flatten()[worst]):.3f} of {float(limit.flatten()[worst]):g} "
               f"steps (r = {int(requants.flatten()[worst])}), requantizations per row up to "
               f"{int(requants[held].max())}; k_scale largest relative gap "
               f"{float(sc[held].max()):.3e}")
    return ok, reading


def phase_plain_vs_kernel_encoding(dev, cfg, params):
    """The encoding family on a 1024-token prompt, stride 96, roco, 32 new
    tokens: `encoding` (budget 0.5, with and without keep_attention: the
    prefix prefill then runs K5 with its statistics), `encoding_decoding`
    (budget 512) and `ppl` (budget 0.5), kernel path against plain path.

    A float cache: equal tokens, final pos (every layer) and kv_len; ppl
    within 1e-5 relative (both paths run the same plain encode; measured:
    equal). An int8 cache: layer 0's K/V are written
    bit-identically by both paths (K6's rows are bit-exact, phase 2), so its
    final pos must be equal; a later layer's rows are quantized from hidden
    states that differ in their last f32 bits, so some int8 values land one
    step apart and move that layer's scores by ~1e-3, which can move its
    victims (measured: ~200 values, 91 positions of layer 1 after the
    encoding_decoding encode). There: equal tokens and kv_len, layer 0's pos
    equal, K/V within one int8 step wherever both paths hold the same
    position, ppl within 1e-5 relative (measured: 1.32e-6); the differing
    positions of later layers are printed.

    Then StreamingLLM (streaming=True: the chunk-major encode over the
    unordered cache, K rotated by rank; the decode through K1's rank
    variant): `encoding` at stride 96 and at stride 1 (a 256-token prompt:
    every chunk a decode step) and `ppl` at stride 96, under the same
    rules."""
    ids = torch.randint(1, cfg.vocab_size, (1, 1024), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32).to(dev)
    runs = [  # mode, budget, keep_attention, stride, streaming, prompt length
        ("encoding", 0.5, False, STRIDE, False, 1024), ("encoding", 0.5, True, STRIDE, False, 1024),
        ("encoding_decoding", 512, False, STRIDE, False, 1024),
        ("ppl", 0.5, False, STRIDE, False, 1024),
        ("encoding", 0.5, False, STRIDE, True, 1024), ("encoding", 0.5, False, 1, True, 256),
        ("ppl", 0.5, False, STRIDE, True, 1024)]
    for quant in (False, True):
        kv = "int8" if quant else "f32"
        for mode, budget, keep, stride, streaming, n in runs:
            b = int(n * budget) + stride if isinstance(budget, float) else budget + stride
            align = gen_mod.stride_align if mode == "encoding" else gen_mod.stride_align_encdec
            idx, r_idx = align(n, b, stride)
            st = gen_mod.EngineStatics(
                cfg=cfg, policy="roco", length=n, budget=b, max_new_tokens=32,
                recent_window_dec=int(b * 0.3), kv_quant=quant, mode=mode, stride=stride,
                idx=idx, r_idx=r_idx, recent_window=int(b * 0.1), keep_attention=keep,
                streaming=streaming)
            res = {}
            for plain in (False, True):
                gen = torch.Generator(device=dev).manual_seed(0)
                reset_counts()
                with plain_kernels() if plain else contextlib.nullcontext():
                    if mode == "ppl":
                        loss, kv_len, _ = gen_mod._run_ppl(st, params, ids[:, :n], gen,
                                                           torch.float32)
                        res[plain] = (float(loss[0]), None, int(kv_len[0]), counts())
                    else:
                        run = gen_mod._run_encoding if mode == "encoding" else gen_mod._run_encdec
                        out = run(st, params, ids[:, :n], 1e-9, 1.0, gen, torch.float32)
                        cache = out[-2]
                        res[plain] = (out[0].out_ids.cpu(), (cache.pos.cpu(), cache.k.cpu(),
                                                             cache.v.cpu()),
                                      int(out[0].kv_len[0]), counts())
            (ta, ca, la, k_c), (tb, cb, lb, p_c) = res[False], res[True]
            n6 = 2 * ((n - r_idx) // stride) if quant and not streaming else 0
            name = (("streaming " if streaming else "") + mode
                    + (" keep_attention" if keep else ""))
            if mode == "ppl":
                rel = abs(ta - tb) / abs(tb)
                ok = rel <= 1e-5 and la == lb
                what = f"ppl {math.exp(ta):.4f} vs {math.exp(tb):.4f} (CE rel. diff {rel:.2e})"
            else:
                same_tok = torch.equal(ta, tb)
                pos_diff = [int((ca[0][l] != cb[0][l]).sum()) for l in range(ca[0].shape[0])]
                what = f"tokens equal {same_tok}, final pos differing per layer {pos_diff}"
                if quant:
                    held = (ca[0] >= 0) & (ca[0] == cb[0])
                    step = max(int((ca[i].int() - cb[i].int()).abs()[held].max()) for i in (1, 2))
                    what += f", int8 K/V at the same positions within {step} step(s)"
                    ok = same_tok and pos_diff[0] == 0 and step <= 1
                else:
                    ok = same_tok and sum(pos_diff) == 0
                ok = ok and la == lb
            print(f"phase 4: full width L=2 f32 weights, {kv} KV, {name} roco, {n} tokens, "
                  f"stride {stride}: {what}, kv_len {la} / {lb}; launches kernel path {k_c}, "
                  f"plain path {p_c}")
            check(ok, f"{kv} KV {name} stride {stride}: kernel path and plain path disagree")
            ranked = streaming and mode != "ppl"      # its decode (and stride 1's chunks)
            check(k_c["K6"] == n6 and sum(p_c.values()) == 0
                  and (k_c["K5"] > 0) == quant and (k_c["K1 rank"] > 0) == ranked
                  and k_c["K1 rank"] == (k_c["K1"] if streaming else 0),
                  f"{kv} KV {name} stride {stride}: launch counts")


def graph_ms(fn, arg_sets, reps, restore=None):
    """Device time of one call: `reps` calls (cycling through arg_sets, so a
    caller that would find the L2 cache cold finds it cold) captured in one
    CUDA graph, replayed, timed with CUDA events. A call that changes its
    inputs in place passes `restore`, which puts them back (untimed) before
    the capture and before the timed replay, and reps = len(arg_sets): each
    call of the timed replay then finds the state it was given."""
    for a in arg_sets:
        fn(*a)
    if restore is not None:
        restore()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    if restore is not None:
        restore()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k1_library_ms(sets, quant, reps=320):
    """K1's yardstick: scaled_dot_product_attention of q over the same
    cache's K and V with the same visibility mask, the attention half alone
    (no probabilities, no in-flight token, no rotation); an int8 cache as a
    bf16 copy dequantized beforehand (not timed). sets: K1's argument
    tuples (q, kn, vn, k, v, pos, q_pos[, k_scale, v_scale])."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_sets = []
    for a in sets:
        q, k, v, pos, qp = a[0], a[3], a[4], a[5], a[6]
        if quant:
            k = (k.float() * a[7][..., None]).to(torch.bfloat16)
            v = (v.float() * a[8][..., None]).to(torch.bfloat16)
        mask = ((pos >= 0) & (pos <= qp[:, None, None]))[:, :, None, :]
        lib_sets.append((q, k, v, mask))
    ms = graph_ms(lambda q, k, v, m: sdpa(q, k, v, attn_mask=m), lib_sets, reps)
    del lib_sets
    return ms


K1_TIMED = ("K1", "K1 ordered", "K1 rank", "decode_attend")


def k1_time_cases(dev, keys=K1_TIMED, B=1):
    """Phase 5's K1 inputs, one layer a launch and 32 layers' K / V cycled
    (32 / B at B > 1, at least 2) so that L2 is cold. Yields, per key and
    cache dtype (bf16, then int8), (key, kv, sets, run, lib, nbytes, flops,
    visible): run(fn) launches K1's fn (k1, k1_plain) or, for
    decode_attend, kda / kda_plain on a set; lib holds K1's arguments (q,
    kn, vn, k, v, pos, q_pos[, k_scale, v_scale]) of each set, for
    k1_library_ms. K1: phase 3's decode cache at S=768 (712 slots visible);
    K1 ordered (int8 only): the same shapes over the rotate-at-read cache,
    with the rotation tables; K1 rank and decode_attend: the encoding
    family's cache at S=2304 (2144 valid slots scattered, their age ranks).
    nbytes, the bound's bytes: the visible K and V rows (and int8 scales)
    read once, pos read, probs written, q, kn, vn and out, p_new, q_pos;
    ordered and rank also the (S, D/2) f32 cos and sin tables once, rank
    the (B, H, S) int32 ranks; flops 4 a visible slot and dim (10 with a
    rotation). visible: slots a layer that q sees."""
    L, H, D = max(2, 32 // B), 32, 128

    def case(key, kv, sets, run, lib):
        pos, qp, S = lib[0][5], lib[0][6], lib[0][5].shape[-1]
        visible = sum(int(((a[5] >= 0) & (a[5] <= qp[:, None, None])).sum()) for a in lib) / L
        row = D + 4 if kv == "int8" else D * 2
        nbytes = visible * row * 2 + B * H * S * 4 * 2 + B * 4   # K, V; pos, probs; q_pos
        nbytes += B * H * D * 2 * (2 if key == "decode_attend" else 4)
        nbytes += 0 if key == "decode_attend" else B * H * 4     # p_new
        rot = key in ("K1 ordered", "K1 rank")
        nbytes += (S * D // 2 * 4 * 2 if rot else 0) + (B * H * S * 4 if key == "K1 rank" else 0)
        return key, kv, sets, run, lib, nbytes, (10 if rot else 4) * visible * D, visible

    def cache(gk, kv, S, bf16=True):
        kc, vc = (torch.randn((L, B, H, S, D), generator=gk, device=dev) for _ in range(2))
        if kv == "bf16" or bf16:
            kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
        if kv == "bf16":
            return kc, vc, [()] * L
        (kc, ksc), (vc, vsc) = quantize_kv(kc), quantize_kv(vc)
        return kc, vc, [(ksc[l], vsc[l]) for l in range(L)]

    def qkv(gk):
        return tuple(torch.randn((B, H, 1, D), generator=gk, device=dev).to(torch.bfloat16)
                     for _ in range(3))
    plain_run = lambda fn: fn  # noqa: E731
    if "K1" in keys:
        gk = torch.Generator(device=dev).manual_seed(40)
        pos = slot_positions(L, B, H, S_MAIN, PROMPT + BUDGET, torch.Generator().manual_seed(40),
                             dev)
        q, kn, vn = qkv(gk)
        qp = torch.full((B,), PROMPT + NEW - 1, dtype=torch.int32, device=dev)
        for kv in ("bf16", "int8"):
            kc, vc, sc = cache(gk, kv, S_MAIN)
            sets = [(q, kn, vn, kc[l], vc[l], pos[l], qp, *sc[l]) for l in range(L)]
            yield case("K1", kv, sets, plain_run, sets)
            del kc, vc, sc, sets
    if "K1 ordered" in keys:
        pos = slot_positions(L, B, H, S_MAIN, PROMPT + BUDGET, torch.Generator().manual_seed(190),
                             dev)
        gk = torch.Generator(device=dev).manual_seed(194)
        q, kn, vn = qkv(gk)
        qp = torch.full((B,), PROMPT + NEW - 1, dtype=torch.int32, device=dev)
        kc, vc, sc = cache(gk, "int8", S_MAIN, bf16=False)
        rot = rotation_tables(S_MAIN, LLAMA2_7B, dev)
        sets = [(q, kn, vn, kc[l], vc[l], pos[l], qp, *sc[l]) for l in range(L)]
        yield case("K1 ordered", "int8", sets, lambda fn, rot=rot: lambda *a: fn(*a, rot=rot),
                   sets)
        del kc, vc, sc, sets
    if "K1 rank" in keys or "decode_attend" in keys:
        gk = torch.Generator(device=dev).manual_seed(210)
        q, kn, vn = qkv(gk)
        qp = torch.full((B,), ENC_PROMPT + ENC_NEW, dtype=torch.int32, device=dev)
        pos = torch.stack([scrambled_positions(B, H, ENC_S, RANK_VALID, dev, 211 + l)
                           for l in range(L)])
        ranks = age_ranks_all(pos)
        rot = rotation_tables(ENC_S, LLAMA2_7B, dev)
        for kv in ("bf16", "int8"):
            kc, vc, sc = cache(gk, kv, ENC_S)
            lib = [(q, kn, vn, kc[l], vc[l], pos[l], qp, *sc[l]) for l in range(L)]
            if "K1 rank" in keys:
                sets = [a[:7] + (ranks[l],) + a[7:] for l, a in enumerate(lib)]
                yield case("K1 rank", kv, sets,
                           lambda fn, rot=rot: lambda *a: fn(*a[:7], *a[8:], rot=rot, rank=a[7]),
                           lib)
                del sets
            if "decode_attend" in keys:
                yield case("decode_attend", kv, lib,
                           lambda fn: lambda *a: fn(a[0], *a[3:]), lib)
            del kc, vc, sc, lib
            torch.cuda.empty_cache()


def k1_timings(dev, keys):
    """Phase 5's K1 rows (k1_time_cases) keyed by (key, cache dtype): the
    kernel's time, its plain version's, k1_library_ms, and its bound's
    bytes and operations."""
    out = {}
    for key, kv, sets, run, lib, nbytes, flops, visible in k1_time_cases(dev, keys):
        fn, plain = (kda, kda_plain) if key == "decode_attend" else (k1, k1_plain)
        out[(key, kv)] = dict(ms=graph_ms(run(fn), sets, 320),
                              plain_ms=graph_ms(run(plain), sets,
                                                 32 if key in ("K1 rank", "decode_attend") else 64),
                              library_ms=k1_library_ms(lib, kv == "int8"), bytes=nbytes,
                              flops=flops, peak=F32_FLOPS, visible=visible)
    return out


def phase_times(dev):
    """Times keyed by (kernel, cache dtype), each with its plain version's,
    its library yardstick's (or None) and its bound from this run's inputs.
    K1's yardstick: k1_library_ms."""
    L, H, S, D = 32, 32, S_MAIN, 128
    n_valid = PROMPT + BUDGET
    out = {}
    out.update(k1_timings(dev, ("K1",)))   # 32 layers' K/V (403 MB bf16) cycled
    # K2: roco with the eviction gate on (the budgeted steady state), four
    # copies of the sidecars cycled (k2_time_sets); with an int8 cache also
    # the scale rows, of which only the written slot's two scales move. At
    # B = 1 and S = 768, then at the batched decodes' B = 4 and 16 and the
    # encoding family's S = 2304
    for i, shape in enumerate(K2_SHAPES):
        B, S_ = K2_SHAPES[shape]
        for kv in ("bf16", "int8"):
            copies, run, nbytes, flops = k2_time_sets(dev, B, S_, kv, seed=50 + 10 * i)
            out[("K2" if shape == "B=1" else f"K2 {shape}", kv)] = dict(
                ms=graph_ms(run(k2), copies, 64), plain_ms=graph_ms(run(k2_plain), copies, 8),
                library_ms=None, bytes=nbytes, flops=flops, peak=F32_FLOPS)
            del copies
            torch.cuda.empty_cache()
    # K3 inside K2's launch: K2 given the rows less K2 alone (B = 1, S =
    # 768, roco, the gate on); beside it the stand-alone kernel (alone_ms);
    # library yardstick: index_put_
    for kv, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        copies, run, _, _ = k2_time_sets(dev, 1, S, kv, seed=50, rows=True)
        folded = graph_ms(run(k2), copies, 64) - out[("K2", kv)]["ms"]
        del copies
        k, v, kn3, vn3, slots = k3_case(L, 1, H, S, D, dev, 60, dtype)
        idx = (torch.arange(L, device=dev)[:, None, None],
               torch.zeros(1, 1, 1, dtype=torch.long, device=dev),
               torch.arange(H, device=dev)[None, None, :], slots.long())
        kr, vr = kn3[:, :, :, 0], vn3[:, :, :, 0]

        def library(*_):
            k.index_put_(idx, kr)
            v.index_put_(idx, vr)
        rows = L * H
        out[("K3", kv)] = dict(ms=folded, alone_ms=graph_ms(k3, [(k, v, kn3, vn3, slots)], 200),
                               plain_ms=graph_ms(k3_plain, [(k, v, kn3, vn3, slots)], 50),
                               library_ms=graph_ms(library, [()], 50),
                               bytes=2 * 2 * rows * D * k.element_size() + rows * 4, flops=0,
                               peak=F32_FLOPS)
    out[("K5", "int8")] = k5_times(dev)
    out[("K6", "int8")] = k6_times(dev)
    out.update(streaming_times(dev))
    return with_bounds(out)


def with_bounds(out):
    """Each timing's bound_ms, the larger of its bytes over 3.35 TB/s and its
    operations over its peak, and bound_by, which of the two it is."""
    for r in out.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r.pop("peak") * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def tail_rows(v_slot, S):
    """Rows at and above each head's victim: what K8 and K9 move."""
    return int((S - v_slot.clamp(max=S)).sum())


def k9_times(dev, B, kinds=("bf16", "int8"), plain=True):
    """K9 (rotate) at the main path's shapes (L=32, H=32, S=768, D=128) and
    B rows: B=1 the pre-rotated streaming decode, B=4 the fused int4 tree's
    streaming B=4 run; victims among the 200 generated tokens, one head in
    six without. Keyed ("K9", kv) at B=1, ("K9 B=4", kv) at B=4. Bound: the
    K and V rows (and int8 scales) at and above each victim read and written
    once, and the victims."""
    L, H, S, D = STREAM_SHAPE
    shift = shift_rotation(rope_inv_freq(D, LLAMA2_7B.rope_theta, dev))
    out = {}
    for kv in kinds:
        seed = 191 if B == 1 else 191 + 4 * B
        kvr = kv_rows(L, B, H, S, D, kv, dev, seed)
        vs = stream_victims(L, B, H, S, dev, seed + 1)
        rows = tail_rows(vs, S)
        row_bytes = 2 * D * (1 if kv == "int8" else 2) + (8 if kv == "int8" else 0)
        args = [(kvr[0], kvr[1], vs, *kvr[2:])]

        def run_k9(fn):
            return lambda *a: fn(*a, rot=shift)
        key = "K9" if B == 1 else f"K9 B={B}"
        out[(key, kv)] = dict(ms=graph_ms(run_k9(k9), args, 64),
                              plain_ms=graph_ms(run_k9(k9_plain), args, 8) if plain else None,
                              library_ms=None, bytes=2 * rows * row_bytes + vs.numel() * 4,
                              flops=rows * D * 6, peak=F32_FLOPS)
        print(f"phase 5: {key} {kv} inputs: {rows} rows at and above the victims of "
              f"{L * B * H} heads ({rows / (L * B * H):.1f} per head), "
              f"{(2 * rows * row_bytes) / 1e6:.2f} MB to move")
        del kvr, args
        torch.cuda.empty_cache()
    return out


def streaming_times(dev):
    """The ordered StreamingLLM kernels at the main path's shapes (L=32,
    B=1, H=32, S=768, D=128; victims among the 200 generated tokens, one
    head in six without); K4 also at the encoding family's S = 2304, K9 also
    at B = 4 (k9_times). Bounds:
    K4 reads pos, score, score_sq and counter (16 bytes a slot) and writes
    counter (4) and one pos per row;
    K9 and K8 read and write the K and V rows (and int8 scales) at and
    above each victim once, K8
    also the four sidecars there and pos_mid / pos in full to find the
    victims; K2 compact moves what K2 moves and its victim slots; K1
    ordered what K1 moves plus
    the (S, D/2) cos and sin tables once (k1_time_cases). No PyTorch call
    computes the others: their library_ms is None; K1 ordered's is
    k1_library_ms."""
    L, H, S, D = STREAM_SHAPE
    slots = L * H * S
    out = {}
    # K4: roco, gate on (k4_time_sets), at S = 768 and at the encoding
    # family's S = 2304
    for key, S_ in (("K4", S), ("K4 S=2304", ENC_S)):
        copies, nbytes, flops = k4_time_sets(dev, 1, S_)
        out[(key, "-")] = dict(ms=graph_ms(k4, copies, 32), plain_ms=graph_ms(k4_plain, copies, 8),
                               library_ms=None, bytes=nbytes, flops=flops, peak=F32_FLOPS)
        del copies
    # K2 compact: the K2 timing's inputs with compact=True
    for kv in ("bf16", "int8"):
        copies, run, nbytes, flops = k2_time_sets(dev, 1, S, "compact " + kv, seed=180)
        out[("K2 compact", kv)] = dict(
            ms=graph_ms(run(k2), copies, 64), plain_ms=graph_ms(run(k2_plain), copies, 8),
            library_ms=None, bytes=nbytes, flops=flops, peak=F32_FLOPS)
        del copies
    pos = slot_positions(L, 1, H, S, PROMPT + BUDGET, torch.Generator().manual_seed(190), dev)
    for B in (1, B_WIDE):
        out.update(k9_times(dev, B))
    # K8 (the rotate-at-read path, int8 run): the same victims as K9's int8
    # timing at B = 1, as pos_mid -> pos; each call restores pos first (a 3
    # MB copy timed alone and subtracted), since K8 consumes its victims
    kvr = kv_rows(L, 1, H, S, D, "int8", dev, 191)
    vs = stream_victims(L, 1, H, S, dev, 192)
    rows = tail_rows(vs, S)
    row_bytes = 2 * D + 8
    post = pos.clone()
    idx = vs.clamp(max=S - 1)[..., None].long()
    post.scatter_(-1, idx, torch.where((vs < S)[..., None], -1, post.gather(-1, idx)))
    state = k2_case(L, 1, H, S, dev, 193)[0]
    work = [post.clone(), *[x.clone() for x in state[1:4]], *kvr]

    def run_k8(fn):
        def call():
            work[0].copy_(post)
            fn(pos, *work)
        return call

    def restore():
        work[0].copy_(post)
    t_restore = graph_ms(restore, [()], 64)
    out[("K8", "int8")] = dict(
        ms=graph_ms(run_k8(k8), [()], 64) - t_restore,
        plain_ms=graph_ms(run_k8(k8_plain), [()], 8) - t_restore, library_ms=None,
        bytes=2 * rows * (row_bytes + 16) + 2 * slots * 4, flops=0, peak=F32_FLOPS)
    del kvr
    out.update(k1_timings(dev, ("K1 ordered",)))
    return out


def k5_times(dev):
    """K5 at the prompt's last chunk (queries 384..511, 512 visible slots of
    768, int8 cache, no statistics), one launch per layer, 32 layers' K/V
    cycled. Library yardstick: scaled_dot_product_attention over a bf16 copy
    dequantized beforehand (not timed) with the same mask."""
    L, H, D = 32, 32, 128
    sets = [k5_case(1, H, H, PROMPT, torch.bfloat16, True, False, dev, 90 + l)
            for l in range(L)]
    q, kq, vq, pos, q_pos, ks, vs = sets[0]
    mask = (pos[:, :, None, :] >= 0) & (pos[:, :, None, :] <= q_pos[:, None, :, None])
    visible = int((pos[0, 0] >= 0).sum())                 # rows some query sees
    need = int(mask.sum())                                # (query, slot) pairs seen
    k5_bytes = (q.numel() * 2 * 2                         # q read, out written
                + H * visible * (2 * D + 8)               # int8 K, V rows and scales
                + pos.numel() * 4 + q_pos.numel() * 4)
    deq = [(a[0], (a[1].float() * a[5][..., None]).to(torch.bfloat16),
            (a[2].float() * a[6][..., None]).to(torch.bfloat16), mask) for a in sets]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q_, k_, v_, m_):
        return sdpa(q_, k_, v_, attn_mask=m_)

    def kernel(*a):
        return k5(*a, need_scores=False)

    def plain(*a):
        return k5_plain(*a, need_scores=False)
    print(f"phase 5: K5 inputs: {visible} of {S_MAIN} slots visible, {need} (query, slot) "
          f"pairs per batch row over {H} heads, {k5_bytes / 1e6:.2f} MB to move")
    return dict(ms=graph_ms(kernel, sets, 64), plain_ms=graph_ms(plain, sets, 16),
                library_ms=graph_ms(library, deq, 64), bytes=k5_bytes, flops=4 * D * need,
                peak=BF16_FLOPS)


def k6_times(dev):
    """K6 at a triggered chunk of the int8 `encoding` run (2176 valid slots
    of 2304 per head after writing the 96 an eviction freed, queries
    4000..4095, statistics on), the whole wrapper call (row write, attention,
    statistics), 32 layers' caches cycled. Each call rewrites the same rows,
    so repeats are idempotent. Library yardstick: scaled_dot_product_attention
    over a bf16 copy of the updated cache dequantized beforehand (not timed),
    the attention half alone."""
    L, H, D, C = 32, 32, 128, STRIDE
    sets = [k6_case(1, H, H, torch.bfloat16, True, True, True, dev, 130 + l) for l in range(L)]
    for a in sets:
        k6_plain(*a)                        # the updated cache, as every timed call leaves it
    q, k_c, v_c, ids, q_pos, cinit, kq, vq, pos, score, ssq, cnt, ks, vs = sets[0]
    mask = (pos[:, :, None, :] >= 0) & (pos[:, :, None, :] <= q_pos[:, None, :, None])
    visible = int((pos >= 0).sum()) // H                  # valid slots per head, written ones in
    need = int(mask.sum())                                # (query, slot) pairs seen
    act = q.numel() * 2 * 2 + (k_c.numel() + v_c.numel()) * 2          # q, out; k_c, v_c
    k6_bytes = (act + H * visible * (2 * D + 8)           # int8 K, V rows and scales, once
                + pos.numel() * 4 + 3 * pos.numel() * 4   # pos read; ssum, ssq, last written
                + H * C * 4 * 4                           # pos, counter, score, score_sq rows
                + ids.numel() * 4 + q_pos.numel() * 4 + cinit.numel() * 4)
    deq = [(a[0], (a[6].float() * a[12][..., None]).to(torch.bfloat16),
            (a[7].float() * a[13][..., None]).to(torch.bfloat16),
            (a[8][:, :, None, :] >= 0) & (a[8][:, :, None, :] <= a[4][:, None, :, None]))
           for a in sets]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library(q_, k_, v_, m_):
        return sdpa(q_, k_, v_, attn_mask=m_)
    print(f"phase 5: K6 inputs: {visible} of {ENC_S} slots valid per head after the write, "
          f"{need} (query, slot) pairs over {H} heads, {k6_bytes / 1e6:.2f} MB to move")
    return dict(ms=graph_ms(k6, sets, 32), plain_ms=graph_ms(k6_plain, sets, 8),
                library_ms=graph_ms(library, deq, 64), bytes=k6_bytes, flops=4 * D * need,
                peak=BF16_FLOPS)


def k7_times(dev):
    """K7 roco at a triggered chunk of the `encoding` run (gates on: write,
    attention with statistics, score update, bump, selection, invalidation,
    next mask), int8 and bf16 caches, 32 layers' caches cycled, each call
    once per timed replay from its untouched state. Bound from bytes: q
    read and out written, the chunk's K/V rows read and written to their
    slots, every other valid K and V row (and int8 scale) read once, score
    / score_sq / counter read and written, pos read and written at the
    written slots and the victims, the write mask read and the next one
    written (the statistics are intermediates and are not counted);
    operations: QK
    and PV over the (query, slot) pairs seen, at the bf16 tensor-core rate.
    library_ms: None, no PyTorch call selects the victims (the attention
    half is K6's SDPA time)."""
    L, H, D, C = 32, 32, 128, STRIDE
    st = enc_step_statics("roco")
    out = {}
    for kv in ("int8", "bf16"):
        sets = [list(k7_case(1, H, H, kv, [(True, True)], dev, 330 + l)) for l in range(L)]
        pristine = [[a.clone() for a in x[10:]] for x in sets]

        def restore():
            for x, p in zip(sets, pristine):
                for a, b in zip(x[10:], p):
                    a.copy_(b)
        q, k_c, v_c, wm, q_pos = sets[0][:5]
        pos = torch.where(wm != 0, (4000 + (wm.cumsum(-1) - 1)).to(torch.int32),
                          sets[0][12])
        mask = (pos[:, :, None, :] >= 0) & (pos[:, :, None, :] <= q_pos[:, None, :, None])
        visible = int((pos >= 0).sum()) // H                  # valid slots a head after the write
        written = int((wm != 0).sum())                        # rows written, all heads
        need = int(mask.sum())
        row = 2 * D + 8 if kv == "int8" else 2 * D * 2        # K and V rows (+ scales)
        k7_bytes = (q.numel() * 2 * 2 + (k_c.numel() + v_c.numel()) * 2   # q, out; chunk rows
                    + written * row                           # the chunk's rows written
                    + (H * visible - written) * row           # every other valid row read once
                    + pos.numel() * 4 * 3 * 2                 # score, score_sq, counter r + w
                    + pos.numel() * 4 + written * 2 * 4       # pos read; written slots, victims
                    + pos.numel() * 4 * 2                     # write mask read, next written
                    + q_pos.numel() * 4 * 2 + 2 + 8)          # q_pos, counter_init, gates, ...

        def kernel(*a):
            return k7(*a, policy="roco", **st)

        def plain(*a):
            return k7_plain(*a, policy="roco", **st)
        out[("K7", kv)] = dict(ms=graph_ms(kernel, sets, L, restore),
                               plain_ms=graph_ms(plain, sets, L, restore),
                               library_ms=None, bytes=k7_bytes, flops=4 * D * need,
                               peak=BF16_FLOPS)
        print(f"phase 5: K7 {kv} inputs: {visible} of {ENC_S} slots valid a head after the "
              f"write, {need} (query, slot) pairs over {H} heads, {k7_bytes / 1e6:.2f} MB to move")
        del sets, pristine
        torch.cuda.empty_cache()
    return with_bounds(out)


def k7_records(k7t, errs, runs, k6_library_ms):
    """The kernels-line records of K7, with launches from the phase-3 run
    of the same cache dtype with the step kernel on (once a chunk-layer)."""
    records = []
    for (key, kv), t in k7t.items():
        run = "int8 encoding roco step" if kv == "int8" else "bf16 ppl roco step"
        launches = runs[run]["counts"]["K7"]
        label = "fused_chunk_step" + (" (int8 KV)" if kv == "int8" else "")
        print(f"phase 5: K7 {label}: {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
              f"us, library none for the selection (the attention half, K6's SDPA: "
              f"{k6_library_ms * 1e3:.2f} us), bound {t['bound_ms'] * 1e3:.2f} us "
              f"({t['bound_by']}), {launches} launches in the {run} run")
        records.append({"name": label, "route": "cuda",
                        "source": "easykv_tpu_torch/csrc/chunk_attention.cu",
                        "replaces": "easykv_tpu/ops/pallas/chunk_attention.py:1088",
                        "launches": launches, "max_abs_err": errs[(key, kv)], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return records


# ---------------------------------------------------------------------------
# quantized weights: K10-K13
# ---------------------------------------------------------------------------

# (K, N) of each product at LLaMa-2-7B width: the fused tree's four, the
# split tree's widths, the LM head (N = 32000, not a multiple of 512)
QSHAPES = {"wqkv": (4096, 12288), "wo": (4096, 4096), "wgu": (4096, 22016),
           "wd": (11008, 4096), "wq": (4096, 4096), "wg": (4096, 11008), "head": (4096, 32000)}
FUSED = ("wqkv", "wo", "wgu", "wd")
SPLIT_SHAPES = ("wq", "wg", "wd")          # wq = wk = wv = wo, wg = wu
K11_MS, K12_MS = (2, 4, 16, 96, 128, 512), tuple(range(1, 9))
# K13: M = 1 (its own stream), then the edges of the tensor-core kernel's
# configurations (x rows on the MMA's 8-wide side up to 8 and 16; 64-, 128-
# and 256-row tiles); timed at the batched decode's and the ppl blocks' M
K13_MS, K13_TIMED = (1, 2, 3, 4, 5, 16, 17, 128, 255, 256), (1, 4, 16, 128, 256)
K11_SHAPES = SPLIT_SHAPES + ("wqkv", "wgu")  # wq = wo: every width of both trees
SPLIT_USES = {"wq": 4, "wg": 2, "wd": 1}   # products a layer of the split tree runs per width
QUANT_RUNS = {  # the phase-3 run whose launches a quantized kernel reports
    "K10": "int4 arith split roco", "K11": "int4 arith split roco B=4",
    "K12": "int4 halves split roco", "K13": "int8 fused roco"}


def quant_limit(ref):
    """Limit on |kernel - plain| for K10-K13: 1e-5 of max|ref| (the order of
    the f32 sums), plus in bf16 one bf16 ulp of the reference value (the
    two f32 sums round to the same or adjacent bf16 values)."""
    lim = 1e-5 * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        lim = lim + 2**-7 * ref.float().abs()
    return lim


def quant_case(name, fmt, dev, seed):
    """A quantized linear of shape QSHAPES[name], made on the card with the
    port's quantizer from N(0, 0.02) weights."""
    K, N = QSHAPES[name]
    w = torch.randn((K, N), generator=torch.Generator(device=dev).manual_seed(seed), device=dev)
    w.mul_(0.02)
    if fmt == "int8":
        return quant_mod.quantize_linear(w)
    return quant_mod.quantize_linear_int4(w, 128, fmt)


QARGS = {"K10": ("q4a", "gs3"), "K11": ("q4a", "gs"), "K12": ("q4p", "gs"), "K13": ("q", "s")}


def quant_args(kernel, ql):
    """The leaves of a QuantLinear that a kernel takes after x."""
    return tuple(ql[k] for k in QARGS[kernel])


QPAIRS = {"K10": (k10, k10_plain), "K11": (k11, k11_plain), "K12": (k12, k12_plain),
          "K13": (k13, k13_plain)}


def phase_quant_kernels(dev):
    """K10-K13 against their plain versions at the 7B shapes of their
    phase-3 trees, x in bf16 and f32: K10 at M = 1 and K12 at M = 1..8
    (split widths; K12 twice, bit-identical),
    K11 at M = 2, 4, 16 (its small tiles), 96, 128, 512 (its 64-row tiles;
    its groups split over blocks at 2-128) over the split and the fused
    widths, K13 at M = 1 (its own stream) and at the edges of its
    tensor-core tiles, M = 2, 3, 4, 5, 16, 17, 128, 255, 256 (fused widths;
    the head with a float32 result; K13 twice, bit-identical). Returns the
    max |err| keyed (kernel, shape, M, x dtype)."""
    plan = [("K10", "arith", SPLIT_SHAPES + ("head",), (1,)),
            ("K12", "halves", SPLIT_SHAPES + ("head",), K12_MS),
            ("K11", "arith", K11_SHAPES, K11_MS),
            ("K13", "int8", FUSED + ("head",), K13_MS)]
    errs = {}
    for i, (kernel, fmt, names, ms) in enumerate(plan):
        fn, plain = QPAIRS[kernel]
        for j, name in enumerate(names):
            args = quant_args(kernel, quant_case(name, fmt, dev, 300 + 10 * i + j))
            K, N = QSHAPES[name]
            for dtype in (torch.bfloat16, torch.float32):
                line = []
                for M in ms:
                    x = torch.randn((M, K), generator=torch.Generator(device=dev).manual_seed(M),
                                    device=dev).to(dtype)
                    kw = dict(out_f32=True) if kernel == "K13" and name == "head" else {}
                    got, ref = fn(x, *args, **kw), plain(x, *args, **kw)
                    torch.cuda.synchronize()
                    err = (got.float() - ref.float()).abs()
                    ratio = (err / quant_limit(ref)).max().item()
                    check(got.dtype == ref.dtype and got.shape == ref.shape and ratio <= 1
                          and bool(torch.isfinite(got).all()),
                          f"{kernel} {name} M={M} {dtype}: {ratio:.3f} of its limit")
                    if kernel in ("K10", "K12", "K13"):           # no shared state:
                        check(torch.equal(got, fn(x, *args, **kw)),   # the same bits every run
                              f"{kernel} {name} M={M} {dtype}: two launches differ")
                    errs[(kernel, name, M, dtype)] = err.max().item()
                    line.append(f"M={M} max|err| {err.max().item():.3e} "
                                f"({ratio:.2f} of its limit)")
                dt = "bf16" if dtype == torch.bfloat16 else "f32"
                out = " f32 out" if kernel == "K13" and name == "head" else ""
                print(f"phase 2: {kernel} {name} (K={K}, N={N}) x {dt}{out}: " + "; ".join(line))
    return errs


def step_weight_gb(params):
    """GB of weights one M = 1 decode step reads: each linear's M = 1 leaf
    (q4a + gs3, q4p + gs, or q + s) and the LM head; and GB resident."""
    def leaf_bytes(w, step):
        if not isinstance(w, quant_mod.QuantLinear):
            return w.numel() * w.element_size()
        keys = (("q4a", "gs3") if "q4a" in w else ("q4p", "gs") if "q4p" in w
                else ("q", "s")) if step else w.keys()
        return sum(w[k].numel() * w[k].element_size() for k in keys)
    lin = [w for p in params.layers for n, w in list(p.named_parameters(recurse=False))
           + list(p.named_children()) if n.startswith("w")] + [params.lm_head]
    return (sum(leaf_bytes(w, True) for w in lin) / 1e9,
            sum(leaf_bytes(w, False) for w in lin) / 1e9)


def phase_quant(dev, cfg, params):
    """Quantized weights at 7B width, quantized on the card from the phase's
    bf16 weights with the port's own functions; the 512-token prompt, 384
    new tokens, greedy: int4 arithmetic fused (bench.py's headline tree: K14
    once a decode step at B=1, K15 at B=4 and 16) with an int8 KV cache,
    roco and `full`, roco with a bf16 KV cache and StreamingLLM roco over
    the pre-rotated int8 cache at B=1; roco at B=4 and 16 (int8 and bf16
    KV), `full` at B=16 and StreamingLLM roco at B=4; int4 arithmetic split,
    int8 KV, roco and `full`, and roco at B=4; int8 fused, int8 KV, roco;
    int4 halves split, bf16 KV, roco. Exact launch counts, 200 retained
    tokens (384 under `full`) in row 0's kv_len and in the final cache's
    valid slots of every (layer, row, head), and the printed ratio line."""
    L = cfg.num_hidden_layers
    g = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab_size, (B_MAX, PROMPT), generator=g)
    gc = dict(budget=BUDGET, kv_policy="roco", max_new_tokens=NEW, temperature=1e-9,
              top_p=1.0, eos_token_ids=[], seed=0)
    trees = [  # tree, make, runs (policy, B, KV, streaming)
        ("int4 arith fused", lambda: quant_mod.fuse_gemv_params(
            quant_mod.quantize_params_int4(params, layout="arith")),
         [("roco", 1, "int8", False), ("full", 1, "int8", False), ("roco", 1, "bf16", False),
          ("roco", 1, "int8", True), ("roco", B_WIDE, "int8", False),
          ("roco", B_MAX, "int8", False), ("roco", B_WIDE, "bf16", False),
          ("roco", B_MAX, "bf16", False), ("full", B_MAX, "int8", False),
          ("roco", B_WIDE, "int8", True)]),
        ("int4 arith split", lambda: quant_mod.quantize_params_int4(params, layout="arith"),
         [("roco", 1, "int8", False), ("full", 1, "int8", False), ("roco", B_WIDE, "int8", False)]),
        ("int8 fused", lambda: quant_mod.fuse_gemv_params(quant_mod.quantize_params(params)),
         [("roco", 1, "int8", False)]),
        ("int4 halves split", lambda: quant_mod.quantize_params_int4(params),
         [("roco", 1, "bf16", False)]),
    ]
    n_k5 = L * PROMPT // CHUNK
    runs = {}
    for tree, make, plan in trees:
        t0 = time.perf_counter()
        qparams = make()
        torch.cuda.synchronize()
        step_gb, held_gb = step_weight_gb(qparams)
        print(f"phase 3: {tree}: quantized on the card in {time.perf_counter() - t0:.1f} s; "
              f"weights read per M=1 step {step_gb:.3f} GB (at 3.35 TB/s "
              f"{step_gb / 3.35:.3f} ms), resident {held_gb:.3f} GB")
        models = {kv: easykv_tpu_torch.enable_fixed_kv(
            easykv_tpu_torch.CausalLM(cfg, qparams, device=dev, kv_quant=kv == "int8"), None,
            "decoding") for kv in sorted({r[2] for r in plan})}
        for model in models.values():
            model.easykv_generate(prompts[0].tolist(), dict(gc, max_new_tokens=8))   # warm-up
        for policy, B, kv, streaming in plan:
            name = (f"{tree} {'stream ' if streaming else ''}{policy}"
                    + (f" B={B}" if B > 1 else "") + (" bf16 KV" if tree == "int4 arith fused"
                                                      and kv == "bf16" else ""))
            model = models[kv]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            printed = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(printed), engine_caches() as made:
                out = model.easykv_generate(prompts[0].tolist() if B == 1
                                            else prompts[:B].numpy(),
                                            dict(gc, kv_policy=policy, streaming=streaming))
            c = counts()
            st = model.last_run
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            ordered, held = ordered_invariant(made[-1].pos)
            ordered = ordered or not streaming
            del made
            tok_s = B * st.n_tokens / st.decode_s
            line = printed.getvalue().strip().splitlines()[-1]
            print(f"phase 3: {name} ({kv} KV): prefill {st.prefill_s:.3f} s, decode "
                  f"{B}x{st.n_tokens} tokens in {st.decode_s:.3f} s = {tok_s:.2f} tok/s "
                  f"({graph_note(name, st)}), kv_len {st.kv_len}, valid slots per (layer, row, "
                  f"head) {held}, weights "
                  f"{step_gb:.3f} GB per step, peak memory {peak:.2f} GiB, launches {c}; "
                  f"printed: {line}")
            check(len(out) == NEW and st.logits_finite, f"{name}: bad output / NaN logits")
            want = {"K1": L * NEW, "K2": NEW, "K2 rows": NEW,
                    "K5": n_k5 if kv == "int8" else 0, "K13": NEW + 1}
            if tree == "int4 arith fused":
                if B == 1:
                    want.update(K1=0, K14=NEW, K11=4 * L)       # prefill: K11 at M = 512
                else:
                    want.update(K1=0, K15=NEW)                  # prefill M = 512 B: dense, plain
                if streaming:
                    want.update({"K9": NEW, "K2 compact": NEW})
            elif tree == "int4 arith split" and B == 1:
                want.update(K10=7 * L * NEW, K11=7 * L)         # prefill: K11 at M = 512
            elif tree == "int4 arith split":
                want.update(K11=7 * L * NEW)                    # prefill M = 2048: dense, plain
            elif tree == "int8 fused":
                want.update(K13=(4 * L + 1) * NEW + 1)          # prefill M = 512: plain
            else:
                want.update(K12=7 * L * NEW)                    # prefill M = 512: plain
            want = zero_counts(**want)
            check(c == want, f"{name}: launch counts {c}, expected {want}")
            kept = BUDGET if policy == "roco" else NEW
            ratio = f"KV cache budget ratio: {kept / NEW * 100:.2f}%({kept}/{NEW})"
            check(st.kv_len - PROMPT == kept and held == (PROMPT + kept, PROMPT + kept),
                  f"{name} kept {st.kv_len - PROMPT} tokens, slots {held}, not {kept}")
            check(line == ratio, f"{name}: printed {line!r}, expected {ratio!r}")
            check(ordered, f"{name}: the final cache is not age-ordered")
            runs[name] = dict(counts=c, tok_s=tok_s, prefill_s=st.prefill_s, peak_gib=peak,
                              weight_gb=step_gb, tokens=out)
        del models, model, qparams
        torch.cuda.empty_cache()
    return runs


# Phase 4's decode loop replayed as a CUDA graph against the same loop
# eager, at LLaMa-2-7B width with L = 2 and bf16 weights drawn from seed 2:
# name -> (weights: None bf16, "split" int4 arithmetic through K10 / K11,
# "fused" K14 at B = 1 and K15 above; KV; kv_mode; policy; B; more of the
# generate config, "prerot" the flag)
GRAPH_CASES = {
    "bf16 roco": (None, "bf16", "decoding", "roco", 1, {}),
    "bf16 roco B=4": (None, "bf16", "decoding", "roco", 4, {}),
    "int8 roco": (None, "int8", "decoding", "roco", 1, {}),
    "int8 roco B=4": (None, "int8", "decoding", "roco", 4, {}),
    "bf16 full": (None, "bf16", "decoding", "full", 1, {}),
    "int8 random B=4": (None, "int8", "decoding", "random", 4, {}),
    "bf16 stream prerot": (None, "bf16", "decoding", "roco", 1, {"streaming": True}),
    "int8 stream rotate-at-read": (None, "int8", "decoding", "roco", 1,
                                   {"streaming": True, "prerot": False}),
    "int8 stream rank (encoding_decoding)": (None, "int8", "encoding_decoding", "roco", 1,
                                             {"streaming": True}),
    "int4 arith split roco B=4": ("split", "int8", "decoding", "roco", 4, {}),
    "int4 arith fused roco (K14)": ("fused", "int8", "decoding", "roco", 1, {}),
    "int4 arith fused roco B=4 (K15)": ("fused", "bf16", "decoding", "roco", 4, {}),
    "bf16 roco sampled": (None, "bf16", "decoding", "roco", 1,
                          {"temperature": 0.7, "top_p": 0.9}),
}
GRAPH_PROMPT, GRAPH_BUDGET, GRAPH_NEW, GRAPH_STRIDE = 200, 24, 48, 24
CACHE_ARRAYS = ("pos", "score", "score_sq", "counter", "k", "v", "k_scale", "v_scale")


def graph_twin(model, case, prompts):
    """One GRAPH_CASES run through generate(), its decode replayed as a CUDA
    graph and then eager (flags.eager_decode_loop). Returns (the two runs'
    graph nodes, what differs between them: every row's tokens, kv_len,
    the final cache's arrays, the carried ranks, the launch counts; the
    replayed run's launch counts)."""
    _, _, mode, policy, B, more = case
    more = dict(more)
    prerot = more.pop("prerot", None)
    gc = dict(budget=GRAPH_BUDGET if mode == "decoding" else 4 * GRAPH_BUDGET, kv_policy=policy,
              max_new_tokens=GRAPH_NEW, temperature=1e-9, top_p=1.0, eos_token_ids=[], seed=5)
    gc.update(more)
    ids = prompts[0].tolist() if B == 1 else prompts[:B].numpy()
    got = []
    for eager in (False, True):
        flags.use_prerot(prerot)
        reset_counts()
        try:
            with flags.eager_decode_loop() if eager else contextlib.nullcontext(), \
                    contextlib.redirect_stdout(io.StringIO()), \
                    recorded("_decode_loop") as res, engine_caches() as made, \
                    recorded("_carry_ranks", last_only=True) as ranks:
                easykv_tpu_torch.generate(model, ids, gc, kv_mode=mode, stride=GRAPH_STRIDE)
        finally:
            flags.use_prerot(None)
        got.append((res[-1], made[-1], ranks[-1] if ranks else None, counts(),
                    model.last_run.graph_nodes))
    (rg, cg, kg, ng, nodes), (re_, ce, ke, ne, eager_nodes) = got
    diff = [n for n in ("out_ids", "kv_len") if not torch.equal(getattr(rg, n), getattr(re_, n))]
    diff += [n for n in CACHE_ARRAYS
             if getattr(cg, n) is not None and not same_bits(getattr(cg, n), getattr(ce, n))]
    if (kg is None) != (ke is None) or (kg is not None and not torch.equal(kg, ke)):
        diff.append("carried ranks")
    if ng != ne:
        diff.append(f"launches (eager {ne})")
    return (nodes, eager_nodes), diff, ng


def graph_twin_results(dev):
    """graph_twin over every GRAPH_CASES path: yields (name, the two runs'
    graph nodes, what differs, the replayed run's launch counts)."""
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=2)
    params = init_params(cfg, seed=2, dtype=torch.bfloat16, device=dev)
    split = quant_mod.quantize_params_int4(params, layout="arith")
    trees = {None: params, "split": split, "fused": quant_mod.fuse_gemv_params(split)}
    prompts = torch.randint(1, cfg.vocab_size, (4, GRAPH_PROMPT),
                            generator=torch.Generator().manual_seed(2))
    for name, case in GRAPH_CASES.items():
        model = easykv_tpu_torch.CausalLM(cfg, trees[case[0]], device=dev,
                                          kv_quant=case[1] == "int8")
        yield (name, *graph_twin(model, case, prompts))
    del trees, split, params
    torch.cuda.empty_cache()


def phase_graph_vs_eager(dev):
    """Every GRAPH_CASES path (bf16 / int8 KV, B = 1 and 4, roco, `full`,
    `random`, StreamingLLM pre-rotated, rotate-at-read and rank, the split
    int4 tree at B = 4 with K11's split tickets, K14, K15, a sampled run at
    temperature 0.7) decodes GRAPH_NEW tokens with the loop replayed as a
    CUDA graph and eager: bit-identical tokens, kv_len, final cache arrays
    (pos, score, score_sq, counter, k, v, scales) and carried ranks, equal
    launch counts."""
    L = 2
    for name, (nodes, eager_nodes), diff, c in graph_twin_results(dev):
        print(f"phase 4: full width L=2, {name}: replayed graph ({nodes} nodes) against the "
              f"eager loop: bit-identical {not diff}" + (f" but for {diff}" if diff else "")
              + f"; launches {c}")
        check(nodes > 0 and eager_nodes == 0 and not diff,
              f"{name}: the replayed graph and the eager loop differ in {diff}")
        want = {"int4 arith split roco B=4": ("K11", 7 * L * GRAPH_NEW),
                "int4 arith fused roco (K14)": ("K14", GRAPH_NEW),
                "int4 arith fused roco B=4 (K15)": ("K15", GRAPH_NEW)}.get(name)
        check(want is None or c[want[0]] == want[1], f"{name}: launch counts {c}")


def phase_plain_vs_kernel_quant(dev, cfg, params, ids, plen):
    """The decode path over quantized trees of the phase's L=2 f32 weights
    (int4 arithmetic fused, int8 fused, int4 arithmetic split, int4 halves
    split), f32 KV cache, roco at budget 8, 32 new tokens: kernel path (K14
    a step over the int4 arithmetic fused tree at B=1, K15 at B=4; K10 /
    K12 / K13 per product over the others; K11 or a plain branch in the
    prefill) against the plain path. Equal greedy tokens and final pos; the
    fused tree also with an int8 KV cache, under the int8 rule (equal
    tokens, layer 0's pos equal, int8 K/V within one step wherever the two
    caches hold the same position)."""
    trees = {"int4 arith fused": lambda: quant_mod.fuse_gemv_params(
                 quant_mod.quantize_params_int4(params, layout="arith")),
             "int8 fused": lambda: quant_mod.fuse_gemv_params(quant_mod.quantize_params(params)),
             "int4 arith split": lambda: quant_mod.quantize_params_int4(params, layout="arith"),
             "int4 halves split": lambda: quant_mod.quantize_params_int4(params)}
    wide = torch.randint(1, cfg.vocab_size, (B_WIDE, PROMPT),
                         generator=torch.Generator().manual_seed(2), dtype=torch.int32).to(dev)
    prompts = {1: (ids, plen), B_WIDE: (wide, torch.full((B_WIDE,), PROMPT, dtype=torch.int32,
                                                          device=dev))}
    for tree, make in trees.items():
        qparams = make()
        fused = tree == "int4 arith fused"
        for B, quant in ([(1, False), (1, True), (B_WIDE, False), (B_WIDE, True)] if fused
                         else [(1, False)]):
            st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=PROMPT, budget=8,
                                       max_new_tokens=32, recent_window_dec=int(8 * 0.3),
                                       kv_quant=quant)
            res = {}
            for plain in (False, True):
                gen = torch.Generator(device=dev).manual_seed(0)
                reset_counts()
                with plain_kernels() if plain else contextlib.nullcontext():
                    r, cache, _, _ = gen_mod._run_decoding(st, qparams, *prompts[B], 1e-9, 1.0,
                                                           gen, torch.float32)
                res[plain] = (r.out_ids.cpu(), cache.pos.cpu(), counts(), cache.k.cpu(),
                              cache.v.cpu())
            same_tok = torch.equal(res[False][0], res[True][0])
            pa, pb = res[False][1], res[True][1]
            pos_diff = [int((pa[l] != pb[l]).sum()) for l in range(pa.shape[0])]
            k_c = {k: v for k, v in res[False][2].items()
                   if k in ("K10", "K11", "K12", "K13", "K14", "K15")}
            kv = "int8" if quant else "f32"
            what = f"tokens equal {same_tok}, final pos differing per layer {pos_diff}"
            if quant:
                held = (pa >= 0) & (pa == pb)
                step = max(int((res[False][i].int() - res[True][i].int()).abs()[held].max())
                           for i in (3, 4))
                what += f", int8 K/V at the same positions within {step} step(s)"
                ok = same_tok and pos_diff[0] == 0 and step <= 1
            else:
                ok = same_tok and sum(pos_diff) == 0
            print(f"phase 4: full width L=2 f32 weights, {tree} tree, B={B}, {kv} KV, roco b=8, "
                  f"32 tokens: {what}; quantized-kernel launches kernel path {k_c}, plain path "
                  f"total {sum(res[True][2].values())}")
            check(ok, f"{tree} B={B} {kv} KV: kernel path and plain path disagree")
            per_step = {"int8 fused": "K13", "int4 arith split": "K10",
                        "int4 halves split": "K12",
                        "int4 arith fused": "K14" if B == 1 else "K15"}[tree]
            check(k_c[per_step] > 0 and k_c["K13"] > 0 and sum(res[True][2].values()) == 0,
                  f"{tree}: launch counts")
            if fused:
                check(k_c[per_step] == 32 and k_c["K14" if B > 1 else "K15"] == 0
                      and k_c["K10"] == 0, f"{tree} B={B}: K14 / K15 / K10 launches {k_c}")
        del qparams


def quant_copies(nbytes, cap=32):
    """Copies of a weight to cycle so that they exceed the 50 MB L2 twice."""
    return max(2, min(cap, math.ceil(100e6 / nbytes)))


QUANT_TIMED = [("K10", "arith", SPLIT_SHAPES, (1,)), ("K12", "halves", SPLIT_SHAPES, (1,)),
               ("K11", "arith", K11_SHAPES, (4, 512)),
               ("K13", "int8", FUSED + ("head",), K13_TIMED)]


def quant_times(dev, plan=QUANT_TIMED):
    """K10-K13 at the 7B shapes, bf16 activations: K10 and K12 at the split
    tree's three widths (M = 1), K11 at them and at the fused tree's wqkv
    and wgu at M = 4 (B=4 decode) and M = 512 (the prompt's prefill), K13
    at the fused tree's four products and the head (f32 logits), M = 1
    (the decode row), 4 and 16 (batched decode steps) and 128 and 256 (ppl
    blocks of the head). Each
    graph cycles enough copies of the weight that L2 is cold. Bound: the
    weight, scale, x and out bytes at 3.35 TB/s, or 2 M K N operations at
    989 TFLOP/s (bf16 x) where that is larger. Library: torch.matmul of x
    with a bf16 copy dequantized beforehand (not timed). `plan`: (kernel,
    format, widths, Ms) rows, QUANT_TIMED by default."""
    out = {}
    for i, (kernel, fmt, names, ms) in enumerate(plan):
        fn, plain = QPAIRS[kernel]
        for j, name in enumerate(names):
            K, N = QSHAPES[name]
            ql = quant_case(name, fmt, dev, 400 + 10 * i + j)
            args = quant_args(kernel, ql)
            wbytes = sum(a.numel() * a.element_size() for a in args)
            n = quant_copies(wbytes)
            copies = [tuple(a.clone() for a in args) for _ in range(n)]
            deq = quant_mod.dequantize(ql, torch.bfloat16)
            lib_w = [deq.clone() for _ in range(quant_copies(deq.numel() * 2, 8))]
            del ql, deq
            for M in ms:
                x = torch.randn((M, K), generator=torch.Generator(device=dev).manual_seed(M),
                                device=dev).to(torch.bfloat16)
                f32_out = kernel == "K13" and name == "head"
                kw = dict(out_f32=True) if f32_out else {}
                sets = [(x, *c) for c in copies]
                reps = 256 if M == 1 else (64 if M < 512 else 8)
                ms_k = graph_ms(lambda *a: fn(*a, **kw), sets, reps)
                ms_p = graph_ms(lambda *a: plain(*a, **kw), sets[:2], 4 if M < 512 else 2)
                ms_l = graph_ms(torch.matmul, [(x, w) for w in lib_w], 64 if M < 512 else 16)
                out_bytes = M * N * (4 if f32_out else 2)
                out[(kernel, name, M)] = dict(
                    ms=ms_k, plain_ms=ms_p, library_ms=ms_l, copies=n,
                    bytes=wbytes + M * K * 2 + out_bytes, flops=2 * M * K * N, peak=BF16_FLOPS)
            del copies, lib_w
            torch.cuda.empty_cache()
    return with_bounds(out)


QMETA = {  # name, source, TPU kernel it replaces
    "K10": ("w4a16_gemv_arith", "easykv_tpu_torch/csrc/quant_gemv.cu",   # K13's M = 1 stream
            "easykv_tpu/ops/pallas/w4_stream.py:258"),
    "K11": ("w4a16_gemm_arith", "easykv_tpu_torch/csrc/w4_gemm.cu",
            "easykv_tpu/ops/pallas/w4_stream.py:182"),
    "K12": ("w4a16_gemv", "easykv_tpu_torch/csrc/w4_matmul.cu",
            "easykv_tpu/ops/pallas/w4_matmul.py:62"),
    "K13": ("quant_matmul", "easykv_tpu_torch/csrc/quant_gemv.cu",   # M = 1, its own kernel
            "easykv_tpu/ops/pallas/quant_matmul.py:41"),
    "K13 M>1": ("quant_matmul", "easykv_tpu_torch/csrc/quant_matmul.cu",   # 1 < M <= 256
                "easykv_tpu/ops/pallas/quant_matmul.py:41"),
}
# the phase-3 run whose K13 launches a timed M > 1 reports: the int8 head at
# M = B of the split tree's B=4 and the fused tree's B=16 runs (every one of
# their K13 launches); no phase-3 run has the fused widths at M > 1 or the
# head at M = 128 (a quantized ppl block) or 256
K13_RUNS = {("head", 4): "int4 arith split roco B=4", ("head", 16): "int4 arith fused roco B=16"}


def quant_records(qtimes, errs, runs):
    """Phase 5's lines and `kernels` entries of K10-K13, one per (kernel,
    shape, M); launches are the kernel's total in its phase-3 run (K11 at
    M = 512: the prefill of the int4 arithmetic roco run; at the fused
    tree's wqkv and wgu, that tree's B=1 roco run, whose prefill runs K11
    at all four fused widths). Per decode step:
    K10 and K12 over the split tree's seven products a layer, K13 over the
    fused tree's four. K13 at M > 1: K13_RUNS."""
    records = []
    for (kernel, name, M), t in qtimes.items():
        kname, src, repl = QMETA["K13 M>1" if kernel == "K13" and M > 1 else kernel]
        run = ("int4 arith fused roco" if kernel == "K11" and name in ("wqkv", "wgu")
               else "int4 arith split roco" if (kernel, M) == ("K11", 512)
               else K13_RUNS.get((name, M)) if kernel == "K13" and M > 1 else QUANT_RUNS[kernel])
        launches = 0 if run is None else runs[run]["counts"][kernel]
        K, N = QSHAPES[name]
        label = f"{kname} {name} (M={M}, K={K}, N={N}{', f32 out' if name == 'head' else ''})"
        print(f"phase 5: {kernel} {label}: {t['ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, library {t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), {t['copies']} weight copies "
              f"cycled; " + (f"{launches} launches of {kernel} in the {run} run" if run else
                             "0 launches: no phase-3 run has this product at this M"))
        records.append({"name": label, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches,
                        "max_abs_err": errs[(kernel, name, M, torch.bfloat16)], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    for kernel, uses in (("K10", SPLIT_USES), ("K12", SPLIT_USES),
                         ("K13", dict.fromkeys(FUSED, 1))):
        step = sum(qtimes[(kernel, n, 1)]["ms"] * k for n, k in uses.items()) * 32
        bound = sum(qtimes[(kernel, n, 1)]["bound_ms"] * k for n, k in uses.items()) * 32
        layer = ", ".join(f"{k}x {n}" for n, k in uses.items())
        print(f"phase 5: {kernel} per decode step (32 layers x {layer}): "
              f"{step:.3f} ms, bound {bound:.3f} ms")
    return records


# ---------------------------------------------------------------------------
# K14: the one-kernel decode step over the fused arithmetic-int4 tree
# ---------------------------------------------------------------------------

K14_META = ("fused_decode_step", "easykv_tpu_torch/csrc/fused_decode.cu",
            "easykv_tpu/ops/pallas/fused_decode.py:79")
K14_RUNS = {"int8": "int4 arith fused roco", "bf16": "int4 arith fused roco bf16 KV"}


def step_tree(dev, L, seed, base=LLAMA2_7B, dtype=torch.bfloat16):
    """(config, the fused arithmetic-int4 tree) at the widths of `base`
    (LLaMa-2-7B) with L layers, quantized on the card from `dtype` weights
    drawn from `seed`."""
    cfg = dataclasses.replace(base, num_hidden_layers=L)
    params = init_params(cfg, seed=seed, dtype=dtype, device=dev)
    tree = quant_mod.fuse_gemv_params(quant_mod.quantize_params_int4(params, layout="arith"))
    del params
    torch.cuda.empty_cache()
    return cfg, tree


def step_case(dev, cfg, B, kv, rope, seed, holes=False, dead_row=False):
    """A one-kernel step's arguments (K14 at B=1, K15) at the main path's
    cache (S = 768, the prompt and 200 generated tokens with holes) for B
    rows at positions 895 - 3 b (rope_pos 712 - b with `rope`); with
    `holes` a fifth of the other slots dead too, with `dead_row` row 1 dead
    (q_pos -1)."""
    L, H, S, D = cfg.num_hidden_layers, cfg.num_key_value_heads, S_MAIN, cfg.head_dim
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = slot_positions(L, B, H, S, PROMPT + BUDGET, torch.Generator().manual_seed(seed), dev)
    if holes:
        pos[torch.rand(pos.shape, generator=g, device=dev) < 0.2] = -1
    k, v = (torch.randn((L, B, H, S, D), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    scales = ()
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    h0 = (torch.randn((B, cfg.hidden_size), generator=g, device=dev) * 0.02).to(torch.bfloat16)
    rows = torch.arange(B, dtype=torch.int32, device=dev)
    q_pos = (PROMPT + NEW - 1 - 3 * rows).to(torch.int32)
    if dead_row:
        q_pos[1] = -1
    rope_pos = (PROMPT + BUDGET - rows).to(torch.int32) if rope else None
    return (k, v, pos, h0, q_pos, *scales), rope_pos


def phase_k14(dev):
    """K14 against its plain version at LLaMa-2-7B width (D=4096, F=11008,
    32 heads, S=768), L=2, bf16 activations: bf16 and int8 KV, RoPE at
    q_pos and at rope_pos, the main path's holes and scattered dead slots;
    every output within k14_limit. The `kernels` record's max_abs_err comes
    from step_check at L=32, the main path's depth."""
    cfg, tree = step_tree(dev, 2, 7)
    for kv in ("bf16", "int8"):
        for rope, scattered in ((False, False), (True, False), (True, True)):
            args, rope_pos = step_case(dev, cfg, 1, kv, rope, 700 + rope + 2 * scattered,
                                        holes=scattered)
            what = (f"{kv} KV, L=2, RoPE at {'rope_pos' if rope else 'q_pos'}"
                    + (", scattered dead slots" if scattered else ""))
            step_check("phase 2", what, tree.layers, cfg, args, rope_pos)
    del tree
    torch.cuda.empty_cache()


def step_check(phase, what, layers, cfg, args, rope_pos=None, spread=None, key="K14"):
    """The step kernel `key` (K14, or K15) and its plain version once each on
    the same arguments: every output finite, of the plain version's dtype
    and shape, and within its limit (step_shares). Prints each output's max
    |err| and its share of the limit; returns (max |err| over the outputs,
    the plain outputs)."""
    kernel, plain = {"K14": (k14, k14_plain), "K15": (k15, k15_plain)}[key]
    got = kernel(layers, cfg, *args, rope_pos=rope_pos)
    ref = plain(layers, cfg, *args, rope_pos=rope_pos)
    torch.cuda.synchronize()
    for name, a, b in zip(STEP_OUTPUTS, got, ref):
        check(a.dtype == b.dtype and a.shape == b.shape
              and bool(torch.isfinite(a.float()).all()), f"{key} {what} {name}: bad output")
    worst, err, line = step_shares(got, ref, spread,
                                   "one-ulp spread" if key == "K14" else "reorder spread")
    print(f"{phase}: {key} {what}: max|err| (share of its limit) " + ", ".join(line))
    check(worst <= 1, f"{key} {what}: {worst:.3f} of its limit")
    return err, ref


def k14_bf16_control(phase, what, layers, cfg, args, ref, spread):
    """The bar of step_check must catch a wrong function: the plain K14 with
    each product's output rounded to bf16 (what the per-layer scan does in
    bf16) must miss it."""
    real = k14_fd._product
    with mock.patch.object(k14_fd, "_product",
                           lambda x, w: real(x, w).to(torch.bfloat16).float()):
        bad = k14_plain(layers, cfg, *args)
    worst, _, line = step_shares(bad, ref, spread)
    print(f"{phase}: K14 {what}, control (bf16-rounded products): " + ", ".join(line))
    check(worst > 1, f"K14 {what}: bf16-rounded products within the bar ({worst:.3f})")


def event_ms(fn, arg_sets, reps):
    """Device time of one call: `reps` calls cycling through arg_sets,
    launched back to back and timed with CUDA events (K14's cooperative
    launch is not captured in a graph; a call's few milliseconds of device
    time cover its launch)."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def k14_times(dev, cfg, tree):
    """K14 at the main path's step: LLaMa-2-7B width, L=32 (cfg, tree:
    step_tree's), S=768, the
    prompt and 200 generated tokens visible, bf16 and int8 KV. The weights
    (3.3 GB) and the K/V (0.2-0.4 GB) far exceed the 50 MB L2, so every call
    finds them cold. Bound: the bytes one step reads once (every layer's
    carriers, scale pairs and norm weights; the visible K/V rows, with
    their int8 scales; pos) and writes once (probs, kn, vn, p_new, h) at
    3.35 TB/s; its operations (~3 integer operations a weight byte on the
    CUDA cores) take less. library_ms: None, no PyTorch call computes a
    decode step. Before the timing, step_check holds K14 to its plain
    version on these arguments, each output within the larger of phase 2's
    limit and twice its one-ulp spread (k14_ulp_spread): the f32 residual
    carries the feed's roundings through 32 layers, and p_new read 1.12 of
    phase 2's fixed limit at this depth (PERF.md section 2). Its max |err|
    is the record's max_abs_err; the plain version with bf16-rounded
    products must miss that bar."""
    L, H, S, D = cfg.num_hidden_layers, cfg.num_key_value_heads, S_MAIN, cfg.head_dim
    wbytes = step_tree_bytes(tree)
    out = {}
    for kv in ("bf16", "int8"):
        args, _ = step_case(dev, cfg, 1, kv, False, 800)
        visible = int(((args[2] >= 0) & (args[2] <= args[4])).sum())
        row = D * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
        kv_bytes = 2 * visible * row + L * H * S * 4                 # K, V rows; pos
        out_bytes = L * H * S * 4 + 2 * L * H * D * 2 + L * H * 4 + cfg.hidden_size * 2
        what, spread = f"{kv} KV, L={L}, RoPE at q_pos", k14_ulp_spread(tree.layers, cfg, args)
        err, ref = step_check("phase 5", what, tree.layers, cfg, args, spread=spread)
        k14_bf16_control("phase 5", what, tree.layers, cfg, args, ref, spread)
        del ref
        ms = event_ms(lambda *a: k14(tree.layers, cfg, *a), [args], 20)
        plain = event_ms(lambda *a: k14_plain(tree.layers, cfg, *a), [args], 2)
        nbytes = wbytes + kv_bytes + out_bytes
        out[kv] = dict(ms=ms, plain_ms=plain, library_ms=None, bytes=nbytes, max_abs_err=err,
                       bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                       weight_gb=wbytes / 1e9, kv_gb=kv_bytes / 1e9)
        del args
    torch.cuda.empty_cache()
    return out


def step_tree_bytes(tree):
    """Bytes of a fused arithmetic-int4 tree that one step reads: every
    layer's carriers, scale pairs and norm weights."""
    return sum(t.numel() * t.element_size() for p in tree.layers
               for t in [getattr(p, n)[k] for n in ("wqkv", "wo", "wgu", "wd")
                         for k in ("q4a", "gs3")] + [p.ln_attn, p.ln_mlp])


def k14_records(ktimes, runs):
    records = []
    kname, src, repl = K14_META
    for kv, t in ktimes.items():
        run = K14_RUNS[kv]
        launches = runs[run]["counts"]["K14"]
        label = f"{kname} ({kv} KV, L=32, S={S_MAIN})"
        print(f"phase 5: K14 {label}: {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library none, bound {t['bound_ms'] * 1e3:.2f} us (bytes: weights "
              f"{t['weight_gb']:.3f} GB, K/V and pos {t['kv_gb']:.3f} GB), {launches / NEW:g} "
              f"launches/step in the {run} run")
        records.append({"name": label, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return records


# ---------------------------------------------------------------------------
# K15: the batched one-kernel decode step over the fused arithmetic-int4 tree
# ---------------------------------------------------------------------------

K15_META = ("fused_decode_step_batch", "easykv_tpu_torch/csrc/fused_decode_batch.cu",
            "easykv_tpu/ops/pallas/fused_decode_batch.py:73")
K15_RUNS = {(B_WIDE, "bf16"): "int4 arith fused roco B=4 bf16 KV",
            (B_WIDE, "int8"): "int4 arith fused roco B=4",
            (SERVE_SLOTS, "int8"): "serving (a)",        # its decode ticks, phase 3
            (B_MAX, "bf16"): "int4 arith fused roco B=16 bf16 KV",
            (B_MAX, "int8"): "int4 arith fused roco B=16"}
K15_MORE_B = (2, 3, 5, 9)     # phase 2's other batch sizes of K15
# Mistral-7B's published widths (GQA: 32 query heads, 8 KV heads, F 14336), with
# a sliding window of 512 slots, shorter than the 712 the main path's cache
# holds visible (Mistral's own window, 4096, would hide none of them)
MISTRAL_7B = dataclasses.replace(LLAMA2_7B, intermediate_size=14336, num_key_value_heads=8,
                                 sliding_window=512)


def k15_feed_check(phase, what, layers, cfg, args, rope_pos=None):
    """K15 rounds each product's input to bf16 as its plain version does:
    at least 99.9% of layer 0's kn and vn bit-equal to the plain version's,
    where the plain version with an f32 feed (the rounding left out) must
    stay under 90% (it reads ~55%)."""
    share = k15_feed_share(layers, cfg, args, rope_pos)
    control = k15_feed_share(layers, cfg, args, rope_pos, torch.float32)
    print(f"{phase}: K15 {what}: layer 0's kn / vn bit-equal to the plain version's: "
          f"{share[0]:.4f} / {share[1]:.4f}; control (an f32 feed): {control[0]:.4f} / "
          f"{control[1]:.4f}")
    check(min(share) >= 0.999 and max(control) < 0.9,
          f"K15 {what}: layer 0's rows {share}, the f32-feed control {control}")


def phase_k15(dev):
    """K15 against its plain version at 7B widths, L=2, S=768, bf16
    activations, the main path's holes plus a fifth of the other slots dead,
    row 1 dead (q_pos -1): LLaMa-2-7B (MHA) at B=4 and 16 and Mistral-7B's
    widths (GQA) at B=8 with a 512-slot sliding window, bf16 and int8 KV,
    RoPE at q_pos and at rope_pos; LLaMa-2-7B at B=2, 3, 5 and 9 too (odd B
    pads the feed), RoPE at q_pos. Every output within the larger of
    k14_limit and twice the plain version's reorder spread (k15_spread); the
    dead row's probabilities all 0; the feed rounded as the plain version
    rounds it (k15_feed_check)."""
    for base, Bs in ((LLAMA2_7B, (B_WIDE, B_MAX) + K15_MORE_B), (MISTRAL_7B, (8,))):
        cfg, tree = step_tree(dev, 2, 7, base)
        model = "LLaMa-2-7B" if base is LLAMA2_7B else "Mistral-7B widths, window 512"
        for B in Bs:
            for kv in ("bf16", "int8"):
                for rope in (False, True) if B not in K15_MORE_B else (False,):
                    args, rope_pos = step_case(dev, cfg, B, kv, rope, 900 + B + 2 * rope,
                                              holes=True, dead_row=True)
                    what = (f"{model}, B={B}, {kv} KV, L=2, RoPE at "
                            f"{'rope_pos' if rope else 'q_pos'}, holes, row 1 dead")
                    spread = k15_spread(tree.layers, cfg, args, rope_pos)
                    _, ref = step_check("phase 2", what, tree.layers, cfg, args, rope_pos,
                                        spread, key="K15")
                    check(not ref[3][:, 1].any() and not ref[4][:, 1].any(),
                          f"K15 {what}: the dead row has probabilities")
                    k15_feed_check("phase 2", what, tree.layers, cfg, args, rope_pos)
        del tree
        torch.cuda.empty_cache()


def k15_rounded_residual(layers, cfg, args, dt):
    """The known-wrong control: the plain K15 one layer at a time, its
    residual h rounded to dt between the layers (the per-layer scan's
    rounding, which K15 does not do). Returns the step's five outputs."""
    k, v, pos, h, q_pos, *scales = args
    outs = []
    for l in range(len(layers)):
        one = lambda t: t[l:l + 1]  # noqa: E731
        o = k15_plain(layers[l:l + 1], cfg, one(k), one(v), one(pos), h, q_pos,
                      *(one(t) for t in scales))
        h = o[0].to(dt).to(h.dtype)
        outs.append(o)
    return (outs[-1][0],) + tuple(torch.cat([o[i] for o in outs]) for i in range(1, 5))


def k15_times(dev, cfg, tree):
    """K15 at the main path's step: LLaMa-2-7B width, L=32 (cfg, tree:
    step_tree's), S=768, the prompt and 200 generated tokens visible in every
    row, B=4 and 16, bf16 and int8 KV, and B=8 (serving run (a)'s slots) with
    int8 KV: K15_RUNS. Bound: the bytes one step reads once
    (every layer's carriers, scale pairs and norms; every row's visible K/V
    rows with their int8 scales; pos) and writes once (probs, kn, vn, p_new,
    h) at 3.35 TB/s; its operations (3 B multiply-adds a carrier byte on the
    tensor cores) take less. library_ms: None, no PyTorch call computes a
    decode step. Before the timing, step_check holds K15 to its plain version
    within the larger of phase 2's limit and twice its reorder spread
    (k15_spread); its max |err| is the record's max_abs_err. No known-wrong
    control separates from K15 at this depth in bf16 (the residual rounded
    between the layers reads within ~1.6x of K15 itself, PERF.md section
    2): k15_control holds the same bar where one does."""
    L, H, S, D = cfg.num_hidden_layers, cfg.num_key_value_heads, S_MAIN, cfg.head_dim
    wbytes = step_tree_bytes(tree)
    out = {}
    for B, kv in K15_RUNS:
        args, _ = step_case(dev, cfg, B, kv, False, 800)
        pos, q_pos = args[2], args[4]
        visible = int(((pos >= 0) & (pos <= q_pos[None, :, None, None])).sum())
        row = D * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
        kv_bytes = 2 * visible * row + L * B * H * S * 4               # K, V rows; pos
        out_bytes = (L * B * H * S * 4 + 2 * L * B * H * D * 2 + L * B * H * 4
                     + B * cfg.hidden_size * 2)
        what = f"B={B}, {kv} KV, L={L}, RoPE at q_pos"
        spread = k15_spread(tree.layers, cfg, args, draws=2)
        err, _ = step_check("phase 5", what, tree.layers, cfg, args, spread=spread,
                            key="K15")
        ms = event_ms(lambda *a: k15(tree.layers, cfg, *a), [args], 20)
        plain = event_ms(lambda *a: k15_plain(tree.layers, cfg, *a), [args], 2)
        nbytes = wbytes + kv_bytes + out_bytes
        out[(B, kv)] = dict(ms=ms, plain_ms=plain, library_ms=None, bytes=nbytes,
                            max_abs_err=err, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                            bound_by="bytes", weight_gb=wbytes / 1e9, kv_gb=kv_bytes / 1e9)
        del args
        torch.cuda.empty_cache()
    return out


def k15_control(dev):
    """The bar that catches the per-layer rounding K15 must not do: with f32
    activations nothing in K15 rounds (an int8 cache is read as its f32
    values times their scales), so the kernel and its plain version agree to
    f32 sums at LLaMa-2-7B width, L=32, B=4 and 16, with an f32 and with an
    int8 KV cache, while the plain version with its residual rounded to
    bf16 between the layers (k15_rounded_residual) must miss the same bar
    (k14_limit, with twice the reorder spread) in every case."""
    cfg, tree = step_tree(dev, 32, 5, dtype=torch.float32)
    for B in (B_WIDE, B_MAX):
        for kv in ("f32", "int8"):
            args, _ = step_case(dev, cfg, B, "int8" if kv == "int8" else "bf16", False, 801)
            k, v, pos, h0, q_pos, *scales = args
            if kv == "f32":
                k, v = k.float(), v.float()
            args = (k, v, pos, h0.float(), q_pos, *scales)
            what = f"B={B}, f32 activations, {kv} KV, L=32"
            spread = k15_spread(tree.layers, cfg, args, draws=2)
            _, ref = step_check("phase 5", what, tree.layers, cfg, args, spread=spread,
                                key="K15")
            bad = k15_rounded_residual(tree.layers, cfg, args, torch.bfloat16)
            worst, _, line = step_shares(bad, ref, spread, "reorder spread")
            print(f"phase 5: K15 {what}, control (residual rounded to bf16 between the layers): "
                  + ", ".join(line))
            check(worst > 1,
                  f"K15 {what}: the per-layer rounded residual within the bar ({worst:.3f})")
            del args, k, v, scales, ref, bad
            torch.cuda.empty_cache()
    del tree
    torch.cuda.empty_cache()


def k15_records(ktimes, runs):
    records = []
    kname, src, repl = K15_META
    for (B, kv), t in ktimes.items():
        run = K15_RUNS[(B, kv)]
        launches = runs[run]["counts"]["K15"]
        per = runs[run].get("dec_ticks", NEW)       # a serving run: its decode ticks
        label = f"{kname} (B={B}, {kv} KV, L=32, S={S_MAIN})"
        print(f"phase 5: K15 {label}: {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library none, bound {t['bound_ms'] * 1e3:.2f} us (bytes: weights "
              f"{t['weight_gb']:.3f} GB, K/V and pos {t['kv_gb']:.3f} GB), {launches / per:g} "
              f"launches/step in the {run} run")
        records.append({"name": label, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches, "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return records


# ---------------------------------------------------------------------------
# StreamingLLM in the encoding family: K1's rank variant, fused_decode_attend
# ---------------------------------------------------------------------------

RANK_VALID = ENC_IDX + ENC_NEW // 2     # valid slots a head midway through `encoding`'s decode
RANK_META = {  # key: (name, TPU kernel it replaces)
    "K1 rank": ("fused_decode_attend_inflight rank",
                "easykv_tpu/ops/pallas/decode_attention.py:207"),
    "decode_attend": ("fused_decode_attend", "easykv_tpu/ops/pallas/decode_attention.py:406"),
}


def scrambled_positions(B, H, S, n_valid, dev, seed, dead_row=False):
    """(B, H, S) positions of the encoding family's unordered cache: n_valid
    distinct positions of the 4096-token prompt and its decode, scattered
    over random slots of each head (eviction leaves holes anywhere and
    write_tokens refills the lowest ones), the rest -1; dead_row: the last
    row all -1."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.full((B * H, S), -1, dtype=torch.int32)
    for r in range(B * H):
        slots = torch.randperm(S, generator=g)[:n_valid]
        keep = torch.randperm(ENC_PROMPT + ENC_NEW, generator=g)[:n_valid].sort().values
        pos[r, slots] = keep.to(torch.int32)
    pos = pos.view(B, H, S)
    if dead_row:
        pos[-1] = -1
    return pos.to(dev)


def rank_case(B, Hq, Hkv, dtype, quant, dev, seed, dead_row=False, S=ENC_S, D=128):
    """K1's arguments over the unordered cache at the `encoding` decode's
    shapes, with the query one past the newest position (a dead row: -1),
    and the rank variant's tables and age ranks: (args, rot, ranks)."""
    args = k1_case(B, Hq, Hkv, S, D, dtype, [ENC_PROMPT + ENC_NEW] * B, dev, seed, quant)
    pos = scrambled_positions(B, Hkv, S, RANK_VALID, dev, seed, dead_row)
    q_pos = args[6].clone()
    if dead_row:
        q_pos[-1] = -1
    args = args[:5] + (pos, q_pos) + args[7:]
    return args, rotation_tables(S, LLAMA2_7B, dev), age_ranks_all(pos[None])[0]


def phase_rank_kernels(dev):
    """K1's rank variant and fused_decode_attend against their plain
    versions at the `encoding` decode's shapes (S=2304, D=128, 2144 valid
    slots a head scattered over the cache, ranks of that cache): bf16 and
    int8 KV, LLaMa-2-7B's 32 heads at B=1, and B=2 with a dead row and
    Mistral-style GQA (32 query heads on 8 KV heads, rep 4: 4 x 2304 logits
    in shared memory); fused_decode_attend also with a 512-slot window.
    K1's limits: out within k1_out_limit, probs and p_new within 1e-5; a
    dead row all zero. Returns the max |err| of the B=1 cases keyed as
    phase 5 keys its times."""
    errs = {}
    cases = [("bf16 MHA B=1", 1, 32, 32, torch.bfloat16, False, False, None),
             ("int8 MHA B=1", 1, 32, 32, torch.bfloat16, True, False, None),
             ("bf16 GQA rep 4 B=2 dead row", 2, 32, 8, torch.bfloat16, False, True, None),
             ("int8 GQA rep 4 B=2 dead row", 2, 32, 8, torch.bfloat16, True, True, None),
             ("bf16 MHA B=1 window 512", 1, 32, 32, torch.bfloat16, False, False, 512),
             ("f32 MHA B=1", 1, 32, 32, torch.float32, False, False, None)]
    for i, (name, B, Hq, Hkv, dtype, quant, dead, window) in enumerate(cases):
        args, rot, ranks = rank_case(B, Hq, Hkv, dtype, quant, dev, 200 + i, dead)
        da_args = (args[0],) + args[3:]
        pairs = [("decode_attend", kda(*da_args, sliding_window=window),
                  kda_plain(*da_args, sliding_window=window))]
        if window is None:
            pairs.insert(0, ("K1 rank", k1(*args, rot=rot, rank=ranks),
                             k1_plain(*args, rot=rot, rank=ranks)))
        torch.cuda.synchronize()
        for key, got, ref in pairs:
            e = [(a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)]
            ratio = ((got[0].float() - ref[0].float()).abs() / k1_out_limit(ref[0])).max().item()
            print(f"phase 2: {key} {name}: max|err| out {e[0]:.3e} (at most {ratio:.2f} of its "
                  f"limit) probs {e[1]:.3e}" + (f" p_new {e[2]:.3e}" if len(e) > 2 else ""))
            check(ratio <= 1 and max(e[1:]) <= 1e-5, f"{key} {name} disagrees: {e}")
            if dead:
                check(got[0][1].abs().max().item() == 0 and got[1][1].abs().max().item() == 0,
                      f"{key} {name}: the dead row is not all zero")
            if name.endswith("MHA B=1"):
                errs[(key, "int8" if quant else "bf16")] = max(e)
        if name == "bf16 MHA B=1":
            by_slot = k1_plain(*args, rot=rot)[1]
            moved = (by_slot - pairs[0][2][1]).abs().max().item()
            print(f"phase 2: K1 rank {name}: probs move by {moved:.3e} when slots stand for "
                  f"ranks")
            check(moved > 1e-4, "K1 rank: the ranks do not move the rotation")
    return errs


def rank_times(dev):
    """K1's rank variant and fused_decode_attend at the `encoding` decode's
    shapes (B=1, 32 heads, S=2304, 2144 valid slots a head, all visible),
    one layer per launch, 32 layers' K/V cycled (604 MB bf16): cold L2.
    Bounds (bytes at 3.35 TB/s): the visible K and V rows (and int8
    scales) read once, pos read, probs written, q (kn, vn), out (p_new);
    K1 rank also the (B, H, S) int32 ranks and the (S, D/2) cos and sin
    tables once. library_ms: k1_library_ms, the attention half alone (no
    PyTorch call emits the probabilities)."""
    L, H, S = 32, 32, ENC_S
    out = k1_timings(dev, ("K1 rank", "decode_attend"))
    visible = out[("K1 rank", "bf16")]["visible"]
    print(f"phase 5: K1 rank / fused_decode_attend inputs: {visible / H:.0f} of {S} slots "
          f"visible per head, {H} heads, {L} layers' K/V cycled")
    return with_bounds(out)


def rank_records(rtimes, errs, runs):
    """The kernels-line records of K1 rank (launches from the streaming
    `encoding` run of the same cache dtype, 32 a decode step) and
    fused_decode_attend (from phase 3's forward bootstrap call, 32 a
    call)."""
    records = []
    for (key, kv), t in rtimes.items():
        kname, repl = RANK_META[key]
        if key == "K1 rank":
            run, unit, n = f"{kv} stream encoding roco", "step", ENC_NEW
        else:
            run, unit, n = f"{kv} forward bootstrap", "call", 1
        launches = runs[run]["counts"][key]
        label = kname + (" (int8 KV)" if kv == "int8" else "")
        print(f"phase 5: {key} {label}: {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} "
              f"us, library {t['library_ms'] * 1e3:.2f} us (SDPA, attention half), bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), {launches / n:g} "
              f"launches/{unit} in the {run} run")
        records.append({"name": label, "route": "cuda",
                        "source": "easykv_tpu_torch/csrc/decode_attention.cu", "replaces": repl,
                        "launches": launches, "max_abs_err": errs[(key, kv)], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    return records


# ---------------------------------------------------------------------------
# serving: easykv_tpu_torch.serving's engines
# ---------------------------------------------------------------------------


def serving_prompts(n, vocab, seed):
    """bench_serving.py's requests: n lengths from
    np.random.default_rng(seed).integers(128, 513), then each prompt from
    the same generator."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(128, 513, size=n)
    return [rng.integers(1, vocab, size=int(T)) for T in lengths]


def count_delta(after, before):
    return {k: after[k] - before[k] for k in after}


def submitted(eng, prompts, new):
    """The engine with every prompt submitted (request i, max_new_tokens = new)."""
    for i, p in enumerate(prompts):
        eng.submit(serving_engine.Request(request_id=i, ids=p, max_new_tokens=new))
    return eng


def serve(eng, prompts, new, want_dec=None, want_merged=None):
    """Submits the prompts (max_new_tokens = new) and drains the engine a
    step at a time (ScheduledBatchEngine.tick, ContinuousBatchEngine.step),
    with the counts set to 0 before and read after. Each decode tick is
    timed on the host clock (it ends in its (B,) readback) and its launch
    counts read, as each step's; before each _clear_row the finishing row's
    valid slots per (layer, head) are held to the single-request
    `decoding` rule (prompt + the forwarded tokens, at most the budget: the
    runs evict, roco).
    Checks: every request ends with exactly `new` tokens, all in the
    vocabulary; every decode tick launches want_dec, every merged tick
    want_merged (when given); every row's pos is -1 after the run. Returns
    the readings."""
    scheduled = isinstance(eng, serving_sched.ScheduledBatchEngine)
    tick = eng.decode_tick
    dec, steps, bad_rows = [], [], []
    calls = {"merged": 0, "admit": 0, "finished": 0}

    def timed_tick(*args):
        c0, r0, had = counts(), tick.replays, tick.graph is not None
        t0 = time.perf_counter()
        out = tick(*args)
        ms = (time.perf_counter() - t0) * 1e3
        kind = ("replay" if had else "capture") if tick.replays > r0 else "eager"
        dec.append((kind, ms, count_delta(counts(), c0)))
        return out

    real_clear = serving_engine._clear_row

    def checked_clear(cache, row):
        req = next(reversed(eng.finished.values()))
        want = len(req.ids) + min(len(req.out) - 1, eng.budget)
        held = (cache.pos[:, row] >= 0).sum(dim=-1)
        if not bool((held == want).all()):
            bad_rows.append((req.request_id, int(held.min()), int(held.max()), want))
        calls["finished"] += 1
        real_clear(cache, row)

    def counted(fn, key):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    submitted(eng, prompts, new)
    step = eng.tick if scheduled else eng.step

    def busy():
        return (eng.requests or eng.sched.num_waiting) if scheduled else (
            eng.pending or any(s is not None for s in eng.slots))
    emit_t = {}
    torch.cuda.synchronize()
    reset_counts()
    with mock.patch.object(eng, "decode_tick", timed_tick), \
            mock.patch.object(serving_engine, "_clear_row", checked_clear), \
            mock.patch.object(serving_sched, "_clear_row", checked_clear), \
            mock.patch.object(serving_sched, "_merged_step",
                              counted(serving_sched._merged_step, "merged")), \
            mock.patch.object(serving_engine, "_prefill_chunk",
                              counted(serving_engine._prefill_chunk, "admit")):
        t_run = time.perf_counter()
        while busy():
            before, d0, c0 = dict(calls), len(dec), counts()
            t0 = time.perf_counter()
            emitted = step()
            t1 = time.perf_counter()
            for rid, _ in emitted:
                emit_t.setdefault(rid, []).append(t1)
            kind = next((k for k in ("merged", "admit") if calls[k] > before[k]),
                        dec[-1][0] if len(dec) > d0 else "idle")
            steps.append((kind, (t1 - t0) * 1e3, count_delta(counts(), c0)))
        wall = time.perf_counter() - t_run
    total = counts()
    outs = {rid: r.out for rid, r in eng.finished.items()}
    V = eng.cfg.vocab_size
    check(sorted(outs) == list(range(len(prompts))) and calls["finished"] == len(prompts),
          f"serving: {len(outs)} of {len(prompts)} requests finished")
    check(all(len(o) == new and all(0 <= t < V for t in o) for o in outs.values()),
          f"serving: a request did not end with exactly {new} tokens in the vocabulary")
    check(not bad_rows, f"serving: valid slots (request, min, max, want) {bad_rows}")
    check(bool((eng.cache.pos == -1).all()), "serving: a row still holds valid slots")
    if want_dec is not None:
        off = [(k, c) for k, _, c in dec if c != want_dec]
        check(not off, f"serving: decode tick launches {off[:1]}, expected {want_dec}")
    if want_merged is not None:
        off = [c for k, _, c in steps if k == "merged" and c != want_merged]
        check(not off, f"serving: merged tick launches {off[:1]}, expected {want_merged}")
    itl = [1e3 * (b - a) for ts in emit_t.values() for a, b in zip(ts, ts[1:])]
    by_kind = {}
    for kind, ms, _ in steps:
        by_kind.setdefault(kind, []).append(ms)
    dec_ms = {}
    for kind, ms, _ in dec:
        dec_ms.setdefault(kind, []).append(ms)
    n_tok = sum(len(o) for o in outs.values())
    return dict(outs=outs, counts=total, wall_s=wall, tok_s=n_tok / wall, tokens=n_tok,
                itl_p50=float(np.percentile(itl, 50)), itl_p95=float(np.percentile(itl, 95)),
                ticks={k: len(v) for k, v in by_kind.items()},
                step_ms={k: float(np.median(v)) for k, v in by_kind.items()},
                dec_ms={k: float(np.median(v)) for k, v in dec_ms.items()},
                dec_ticks=len(dec), capture_s=tick.capture_s, nodes=tick.nodes)


def serving_line(name, r, extra=""):
    ticks = ", ".join(f"{k} {n} ({r['step_ms'][k]:.3f} ms median)" for k, n in r["ticks"].items())
    dec = ", ".join(f"{k} {ms:.3f}" for k, ms in r["dec_ms"].items())
    print(f"phase 3: serving {name}: {len(r['outs'])} requests, {r['tokens']} tokens in "
          f"{r['wall_s']:.3f} s = {r['tok_s']:.2f} tok/s aggregate; inter-token p50 "
          f"{r['itl_p50']:.3f} ms, p95 {r['itl_p95']:.3f} ms; steps by kind: {ticks}; decode tick "
          f"ms (median, host clock to its readback): {dec}; graph captured in "
          f"{r['capture_s']:.3f} s, {r['nodes']} nodes; launches {r['counts']}{extra}")


def phase_serving(dev, cfg, params):
    """The serving engines at LLaMa-2-7B width, weights from phase 3's bf16
    ones: (a) ScheduledBatchEngine at bench_serving.py's configuration (the
    int4 arithmetic fused tree, quantized on the card, int8 KV; decode ticks
    through K15 at B=8); (b) ScheduledBatchEngine with bf16 weights, bf16
    and then int8 KV, SMALL_SLOTS slots, SMALL_REQS requests, greedy, roco
    at budget 64; (c) ContinuousBatchEngine, bf16 KV, (b)'s requests,
    replayed and then eager (flags.eager_decode_loop): equal tokens and
    bit-identical final cache arrays. serve()'s checks on every run, and
    each tick kind's exact launches."""
    L = cfg.num_hidden_layers
    runs = {}
    t0 = time.perf_counter()
    qparams = quant_mod.fuse_gemv_params(quant_mod.quantize_params_int4(params, layout="arith"))
    torch.cuda.synchronize()
    print(f"phase 3: serving (a): int4 arith fused tree quantized on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    model = easykv_tpu_torch.CausalLM(cfg, qparams, device=dev, kv_quant=True)
    eng = serving_sched.ScheduledBatchEngine(
        model, batch_slots=SERVE_SLOTS, max_prompt=SERVE_MAX_PROMPT, budget=BUDGET,
        kv_policy="roco", temperature=1.0, top_p=0.95, prefill_chunk=CHUNK, seed=0)
    r = serve(eng, serving_prompts(SERVE_REQS, cfg.vocab_size, 0), SERVE_NEW,
              want_dec=zero_counts(K15=1, K13=1, K2=1, **{"K2 rows": 1}),
              want_merged=zero_counts(K5=L, K4=1))
    serving_line("(a) scheduled, int4 arith fused, int8 KV, B=8, roco b=200, T=1.0 top_p 0.95",
                 r)
    runs["serving (a)"] = r
    del eng, model, qparams
    torch.cuda.empty_cache()
    prompts = serving_prompts(SMALL_REQS, cfg.vocab_size, 1)
    kw = dict(batch_slots=SMALL_SLOTS, max_prompt=SERVE_MAX_PROMPT, budget=SMALL_BUDGET,
              kv_policy="roco", temperature=1e-9, top_p=1.0, prefill_chunk=CHUNK, seed=0)
    want_dec = zero_counts(K1=L, K2=1, **{"K2 rows": 1})
    for kv in ("bf16", "int8"):
        model = easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8")
        r = serve(serving_sched.ScheduledBatchEngine(model, **kw), prompts, SERVE_NEW,
                  want_dec=want_dec, want_merged=zero_counts(K5=L if kv == "int8" else 0, K4=1))
        serving_line(f"(b) scheduled, bf16 weights, {kv} KV, B={SMALL_SLOTS}, roco "
                     f"b={SMALL_BUDGET}, greedy", r)
        runs[f"serving (b) {kv} KV"] = r
    model = easykv_tpu_torch.CausalLM(cfg, params, device=dev)
    twin = {}
    for eager in (False, True):
        eng = serving_engine.ContinuousBatchEngine(model, **kw)
        with flags.eager_decode_loop() if eager else contextlib.nullcontext():
            twin[eager] = (serve(eng, prompts, SERVE_NEW, want_dec=want_dec), eng.cache)
    (rg, cg), (re_, ce) = twin[False], twin[True]
    diff = [f.name for f in dataclasses.fields(KVCache)
            if getattr(cg, f.name) is not None
            and not same_bits(getattr(cg, f.name), getattr(ce, f.name))]
    serving_line(f"(c) continuous, bf16 weights, bf16 KV, B={SMALL_SLOTS}, roco "
                 f"b={SMALL_BUDGET}, greedy, replayed", rg,
                 f"; its eager twin: {re_['tok_s']:.2f} tok/s, decode tick ms {re_['dec_ms']}, "
                 f"tokens equal {rg['outs'] == re_['outs']}, final cache bit-identical "
                 f"{not diff}" + (f" but for {diff}" if diff else ""))
    check(rg["nodes"] > 0 and re_["nodes"] == 0, "serving (c): replayed / eager twin graphs")
    check(rg["outs"] == re_["outs"] and not diff,
          f"serving (c): the replayed decode tick differs from the eager one in {diff}")
    runs["serving (c)"], runs["serving (c) eager"] = rg, re_
    del twin, model
    torch.cuda.empty_cache()
    return runs


def continuous_run(model, prompts, new, **kw):
    """ContinuousBatchEngine's outputs, final cache and decode graph nodes."""
    eng = submitted(serving_engine.ContinuousBatchEngine(model, **kw), prompts, new)
    return eng.run_all(), eng.cache, eng.decode_tick.nodes


def scheduled_outputs(model, prompts, new, snapshot_after=None, path=None, **kw):
    """ScheduledBatchEngine's outputs; with snapshot_after = n, the engine is
    snapshotted to `path` after n ticks, dropped, and resumed into a new
    engine, which finishes the run."""
    eng = submitted(serving_sched.ScheduledBatchEngine(model, **kw), prompts, new)
    if snapshot_after is None:
        return eng.run_all()
    for _ in range(snapshot_after):
        eng.tick()
    replays = eng.decode_tick.replays
    eng.snapshot(path)
    del eng
    return serving_sched.ScheduledBatchEngine.resume(path, model, **kw).run_all(), replays


def phase_plain_vs_kernel_serving(dev, cfg, params):
    """Phase 4's serving checks at full width, L=2, f32 weights, f32 and int8
    KV, (b)'s and (c)'s requests cut to 32 new tokens and budget 8 (so
    every row evicts): ScheduledBatchEngine and ContinuousBatchEngine
    through the kernels against the same engines with plain_kernels(),
    equal tokens; a sampled (T=1.0, top_p 0.95) ScheduledBatchEngine
    snapshotted after 24 ticks (requests decoding, some waiting; its decode
    tick already replayed) and resumed gives the uninterrupted run's
    outputs."""
    prompts = serving_prompts(SMALL_REQS, cfg.vocab_size, 1)
    new = 32
    kw = dict(batch_slots=SMALL_SLOTS, max_prompt=SERVE_MAX_PROMPT, budget=8,
              kv_policy="roco", temperature=1e-9, top_p=1.0, prefill_chunk=CHUNK, seed=0)
    for kv in ("f32", "int8"):
        model = easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8")
        for name, run in (("scheduled", lambda: scheduled_outputs(model, prompts, new, **kw)),
                          ("continuous", lambda: continuous_run(model, prompts, new, **kw)[0])):
            reset_counts()
            kern = run()
            c = counts()
            with plain_kernels():
                plain = run()
            print(f"phase 4: full width L=2 f32 weights, {kv} KV, serving {name}, "
                  f"{SMALL_SLOTS} slots, {len(prompts)} requests, roco b=8, {new} tokens: kernel "
                  f"path against plain path tokens equal {kern == plain}; launches {c}")
            check(kern == plain, f"serving {name} {kv} KV: kernel path and plain path disagree")
            check(c["K1"] > 0 and c["K2"] > 0 and (c["K4"] > 0) == (name == "scheduled")
                  and (c["K5"] > 0) == (kv == "int8"), f"serving {name}: launches {c}")
        sampled = dict(kw, temperature=1.0, top_p=0.95, seed=7)
        with tempfile.TemporaryDirectory() as tmp:
            path = f"{tmp}/engine.snap"
            whole = scheduled_outputs(model, prompts, new, **sampled)
            resumed, replays = scheduled_outputs(model, prompts, new, 24, path, **sampled)
        print(f"phase 4: full width L=2 f32 weights, {kv} KV, serving scheduled sampled (T=1.0, "
              f"top_p 0.95): snapshot after 24 ticks ({replays} decode ticks replayed) and "
              f"resume against the uninterrupted run: outputs equal {resumed == whole}")
        check(replays > 0 and resumed == whole, f"serving {kv} KV: snapshot / resume differs")
        del model


# ---------------------------------------------------------------------------
# phase 6: the 7B-width tree through disk: an HF checkpoint, the loader, the
# native checkpoint, the CLI
# ---------------------------------------------------------------------------

HF_SHARDS = 3                  # model-0000{1,2,3}-of-00003.safetensors, as a 7B release ships
CLI_GENERATE = ["generate", "--mode", "decoding", "--max-new-tokens", "16", "--budget", "8"]
INT4_OVER_LIMIT = 3e9          # the int4 load's peak device bytes over the tree it returns


def hf_config_json(cfg):
    """config.json with HF's keys, as LlamaForCausalLM's config writes them."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads, "head_dim": cfg.head_dim,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_word_embeddings, "torch_dtype": "bfloat16"}


def write_hf_checkpoint(path, cfg, params, shards=HF_SHARDS):
    """A plain tree as an HF checkpoint in `path`: HF names, (out, in), the
    tree's dtype, the layers split over `shards` files (the embedding in the
    first, the norm and head in the last), the index and config.json.
    Returns the bytes of the tensor files."""
    sd = hf_mod.hf_state_dict(params)
    L = cfg.num_hidden_layers
    groups = [[k for k in sd if k.startswith("model.layers.")
               and s * L // shards <= int(k.split(".")[2]) < (s + 1) * L // shards]
              for s in range(shards)]
    groups[0].insert(0, "model.embed_tokens.weight")
    groups[-1] += [k for k in ("model.norm.weight", "lm_head.weight") if k in sd]
    weight_map, total = {}, 0
    for s, names in enumerate(groups):
        fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
        total += save_safetensors(os.path.join(path, fname), {k: sd[k] for k in names},
                                  {"format": "pt"})
        weight_map.update({k: fname for k in names})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_json(cfg), f)
    return total


def tree_bytes(params):
    return sum(t.numel() * t.element_size() for t in ckpt_mod._flat(params).values())


def trees_identical(a, b):
    """a and b hold the same leaves under the same names, dtypes, shapes and
    bits."""
    fa, fb = ckpt_mod._flat(a), ckpt_mod._flat(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape
        and torch.equal(fa[k].contiguous().view(torch.uint8), fb[k].contiguous().view(torch.uint8))
        for k in fa)


def measured(dev, fn):
    """(fn()'s result, its seconds, its peak device bytes over what it
    leaves allocated, the bytes it leaves allocated)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    held = torch.cuda.memory_allocated(dev) - base
    return out, secs, torch.cuda.max_memory_allocated(dev) - base - held, held


def loaded_decode(dev, cfg, params, kv, run, runs):
    """Phase 3's run `run` (the 512-token prompt, 384 new tokens, roco at
    budget 200, greedy) again on a tree loaded from disk: the same tokens
    and launch counts; tok/s beside phase 3's."""
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(1, cfg.vocab_size, (B_WIDE, PROMPT), generator=g)[0].tolist()
    gc = dict(budget=BUDGET, kv_policy="roco", max_new_tokens=NEW, temperature=1e-9,
              top_p=1.0, eos_token_ids=[], seed=0)
    model = easykv_tpu_torch.enable_fixed_kv(
        easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8"), None,
        "decoding")
    with contextlib.redirect_stdout(io.StringIO()):
        model.easykv_generate(prompt, dict(gc, max_new_tokens=8))       # warm-up
        reset_counts()
        out = model.easykv_generate(prompt, gc)
    c = counts()
    st = model.last_run
    tok_s = st.n_tokens / st.decode_s
    want = runs[run]
    print(f"phase 6: decode from the loaded tree, {run} ({kv} KV): {tok_s:.2f} tok/s against "
          f"phase 3's {want['tok_s']:.2f} ({graph_note(run, st)}); tokens equal "
          f"{out == want['tokens']}, launches equal {c == want['counts']}: {c}")
    check(out == want["tokens"], f"phase 6 {run}: the loaded tree's tokens differ from phase 3's")
    check(c == want["counts"], f"phase 6 {run}: launches {c}, phase 3 {want['counts']}")


def cli_run(argv):
    """`python3 -m easykv_tpu_torch argv` from the repository's root:
    (its stdout, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "easykv_tpu_torch", *argv],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"CLI {argv[0]} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout, time.perf_counter() - t0


def phase_loading(dev, runs):
    """Phase 3's bf16 LLaMa-2-7B tree (seed 0) written to disk as a 3-shard
    HF checkpoint and read back through the port's own reader: bf16, int4
    and int8 loads bit-identical to their in-memory twins, the int4 load's
    peak device memory over its tree within INT4_OVER_LIMIT, phase 3's
    decode tokens and launches from the loaded bf16 and int4 fused trees, a
    save_checkpoint / load_checkpoint round trip of the int4 fused tree, and
    the CLI's info, generate and ppl as subprocesses."""
    cfg = LLAMA2_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="easykv_hf_") as root:
        hf_dir, native_dir = os.path.join(root, "hf"), os.path.join(root, "native")
        os.makedirs(hf_dir)
        free = shutil.disk_usage(root).free
        need = tree_bytes(params)
        print(f"phase 6: {root}: {free / 1e9:.2f} GB free; the bf16 tree is {need / 1e9:.3f} GB")
        check(free > 1.4 * need, f"phase 6: {free / 1e9:.2f} GB free under {root}, "
              f"{1.4 * need / 1e9:.2f} GB needed")
        t0 = time.perf_counter()
        written = write_hf_checkpoint(hf_dir, cfg, params)
        secs = time.perf_counter() - t0
        print(f"phase 6: (a) HF checkpoint, {HF_SHARDS} shards: {written} bytes written in "
              f"{secs:.2f} s ({written / secs / 1e9:.2f} GB/s from the card to the files)")

        (lcfg, bf16), secs, over, held = measured(dev, lambda: hf_mod.load_hf_checkpoint(
            hf_dir, device=dev))
        same = trees_identical(bf16, params)
        print(f"phase 6: (b) load_hf_checkpoint bf16: {secs:.2f} s, {written / secs / 1e9:.2f} "
              f"GB/s; tree {held / 1e9:.3f} GB, peak {over / 1e9:.3f} GB over it; "
              f"bit-identical {same}")
        check(lcfg == cfg and same, "phase 6: the loaded bf16 tree differs from the drawn one")

        trees = {}
        for mode, make in (("int4", lambda p: quant_mod.quantize_params_int4(p, layout="arith")),
                           ("int8", quant_mod.quantize_params)):
            twin, q_secs, q_over, q_held = measured(dev, lambda: make(params))
            twin = quant_mod.fuse_gemv_params(twin)
            (_, tree), secs, over, held = measured(dev, lambda: hf_mod.load_hf_checkpoint(
                hf_dir, quantize=mode, device=dev))
            tree = quant_mod.fuse_gemv_params(tree)
            same = trees_identical(tree, twin)
            print(f"phase 6: (c) load_hf_checkpoint quantize={mode!r}: {secs:.2f} s; tree "
                  f"{held / 1e9:.3f} GB, peak {over / 1e9:.3f} GB over it; in-memory quantize of "
                  f"the bf16 tree {q_secs:.2f} s, peak {q_over / 1e9:.3f} GB over its "
                  f"{q_held / 1e9:.3f} GB; fused, bit-identical {same}")
            check(same, f"phase 6: the {mode} load differs from the in-memory quantized tree")
            if mode == "int4":
                check(over <= INT4_OVER_LIMIT, f"phase 6: the int4 load peaked {over / 1e9:.3f} "
                      f"GB over its tree, limit {INT4_OVER_LIMIT / 1e9:.1f}")
            trees[mode] = tree
            del twin
        del params, trees["int8"]
        torch.cuda.empty_cache()

        loaded_decode(dev, cfg, bf16, "bf16", "bf16 roco", runs)
        loaded_decode(dev, cfg, trees["int4"], "int8", "int4 arith fused roco", runs)

        t0 = time.perf_counter()
        n = ckpt_mod.save_checkpoint(native_dir, cfg, trees["int4"])
        save_s = time.perf_counter() - t0
        (ccfg, back), secs, _, _ = measured(dev, lambda: ckpt_mod.load_checkpoint(
            native_dir, device=dev))
        same = trees_identical(back, trees["int4"])
        print(f"phase 6: (e) save_checkpoint of the int4 fused tree: {n} bytes in {save_s:.2f} s; "
              f"load_checkpoint {secs:.2f} s; config equal {ccfg == cfg}, bit-identical {same}")
        check(ccfg == cfg and same, "phase 6: the checkpoint round trip differs")
        del back, trees

        args = cli.parser().parse_args(CLI_GENERATE + ["--model", hf_dir])
        args.device = dev
        model = easykv_tpu_torch.CausalLM(lcfg, bf16, tokenizer=cli.load_tokenizer(hf_dir),
                                          device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            want_ids, want_ppl = (cli.run_generate(model, args),
                                  cli.run_ppl(model, cli.parser().parse_args(["ppl"])))
        del model, bf16
        torch.cuda.empty_cache()
        out, secs = cli_run(["info", "--model", hf_dir])
        info = json.loads(out)
        print(f"phase 6: (f) CLI info: {secs:.1f} s, {info}")
        check(info == dataclasses.asdict(cfg), "phase 6: CLI info differs from the config")
        out, secs = cli_run(CLI_GENERATE + ["--model", hf_dir])
        print(f"phase 6: (f) CLI {' '.join(CLI_GENERATE)}: {secs:.1f} s, printed "
              f"{out.strip().splitlines()}")
        check(out.strip().splitlines()[-1] == str(want_ids),
              f"phase 6: the CLI's tokens differ from the same call in-process, {want_ids}")
        out, secs = cli_run(["ppl", "--model", hf_dir])
        ppl = float(re.findall(r"ppl: (\S+)", out)[-1])
        print(f"phase 6: (f) CLI ppl: {secs:.1f} s, ppl {ppl} (in-process {want_ppl:.4f})")
        check(math.isfinite(ppl) and f"{ppl:.4f}" == f"{want_ppl:.4f}",
              "phase 6: the CLI's ppl is not the in-process one")


# ---------------------------------------------------------------------------
# phase 7: tensor / data parallelism over a (data, model) mesh of ranks
# ---------------------------------------------------------------------------

TP_NEW = 256                 # new tokens of (a) and (b): 56 steps past the budget of 200
EXACT_NEW = 32               # (c)'s new tokens (phase 4's)
EXACT_ENC_PROMPT = 1056      # (c)'s encoding prompt: 11 chunks of the stride
MESH_TIMEOUT = 900           # seconds a phase-7 group may take, and a collective may wait
LOGIT_LIMIT = 1e-3           # (c), f32 KV: max |logits - one-process'| / max |one-process'|
WRAP_SETS = 32               # (d): argument sets cycled in a timing (phase 5's 32 layers)
SHARDED_META = {  # key: (wrapper, its kernel's source, the TPU wrapper it replaces)
    "K1s": ("fused_decode_attend_inflight_sharded", "easykv_tpu_torch/csrc/decode_attention.cu",
            "easykv_tpu/ops/pallas/decode_attention.py:338"),
    "K2s": ("fused_write_update_sharded", "easykv_tpu_torch/csrc/sidecar_update.cu",
            "easykv_tpu/ops/pallas/sidecar_update.py:360"),
    "K4s": ("fused_evict_sharded", "easykv_tpu_torch/csrc/sidecar_update.cu",
            "easykv_tpu/ops/pallas/sidecar_update.py:472"),
    "K5s": ("fused_chunk_attend_sharded", "easykv_tpu_torch/csrc/chunk_attention.cu",
            "easykv_tpu/ops/pallas/chunk_attention.py:348"),
    "K6s": ("fused_chunk_write_attend_sharded", "easykv_tpu_torch/csrc/chunk_attention.cu",
            "easykv_tpu/ops/pallas/chunk_attention.py:844"),
    "K7s": ("fused_chunk_step_sharded", "easykv_tpu_torch/csrc/chunk_attention.cu",
            "easykv_tpu/ops/pallas/chunk_attention.py:1199"),
    # K9 on a shard: the JAX package shifts and rotates in XLA under a mesh
    # (engine/generate.py:694-723 there); the port launches K9 on the shard
    "K9s": ("fused_kv_compact_sharded", "easykv_tpu_torch/csrc/kv_compact.cu",
            "easykv_tpu/ops/pallas/sidecar_update.py:801"),
}


class RankFailure(Exception):
    pass


def need(cond, msg):
    """check() inside a rank: the rank reports the failure to phase 7."""
    if not cond:
        raise RankFailure(msg)


def rank_main(rank, world, data, model, backend, tmp, job, ctx):
    """One rank of a phase-7 or phase-8 group: joins the group's process
    group (a file:// rendezvous in `tmp`), makes the (data, model) mesh on
    card rank % device_count() (data = 0: the sequence-parallel mesh over
    all `world` ranks, mc None), runs JOBS[job] and pickles what it found
    (and any failure, with the end of what the job printed) to
    tmp/rank{rank}.pkl for the parent."""
    out = {"lines": []}
    printed = io.StringIO()
    try:
        parallel_mod.init_distributed(backend, "file://" + os.path.join(tmp, "rendezvous"),
                                      world, rank, timeout_s=MESH_TIMEOUT)
        if data:
            mc = MeshConfig(data, model)
            mesh = parallel_mod.make_mesh(mc, "cuda")
        else:
            mc, mesh = None, parallel_mesh.make_sp_mesh("cuda")
        out["device"] = str(mesh.device)
        with contextlib.redirect_stdout(printed):
            JOBS[job](mesh, mc, ctx, out)
    except BaseException:  # noqa: BLE001 - every failure goes back to the parent
        out["error"] = printed.getvalue()[-2000:] + traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if "error" in out:
        os._exit(1)      # the other ranks' collectives then fail instead of waiting


def spawn_ranks(job, data, model, ctx):
    """JOBS[job] on a (data, model) mesh of data * model spawned ranks (data
    = 0: an sp mesh of `model` ranks): NCCL when the machine has a card a
    rank, else gloo (several ranks a card; NCCL refuses that). Returns
    (backend, each rank's results); a rank that fails fails the phase."""
    world = data * model or model
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    mp = importlib.import_module("multiprocessing").get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="easykv_mesh_") as tmp:
        ctx = dict(ctx, tmp=tmp)
        procs = [mp.Process(target=rank_main, args=(r, world, data, model, backend, tmp, job,
                                                     ctx)) for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + MESH_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.time()))
        res = []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
            path = os.path.join(tmp, f"rank{r}.pkl")
            check(os.path.exists(path), f"phase 7 {job}: rank {r} left no result "
                  f"(exit code {p.exitcode})")
            with open(path, "rb") as f:
                res.append(pickle.load(f))
        for r, x in enumerate(res):
            if "error" in x:
                print(f"phase 7 {job}: rank {r}'s results before it failed: "
                      f"{ {k: v for k, v in x.items() if k != 'error'} }"[:6000])
            check("error" not in x, f"phase 7 {job} ({data}, {model}): rank {r} failed:\n"
                  f"{x.get('error', '')[-4000:]}")
    return backend, res


def local(t, spec, mesh):
    """This rank's shard of a global tensor under spec."""
    return parallel_sharding._shard(t, spec, mesh, t.device)


def gathered(t, mesh, mc, hdim):
    """The global tensor from every rank's shard: rows (dim hdim - 1) over
    data, heads (dim hdim) over model."""
    t = parallel_mesh.all_gather_cat(t, mesh, mc.axis_model, hdim)
    return parallel_mesh.all_gather_cat(t, mesh, mc.axis_data, hdim - 1)


def bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def float_ok(got, ref):
    """A float output of a kernel whose launch plan differs between the
    shard and the whole (its sums run in another order): bf16 within one
    ulp of the reference value plus 1e-3 (k1_out_limit), f32 within 1e-5 of
    max(1, max |ref|)."""
    err = (got.float() - ref.float()).abs()
    if ref.dtype == torch.bfloat16:
        return bool((err <= k1_out_limit(ref)).all())
    return err.max().item() <= 1e-5 * max(1.0, ref.float().abs().max().item())


# the sharded wrappers' cases at 7B width: per wrapper, the arguments'
# specs (a string a dimension: d, m, or . for whole), the outputs' head dim,
# and the inputs it changes in place
WRAP_SPECS = {
    "K1s": (("dm..",) * 5 + ("dm.", "d"), 1),
    "K2s": ((".dm.",) * 6 + ("d",) * 4, 2),
    "K4s": ((".dm.",) * 4 + ("d",) * 4, 2),
    "K5s": (("dm..",) * 3 + ("dm.", "d.", "dm.", "dm."), 1),
    "K6s": (("dm..",) * 3 + ("dm.", "d.", "d.", "dm..", "dm..") + ("dm.",) * 6, 1),
    "K7s": (("dm..",) * 3 + ("dm.", "d.", "d.", "d", "d", "d", "d", "dm..", "dm..")
            + ("dm.",) * 6, 1),
    "K9s": ((".dm..", ".dm..", ".dm"), 2),
}
K2_ROWS_SPEC = ".dm.."


def _spec(code, mc):
    return tuple({"d": mc.axis_data, "m": mc.axis_model, ".": None}[c] for c in code)


def wrapper_calls(dev, mesh, mc):
    """Per sharded wrapper: (unsharded kernel call, sharded call, plain
    call) taking one argument set, the global sets at phase 5's shapes
    (phase 3's decode at B = 1, S = 768; the int8 prefill's chunk; the int8
    `encoding` run's triggered chunk at S = 2304), the sets of the shape
    where the shard's launch plan equals the whole's (K1 at B = 8; K5, K6
    and K7 with f32 queries, one attention run; K2 and K4 plan by S
    alone), reps for the timings, whether the plans at phase 5's shape
    coincide, and a restore for the calls that change their inputs."""
    kw = dict(mesh=mesh, data_axis=mc.axis_data, model_axis=mc.axis_model)
    st = enc_step_statics("roco")
    H, D = 32, 128
    cases = {}
    # K1: phase 5's sets (32 layers' bf16 cache cycled)
    _, _, sets, _, lib, _, _, _ = next(k1_time_cases(dev, ("K1",)))
    wide = [tuple(a.repeat(8, *([1] * (a.dim() - 1))) for a in s[:7]) for s in sets[:2]]
    same = (da_mod.split_plan(1, H, 1, S_MAIN, D, "bf16")
            == da_mod.split_plan(1, H // mc.model, 1, S_MAIN, D, "bf16"))
    cases["K1s"] = dict(kernel=lambda *a: k1(*a), sharded=lambda *a: k1s(*a, **kw),
                        plain=lambda *a: k1_plain(*a), sets=sets, exact_sets=wide,
                        reps=(320, 64), same_plan=same, lib=lib)
    # K2: roco unfolded (no espec: the mesh's K2), given the step's bf16 rows
    copies, run, nbytes, flops = k2_time_sets(dev, 1, S_MAIN, "bf16", rows=True)
    k2_sets = []
    for state, per_b, kwargs in copies:
        rows = {k: kwargs[k] for k in ("k", "v", "kn", "vn")}
        k2_sets.append(tuple(state) + tuple(per_b.values()) + tuple(rows[k] for k in
                                                                     ("k", "v", "kn", "vn")))

    def k2_call(fn):
        return lambda *a: fn(*a[:10], "roco", k=a[10], v=a[11], kn=a[12], vn=a[13])
    cases["K2s"] = dict(kernel=k2_call(k2), sharded=k2_call(lambda *a, **k: k2s(*a, **k, **kw)),
                        plain=k2_call(k2_plain), sets=k2_sets, exact_sets=None, reps=(64, 8),
                        same_plan=True, bound=(nbytes, flops, F32_FLOPS))
    # K4: roco, the gate on (phase 5's sets)
    k4_sets, _, _ = k4_time_sets(dev, 1, S_MAIN)
    spec = k4_sets[0][8]
    cases["K4s"] = dict(kernel=lambda *a: k4(*a[:8], spec),
                        sharded=lambda *a: k4s(*a[:8], spec=spec, **kw),
                        plain=lambda *a: k4_plain(*a[:8], spec), sets=[s[:8] for s in k4_sets],
                        exact_sets=None, reps=(32, 8), same_plan=True)
    # K5: the int8 prefill's last chunk (phase 5's sets), no statistics
    k5_sets = [k5_case(1, H, H, PROMPT, torch.bfloat16, True, False, dev, 90 + l)
               for l in range(WRAP_SETS)]
    k5_f32 = [k5_case(1, H, H, PROMPT, torch.float32, True, False, dev, 95 + l)
              for l in range(2)]
    same = (chunk_mod.attend_splits(1, H, 1, CHUNK, S_MAIN)
            == chunk_mod.attend_splits(1, H // mc.model, 1, CHUNK, S_MAIN))
    cases["K5s"] = dict(kernel=lambda *a: k5(*a, need_scores=False),
                        sharded=lambda *a: k5s(*a, need_scores=False, **kw),
                        plain=lambda *a: k5_plain(*a, need_scores=False), sets=k5_sets,
                        exact_sets=k5_f32, reps=(64, 16), same_plan=same)
    # K6: the int8 `encoding` run's triggered chunk (phase 5's sets)
    k6_sets = [k6_case(1, H, H, torch.bfloat16, True, True, True, dev, 130 + l)
               for l in range(WRAP_SETS)]
    k6_f32 = [k6_case(1, H, H, torch.float32, True, True, True, dev, 135 + l) for l in range(2)]
    same = (chunk_mod.attend_splits(1, H, 1, STRIDE, ENC_S)
            == chunk_mod.attend_splits(1, H // mc.model, 1, STRIDE, ENC_S))
    cases["K6s"] = dict(kernel=lambda *a: k6(*a), sharded=lambda *a: k6s(*a, **kw),
                        plain=lambda *a: k6_plain(*a), sets=k6_sets, exact_sets=k6_f32,
                        reps=(32, 8), same_plan=same)
    # K7: roco at that chunk, gates on (phase 5's sets), each call from its
    # untouched state
    k7_sets = [list(k7_case(1, H, H, "int8", [(True, True)], dev, 330 + l))
               for l in range(WRAP_SETS)]
    k7_f32 = [list(k7_case(1, H, H, "int8", [(True, True)], dev, 335 + l, dtype=torch.float32))
              for l in range(2)]
    cases["K7s"] = dict(kernel=lambda *a: k7(*a, policy="roco", **st),
                        sharded=lambda *a: k7s(*a, policy="roco", **st, **kw),
                        plain=lambda *a: k7_plain(*a, policy="roco", **st), sets=k7_sets,
                        exact_sets=k7_f32, reps=(32, 32), same_plan=same, restore_from=10)
    # K9 (rotate): phase 5's bf16 set (the pre-rotated decode cache, victims
    # among the generated tokens); its launch plan depends on the row alone
    L, _, S, _ = STREAM_SHAPE
    shift = shift_rotation(rope_inv_freq(D, LLAMA2_7B.rope_theta, dev))
    kvr = kv_rows(L, 1, H, S, D, "bf16", dev, 191)
    k9_sets = [(kvr[0], kvr[1], stream_victims(L, 1, H, S, dev, 192))]
    cases["K9s"] = dict(kernel=lambda *a: k9(*a, rot=shift),
                        sharded=lambda *a: k9s(*a, rot=shift, **kw),
                        plain=lambda *a: k9_plain(*a, rot=shift), sets=k9_sets,
                        exact_sets=None, reps=(64, 8), same_plan=True)
    return cases


def restorer(sets, i0):
    """For calls that change sets' arguments from index i0 on in place (K7):
    a function that puts them back (graph_ms's restore); None for i0 None."""
    if i0 is None:
        return None
    pristine = [[a.clone() for a in x[i0:]] for x in sets]

    def restore():
        for x, p in zip(sets, pristine):
            for a, b in zip(x[i0:], p):
                a.copy_(b)
    return restore


def sdpa_ms(sets, at):
    """The library yardstick of K5 / K6 on these sets (phase 5's): one
    scaled_dot_product_attention over a bf16 copy of the int8 cache (K, V
    and their scales at sets[at], [at + 1], [-2], [-1]) dequantized
    beforehand, with the same mask; K6's sets already hold the written
    chunk."""
    deq = [(a[0], (a[at].float() * a[-2][..., None]).to(torch.bfloat16),
            (a[at + 1].float() * a[-1][..., None]).to(torch.bfloat16),
            (a[at + 2][:, :, None, :] >= 0)
            & (a[at + 2][:, :, None, :] <= a[4][:, None, :, None])) for a in sets]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return graph_ms(lambda q_, k_, v_, m_: sdpa(q_, k_, v_, attn_mask=m_), deq, 64)


def _outputs(res, args, key):
    """A wrapper's outputs as a flat list: its results, then the inputs it
    changes in place (K2's k and v rows, K6's and K7's cache arrays)."""
    if key == "K7s":
        o, arrs, wm = res
        return [o, *arrs, wm]
    res = list(res) if isinstance(res, (tuple, list)) else [res]
    if key == "K2s":
        return res[:5] + list(args[10:12])
    if key == "K6s":
        return res + list(args[6:])
    return res


def _compare(case, key, args, mesh, mc, hdim, specs):
    """The sharded call on this rank's shards, gathered, against the
    unsharded kernel on copies of the global args: (max |err|, bits equal,
    floats within the limit, integers equal)."""
    ref_args = [a.clone() for a in args]
    mine = [local(a, _spec(s, mc), mesh) for a, s in zip(args, specs)]
    got = _outputs(case["sharded"](*mine), mine, key)
    ref = _outputs(case["kernel"](*ref_args), ref_args, key)
    err, bits, floats, ints = 0.0, True, True, True
    for g, r in zip(got, ref):
        if g is None:
            continue
        full = gathered(g, mesh, mc, hdim)
        bits &= bits_equal(full, r)
        if r.is_floating_point():
            err = max(err, (full.float() - r.float()).abs().max().item())
            floats &= float_ok(full, r)
        else:
            ints &= torch.equal(full, r)
    return err, bits, floats, ints


def sharded_wrappers(mesh, mc, out):
    """(d): each sharded wrapper at 7B width against the unsharded launch of
    its kernel on the same global inputs, each rank's outputs gathered:
    bit-identical where the shard's launch plan is the whole's (always at
    the plan-coincident shape), else floats within float_ok and integers
    equal (K7's victims follow its statistics, so only bits at the
    plan-coincident shape). Rank 0 then times the sharded call on its shard
    (graph_ms, as phase 5), the plain version on the shard and the
    unsharded kernel on the global sets, while the other ranks wait."""
    dev = mesh.device
    rec = {}
    for key, case in wrapper_calls(dev, mesh, mc).items():
        specs, hdim = WRAP_SPECS[key]
        if key == "K2s":
            specs = specs + (K2_ROWS_SPEC,) * 4
        err, bits, floats, ints = _compare(case, key, case["sets"][0], mesh, mc, hdim, specs)
        if case["same_plan"]:
            need(bits, f"{key} at phase 5's shape (the same launch plan): not bit-identical, "
                 f"max |err| {err:.3e}")
        else:
            need(floats and (ints or key == "K7s"), f"{key}: floats within the limit {floats}, "
                 f"integers equal {ints}, max |err| {err:.3e}")
        exact_bits = True
        for s in case["exact_sets"] or ():
            e2, b2, _, _ = _compare(case, key, s, mesh, mc, hdim, specs)
            exact_bits &= b2
            need(b2, f"{key} at the plan-coincident shape: not bit-identical ({e2:.3e})")
        rec[key] = dict(max_abs_err=err, bits=bits, same_plan=case["same_plan"],
                        exact_bits=exact_bits if case["exact_sets"] else None)
        if mesh.rank == 0:
            mine = [[local(a, _spec(s, mc), mesh) for a, s in zip(args, specs)]
                    for args in case["sets"]]
            i0 = case.get("restore_from")
            restore, restore_whole = restorer(mine, i0), restorer(case["sets"], i0)
            reps, plain_reps = case["reps"]
            n = len(mine) if i0 else reps
            rec[key].update(
                ms=graph_ms(case["sharded"], mine, n, restore),
                plain_ms=graph_ms(case["plain"], mine, n if i0 else plain_reps, restore),
                whole_ms=graph_ms(case["kernel"], case["sets"], n, restore_whole),
                library_ms=(k1_library_ms([m_[:7] for m_ in mine], False) if key == "K1s"
                            else sdpa_ms(mine, 6 if key == "K6s" else 1)
                            if key in ("K5s", "K6s") else None))
            if "bound" in case:
                nbytes, flops, peak = case["bound"]
                t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
                rec[key]["whole_bound"] = (max(t_b, t_o), "bytes" if t_b >= t_o else "operations")
            del mine
        parallel_mesh.barrier(mesh)
        del case
        torch.cuda.empty_cache()
    out["wrappers"] = rec


def mesh_decode(mesh, mc, ctx, out, kvs, B):
    """(a) / (b): phase 3's decode (its 512-token prompt, or its B = 4
    prompts, roco at budget 200, greedy) for TP_NEW new tokens through
    generate() under the mesh, on this rank's shards of the LLaMa-2-7B bf16
    tree drawn from seed 0, for each KV cache dtype in kvs. Per rank: tok/s,
    prefill s, peak memory, launches (exact: 32 K1 on Hkv / m local heads, one
    K2 unfolded with the rows, one K4 a step, K14 / K15 never, 128 K5 with
    int8 KV, each through its sharded wrapper), and the final cache (every
    (layer, row, head) holds the prompt and 200 generated tokens)."""
    dev, cfg, L = mesh.device, LLAMA2_7B, LLAMA2_7B.num_hidden_layers
    full = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    sp = parallel_mod.shard_params(full, cfg, mc, mesh)
    del full
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(0)
    prompts = torch.randint(1, cfg.vocab_size, (B_WIDE, PROMPT), generator=g)
    ids = prompts[0].tolist() if B == 1 else prompts[:B].numpy()
    gc = dict(budget=BUDGET, kv_policy="roco", max_new_tokens=TP_NEW, temperature=1e-9,
              top_p=1.0, eos_token_ids=[], seed=0)
    flags.set_active_mesh(mesh, mc.axis_data, mc.axis_model)
    res = {}
    try:
        for kv in kvs:
            model = easykv_tpu_torch.CausalLM(cfg, sp, device=dev, kv_quant=kv == "int8")
            easykv_tpu_torch.generate(model, ids, dict(gc, max_new_tokens=8), kv_mode="decoding")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            with engine_caches() as made:
                toks = easykv_tpu_torch.generate(model, ids, gc, kv_mode="decoding")
            c = counts()
            st = model.last_run
            cache = made[-1]
            Bl = cache.pos.shape[1]
            n_k5 = L * PROMPT // CHUNK if kv == "int8" else 0
            want = zero_counts(K1=L * TP_NEW, K1s=L * TP_NEW, K2=TP_NEW, K2s=TP_NEW,
                               **{"K2 rows": TP_NEW}, K4=TP_NEW, K4s=TP_NEW, K5=n_k5, K5s=n_k5)
            need(c == want, f"{kv} B={B}: launches {c}, want {want}")
            need(tuple(cache.pos.shape) == (L, B // mc.data, cfg.num_key_value_heads // mc.model,
                                            S_MAIN),
                 f"{kv}: the rank's cache is {tuple(cache.pos.shape)}")
            kept = (cache.pos >= PROMPT).sum(-1)
            need(bool((kept == BUDGET).all()) and bool(((cache.pos >= 0).sum(-1)
                                                        == PROMPT + BUDGET).all()),
                 f"{kv}: generated tokens kept per (layer, row, head) {kept.unique().tolist()}")
            need(len(toks) == TP_NEW and st.logits_finite, f"{kv}: bad output / NaN logits")
            need(st.graph_nodes == 0 or mesh.backend == "nccl",
                 f"{kv}: a gloo step was captured")
            res[kv] = dict(tokens=toks, kv_len=st.kv_len, tok_s=B * st.n_tokens / st.decode_s,
                           prefill_s=st.prefill_s, decode_s=st.decode_s, counts=c,
                           peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                           local=(Bl, cache.pos.shape[2]), graph=st.graph_nodes)
            del made, cache, model
            torch.cuda.empty_cache()
    finally:
        flags.set_active_mesh(None)
    out["decode"] = res
    return sp


def mesh_load(mesh, mc, ctx, out, sp):
    """(e): this rank's shard of the LLaMa-2-7B bf16 checkpoint (the parent
    wrote it with save_checkpoint), read with load_checkpoint(mesh=),
    bit-identical to shard_params of the in-memory tree."""
    dev = mesh.device
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, loaded = ckpt_mod.load_checkpoint(ctx["ckpt"], mesh=mesh, mesh_config=mc)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = trees_identical(loaded, sp)
    need(cfg == LLAMA2_7B and same, "load_checkpoint(mesh=) differs from shard_params")
    out["load"] = dict(secs=secs, gb=tree_bytes(loaded) / 1e9, same=same,
                       device=str(dev))


def int4_mesh_tree(full, m):
    """The split int4 arithmetic tree (quantize_params_int4, groups of
    128) with each row-parallel product's group shrunk until a shard of its
    in-rows holds whole groups in both halves (parallel/sharding.py): wd's
    11008 / 2 in-rows are 43 groups of 128, so wd takes groups of 64."""
    tree = quant_mod.quantize_params_int4(full, layout="arith")
    for p, src in zip(tree.layers, full.layers):
        for name in ("wo", "wd"):
            K = getattr(src, name).shape[0]
            G = 128
            while (K // m) % (2 * G):
                G //= 2
            if G != 128:
                setattr(p, name, quant_mod.quantize_linear_int4(getattr(src, name).detach(), G,
                                                                "arith"))
    return tree


EXACT_CASES = {   # (c): name -> (tree, KV, kv_mode, policy, flags)
    "f32 KV decoding": ("f32", "f32", "decoding", "roco", {}),
    "int8 KV decoding": ("f32", "int8", "decoding", "roco", {}),
    "int8 tree decoding": ("int8", "f32", "decoding", "roco", {}),
    "int4 arith split tree decoding": ("int4", "f32", "decoding", "roco", {}),
    "f32 KV encoding, chunk kernels and K7": ("f32", "f32", "encoding", "roco",
                                              {"chunk": True, "step": True}),
    "f32 KV tova encoding, chunk kernels": ("f32", "f32", "encoding", "tova", {"chunk": True}),
    # phase 8 (d): pre-rotated StreamingLLM `decoding` (K2s, K4s, K9s a step)
    "f32 KV stream decoding": ("f32", "f32", "decoding", "roco", {"streaming": True}),
}
EXACT_BY_MESH = {(1, 2): list(EXACT_CASES), (2, 1): ["f32 KV decoding", "int8 KV decoding"],
                 (2, 2): ["f32 KV decoding", "int8 KV decoding"]}


def exact_run(model, ids, name, mesh, mc):
    """One (c) run through generate(), its decode loop eager (a gloo mesh's
    is): (every row's tokens, gathered over data; this rank's final cache
    pos; every step's logits; launches)."""
    _, kv, mode, policy, fl = EXACT_CASES[name]
    gc = dict(budget=8 if mode == "decoding" else 0.5, kv_policy=policy,
              max_new_tokens=EXACT_NEW, temperature=1e-9, top_p=1.0, eos_token_ids=[], seed=0,
              streaming=fl.get("streaming", False))
    logits = []
    tail = llama_mod._logits_tail

    def keep(*a):
        logits.append(tail(*a))
        return logits[-1]
    flags.use_step_kernel(fl.get("step"))
    flags.use_chunk_kernel(fl.get("chunk"))
    if mesh is not None:
        flags.set_active_mesh(mesh, mc.axis_data, mc.axis_model)
    reset_counts()
    try:
        with contextlib.ExitStack() as stack:
            # eager on both sides, so that every step's logits are recorded
            stack.enter_context(flags.eager_decode_loop())
            rows = stack.enter_context(recorded("_gather_result", last_only=True))
            made = stack.enter_context(engine_caches())
            stack.enter_context(mock.patch.object(llama_mod, "_logits_tail", keep))
            easykv_tpu_torch.generate(model, ids, gc, kv_mode=mode,
                                      stride=STRIDE if mode == "encoding" else 1)
    finally:
        flags.set_active_mesh(None)
        flags.use_step_kernel(None)
        flags.use_chunk_kernel(None)
    return rows[-1].out_ids.cpu(), made[-1].pos, logits, counts()


def mesh_exact(mesh, mc, ctx, out, names=None, key="exact"):
    """(c): at full width with L = 2 and f32 weights, each case of this
    mesh's EXACT_BY_MESH through generate() without a mesh (this rank, the
    whole tree) and under it (its shards): equal tokens in every row; with
    an f32 cache also this rank's final pos equal to the whole cache's at
    its rows and heads, and every logits row within LOGIT_LIMIT of the
    one-process one. With an int8 cache the positions and logits are
    printed: the row-parallel products sum in another order, so an int8
    rounding of K or V can flip by one step past layer 0, and roco then
    keeps another slot (phase 4's standard for the kernel path against the
    plain one). `names` (default: EXACT_BY_MESH's) go to out[key]."""
    dev = mesh.device
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=2)
    full = init_params(cfg, seed=1, dtype=torch.float32, device=dev)
    g = torch.Generator().manual_seed(1)
    res = {}
    for name in names or EXACT_BY_MESH[(mc.data, mc.model)]:
        tree_kind, kv, mode = EXACT_CASES[name][:3]
        tree = {"f32": lambda: full, "int8": lambda: quant_mod.quantize_params(full),
                "int4": lambda: int4_mesh_tree(full, mc.model)}[tree_kind]()
        T = PROMPT if mode == "decoding" else EXACT_ENC_PROMPT
        ids = torch.randint(1, cfg.vocab_size, (2, T), generator=g).numpy()
        runs = []
        for m_ in (None, mesh):
            params = tree if m_ is None else parallel_mod.shard_params(tree, cfg, mc, mesh)
            model = easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8")
            with contextlib.redirect_stdout(io.StringIO()):
                runs.append(exact_run(model, ids, name, m_, mc))
            del model, params
        (rows0, pos0, log0, _), (rows1, pos1, log1, c) = runs
        r0, n = parallel_mesh.rows_of(mesh, mc.axis_data, 2)
        h = pos0.shape[2] // mc.model
        hi = mesh.index(mc.axis_model)
        want_pos = pos0[:, r0:r0 + n, hi * h:(hi + 1) * h]
        rel = max(((a - b.narrow(0, r0, n) if a.shape[0] != b.shape[0] else a - b)
                   .abs().max().item() / b.abs().max().item()) for a, b in zip(log1, log0))
        same_tok = torch.equal(rows0, rows1)
        diff = (pos1 != want_pos).flatten(1).sum(1).tolist()     # per layer
        need(same_tok and len(log0) == len(log1), f"(c) {name}: tokens equal {same_tok}")
        need(kv == "int8" or (sum(diff) == 0 and rel <= LOGIT_LIMIT),
             f"(c) {name}: final pos differing per layer {diff}, logits rel err {rel:.2e} "
             f"(limit {LOGIT_LIMIT:g})")
        res[name] = dict(rel=rel, tokens=tuple(rows1.shape), counts=c, diff_pos=diff, kv=kv)
        if tree is not full:
            del tree
        torch.cuda.empty_cache()
    out[key] = res


def mesh_serving(mesh, mc, ctx, out):
    """(c) serving at (2, 1): ScheduledBatchEngine over serving run (b)'s
    requests (cut to 32 new tokens, budget 8, as phase 4; sampled, T=1.0,
    top_p 0.95) at full width, L = 2, f32 weights and KV: without a mesh, under
    the mesh (the slots sharded over data), and under the mesh snapshotted
    after 24 ticks (each rank its shard, rank 0 the host state, into one
    directory) and resumed: equal outputs."""
    dev = mesh.device
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=2)
    full = init_params(cfg, seed=1, dtype=torch.float32, device=dev)
    prompts = serving_prompts(SMALL_REQS, cfg.vocab_size, 1)
    kw = dict(batch_slots=SMALL_SLOTS, max_prompt=SERVE_MAX_PROMPT, budget=8, kv_policy="roco",
              temperature=1.0, top_p=0.95, prefill_chunk=CHUNK, seed=7)
    model = easykv_tpu_torch.CausalLM(cfg, full, device=dev)
    single = scheduled_outputs(model, prompts, 32, **kw)
    mkw = dict(kw, mesh=mesh, mesh_config=mc)
    reset_counts()
    whole = scheduled_outputs(model, prompts, 32, **mkw)
    c = counts()
    path = os.path.join(ctx["tmp"], "engine.snap")
    resumed, _ = scheduled_outputs(model, prompts, 32, 24, path, **mkw)
    need(whole == single and resumed == whole and os.path.isdir(path),
         f"(c) serving: mesh = one process {whole == single}, resumed = whole "
         f"{resumed == whole}")
    need(c["K1s"] > 0 and c["K2s"] > 0 and c["K4s"] > 0, f"(c) serving: launches {c}")
    out["serving"] = dict(requests=len(prompts), equal=True, counts=c,
                          files=sorted(os.listdir(path)))


def job_tp(mesh, mc, ctx, out):
    """Mesh (1, 2): (d), (a), (e), then (c)."""
    sharded_wrappers(mesh, mc, out)
    sp = mesh_decode(mesh, mc, ctx, out, ("bf16", "int8"), 1)
    mesh_load(mesh, mc, ctx, out, sp)
    del sp
    torch.cuda.empty_cache()
    mesh_exact(mesh, mc, ctx, out)


def job_dp(mesh, mc, ctx, out):
    """Mesh (2, 1): (b), then (c) and its serving run."""
    sp = mesh_decode(mesh, mc, ctx, out, ("int8",), B_WIDE)
    del sp
    torch.cuda.empty_cache()
    mesh_exact(mesh, mc, ctx, out)
    mesh_serving(mesh, mc, ctx, out)


def job_exact(mesh, mc, ctx, out):
    """Mesh (2, 2): (c)."""
    mesh_exact(mesh, mc, ctx, out)


JOBS = {"tp": job_tp, "dp": job_dp, "exact": job_exact}


def exact_note(x):
    """A (c) case's line: what was held and what was read."""
    if x["kv"] == "int8":
        return (f"tokens of both rows equal; rank 0's final pos differing per layer "
                f"{x['diff_pos']}, logits rel err {x['rel']:.2e} (int8 KV: read, no limit)")
    return (f"tokens of both rows equal, final pos equal, logits rel err {x['rel']:.2e} "
            f"(limit {LOGIT_LIMIT:g})")


def first_difference(a, b):
    """The first position at which two token lists part (None: they do not)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def phase_parallel(dev, runs, times, k7t):
    """Phase 7: tensor and data parallelism over a (data, model) mesh of
    spawned ranks (torch.distributed; gloo with several ranks a card),
    each on its own shards: (1, 2) runs (d), (a), (e) and (c); (2, 1) runs
    (b) and (c) with serving; (2, 2) runs (c). Returns the six sharded
    wrappers' kernels-line records, and (d)'s measurement of K9s, whose
    record phase 8 makes."""
    cfg = LLAMA2_7B
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="easykv_tp_ckpt_") as ckpt:
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
        t0 = time.perf_counter()
        n = ckpt_mod.save_checkpoint(ckpt, cfg, params)
        print(f"phase 7: (e) the bf16 tree (seed 0) saved for the ranks: {n} bytes in "
              f"{time.perf_counter() - t0:.1f} s")
        del params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        backend, tp = spawn_ranks("tp", 1, 2, dict(ckpt=ckpt))
    cards = torch.cuda.device_count()
    loop = "graph (nccl)" if backend == "nccl" else "eager (gloo)"
    print(f"phase 7: mesh (data=1, model=2): backend {backend}, {cards} card(s), ranks on "
          f"{[r['device'] for r in tp]}, decode loop {loop}; {time.perf_counter() - t0:.1f} s")
    for kv in ("bf16", "int8"):
        ranks = [r["decode"][kv] for r in tp]
        p3 = runs[f"{kv} roco"]
        part = first_difference(ranks[0]["tokens"], p3["tokens"][:TP_NEW])
        same_ranks = all(r["tokens"] == ranks[0]["tokens"] and r["kv_len"] == ranks[0]["kv_len"]
                         for r in ranks)
        print(f"phase 7: (a) TP {kv} KV roco b={BUDGET}, {PROMPT}-token prompt, {TP_NEW} new: "
              + "; ".join(f"rank {i}: {r['tok_s']:.2f} tok/s, prefill {r['prefill_s']:.3f} s, "
                          f"peak {r['peak_gib']:.2f} GiB, local (B, Hkv) {r['local']}"
                          for i, r in enumerate(ranks))
              + f"; phase 3 one card: {p3['tok_s']:.2f} tok/s (graph), prefill "
              f"{p3['prefill_s']:.3f} s, peak {p3['peak_gib']:.2f} GiB; tokens part from "
              f"phase 3's at {part if part is not None else 'no position'} (no limit); "
              f"ranks agree {same_ranks}, kv_len {ranks[0]['kv_len']}; launches a rank "
              f"{ranks[0]['counts']}")
        check(same_ranks, f"(a) {kv}: the ranks' tokens or kv_len differ")
    ld = [r["load"] for r in tp]
    print(f"phase 7: (e) load_checkpoint(mesh=) of the 7B bf16 checkpoint: " + "; ".join(
        f"rank {i} {x['gb']:.3f} GB in {x['secs']:.2f} s, bit-identical to shard_params "
        f"{x['same']}" for i, x in enumerate(ld)))
    records = []
    w = tp[0]["wrappers"]
    launches = {"K1s": tp[0]["decode"]["bf16"]["counts"]["K1s"],
                "K2s": tp[0]["decode"]["bf16"]["counts"]["K2s"],
                "K4s": tp[0]["decode"]["bf16"]["counts"]["K4s"],
                "K5s": tp[0]["decode"]["int8"]["counts"]["K5s"],
                "K6s": tp[0]["exact"]["f32 KV tova encoding, chunk kernels"]["counts"]["K6s"],
                "K7s": tp[0]["exact"]["f32 KV encoding, chunk kernels and K7"]["counts"]["K7s"]}
    whole_keys = {"K1s": ("K1", "bf16"), "K4s": ("K4", "-"), "K5s": ("K5", "int8"),
                  "K6s": ("K6", "int8")}
    for key, (name, src, repl) in SHARDED_META.items():
        if key == "K9s":      # its launches come from phase 8 (d)
            continue
        r = w[key]
        if key == "K7s":
            bound, by = k7t[("K7", "int8")]["bound_ms"], k7t[("K7", "int8")]["bound_by"]
        elif key == "K2s":
            bound, by = r["whole_bound"]
        else:
            t = times[whole_keys[key]]
            bound, by = t["bound_ms"], t["bound_by"]
        bound /= 2            # every term but a few bytes a row is per (row, kv-head)
        check(launches[key] > 0, f"phase 7: {name} was not launched on the main path")
        lib = "none" if r["library_ms"] is None else f"{r['library_ms'] * 1e3:.2f} us"
        print(f"phase 7: (d) {name} at 7B width on a (1, 2) shard: {r['ms'] * 1e3:.2f} us a call "
              f"(the unsharded kernel on the whole {r['whole_ms'] * 1e3:.2f} us), plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {lib}, bound {bound * 1e3:.2f} us ({by}); "
              f"gathered against the unsharded launch: launch plan the same {r['same_plan']}, "
              f"bit-identical {r['bits']} (max |err| {r['max_abs_err']:.3e}), at the "
              f"plan-coincident shape bit-identical {r['exact_bits']}; {launches[key]} "
              f"launches on rank 0's main-path run")
        records.append({"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches[key], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound,
                        "bound_by": by, "library_ms": r["library_ms"]})
    for name, x in tp[0]["exact"].items():
        print(f"phase 7: (c) (1, 2) L=2 f32 weights, {name}: {exact_note(x)}; launches "
              f"{x['counts']}")

    t0 = time.perf_counter()
    backend, dp = spawn_ranks("dp", 2, 1, {})
    ranks = [r["decode"]["int8"] for r in dp]
    p3 = runs[f"int8 roco B={B_WIDE}"]
    part = first_difference(ranks[0]["tokens"], p3["tokens"][:TP_NEW])
    print(f"phase 7: (b) DP mesh (data=2, model=1), backend {backend}: int8 KV roco b={BUDGET}, "
          f"B={B_WIDE} ({B_WIDE // 2} rows a rank), {TP_NEW} new: " + "; ".join(
              f"rank {i}: {r['tok_s']:.2f} tok/s, prefill {r['prefill_s']:.3f} s, peak "
              f"{r['peak_gib']:.2f} GiB" for i, r in enumerate(ranks))
          + f"; phase 3 one card: {p3['tok_s']:.2f} tok/s; row 0's tokens part from phase 3's at "
          f"{part if part is not None else 'no position'}; launches a rank {ranks[0]['counts']}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(all(r["tokens"] == ranks[0]["tokens"] for r in ranks), "(b): ranks disagree")
    for name, x in dp[0]["exact"].items():
        print(f"phase 7: (c) (2, 1) L=2 f32 weights, {name}: {exact_note(x)}")
    s = dp[0]["serving"]
    print(f"phase 7: (c) (2, 1) serving, {s['requests']} requests, sampled: mesh = one process = "
          f"snapshot after 24 ticks and resumed; snapshot files {s['files']}")
    t0 = time.perf_counter()
    backend, ex = spawn_ranks("exact", 2, 2, {})
    for name, x in ex[0]["exact"].items():
        print(f"phase 7: (c) (2, 2) L=2 f32 weights, {name}: {exact_note(x)}")
    print(f"phase 7: mesh (2, 2), 4 ranks, backend {backend}: {time.perf_counter() - t0:.1f} s")
    return records, w["K9s"]


# ---------------------------------------------------------------------------
# phase 8: the sequence-parallel ring prefill (flags.set_sp_mesh), and
# pre-rotated StreamingLLM decoding under a (data, model) mesh
# ---------------------------------------------------------------------------

SP_NEW = 256                       # (a)'s new tokens (phase 7's)
SP_EXACT_LENS = (512, 389)         # (c): two prefixes of unequal length in 512 columns
SP_EXACT_SLOTS = 640
STREAM_BUDGET, STREAM_NEW = 32, 64  # (d) at 7B: 32 steps past the budget
SP_BARS = dict(kv=(1e-5, 1e-4), score=(1e-5, 1e-4), score_sq=(1e-6, 1e-4),
               logits=(2e-4, 2e-3))  # the JAX package's, tests/test_sp_prefill.py:63-73


def digest(cache):
    """sha256 of every array of a cache: ranks' caches compared by bits
    without moving them."""
    return {f: hashlib.sha256(getattr(cache, f).contiguous().view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()
            for f in CACHE_ARRAYS if getattr(cache, f) is not None}


@contextlib.contextmanager
def prefill_hook():
    """Records each engine _prefill call: its arguments, logits and the
    cache's pos and counter right after it."""
    calls, fn = [], gen_mod._prefill

    def hooked(st, params, cache, ids, prefix_len, *rest):
        logits = fn(st, params, cache, ids, prefix_len, *rest)
        calls.append(dict(st=st, ids=ids, prefix_len=prefix_len, rest=rest, logits=logits,
                          pos=cache.pos.clone(), counter=cache.counter.clone(),
                          S=cache.pos.shape[-1], quant=cache.quantized))
        return logits
    with mock.patch.object(gen_mod, "_prefill", hooked):
        yield calls


def chunked_twin(call, params, cfg, dev, dtype):
    """The one-card chunked prefill of a recorded ring prefill's inputs
    (the same statics without the sp mesh): (cache, logits)."""
    st = dataclasses.replace(call["st"], sp=None)
    cache = init_cache(cfg.num_hidden_layers, call["ids"].shape[0],
                               cfg.num_key_value_heads, call["S"], cfg.head_dim, dtype, dev,
                               quantized=call["quant"])
    logits = gen_mod._prefill(st, params, cache, call["ids"], call["prefix_len"], *call["rest"])
    return cache, logits


def ring_checked(mesh, call, params, cfg, dtype, what):
    """A recorded ring prefill against its one-card chunked twin: pos and
    counter equal (a padding token's slot holds no token: pos -1 in both,
    its other arrays unread). Returns max |logits - twin's| / max |twin's|."""
    twin, logits = chunked_twin(call, params, cfg, mesh.device, dtype)
    valid = twin.pos >= 0
    need(torch.equal(call["pos"], twin.pos)
         and torch.equal(call["counter"][valid], twin.counter[valid]),
         f"{what}: the ring prefill's pos / counter differ from the one-card chunked prefill's")
    err = ((call["logits"] - logits).abs().max() / logits.abs().max()).item()
    del twin
    return err


def sp_decode(mesh, ctx, out):
    """(a): phase 3's bf16 `decoding` (its 512-token prompt, roco b=200,
    greedy) for SP_NEW tokens under the sp mesh, LLaMa-2-7B width, bf16
    weights from seed 0 on each rank: the ring prefill (the rank's 256
    columns), then the decode over the whole cache, replayed as a CUDA
    graph. Exact launches a rank, the ring taken once, 200 generated tokens
    in every (layer, head), the post-prefill pos and counter equal to the
    one-card chunked prefill's; the final cache's digest for the parent."""
    dev, cfg = mesh.device, LLAMA2_7B
    L = cfg.num_hidden_layers
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(1, cfg.vocab_size, (B_WIDE, PROMPT), generator=g)[0].tolist()
    gc = dict(budget=BUDGET, kv_policy="roco", max_new_tokens=SP_NEW, temperature=1e-9,
              top_p=1.0, eos_token_ids=[], seed=0)
    model = easykv_tpu_torch.CausalLM(cfg, params, device=dev)
    flags.set_sp_mesh(mesh)
    try:
        easykv_tpu_torch.generate(model, prompt, dict(gc, max_new_tokens=8), kv_mode="decoding")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        with engine_caches() as made, prefill_hook() as pre, recorded("_ring_prefill") as ring:
            toks = easykv_tpu_torch.generate(model, prompt, gc, kv_mode="decoding")
        c = counts()
    finally:
        flags.set_sp_mesh(None)
    st = model.last_run
    want = zero_counts(K1=L * SP_NEW, K2=SP_NEW, **{"K2 rows": SP_NEW})
    need(c == want, f"(a): launches {c}, want {want}")
    need(len(ring) == 1 and len(toks) == SP_NEW and st.logits_finite,
         f"(a): ring prefills {len(ring)}, {len(toks)} tokens, finite {st.logits_finite}")
    need(st.graph_nodes > 0, "(a): the decode after the ring did not replay a CUDA graph")
    cache = made[-1]
    kept = (cache.pos >= PROMPT).sum(-1)
    need(bool((kept == BUDGET).all()), f"(a): generated tokens kept {kept.unique().tolist()}")
    out["decode"] = dict(tokens=toks, tok_s=st.n_tokens / st.decode_s, prefill_s=st.prefill_s,
                         capture_s=st.capture_s, nodes=st.graph_nodes, counts=c,
                         kv_len=st.kv_len, digest=digest(cache),
                         peak_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
                         logit_err=ring_checked(mesh, pre[-1], params, cfg, torch.bfloat16,
                                                "(a)"))
    del made, cache, pre
    torch.cuda.empty_cache()
    return params


def sp_encode(mesh, ctx, out, params):
    """(b): phase 3's int8 `encoding` (the 4096-token prompt, stride 96,
    roco at 0.5, 128 new tokens) under the sp mesh: the 1984-token prefix
    through the ring (992 columns a rank), then the strided encode through
    K6 and the decode, checked by encoding_run (exact launches: no K5, 704
    K6; 2208 slots; the ratio line); the post-prefix pos and counter equal
    to the one-card chunked prefill's."""
    dev, cfg = mesh.device, LLAMA2_7B
    L = cfg.num_hidden_layers
    prompt = torch.randint(1, cfg.vocab_size, (ENC_PROMPT,),
                           generator=torch.Generator().manual_seed(0)).tolist()
    gc = dict(kv_policy="roco", budget=0.5, max_new_tokens=ENC_NEW, temperature=1e-9, top_p=1.0,
              eos_token_ids=[], seed=0)
    model = easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=True)
    n_enc = L * ((ENC_PROMPT - ENC_RIDX) // STRIDE)
    ratio = f"KV cache budget ratio: {ENC_IDX / ENC_PROMPT * 100:.2f}%({ENC_IDX}/{ENC_PROMPT})"
    flags.set_sp_mesh(mesh)
    try:
        easykv_tpu_torch.generate(model, prompt[:1024], dict(gc, max_new_tokens=4),
                                  kv_mode="encoding", stride=STRIDE)
        with prefill_hook() as pre, recorded("_ring_prefill") as ring:
            res = encoding_run(model, "int8 encoding roco, sp", prompt, gc, "encoding", STRIDE,
                               zero_counts(K1=L * ENC_NEW, K2=ENC_NEW, K6=n_enc,
                                           **{"K2 rows": ENC_NEW}),
                               ENC_IDX + ENC_NEW, ratio, ENC_S, cfg, n_new=ENC_NEW, keep=True)
    finally:
        flags.set_sp_mesh(None)
    need(len(ring) == 1 and pre[-1]["ids"].shape[1] == ENC_RIDX,
         f"(b): ring prefills {len(ring)} of a {pre[-1]['ids'].shape[1]}-token prefix")
    out["encode"] = dict(tokens=res["out"], prefill_s=res["prefill_s"], encode_s=res["encode_s"],
                         tok_s=res["tok_s"], counts=res["counts"], digest=digest(res["cache"]),
                         logit_err=ring_checked(mesh, pre[-1], params, cfg, torch.bfloat16,
                                                "(b)"))
    del res, pre
    torch.cuda.empty_cache()


def sp_exact(mesh, ctx, out):
    """(c): LLaMa-2-7B width, L = 2, f32 weights (seed 1) and cache, B = 2
    with prefixes of SP_EXACT_LENS tokens (padding keys): the encoding
    prefix prefill with the keep_attention roco bootstrap under the sp mesh
    against the one-card chunked prefill on the card: pos exact; at the
    valid slots the counter exact, and k, v, score, score_sq and the logits
    within SP_BARS, or else (the bars were set at the JAX package's test
    widths, where no sum runs over 4096 or 11008 terms) no farther from the
    same prefill with f64 weights and cache than twice the one-card
    prefill's own distance from it; then greedy `decoding` (roco b=8, 32
    new tokens, both rows' 512-token prompts) with and without the mesh:
    every row's tokens equal."""
    dev = mesh.device
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=2)
    params = init_params(cfg, seed=1, dtype=torch.float32, device=dev)
    params64 = copy.deepcopy(params).double()
    params64.lm_head = params.lm_head          # the f32 head: _lm_head's f32 branch
    ids = torch.randint(1, cfg.vocab_size, (2, PROMPT),
                        generator=torch.Generator().manual_seed(8)).to(dev)
    plen = torch.tensor(SP_EXACT_LENS, dtype=torch.int32, device=dev)
    st = gen_mod.EngineStatics(cfg=cfg, mode="encoding", policy="roco", stride=STRIDE,
                               length=ENC_PROMPT, budget=ENC_IDX, idx=ENC_IDX, r_idx=PROMPT,
                               keep_attention=True, recent_window=ENC_IDX // 10)
    got = {}
    for name, sp, tree, dtype in (("one", None, params, torch.float32),
                                  ("sp", (mesh, "sp"), params, torch.float32),
                                  ("f64", None, params64, torch.float64)):
        cache = init_cache(2, 2, cfg.num_key_value_heads, SP_EXACT_SLOTS, cfg.head_dim, dtype,
                           dev)
        logits = gen_mod._prefill(dataclasses.replace(st, sp=sp), tree, cache, ids, plen,
                                  st.encode_spec(), "encode")
        got[name] = dict(logits=logits, **{f: getattr(cache, f) for f in
                                           ("k", "v", "score", "score_sq", "pos", "counter")})
    del params64
    one, ring, x64 = got["one"], got["sp"], got["f64"]
    valid = one["pos"] >= 0
    need(torch.equal(one["pos"], ring["pos"])
         and torch.equal(one["counter"][valid], ring["counter"][valid]),
         f"(c) sp={mesh.size}: pos / counter differ")
    errs = {}
    for f, bar in (("k", "kv"), ("v", "kv"), ("score", "score"), ("score_sq", "score_sq"),
                   ("logits", "logits")):
        sel = (lambda t: t) if f == "logits" else (lambda t: t[valid])  # noqa: E731
        a, b, x = sel(ring[f]), sel(one[f]), sel(x64[f]).double()
        atol, rtol = SP_BARS[bar]
        within = bool(((a - b).abs() <= atol + rtol * b.abs()).all())
        d_ring = (a.double() - x).abs().max().item()
        d_one = (b.double() - x).abs().max().item()
        errs[f] = dict(err=(a - b).abs().max().item(), within=within, d_ring=d_ring, d_one=d_one)
        need(within or d_ring <= 2 * d_one,
             f"(c) sp={mesh.size}: {f} beyond {SP_BARS[bar]} of the one-card prefill "
             f"({errs[f]['err']:.3e}) and |ring - f64| {d_ring:.3e} > 2 x |one-card - f64| "
             f"{d_one:.3e}")
    del got, one, ring, x64
    model = easykv_tpu_torch.CausalLM(cfg, params, device=dev)
    gc = dict(budget=8, kv_policy="roco", max_new_tokens=EXACT_NEW, temperature=1e-9, top_p=1.0,
              eos_token_ids=[], seed=0)
    rows = []
    for sp in (None, mesh):
        flags.set_sp_mesh(sp)
        try:
            with recorded("_gather_result", last_only=True) as res:
                easykv_tpu_torch.generate(model, ids.cpu().numpy(), gc, kv_mode="decoding")
        finally:
            flags.set_sp_mesh(None)
        rows.append(res[-1].out_ids.cpu())
    need(torch.equal(rows[0], rows[1]), f"(c) sp={mesh.size}: greedy tokens differ")
    out["exact"] = dict(errs=errs, valid=int(valid.sum()), tokens=tuple(rows[1].shape))


def job_sp2(mesh, mc, ctx, out):
    """sp = 2: (a), (b), (c)."""
    out["transport"] = parallel_mesh.ring_transport(mesh, mesh.device)
    params = sp_decode(mesh, ctx, out)
    sp_encode(mesh, ctx, out, params)
    del params
    torch.cuda.empty_cache()
    sp_exact(mesh, ctx, out)


def job_sp4(mesh, mc, ctx, out):
    """sp = 4 (four ranks): (c)."""
    out["transport"] = parallel_mesh.ring_transport(mesh, mesh.device)
    sp_exact(mesh, ctx, out)


def job_stream_tp(mesh, mc, ctx, out):
    """(d) on (1, 2): pre-rotated StreamingLLM `decoding` at L = 2, f32
    (mesh_exact: tokens and this rank's final pos equal to the one-process
    run's, logits within LOGIT_LIMIT), then at 7B width, bf16 weights from
    seed 0 (this rank's shards), phase 3's prompt, roco at STREAM_BUDGET,
    STREAM_NEW new tokens: exact launches a rank (one K2s unfolded with the
    rows, one K4s and one K9s a step), STREAM_BUDGET generated tokens in
    every (layer, row, head), the final cache age-ordered."""
    mesh_exact(mesh, mc, ctx, out, names=["f32 KV stream decoding"], key="stream_exact")
    dev, cfg = mesh.device, LLAMA2_7B
    L = cfg.num_hidden_layers
    full = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    params = parallel_mod.shard_params(full, cfg, mc, mesh)
    del full
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(0)
    prompt = torch.randint(1, cfg.vocab_size, (B_WIDE, PROMPT), generator=g)[0].tolist()
    gc = dict(budget=STREAM_BUDGET, kv_policy="roco", max_new_tokens=STREAM_NEW,
              temperature=1e-9, top_p=1.0, eos_token_ids=[], seed=0, streaming=True)
    model = easykv_tpu_torch.CausalLM(cfg, params, device=dev)
    flags.set_active_mesh(mesh, mc.axis_data, mc.axis_model)
    try:
        easykv_tpu_torch.generate(model, prompt, dict(gc, max_new_tokens=STREAM_BUDGET + 4),
                                  kv_mode="decoding")
        torch.cuda.synchronize()
        reset_counts()
        with engine_caches() as made:
            toks = easykv_tpu_torch.generate(model, prompt, gc, kv_mode="decoding")
        c = counts()
    finally:
        flags.set_active_mesh(None)
    st = model.last_run
    n = STREAM_NEW
    want = zero_counts(K1=L * n, K1s=L * n, K2=n, K2s=n, K4=n, K4s=n, K9=n, K9s=n,
                       **{"K2 rows": n})
    need(c == want, f"(d) 7B: launches {c}, want {want}")
    ordered, held = ordered_invariant(made[-1].pos)
    need(ordered and held == (PROMPT + STREAM_BUDGET,) * 2 and len(toks) == n
         and st.logits_finite, f"(d) 7B: ordered {ordered}, slots {held}, {len(toks)} tokens")
    out["stream"] = dict(tok_s=st.n_tokens / st.decode_s, prefill_s=st.prefill_s, counts=c,
                         tokens=toks, local=tuple(made[-1].pos.shape))
    del made


JOBS.update({"sp2": job_sp2, "sp4": job_sp4, "stream_tp": job_stream_tp})


def phase_sp(runs, times, k9w):
    """Phase 8: the sequence-parallel ring prefill on spawned ranks sharing
    the card (gloo; the ring's blocks through pinned host buffers), sp = 2:
    (a) 7B bf16 `decoding`, (b) 7B int8 `encoding`, (c) L = 2 f32
    exactness; sp = 4: (c); then pre-rotated StreamingLLM `decoding` under
    a (1, 2) mesh, (d). Returns K9s's kernels-line record: its launches from
    (d)'s 7B run, its times from phase 7 (d) (k9w)."""
    t0 = time.perf_counter()
    backend, r2 = spawn_ranks("sp2", 0, 2, {})
    print(f"phase 8: sp mesh of 2 ranks, backend {backend}, ranks on "
          f"{[r['device'] for r in r2]}, ring transport: {r2[0]['transport']}; "
          f"{time.perf_counter() - t0:.1f} s")
    a = [r["decode"] for r in r2]
    p3 = runs["bf16 roco"]
    part = first_difference(a[0]["tokens"], p3["tokens"][:SP_NEW])
    same = all(x["tokens"] == a[0]["tokens"] and x["digest"] == a[0]["digest"] for x in a)
    print(f"phase 8: (a) sp=2 bf16 KV `decoding` roco b={BUDGET}, {PROMPT}-token prompt "
          f"({PROMPT // 2} columns a rank), {SP_NEW} new: " + "; ".join(
              f"rank {i}: ring prefill {x['prefill_s']:.3f} s, decode {x['tok_s']:.2f} tok/s "
              f"(graph replayed, {x['nodes']} nodes, captured in {x['capture_s']:.3f} s), peak "
              f"{x['peak_gib']:.2f} GiB" for i, x in enumerate(a))
          + f"; phase 3 one card: chunked prefill {p3['prefill_s']:.3f} s, decode "
          f"{p3['tok_s']:.2f} tok/s; post-prefill pos and counter equal to the one-card chunked "
          f"prefill's, its logits within {a[0]['logit_err']:.2e} of max |logits| (bf16, read); "
          f"tokens part from phase 3's at {part if part is not None else 'no position'} (bf16 "
          f"reduction order, no limit); ranks' tokens and final caches equal by bits {same}; "
          f"launches a rank {a[0]['counts']}")
    check(same, "(a): the ranks' tokens or final caches differ")
    b = [r["encode"] for r in r2]
    p3 = runs["int8 encoding roco"]
    same = all(x["tokens"] == b[0]["tokens"] and x["digest"] == b[0]["digest"] for x in b)
    print(f"phase 8: (b) sp=2 int8 KV `encoding` roco 0.5, {ENC_PROMPT}-token prompt, stride "
          f"{STRIDE}: the {ENC_RIDX}-token prefix through the ring ({ENC_RIDX // 2} columns a "
          f"rank): " + "; ".join(
              f"rank {i}: prefix {x['prefill_s']:.3f} s, strided encode {x['encode_s']:.3f} s, "
              f"decode {x['tok_s']:.2f} tok/s" for i, x in enumerate(b))
          + f"; phase 3 one card: prefix {p3['prefill_s']:.3f} s, strided encode "
          f"{p3['encode_s']:.3f} s, decode {p3['tok_s']:.2f} tok/s; post-prefix pos and counter "
          f"equal to the one-card chunked prefill's (logits within {b[0]['logit_err']:.2e}, "
          f"read); ranks' tokens and final caches equal by bits {same}; launches a rank "
          f"{b[0]['counts']}")
    check(same, "(b): the ranks' tokens or final caches differ")
    t0 = time.perf_counter()
    _, r4 = spawn_ranks("sp4", 0, 4, {})
    for n, ranks in ((2, r2), (4, r4)):
        x = ranks[0]["exact"]
        print(f"phase 8: (c) sp={n} L=2 f32, B=2 prefixes {SP_EXACT_LENS}: ring against the "
              f"one-card chunked prefill at {x['valid']} valid slots, pos and counter exact; "
              + "; ".join(f"{f} max |err| {e['err']:.3e} ("
                          + ("within the bar" if e["within"] else "beyond the bar")
                          + f"; from the f64 prefill: ring {e['d_ring']:.3e}, one card "
                            f"{e['d_one']:.3e})" for f, e in x["errs"].items())
              + f" (bars {SP_BARS}, else ring <= 2 x one card from f64); greedy tokens of "
              f"both rows equal ({x['tokens']})")
    print(f"phase 8: sp mesh of 4 ranks on {[r['device'] for r in r4]}: "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, rd = spawn_ranks("stream_tp", 1, 2, {})
    for name, x in rd[0]["stream_exact"].items():
        print(f"phase 8: (d) (1, 2) L=2 f32 weights, {name} (pre-rotated): {exact_note(x)}; "
              f"launches {x['counts']}")
    d = [r["stream"] for r in rd]
    p3 = runs["bf16 stream roco prerot"]
    print(f"phase 8: (d) (1, 2) bf16 KV StreamingLLM `decoding` pre-rotated, roco "
          f"b={STREAM_BUDGET}, {STREAM_NEW} new: " + "; ".join(
              f"rank {i}: {x['tok_s']:.2f} tok/s (eager, gloo), prefill {x['prefill_s']:.3f} s, "
              f"local cache {x['local']}" for i, x in enumerate(d))
          + f"; phase 3 one card (b={BUDGET}, graph): {p3['tok_s']:.2f} tok/s; launches a rank "
          f"{d[0]['counts']}; {time.perf_counter() - t0:.1f} s")
    check(all(x["tokens"] == d[0]["tokens"] for x in d), "(d): the ranks' tokens differ")
    name, src, repl = SHARDED_META["K9s"]
    launches = d[0]["counts"]["K9s"]
    check(launches > 0, "phase 8: fused_kv_compact_sharded was not launched on the main path")
    t = times[("K9", "bf16")]
    bound, by = t["bound_ms"] / 2, t["bound_by"]     # every term is per (row, kv-head)
    print(f"phase 8: (d) {name} at 7B width on a (1, 2) shard (phase 7's timing): "
          f"{k9w['ms'] * 1e3:.2f} us a call (the unsharded kernel on the whole "
          f"{k9w['whole_ms'] * 1e3:.2f} us), plain {k9w['plain_ms'] * 1e3:.2f} us, bound "
          f"{bound * 1e3:.2f} us ({by}); gathered against the unsharded launch: launch plan the "
          f"same {k9w['same_plan']}, bit-identical {k9w['bits']}; {launches} launches on rank "
          f"0's main-path run ((d) at 7B)")
    check(k9w["bits"], "K9s: not bit-identical to the unsharded launch")
    return [{"name": name, "route": "cuda", "source": src, "replaces": repl,
             "launches": launches, "max_abs_err": k9w["max_abs_err"], "ms": k9w["ms"],
             "plain_ms": k9w["plain_ms"], "bound_ms": bound, "bound_by": by,
             "library_ms": None}]


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"phase 1: {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"phase 1: built {sorted(logs) or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1: ptxas {src}: {line.strip()}")

    errs = phase_kernels(dev)
    errs.update(phase_k7(dev))
    errs.update(phase_rank_kernels(dev))
    errs.update(phase_quant_kernels(dev))
    phase_k14(dev)
    phase_k15(dev)
    runs = phase_end_to_end(dev)
    phase_plain_vs_kernel(dev)
    phase_graph_vs_eager(dev)
    times = phase_times(dev)
    k7t = k7_times(dev)
    rtimes = rank_times(dev)
    qtimes = quant_times(dev)
    cfg32, tree32 = step_tree(dev, 32, 0)
    ktimes = k14_times(dev, cfg32, tree32)
    btimes = k15_times(dev, cfg32, tree32)
    del tree32
    torch.cuda.empty_cache()
    k15_control(dev)
    phase_loading(dev, runs)
    sharded, k9w = phase_parallel(dev, runs, times, k7t)
    sharded += phase_sp(runs, times, k9w)

    meta = {  # name, source, TPU kernel it replaces, the run whose launches it reports
        "K1": ("fused_decode_attend_inflight", "easykv_tpu_torch/csrc/decode_attention.cu",
               "easykv_tpu/ops/pallas/decode_attention.py:207", "{kv} roco"),
        "K1 ordered": ("fused_decode_attend_inflight ordered",
                       "easykv_tpu_torch/csrc/decode_attention.cu",
                       "easykv_tpu/ops/pallas/decode_attention.py:207",
                       "int8 stream roco rotate-at-read"),
        "K2": ("fused_write_update", "easykv_tpu_torch/csrc/sidecar_update.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:270", "{kv} roco"),
        "K2 compact": ("fused_write_update compact", "easykv_tpu_torch/csrc/sidecar_update.cu",
                       "easykv_tpu/ops/pallas/sidecar_update.py:270", "{kv} stream roco prerot"),
        "K3": ("write_rows (inside fused_write_update's launch)",
               "easykv_tpu_torch/csrc/sidecar_update.cu",
               "easykv_tpu/ops/pallas/row_write.py:36", "{kv} roco"),
        "K2 B=4": ("fused_write_update B=4", "easykv_tpu_torch/csrc/sidecar_update.cu",
                   "easykv_tpu/ops/pallas/sidecar_update.py:270", "{kv} B=4"),
        "K2 B=16": ("fused_write_update B=16", "easykv_tpu_torch/csrc/sidecar_update.cu",
                    "easykv_tpu/ops/pallas/sidecar_update.py:270", "{kv} B=16"),
        "K2 S=2304": ("fused_write_update S=2304", "easykv_tpu_torch/csrc/sidecar_update.cu",
                      "easykv_tpu/ops/pallas/sidecar_update.py:270", "{kv} encoding roco"),
        "K4": ("fused_evict", "easykv_tpu_torch/csrc/sidecar_update.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:419", "int8 stream roco rotate-at-read"),
        "K4 S=2304": ("fused_evict S=2304", "easykv_tpu_torch/csrc/sidecar_update.cu",
                      "easykv_tpu/ops/pallas/sidecar_update.py:419", None),
        "K5": ("fused_chunk_attend", "easykv_tpu_torch/csrc/chunk_attention.cu",
               "easykv_tpu/ops/pallas/chunk_attention.py:183", "{kv} roco"),
        "K6": ("fused_chunk_write_attend", "easykv_tpu_torch/csrc/chunk_attention.cu",
               "easykv_tpu/ops/pallas/chunk_attention.py:641", "int8 encoding roco"),
        "K8": ("fused_compact", "easykv_tpu_torch/csrc/kv_compact.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:565", "int8 stream roco rotate-at-read"),
        "K9": ("fused_kv_compact", "easykv_tpu_torch/csrc/kv_compact.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:801", "{kv} stream roco prerot"),
        "K9 B=4": ("fused_kv_compact B=4", "easykv_tpu_torch/csrc/kv_compact.cu",
                   "easykv_tpu/ops/pallas/sidecar_update.py:801", "{kv} fused stream B=4"),
    }
    # the phase-3 runs whose K2 the batched rows report: B = 4 int8 KV is
    # phase 3's own run, the others the fused int4 tree's (K15 a step)
    k2_runs = {"int8 B=4": "int8 roco B=4", "bf16 B=4": "int4 arith fused roco B=4 bf16 KV",
               "int8 B=16": "int4 arith fused roco B=16",
               "bf16 B=16": "int4 arith fused roco B=16 bf16 KV",
               # K9 at B = 4: the fused int4 tree's streaming run (int8 KV; no
               # bf16 KV run streams at B = 4)
               "int8 fused stream B=4": "int4 arith fused stream roco B=4"}
    kernels = []
    for (key, kv), t in times.items():
        kname, src, repl, run = meta[key]
        if kv == "int8":
            kname += " (int8 KV)"
        lib = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f} us"
        run = None if run is None else k2_runs.get(run.format(kv=kv), run.format(kv=kv))
        if run not in runs:   # K4 at S = 2304, K9 bf16 at B = 4: timed, run by no path
            launches, where = 0, f"0 launches: no phase-3 run has {key} with this cache"
        else:
            launches = runs[run]["counts"][key.split(" B=")[0].split(" S=")[0]]
            per = "call" if key in ("K5", "K6") else "step"
            n_per = launches / (1 if per == "call" else ENC_NEW if "encoding" in run else NEW)
            where = f"{n_per:g} launches/{per} in the {run} run"
        alone = ("" if "alone_ms" not in t else
                 f" (K2 given the rows less K2 alone; the stand-alone kernel "
                 f"{t['alone_ms'] * 1e3:.2f} us)")
        print(f"phase 5: {key} {kname}: {t['ms'] * 1e3:.2f} us{alone}, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, library {lib}, "
              f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), {where}")
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches, "max_abs_err": errs[(key, kv)], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kernels += k7_records(k7t, errs, runs, times[("K6", "int8")]["library_ms"])
    kernels += rank_records(rtimes, errs, runs)
    kernels += quant_records(qtimes, errs, runs)
    kernels += k14_records(ktimes, runs)
    kernels += k15_records(btimes, runs)
    kernels += sharded
    print("phase 5: K5 launches in the encoding family's runs: " + ", ".join(
        f"{run} {r['counts']['K5']}" for run, r in runs.items()
        if "encod" in run or "ppl" in run))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
