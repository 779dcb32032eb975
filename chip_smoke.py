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
     without and with the int8 scale rows: bit-exact), K3 row write (Dh=128
     and 64, bf16 and int8: exact), K5 chunk attention (C=128: int8 and bf16
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
     and int8, rotate on and off, victims at the first, a middle and the
     last tile, and none) and K8 compaction (bf16 and int8) bit-exact on
     every array; K1 `ordered` (bf16 and int8, MHA, GQA with B=2) within
     K1's limit; the quantized-weight kernels at the 7B products (x bf16 and
     f32): K10 at M=1 and K12 at M=1..8 (launched twice, bit-identical)
     over the split tree's widths and the head, K11 at M=2, 4,
     16, 96, 128, 512 over the split and the fused tree's widths (both of
     its tile configurations and its group split), K13 at M=1 (its own
     kernel, launched twice, bit-identical), 4, 256 over the fused tree's
     and the LM head
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
     head) of the final cache). Launch counters are zeroed just before
     each run and read just after;
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
     one int8 step elsewhere;
  5. per-kernel device times (CUDA graphs of many launches, timed with CUDA
     events) beside each one's plain version, library call and bound, for
     each cache dtype the main path gives the kernel (K1's rank variant
     and fused_decode_attend at S=2304, each K1 entry beside
     scaled_dot_product_attention over the same cache, the attention half
     alone, as its library yardstick; K7 roco at a triggered chunk,
     int8 and bf16, each call from its untouched state); K10-K13 at each 7B
     product of their phase-3 trees (bf16 activations; K11 at the split
     and the fused widths, M=4 and 512) with enough weight copies cycled that L2 is
     cold, the library call torch.matmul over a bf16 copy dequantized
     beforehand; K14 for a whole decode step at 7B width (L=32, S=768),
     bf16 and int8 KV, first held to its plain version on the same
     arguments within the larger of phase 2's limit and twice the plain
     version's own spread when its input moves by one f32 ulp (the
     record's max_abs_err), then timed with CUDA events over back-to-back
     launches, its bound from the bytes the step reads and writes; K15 the
     same way at B=4 and 16 (bar: twice its reorder spread), then
     k15_control: at f32 activations, B=4 and 16, f32 and int8 KV, K15
     within the bar and the plain K15 with its residual rounded to bf16
     between the layers over it.

It exits non-zero, without a result line, when there is no CUDA device, a
kernel does not build, or any check fails. The last line is
{"ok": true, "device": {...}}; the line before it holds `nvidia-smi`'s card
name and power limit, and the one before that the per-kernel JSON record.
"""
import contextlib
import dataclasses
import importlib
import io
import json
import math
import subprocess
import sys
import time
from unittest import mock

import torch

import easykv_tpu_torch
from easykv_tpu_torch import flags
from easykv_tpu_torch import policies as policies_mod
from easykv_tpu_torch.cache import KVCache, quantize_kv
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.llama import StepCtx, age_ranks_all, init_params, rotation_tables
from easykv_tpu_torch.ops.cuda import _build
from easykv_tpu_torch.ops.cuda import sidecar_update as sidecar_mod
from easykv_tpu_torch.ops.cuda.kv_compact import (
    fused_compact as k8, fused_compact_plain as k8_plain, fused_kv_compact as k9,
    fused_kv_compact_plain as k9_plain, shift_rotation)
from easykv_tpu_torch.ops.rope import rope_inv_freq
from easykv_tpu_torch.ops.cuda.chunk_attention import (
    chunk_step_evict_plain, fused_chunk_attend as k5, fused_chunk_attend_plain as k5_plain,
    fused_chunk_step as k7, fused_chunk_step_plain as k7_plain,
    fused_chunk_write_attend as k6, fused_chunk_write_attend_plain as k6_plain)
from easykv_tpu_torch.ops.cuda import decode_attention as da_mod
from easykv_tpu_torch.ops.cuda.decode_attention import (
    fused_decode_attend as kda, fused_decode_attend_inflight as k1,
    fused_decode_attend_inflight_plain as k1_plain, fused_decode_attend_plain as kda_plain)
from easykv_tpu_torch.ops.cuda import fused_decode as k14_fd
from easykv_tpu_torch.ops.cuda.fused_decode import (fused_decode_step as k14,
                                                    fused_decode_step_plain as k14_plain)
from easykv_tpu_torch.ops.cuda.fused_decode_batch import (
    fused_decode_step_batch as k15, fused_decode_step_batch_plain as k15_plain)
from easykv_tpu_torch.ops.cuda.step_bars import (STEP_OUTPUTS, k14_ulp_spread, k15_feed_share,
                                                 k15_spread, step_shares)
from easykv_tpu_torch.ops.cuda.row_write import write_rows as k3, write_rows_plain as k3_plain
from easykv_tpu_torch.ops.cuda.sidecar_update import (
    fused_evict as k4, fused_evict_plain as k4_plain, fused_write_update as k2,
    fused_write_update_plain as k2_plain)
from easykv_tpu_torch.ops import quant as quant_mod
from easykv_tpu_torch.ops.cuda.quant_matmul import (quant_matmul as k13,
                                                    quant_matmul_plain as k13_plain)
from easykv_tpu_torch.ops.cuda.w4_matmul import w4a16_gemv as k12, w4a16_gemv_plain as k12_plain
from easykv_tpu_torch.ops.cuda.w4_stream import (
    w4a16_gemm_arith as k11, w4a16_gemm_arith_plain as k11_plain, w4a16_gemv_arith as k10,
    w4a16_gemv_arith_plain as k10_plain)
from easykv_tpu_torch.policies import PHASE_DECODE, PolicySpec

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
    rows: k_sc_new, v_sc_new, k_scale, v_scale)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pos = slot_positions(L, B, H, S, PROMPT + BUDGET, torch.Generator().manual_seed(seed), dev)
    valid = pos >= 0
    u = lambda: torch.rand((L, B, H, S), generator=g, device=dev)  # noqa: E731
    score = torch.where(valid, u() * 4, 0.0)
    ssq = score * u() * 0.1
    counter = torch.where(valid, (u() * 200).floor(), 0.0)
    probs = torch.where(valid, u() / S, 0.0)
    p_new = torch.rand((L, B, H, 1), generator=g, device=dev) * 0.05
    nxt = PROMPT + NEW
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
        vs.view(-1)[:6] = torch.tensor([0, 5, S // 2, S - 33, S - 1, S], dtype=torch.int32)
    return vs


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
    pos = slot_positions(L, 1, H, S, PROMPT + BUDGET, torch.Generator().manual_seed(150), dev)
    shift = shift_rotation(rope_inv_freq(D, LLAMA2_7B.rope_theta, dev))
    for kind in ("bf16", "int8"):
        kv = kv_rows(L, 1, H, S, D, kind, dev, 151)
        vs = stream_victims(L, 1, H, S, dev, 152, edges=True)
        for rotate in (True, False):
            a = [x.clone() for x in kv]
            b = [x.clone() for x in kv]
            k9(a[0], a[1], vs, *a[2:], rot=shift if rotate else None)
            k9_plain(b[0], b[1], vs, *b[2:], rot=shift if rotate else None)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(a, b)]
            moved = not torch.equal(a[1], kv[1])
            print(f"phase 2: K9 {kind} rotate={rotate}: bit-exact {all(same)} (k, v"
                  f"{', k_scale, v_scale' if kind == 'int8' else ''} = {same}); victims at "
                  f"slots 0, 5, {S // 2}, {S - 33}, {S - 1}, none and {PROMPT}..{PROMPT + BUDGET - 1}"
                  f"; V moved {moved}")
            check(all(same) and moved, f"K9 {kind} rotate={rotate} disagrees")
        errs[("K9", kind)] = 0.0
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
           "decode_attend": kda}
# launches of a kernel's variant, counted by its wrapper beside the total
VARIANTS = {"K1 ordered": (k1, "ordered_launches"), "K1 rank": (k1, "rank_launches"),
            "K2 compact": (k2, "compact_launches")}


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
    runs = {}
    for kv, policy, B in (("bf16", "roco", 1), ("bf16", "full", 1), ("int8", "roco", 1),
                          ("int8", "full", 1), ("int8", "roco", B_WIDE)):
        name = f"{kv} {policy}" + (f" B={B}" if B > 1 else "")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        out = models[kv].easykv_generate(prompts[0].tolist() if B == 1 else prompts[:B].numpy(),
                                         dict(gc, kv_policy=policy))
        c = counts()
        st = models[kv].last_run
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        tok_s = B * st.n_tokens / st.decode_s
        S = gen_mod._round_up(PROMPT + (BUDGET + 1 if policy == "roco" else NEW), 128)
        print(f"phase 3: {name}: prefill {st.prefill_s:.3f} s, decode {B}x{st.n_tokens} "
              f"tokens in {st.decode_s:.3f} s = {tok_s:.2f} tok/s, kv_len {st.kv_len}, "
              f"KV cache {kv_cache_mb(cfg, B, S, kv == 'int8'):.1f} MB (S={S}), "
              f"peak memory {peak:.2f} GiB, launches {c}")
        check(len(out) == NEW and st.logits_finite, f"{name}: bad output / NaN logits")
        n_k5 = L * PROMPT // CHUNK if kv == "int8" else 0
        check(c["K1"] == L * NEW and c["K2"] == NEW and c["K3"] == NEW and c["K5"] == n_k5,
              f"{name}: launch counts {c}")
        if policy == "roco":
            check(st.kv_len - PROMPT == BUDGET,
                  f"{name} kept {st.kv_len - PROMPT} generated tokens, not {BUDGET}")
        runs[name] = dict(counts=c, tok_s=tok_s, prefill_s=st.prefill_s, peak_gib=peak)
    del models
    runs.update(phase_streaming(dev, cfg, params))
    runs.update(phase_encoding(dev, cfg, params))
    runs.update(phase_quant(dev, cfg, params))
    del params
    torch.cuda.empty_cache()
    return runs


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
              f"{st.decode_s:.3f} s = {tok_s:.2f} tok/s, kv_len {st.kv_len}, valid slots per "
              f"(layer, head) {held}, ordered invariant {ordered}, peak memory {peak:.2f} GiB, "
              f"launches {c}; printed: {line}")
        check(len(out) == NEW and st.logits_finite, f"{name}: bad output / NaN logits")
        want = dict(K1=L * NEW, K2=NEW, K3=NEW, K5=L * PROMPT // CHUNK if kv == "int8" else 0)
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
            STRIDE, zero_counts(K1=L * n_dec, K2=n_dec, K3=n_dec, K5=n5, K6=n6,
                                **{"K1 rank": L * n_dec if streaming else 0}),
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
        "encoding", 1, zero_counts(K1=L * steps, K2=steps, K3=steps,
                                   K5=L * ((ridx1 + CHUNK - 1) // CHUNK),
                                   **{"K1 rank": L * steps}),
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
                zero_counts(K1=L * n_dec, K2=n_dec, K3=n_dec, K5=n_prefix if enc else L,
                            **{"K7" if step else "K6": n_chunks}),
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
        desc += f", decode {st.n_tokens} tokens in {st.decode_s:.3f} s = {tok_s:.2f} tok/s"
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
    where ops.quant.mm calls them, K14 and K15 in the decode step)."""
    with mock.patch.multiple(llama_mod, fused_decode_attend_inflight=k1_plain,
                             fused_decode_attend=kda_plain,
                             fused_write_update=k2_plain, write_rows=k3_plain,
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
    # K2: roco with the eviction gate on (the budgeted steady state); four
    # copies of the sidecars (113 MB) cycled; with an int8 cache also the
    # scale rows, of which only the written slot's two scales move
    for kv in ("bf16", "int8"):
        copies = []
        for c in range(4):
            state, per_b, ev, scales = k2_case(L, 1, H, S, dev, 50 + c)
            kw = dict(ev, espec=k2_spec("roco"),
                      evict_gate=torch.ones(1, dtype=torch.bool, device=dev))
            if kv == "int8":
                kw.update(zip(SCALE_NAMES, scales))
            copies.append((state, per_b, kw))

        def run_k2(fn):
            return lambda state, per_b, kw: fn(*state, per_b["q_pos"], per_b["token_valid"],
                                               per_b["update_gate"], per_b["counter_init"],
                                               "roco", **kw)
        slots_total = L * H * S
        out[("K2", kv)] = dict(ms=graph_ms(run_k2(k2), copies, 64),
                               plain_ms=graph_ms(run_k2(k2_plain), copies, 8), library_ms=None,
                               bytes=36 * slots_total + L * H * (8 + (16 if kv == "int8" else 0)),
                               flops=slots_total * (8 + 31 + 4), peak=F32_FLOPS)
        del copies
    # K3: one launch writes every layer's rows; library yardstick: index_put_
    for kv, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
        k, v, kn3, vn3, slots = k3_case(L, 1, H, S, D, dev, 60, dtype)
        idx = (torch.arange(L, device=dev)[:, None, None],
               torch.zeros(1, 1, 1, dtype=torch.long, device=dev),
               torch.arange(H, device=dev)[None, None, :], slots.long())
        kr, vr = kn3[:, :, :, 0], vn3[:, :, :, 0]

        def library(*_):
            k.index_put_(idx, kr)
            v.index_put_(idx, vr)
        rows = L * H
        out[("K3", kv)] = dict(ms=graph_ms(k3, [(k, v, kn3, vn3, slots)], 200),
                               plain_ms=graph_ms(k3_plain, [(k, v, kn3, vn3, slots)], 50),
                               library_ms=graph_ms(library, [()], 50),
                               bytes=2 * 2 * rows * D * k.element_size() + rows * 4, flops=0,
                               peak=F32_FLOPS)
    out[("K5", "int8")] = k5_times(dev)
    out[("K6", "int8")] = k6_times(dev)
    out.update(streaming_times(dev))
    for r in out.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r.pop("peak") * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def tail_rows(v_slot, S):
    """Rows at and above each head's victim: what K8 and K9 move."""
    return int((S - v_slot.clamp(max=S)).sum())


def streaming_times(dev):
    """The ordered StreamingLLM kernels at the main path's shapes (L=32,
    B=1, H=32, S=768, D=128; victims among the 200 generated tokens, one
    head in six without). Bounds: K4 reads pos, score, score_sq and
    counter (16 bytes a slot) and writes counter (4) and one pos per row;
    K9 and K8 read and write the K and V rows (and int8 scales) at and
    above each victim once, K8
    also the four sidecars there and pos_mid / pos in full to find the
    victims; K2 compact moves what K2 moves; K1 ordered what K1 moves plus
    the (S, D/2) cos and sin tables once (k1_time_cases). No PyTorch call
    computes the others: their library_ms is None; K1 ordered's is
    k1_library_ms."""
    L, H, S, D = STREAM_SHAPE
    slots = L * H * S
    out = {}
    # K4: roco, gate on; in place, so each call evicts one more slot per row
    # (the selection reads every slot whatever was evicted before)
    copies = []
    for c in range(4):
        state, per_b, ev, _ = k2_case(L, 1, H, S, dev, 170 + c)
        copies.append((*state[:4], torch.ones(1, dtype=torch.bool, device=dev),
                       ev["next_pos"], ev["prompt_len"], ev["rand_rank"], k2_spec("roco")))
    out[("K4", "-")] = dict(ms=graph_ms(k4, copies, 32), plain_ms=graph_ms(k4_plain, copies, 8),
                            library_ms=None, bytes=20 * slots + L * H * 4 + 16,
                            flops=slots * (8 + 31 + 4), peak=F32_FLOPS)
    del copies
    # K2 compact: the K2 timing's inputs with compact=True
    for kv in ("bf16", "int8"):
        copies = []
        for c in range(4):
            state, per_b, ev, scales = k2_case(L, 1, H, S, dev, 180 + c)
            kw = dict(ev, espec=k2_spec("roco"), compact=True,
                      evict_gate=torch.ones(1, dtype=torch.bool, device=dev))
            if kv == "int8":
                kw.update(zip(SCALE_NAMES, scales))
            copies.append((state, per_b, kw))

        def run_k2(fn):
            return lambda state, per_b, kw: fn(*state, *per_b.values(), "roco", **kw)
        out[("K2 compact", kv)] = dict(
            ms=graph_ms(run_k2(k2), copies, 64), plain_ms=graph_ms(run_k2(k2_plain), copies, 8),
            library_ms=None, bytes=36 * slots + L * H * (12 + (16 if kv == "int8" else 0)),
            flops=slots * (8 + 31 + 4), peak=F32_FLOPS)
        del copies
    shift = shift_rotation(rope_inv_freq(D, LLAMA2_7B.rope_theta, dev))
    pos = slot_positions(L, 1, H, S, PROMPT + BUDGET, torch.Generator().manual_seed(190), dev)
    for kv in ("bf16", "int8"):
        kvr = kv_rows(L, 1, H, S, D, kv, dev, 191)
        vs = stream_victims(L, 1, H, S, dev, 192)
        rows = tail_rows(vs, S)
        row_bytes = 2 * D * (1 if kv == "int8" else 2) + (8 if kv == "int8" else 0)
        args = [(kvr[0], kvr[1], vs, *kvr[2:])]

        def run_k9(fn):
            return lambda *a: fn(*a, rot=shift)
        out[("K9", kv)] = dict(ms=graph_ms(run_k9(k9), args, 64),
                               plain_ms=graph_ms(run_k9(k9_plain), args, 8), library_ms=None,
                               bytes=2 * rows * row_bytes + vs.numel() * 4,
                               flops=rows * D * 6, peak=F32_FLOPS)
        print(f"phase 5: K9 {kv} inputs: {rows} rows at and above the victims of "
              f"{L * H} heads ({rows / (L * H):.1f} per head), "
              f"{(2 * rows * row_bytes) / 1e6:.2f} MB to move")
        if kv == "int8":
            # K8 (the rotate-at-read path, int8 run): the same victims, as
            # pos_mid -> pos; each call restores pos first (a 3 MB copy timed
            # alone and subtracted), since K8 consumes its victims
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
            out[("K8", kv)] = dict(
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
    for r in out.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r.pop("peak") * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


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
K11_MS, K12_MS, K13_MS = (2, 4, 16, 96, 128, 512), tuple(range(1, 9)), (1, 4, 256)
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
    widths, K13 at M = 1, 4, 256 (fused widths; the head with a float32
    result). Returns the max |err| keyed (kernel, shape, M, x dtype)."""
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
                    if kernel in ("K10", "K12") or (kernel, M) == ("K13", 1):   # no shared state:
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
                  f"{B}x{st.n_tokens} tokens in {st.decode_s:.3f} s = {tok_s:.2f} tok/s, kv_len "
                  f"{st.kv_len}, valid slots per (layer, row, head) {held}, weights "
                  f"{step_gb:.3f} GB per step, peak memory {peak:.2f} GiB, launches {c}; "
                  f"printed: {line}")
            check(len(out) == NEW and st.logits_finite, f"{name}: bad output / NaN logits")
            want = dict(K1=L * NEW, K2=NEW, K3=NEW, K5=n_k5 if kv == "int8" else 0,
                        K13=NEW + 1)
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
                              weight_gb=step_gb)
        del models, model, qparams
        torch.cuda.empty_cache()
    return runs


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


def quant_times(dev):
    """K10-K13 at the 7B shapes, bf16 activations: K10 and K12 at the split
    tree's three widths (M = 1), K11 at them and at the fused tree's wqkv
    and wgu at M = 4 (B=4 decode) and M = 512 (the prompt's prefill), K13
    at the fused tree's four products and
    the head (f32 logits), M = 1. Each
    graph cycles enough copies of the weight that L2 is cold. Bound: the
    weight, scale, x and out bytes at 3.35 TB/s, or 2 M K N operations at
    989 TFLOP/s (bf16 x) where that is larger. Library: torch.matmul of x
    with a bf16 copy dequantized beforehand (not timed)."""
    plan = [("K10", "arith", SPLIT_SHAPES, (1,)), ("K12", "halves", SPLIT_SHAPES, (1,)),
            ("K11", "arith", K11_SHAPES, (4, 512)), ("K13", "int8", FUSED + ("head",), (1,))]
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
    for r in out.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r.pop("peak") * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


QMETA = {  # name, source, TPU kernel it replaces
    "K10": ("w4a16_gemv_arith", "easykv_tpu_torch/csrc/quant_gemv.cu",   # K13's M = 1 stream
            "easykv_tpu/ops/pallas/w4_stream.py:258"),
    "K11": ("w4a16_gemm_arith", "easykv_tpu_torch/csrc/w4_gemm.cu",
            "easykv_tpu/ops/pallas/w4_stream.py:182"),
    "K12": ("w4a16_gemv", "easykv_tpu_torch/csrc/w4_matmul.cu",
            "easykv_tpu/ops/pallas/w4_matmul.py:62"),
    "K13": ("quant_matmul", "easykv_tpu_torch/csrc/quant_gemv.cu",   # M = 1, its own kernel
            "easykv_tpu/ops/pallas/quant_matmul.py:41"),
}


def quant_records(qtimes, errs, runs):
    """Phase 5's lines and `kernels` entries of K10-K13, one per (kernel,
    shape, M); launches are the kernel's total in its phase-3 run (K11 at
    M = 512: the prefill of the int4 arithmetic roco run; at the fused
    tree's wqkv and wgu, that tree's B=1 roco run, whose prefill runs K11
    at all four fused widths). Per decode step:
    K10 and K12 over the split tree's seven products a layer, K13 over the
    fused tree's four."""
    records = []
    for (kernel, name, M), t in qtimes.items():
        kname, src, repl = QMETA[kernel]
        run = ("int4 arith fused roco" if kernel == "K11" and name in ("wqkv", "wgu")
               else "int4 arith split roco" if (kernel, M) == ("K11", 512) else QUANT_RUNS[kernel])
        launches = runs[run]["counts"][kernel]
        K, N = QSHAPES[name]
        label = f"{kname} {name} (M={M}, K={K}, N={N}{', f32 out' if name == 'head' else ''})"
        print(f"phase 5: {kernel} {label}: {t['ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, library {t['library_ms'] * 1e3:.2f} us, bound "
              f"{t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), {t['copies']} weight copies "
              f"cycled; {launches} launches of {kernel} in the {run} run")
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
K15_RUNS = {(B_WIDE, "int8"): "int4 arith fused roco B=4",
            (B_WIDE, "bf16"): "int4 arith fused roco B=4 bf16 KV",
            (B_MAX, "int8"): "int4 arith fused roco B=16",
            (B_MAX, "bf16"): "int4 arith fused roco B=16 bf16 KV"}
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
    row, B=4 and 16, bf16 and int8 KV. Bound: the bytes one step reads once
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
    for B in (B_WIDE, B_MAX):
        for kv in ("bf16", "int8"):
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
        label = f"{kname} (B={B}, {kv} KV, L=32, S={S_MAIN})"
        print(f"phase 5: K15 {label}: {t['ms'] * 1e3:.2f} us, plain {t['plain_ms'] * 1e3:.2f} us, "
              f"library none, bound {t['bound_ms'] * 1e3:.2f} us (bytes: weights "
              f"{t['weight_gb']:.3f} GB, K/V and pos {t['kv_gb']:.3f} GB), {launches / NEW:g} "
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
    for r in out.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r.pop("peak") * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


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
        "K3": ("write_rows", "easykv_tpu_torch/csrc/row_write.cu",
               "easykv_tpu/ops/pallas/row_write.py:36", "{kv} roco"),
        "K4": ("fused_evict", "easykv_tpu_torch/csrc/sidecar_update.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:419", "int8 stream roco rotate-at-read"),
        "K5": ("fused_chunk_attend", "easykv_tpu_torch/csrc/chunk_attention.cu",
               "easykv_tpu/ops/pallas/chunk_attention.py:183", "{kv} roco"),
        "K6": ("fused_chunk_write_attend", "easykv_tpu_torch/csrc/chunk_attention.cu",
               "easykv_tpu/ops/pallas/chunk_attention.py:641", "int8 encoding roco"),
        "K8": ("fused_compact", "easykv_tpu_torch/csrc/kv_compact.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:565", "int8 stream roco rotate-at-read"),
        "K9": ("fused_kv_compact", "easykv_tpu_torch/csrc/kv_compact.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:801", "{kv} stream roco prerot"),
    }
    kernels = []
    for (key, kv), t in times.items():
        kname, src, repl, run = meta[key]
        run = run.format(kv=kv)
        if kv == "int8":
            kname += " (int8 KV)"
        launches = runs[run]["counts"][key]
        per = "call" if key in ("K5", "K6") else "step"
        n_per = launches / (1 if per == "call" else NEW)
        lib = "none" if t["library_ms"] is None else f"{t['library_ms'] * 1e3:.2f} us"
        print(f"phase 5: {key} {kname}: {t['ms'] * 1e3:.2f} us, plain "
              f"{t['plain_ms'] * 1e3:.2f} us, library {lib}, "
              f"bound {t['bound_ms'] * 1e3:.2f} us ({t['bound_by']}), "
              f"{n_per:g} launches/{per} in the {run} run")
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": repl,
                        "launches": launches, "max_abs_err": errs[(key, kv)], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    kernels += k7_records(k7t, errs, runs, times[("K6", "int8")]["library_ms"])
    kernels += rank_records(rtimes, errs, runs)
    kernels += quant_records(qtimes, errs, runs)
    kernels += k14_records(ktimes, runs)
    kernels += k15_records(btimes, runs)
    print("phase 5: K5 launches in the encoding family's runs: " + ", ".join(
        f"{run} {r['counts']['K5']}" for run, r in runs.items()
        if "encod" in run or "ppl" in run))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
