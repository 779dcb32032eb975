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
     sliding window, f32), K6 chunk write + attend (S=2304, C=96: int8 and
     bf16 caches, contiguous and scattered write slots, statistics on and
     off, GQA with B=2, a sliding window, f32, negative initial counters;
     cache arrays bit-exact); the ordered StreamingLLM kernels: K4 gated
     eviction (five policies, gate on and off by row, B=2), K2 `compact`
     (five policies, with and without the scale rows), K9 K/V shift (bf16
     and int8, rotate on and off, victims at the first, a middle and the
     last tile, and none) and K8 compaction (bf16 and int8) bit-exact on
     every array; K1 `ordered` (bf16 and int8, MHA, GQA with B=2) within
     K1's limit;
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
     and int8 `ppl`. Launch counters are zeroed just before each run and
     read just after;
  4. the kernel path against the plain path on the card: full width, L=2,
     float32, 32 new tokens with roco at budget 8, float and int8 caches:
     equal greedy tokens and final positions; StreamingLLM `decoding` over
     the pre-rotated and the rotate-at-read cache, float and int8: equal
     tokens and final positions (int8: layer 0, K/V within one int8 step
     elsewhere); then `encoding` (also with
     keep_attention), `encoding_decoding` and `ppl` with roco on a
     1024-token prompt, stride 96: equal tokens and kv_len; equal final
     positions (an int8 cache: in layer 0, and K/V within one int8 step
     elsewhere); ppl within 1e-5 relative;
  5. per-kernel device times (CUDA graphs of many launches, timed with CUDA
     events) beside each one's plain version, library call and bound, for
     each cache dtype the main path gives the kernel.

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
from easykv_tpu_torch.cache import quantize_kv
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.llama import init_params, rotation_tables
from easykv_tpu_torch.ops.cuda import _build
from easykv_tpu_torch.ops.cuda import sidecar_update as sidecar_mod
from easykv_tpu_torch.ops.cuda.kv_compact import (
    fused_compact as k8, fused_compact_plain as k8_plain, fused_kv_compact as k9,
    fused_kv_compact_plain as k9_plain, shift_rotation)
from easykv_tpu_torch.ops.rope import rope_inv_freq
from easykv_tpu_torch.ops.cuda.chunk_attention import (
    fused_chunk_attend as k5, fused_chunk_attend_plain as k5_plain,
    fused_chunk_write_attend as k6, fused_chunk_write_attend_plain as k6_plain)
from easykv_tpu_torch.ops.cuda.decode_attention import (
    fused_decode_attend_inflight as k1, fused_decode_attend_inflight_plain as k1_plain)
from easykv_tpu_torch.ops.cuda.row_write import write_rows as k3, write_rows_plain as k3_plain
from easykv_tpu_torch.ops.cuda.sidecar_update import (
    fused_evict as k4, fused_evict_plain as k4_plain, fused_write_update as k2,
    fused_write_update_plain as k2_plain)
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
    return errs


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
    """K5 against its plain version: out within 1e-5 (f32) or one bf16 ulp
    of the reference plus 1e-3 (bf16); ssum, ssq, last within 1e-5; padding
    rows exactly 0. Returns the max |err| of the main path's case."""
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
    ]
    main_err = None
    for i, (name, B, Hq, Hkv, dtype, quant, scores, pad, window) in enumerate(cases):
        args = k5_case(B, Hq, Hkv, n_last, dtype, quant, pad, dev, 70 + i)
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
            zero = got[0][-1, :, CHUNK - 17:].abs().max().item() == 0
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


KERNELS = {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K5": k5, "K6": k6, "K8": k8, "K9": k9}
# launches of a kernel's variant, counted by its wrapper beside the total
VARIANTS = {"K1 ordered": (k1, "ordered_launches"), "K2 compact": (k2, "compact_launches")}


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
def engine_caches():
    """Records every KV cache the engine allocates, so that a run through
    generate() can be read back after it."""
    made, make = [], gen_mod._engine_cache

    def record(*args):
        made.append(make(*args))
        return made[-1]
    with mock.patch.object(gen_mod, "_engine_cache", record):
        yield made


def phase_encoding(dev, cfg, params):
    """The encoding family at 7B width on a 4096-token prompt, stride 96,
    128 new tokens, greedy, through generate() and enable_fixed_kv's
    easykv_ppl. Checks the exact launch counts, the slot counts and the
    printed budget ratios. The slots left by the encode are counted in the
    final cache: `encoding` then adds one per decode step, encoding_decoding
    writes one and evicts one, ppl does not decode."""
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
        model.easykv_generate(prompt[:1024], dict(gc, budget=0.5, max_new_tokens=4))
    plan = [  # name, kv, mode, budget, K5, K6, decode launches, slots after the run
        ("int8 encoding roco", "int8", "encoding", 0.5, n_prefix, n_enc, ENC_NEW,
         ENC_IDX + ENC_NEW,
         f"KV cache budget ratio: {ENC_IDX / ENC_PROMPT * 100:.2f}%({ENC_IDX}/{ENC_PROMPT})"),
        ("bf16 encoding roco", "bf16", "encoding", 0.5, 0, 0, ENC_NEW, ENC_IDX + ENC_NEW,
         f"KV cache budget ratio: {ENC_IDX / ENC_PROMPT * 100:.2f}%({ENC_IDX}/{ENC_PROMPT})"),
        ("int8 encoding_decoding roco", "int8", "encoding_decoding", 2048, L, n_encdec,
         ENC_NEW, ENC_IDX, f"KV Cache Budget ratio "
         f"{ENC_IDX / (ENC_PROMPT + ENC_NEW) * 100:.2f}%[{ENC_IDX}/({ENC_PROMPT}+{ENC_NEW})]"),
        ("int8 ppl roco", "int8", "ppl", 0.5, L, n_encdec, 0, ENC_IDX,
         f"KV cache budget ratio: {ENC_IDX / ENC_PROMPT * 100:.2f}%({ENC_IDX}/{ENC_PROMPT})"),
    ]
    runs = {}
    for name, kv, mode, budget, n5, n6, n_dec, slots, ratio in plan:
        model = models[kv]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        printed = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(printed), engine_caches() as made:
            if mode == "ppl":
                out = model.easykv_ppl(prompt, dict(gc, budget=budget))
            else:
                out = easykv_tpu_torch.generate(model, prompt, dict(gc, budget=budget),
                                                kv_mode=mode, stride=STRIDE)
        c = counts()
        st = model.last_run
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        valid = (made[-1].pos >= 0).sum(dim=-1)
        held = (int(valid.min()), int(valid.max()))
        del made
        S = ENC_S if mode == "encoding" else ENCDEC_S
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
            check(len(out) == ENC_NEW and st.logits_finite, f"{name}: bad output / NaN logits")
        print(f"{desc}, valid slots per (layer, head) after the run {held}, "
              f"KV cache {kv_cache_mb(cfg, 1, S, kv == 'int8'):.1f} MB (S={S}), peak memory "
              f"{peak:.2f} GiB, launches {c}; printed: {line}")
        want = zero_counts(K1=L * n_dec, K2=n_dec, K3=n_dec, K5=n5, K6=n6)
        check(c == want, f"{name}: launch counts {c}, expected {want}")
        check(held == (slots, slots), f"{name}: slots {held}, expected {slots}")
        check(line == ratio, f"{name}: printed {line!r}, expected {ratio!r}")
        if mode == "encoding_decoding":
            check(st.kv_len == ENC_IDX, f"{name}: kv_len {st.kv_len} after decode")
        runs[name] = dict(counts=c, tok_s=tok_s, prefill_s=st.prefill_s,
                          encode_s=st.encode_s, peak_gib=peak)
    return runs


@contextlib.contextmanager
def plain_kernels():
    """The model with each kernel's wrapper swapped for its plain version
    (K4 where policies.evict_cache imports it, K8 in the engine)."""
    with mock.patch.multiple(llama_mod, fused_decode_attend_inflight=k1_plain,
                             fused_write_update=k2_plain, write_rows=k3_plain,
                             fused_chunk_attend=k5_plain, fused_chunk_write_attend=k6_plain,
                             fused_kv_compact=k9_plain), \
            mock.patch.object(sidecar_mod, "fused_evict", k4_plain), \
            mock.patch.object(gen_mod, "fused_compact", k8_plain):
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
    positions of later layers are printed."""
    n = 1024
    ids = torch.randint(1, cfg.vocab_size, (1, n), generator=torch.Generator().manual_seed(2),
                        dtype=torch.int32).to(dev)
    runs = [("encoding", 0.5, False), ("encoding", 0.5, True), ("encoding_decoding", 512, False),
            ("ppl", 0.5, False)]
    for quant in (False, True):
        kv = "int8" if quant else "f32"
        for mode, budget, keep in runs:
            b = int(n * budget) + STRIDE if isinstance(budget, float) else budget + STRIDE
            align = gen_mod.stride_align if mode == "encoding" else gen_mod.stride_align_encdec
            idx, r_idx = align(n, b, STRIDE)
            st = gen_mod.EngineStatics(
                cfg=cfg, policy="roco", length=n, budget=b, max_new_tokens=32,
                recent_window_dec=int(b * 0.3), kv_quant=quant, mode=mode, stride=STRIDE,
                idx=idx, r_idx=r_idx, recent_window=int(b * 0.1), keep_attention=keep)
            res = {}
            for plain in (False, True):
                gen = torch.Generator(device=dev).manual_seed(0)
                reset_counts()
                with plain_kernels() if plain else contextlib.nullcontext():
                    if mode == "ppl":
                        loss, kv_len, _ = gen_mod._run_ppl(st, params, ids, gen, torch.float32)
                        res[plain] = (float(loss[0]), None, int(kv_len[0]), counts())
                    else:
                        run = gen_mod._run_encoding if mode == "encoding" else gen_mod._run_encdec
                        out = run(st, params, ids, 1e-9, 1.0, gen, torch.float32)
                        cache = out[-2]
                        res[plain] = (out[0].out_ids.cpu(), (cache.pos.cpu(), cache.k.cpu(),
                                                             cache.v.cpu()),
                                      int(out[0].kv_len[0]), counts())
            (ta, ca, la, k_c), (tb, cb, lb, p_c) = res[False], res[True]
            n6 = 2 * ((n - r_idx) // STRIDE) if quant else 0
            name = f"{mode}" + (" keep_attention" if keep else "")
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
                  f"stride {STRIDE}: {what}, kv_len {la} / {lb}; launches kernel path {k_c}, "
                  f"plain path {p_c}")
            check(ok, f"{kv} KV {name}: kernel path and plain path disagree")
            check(k_c["K6"] == n6 and sum(p_c.values()) == 0
                  and (k_c["K5"] > 0) == quant, f"{kv} KV {name}: launch counts")


def graph_ms(fn, arg_sets, reps):
    """Device time of one call: `reps` calls (cycling through arg_sets, so a
    caller that would find the L2 cache cold finds it cold) captured in one
    CUDA graph, replayed, timed with CUDA events."""
    for a in arg_sets:
        fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_times(dev):
    """Times keyed by (kernel, cache dtype), each with its plain version's,
    its library yardstick's (or None) and its bound from this run's inputs."""
    L, H, S, D = 32, 32, S_MAIN, 128
    n_valid = PROMPT + BUDGET
    out = {}
    # K1: one layer per launch, 32 layers' K/V (403 MB bf16) cycled: cold L2
    gk = torch.Generator(device=dev).manual_seed(40)
    pos = slot_positions(L, 1, H, S, n_valid, torch.Generator().manual_seed(40), dev)
    q, kn, vn = (torch.randn(shape, generator=gk, device=dev).to(torch.bfloat16)
                 for shape in ((1, H, 1, D), (1, H, 1, D), (1, H, 1, D)))
    qp = torch.tensor([PROMPT + NEW - 1], dtype=torch.int32, device=dev)
    visible = int(((pos >= 0) & (pos <= qp)).sum()) / L
    for kv in ("bf16", "int8"):
        kc = torch.randn((L, 1, H, S, D), generator=gk, device=dev).to(torch.bfloat16)
        vc = torch.randn((L, 1, H, S, D), generator=gk, device=dev).to(torch.bfloat16)
        if kv == "int8":
            (kc, ksc), (vc, vsc) = quantize_kv(kc), quantize_kv(vc)
            sets = [(q, kn, vn, kc[l], vc[l], pos[l], qp, ksc[l], vsc[l]) for l in range(L)]
            row_bytes = D + 4                            # int8 row and its scale
        else:
            sets = [(q, kn, vn, kc[l], vc[l], pos[l], qp) for l in range(L)]
            row_bytes = D * 2
        k1_bytes = (visible * row_bytes * 2 + H * S * 4 * 2  # K,V rows read; pos, probs
                    + H * D * 2 * 4 + H * 4 + 4)            # q, kn, vn, out; p_new; q_pos
        out[("K1", kv)] = dict(ms=graph_ms(k1, sets, 320), plain_ms=graph_ms(k1_plain, sets, 64),
                               library_ms=None, bytes=k1_bytes, flops=4 * visible * D,
                               peak=F32_FLOPS)
        del kc, vc, sets
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
    the (S, D/2) cos and sin tables once. No PyTorch call computes any of
    them: library_ms is None."""
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
    # K1 ordered: K1's int8 timing with the rotation tables
    gk = torch.Generator(device=dev).manual_seed(194)
    q, kn, vn = (torch.randn((1, H, 1, D), generator=gk, device=dev).to(torch.bfloat16)
                 for _ in range(3))
    qp = torch.tensor([PROMPT + NEW - 1], dtype=torch.int32, device=dev)
    visible = int(((pos >= 0) & (pos <= qp)).sum()) / L
    (kc, ksc), (vc, vsc) = (quantize_kv(torch.randn((L, 1, H, S, D), generator=gk, device=dev))
                            for _ in range(2))
    rot = rotation_tables(S, LLAMA2_7B, dev)
    sets = [(q, kn, vn, kc[l], vc[l], pos[l], qp, ksc[l], vsc[l]) for l in range(L)]

    def run_k1(fn):
        return lambda *a: fn(*a, rot=rot)
    k1_bytes = (visible * (D + 4) * 2 + H * S * 4 * 2 + H * D * 2 * 4 + H * 4 + 4
                + S * D // 2 * 4 * 2)                     # ... and the cos, sin tables
    out[("K1 ordered", "int8")] = dict(ms=graph_ms(run_k1(k1), sets, 320),
                                       plain_ms=graph_ms(run_k1(k1_plain), sets, 64),
                                       library_ms=None, bytes=k1_bytes,
                                       flops=4 * visible * D + 6 * visible * D, peak=F32_FLOPS)
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
    runs = phase_end_to_end(dev)
    phase_plain_vs_kernel(dev)
    times = phase_times(dev)

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
    print("phase 5: K5 launches in the encoding family's runs: " + ", ".join(
        f"{run} {r['counts']['K5']}" for run, r in runs.items()
        if "encod" in run or "ppl" in run))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))


if __name__ == "__main__":
    main()
