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
     cache arrays bit-exact);
  3. the main path end to end at full LLaMa-2-7B width (L=32, D=4096,
     32 heads, F=11008, V=32000; bf16 weights drawn on the card from a seed):
     a 512-token prompt, then 384 new tokens with roco at budget 200, then
     with the full cache, through CausalLM / enable_fixed_kv / generate, with
     a bf16 KV cache and then an int8 one (kv_quant=True: the prefill runs
     K5), and int8 roco at B=4; then the encoding family on a 4096-token
     prompt with stride 96 and 128 new tokens: int8 and bf16 `encoding` (roco
     at budget 0.5: the strided encode runs K6 with the int8 cache), int8
     `encoding_decoding` (roco at budget 2048: an eviction every decode step)
     and int8 `ppl`. Launch counters are zeroed just before each run and
     read just after;
  4. the kernel path against the plain path on the card: full width, L=2,
     float32, 32 new tokens with roco at budget 8, float and int8 caches:
     equal greedy tokens and final positions; then `encoding` (also with
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
from easykv_tpu_torch.cache import quantize_kv
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.llama import init_params
from easykv_tpu_torch.ops.cuda import _build
from easykv_tpu_torch.ops.cuda.chunk_attention import (
    fused_chunk_attend as k5, fused_chunk_attend_plain as k5_plain,
    fused_chunk_write_attend as k6, fused_chunk_write_attend_plain as k6_plain)
from easykv_tpu_torch.ops.cuda.decode_attention import (
    fused_decode_attend_inflight as k1, fused_decode_attend_inflight_plain as k1_plain)
from easykv_tpu_torch.ops.cuda.row_write import write_rows as k3, write_rows_plain as k3_plain
from easykv_tpu_torch.ops.cuda.sidecar_update import (
    fused_write_update as k2, fused_write_update_plain as k2_plain)
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


KERNELS = {"K1": k1, "K2": k2, "K3": k3, "K5": k5, "K6": k6}


def reset_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def counts():
    return {key: fn.launches for key, fn in KERNELS.items()}


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
    runs.update(phase_encoding(dev, cfg, params))
    del params
    torch.cuda.empty_cache()
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
        want = {"K1": L * n_dec, "K2": n_dec, "K3": n_dec, "K5": n5, "K6": n6}
        check(c == want, f"{name}: launch counts {c}, expected {want}")
        check(held == (slots, slots), f"{name}: slots {held}, expected {slots}")
        check(line == ratio, f"{name}: printed {line!r}, expected {ratio!r}")
        if mode == "encoding_decoding":
            check(st.kv_len == ENC_IDX, f"{name}: kv_len {st.kv_len} after decode")
        runs[name] = dict(counts=c, tok_s=tok_s, prefill_s=st.prefill_s,
                          encode_s=st.encode_s, peak_gib=peak)
    return runs


def plain_kernels():
    """The model with each kernel's wrapper swapped for its plain version."""
    return mock.patch.multiple(llama_mod, fused_decode_attend_inflight=k1_plain,
                               fused_write_update=k2_plain, write_rows=k3_plain,
                               fused_chunk_attend=k5_plain,
                               fused_chunk_write_attend=k6_plain)


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
    phase_plain_vs_kernel_encoding(dev, cfg, params)


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
    for r in out.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / r.pop("peak") * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
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

    meta = {
        "K1": ("fused_decode_attend_inflight", "easykv_tpu_torch/csrc/decode_attention.cu",
               "easykv_tpu/ops/pallas/decode_attention.py:207"),
        "K2": ("fused_write_update", "easykv_tpu_torch/csrc/sidecar_update.cu",
               "easykv_tpu/ops/pallas/sidecar_update.py:270"),
        "K3": ("write_rows", "easykv_tpu_torch/csrc/row_write.cu",
               "easykv_tpu/ops/pallas/row_write.py:36"),
        "K5": ("fused_chunk_attend", "easykv_tpu_torch/csrc/chunk_attention.cu",
               "easykv_tpu/ops/pallas/chunk_attention.py:183"),
        "K6": ("fused_chunk_write_attend", "easykv_tpu_torch/csrc/chunk_attention.cu",
               "easykv_tpu/ops/pallas/chunk_attention.py:641"),
    }
    kernels = []
    for (key, kv), t in times.items():
        kname, src, repl = meta[key]
        if kv == "int8":
            kname += " (int8 KV)"
        run = "int8 encoding roco" if key == "K6" else f"{kv} roco"
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
