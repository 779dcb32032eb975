"""Generation engine: budget-constrained KV-cache generation in the kv_modes
decoding / encoding / auto / encoding_decoding / ppl (counterpart of
easykv_tpu/engine/generate.py: stride_align, stride_align_encdec,
EngineStatics, _encode_counter_init, _prefill, _prefill_layer_major,
_strided_encode, _strided_encode_layer_major, _ce_from_hidden,
_prerotate_cache, _compact_one, _decode_loop (with its carried ranks,
_carry_ranks; split into _Carry, _DecodeStep, capture_step and _drive), _engine_cache,
_run_decoding, _run_encoding, _run_encdec, _run_ppl, _run_ppl_full,
CausalLM, enable_fixed_kv, set_dynamicntk_rope_length, generate).

Budget semantics (reference easykv.py:199-901):
  * decoding: the budget covers only generated tokens, prompt KV is never
    evicted, one slot per (layer, head) is evicted per step once the
    generated count exceeds the budget; the decode-phase recent window is
    the hard-coded 0.3 of the budget (easykv.py:308).
  * encoding: float budget -> int(length*budget)+stride; idx walks down so
    (length-idx)%stride==0, r_idx so (idx-r_idx)%stride==0
    (easykv.py:385-392); the prefix [0, r_idx) is prefilled without
    eviction, the rest is encoded in chunks of `stride` that evict `stride`
    slots per (layer, head) once the cache would exceed idx; decoding then
    keeps everything.
  * encoding_decoding: int budget (+stride unless that reaches the
    length), tiny prefix (ascending r_idx scan, easykv.py:551-552), and one
    eviction per step through decode, prompt slots included
    (easykv.py:670-748).
  * ppl: teacher-forced CE over the tokens fed after r_idx, predicted from
    the evicted cache (easykv.py:759-901).
  * streaming=True (StreamingLLM, reference llama_patch.py:251-379): RoPE
    by cache-relative position. `decoding` keeps an age-ordered cache (see
    _decode_loop); the encoding family encodes chunk-major over an
    unordered cache whose K rotates by its age rank (_strided_encode), and
    its decode carries the ranks from step to step. Full-budget `ppl` is
    never streaming, as in the JAX package.

No loop waits for the host per chunk or per token: the strided encode's
trigger schedule is static (it is computed on the host from the lengths),
the sampled token, `done`, `out`, `g` and `kv_len` stay on the device, and
the decode loop reads back whether every row is done at most once every
ALL_DONE_CHECK_EVERY steps (only when there are EOS ids to stop on).
Tokens after EOS are -1. On the card the decode loop replays a CUDA graph
of one step (the JAX package's on-device while_loop), so no kernel of a
step waits for the host; flags.eager_decode_loop runs it eagerly there too.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import flags
from ..cache import KVCache, init_cache, quantize_kv
from ..config import GenerationConfig, ModelConfig, resolve_device
from ..models import llama
from ..models.llama import LlamaParams, StepCtx
from ..ops.aux_math import confidence
from ..ops.cuda import launch_counters
from ..ops.cuda.kv_compact import fused_compact
from ..ops.rope import rotate
from ..policies import (PHASE_DECODE, PHASE_ENCDEC_DECODE, PHASE_ENCODE, PolicySpec,
                        evict_cache)
from ..sampling import sample_topp

# Width of the no-eviction prompt-prefill chunks. Any width gives the same
# result; peak memory for the per-chunk attention probabilities grows with it.
PREFILL_CHUNK = 128
ALL_DONE_CHECK_EVERY = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stride_align(length: int, budget: int, stride: int) -> Tuple[int, int]:
    """Reference easykv.py:389-392: idx = largest <= budget with
    (length-idx)%stride==0; r_idx = largest < idx with (idx-r_idx)%stride==0."""
    idx = 0
    for i in range(budget, -1, -1):
        if (length - i) % stride == 0:
            idx = i
            break
    r_idx = 0
    for r in range(idx - 1, -1, -1):
        if (idx - r) % stride == 0:
            r_idx = r
            break
    return idx, r_idx


def stride_align_encdec(length: int, budget: int, stride: int) -> Tuple[int, int]:
    """Reference easykv.py:549-552: the same idx; r_idx = smallest >= 1 with
    (idx-r_idx)%stride==0 (ascending scan: a tiny prefix)."""
    idx = 0
    for i in range(budget, -1, -1):
        if (length - i) % stride == 0:
            idx = i
            break
    r_idx = idx - 1 if idx >= 1 else 0
    for r in range(1, idx):
        if (idx - r) % stride == 0:
            r_idx = r
            break
    return idx, r_idx


@dataclasses.dataclass(frozen=True)
class EngineStatics:
    """What shapes one run."""

    cfg: ModelConfig
    policy: str
    length: int               # prompt length (decoding: padded to a multiple of 64)
    budget: int               # resolved integer budget (after the reference's shifts)
    max_new_tokens: int = 0
    eos_token_ids: Tuple[int, ...] = ()
    temp_length: int = 4
    recent_window_dec: int = 0  # decode-phase recent window (the 0.3 quirk)
    kv_quant: bool = False      # int8 KV cache with per-slot scales
    mode: str = "decoding"
    stride: int = 1
    idx: int = 0
    r_idx: int = 0
    recent_window: int = 0      # encode-phase recent window
    keep_attention: bool = False
    streaming: bool = False     # StreamingLLM: RoPE by cache-relative position
    collect_stats: bool = False  # keep each step's token probability and confidence

    def encode_spec(self) -> PolicySpec:
        return PolicySpec(
            policy=self.policy,
            phase=PHASE_ENCODE,
            k=self.stride,
            sink_length=self.temp_length,
            recent_window=self.recent_window,
            # reference easykv.py:474: k = max(budget - recent_window - sink, stride)
            feasible_k=min(
                max(self.budget - self.recent_window - self.temp_length, self.stride),
                self.idx + self.stride,
            ),
        )

    def decode_spec(self) -> Optional[PolicySpec]:
        if self.policy == "full":
            return None
        return PolicySpec(
            policy=self.policy,
            phase=PHASE_DECODE,
            k=1,
            sink_length=self.temp_length,
            recent_window=self.recent_window_dec,
            # reference easykv.py:322: k = budget - recent_window
            feasible_k=max(self.budget - self.recent_window_dec, 1),
            protect_prompt=True,
        )

    def encdec_decode_spec(self) -> PolicySpec:
        return PolicySpec(
            policy=self.policy,
            phase=PHASE_ENCDEC_DECODE,
            k=1,
            sink_length=self.temp_length,
            recent_window=self.recent_window_dec,
            # reference easykv.py:722: k = budget - recent_window, clamped to
            # the idx valid slots the encode leaves
            feasible_k=max(min(self.budget - self.recent_window_dec, self.idx), 1),
        )


def _encode_counter_init(pos: torch.Tensor, idx: int, stride: int, keep: bool) -> torch.Tensor:
    """Per-token initial observation counter of the encoding family, the
    closed form of the reference's buffer initialisers and post-eviction
    tails (easykv.py:412-418, 469, 483):
      pos >= idx:  -((pos - idx) % stride)   (<= 0)
      pos <  idx:  idx - pos if keep_attention else 0"""
    tail = -(((pos - idx) % stride).to(torch.float32))
    head = (idx - pos).to(torch.float32) if keep else torch.zeros_like(pos, dtype=torch.float32)
    return torch.where(pos >= idx, tail, head)


class DecodeResult(NamedTuple):
    out_ids: torch.Tensor   # (B, max_new_tokens) int32, -1 past the end
    n_tokens: torch.Tensor  # (B,) tokens emitted (including EOS)
    kv_len: torch.Tensor    # (B,) final valid cache slots
    finite: torch.Tensor    # () bool: every step's logits were finite
    # With st.collect_stats, the reference's decode-loop bookkeeping
    # (easykv.py:236-285): the sampled token's raw softmax probability and
    # the step's exp(-entropy) confidence, (B, max_new_tokens) f32, 0 past
    # the emitted tokens; None otherwise.
    token_probs: Optional[torch.Tensor] = None
    confidence: Optional[torch.Tensor] = None
    capture_s: float = 0.0  # host seconds capturing the step's CUDA graph (0: none)
    graph_nodes: int = 0    # the graph's nodes


@dataclasses.dataclass
class RunStats:
    """Host-clock timings and counts of the last generate() call. prefill_s
    is the prompt (decoding) or prefix (encoding family) prefill, encode_s
    the strided encode, decode_s the decode loop (its CUDA graph's capture
    included: capture_s of it, a graph of graph_nodes nodes); each ends in a
    synchronise."""

    n_tokens: int
    kv_len: int
    prefill_s: float
    decode_s: float
    logits_finite: bool
    encode_s: float = 0.0
    capture_s: float = 0.0
    graph_nodes: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _isin_eos(token: torch.Tensor, eos: Optional[torch.Tensor]) -> torch.Tensor:
    if eos is None:
        return torch.zeros_like(token, dtype=torch.bool)
    return (token[:, None] == eos).any(dim=-1)


# ---------------------------------------------------------------------------
# Phase A: prompt / prefix prefill (optionally the keep_attention bootstrap)
# ---------------------------------------------------------------------------

def _prefill(st: EngineStatics, params: LlamaParams, cache: KVCache,
             ids: torch.Tensor, prefix_len: torch.Tensor,
             spec: Optional[PolicySpec] = None, counter_kind: str = "zero") -> torch.Tensor:
    """Consume the prompt (or prefix) into the empty cache; returns the last
    real token's logits (B, V). spec: the keep_attention bootstrap;
    counter_kind 'zero' | 'encode' (_encode_counter_init)."""
    B, A = ids.shape
    if A == 0:
        return torch.zeros((B, st.cfg.vocab_size), dtype=torch.float32, device=ids.device)
    PC = min(PREFILL_CHUNK, _round_up(A, 8))
    A_pad = _round_up(A, PC)
    ids = torch.nn.functional.pad(ids, (0, A_pad - A))
    return _prefill_layer_major(st, params, cache, ids, prefix_len, PC, spec, counter_kind)


def _prefill_layer_major(st, params, cache, ids, prefix_len, PC, spec,
                         counter_kind) -> torch.Tensor:
    B, A_pad = ids.shape
    n = A_pad // PC
    dev = ids.device
    pos = (torch.arange(n, device=dev)[:, None] * PC
           + torch.arange(PC, device=dev)[None, :]).to(torch.int32)     # (n, PC)
    posb = pos[:, None, :].expand(n, B, PC)
    tok_valid = posb < prefix_len[None, :, None]
    q_pos = torch.where(tok_valid, posb, -1).to(torch.int32)
    if counter_kind == "encode":
        cinit = _encode_counter_init(pos, st.idx, st.stride, st.keep_attention)
    else:
        cinit = torch.zeros((n, PC), dtype=torch.float32, device=dev)
    cinit = cinit[:, None, :].expand(n, B, PC).contiguous()
    h = llama.prefill_layer_major(params, st.cfg, cache, ids, q_pos, cinit, spec)
    last = (prefix_len - 1).clamp(min=0).long()
    h_last = h[torch.arange(B, device=dev), last][:, None]              # (B, 1, D)
    logits = llama._logits_tail(h_last, params, st.cfg)[:, 0]
    return torch.where((prefix_len > 0)[:, None], logits, 0.0)


# ---------------------------------------------------------------------------
# Phase B: strided encoding with per-chunk eviction (reference easykv.py:426-499)
# ---------------------------------------------------------------------------

def _encode_schedule(st: EngineStatics, B: int, spec: PolicySpec,
                     generator: torch.Generator, dev: torch.device):
    """The strided encode's static chunk schedule: every row feeds st.length
    tokens, so the reference's per-row trigger (kv_len + stride > idx,
    easykv.py:459) is the same for all rows and is computed here on the
    host, with no sync per chunk. Returns (ctxs, the StepCtx of every chunk
    stacked over a leading (n,) axis; trig, the (n,) host triggers; the
    (n,) valid slots before each chunk; the valid slots after the last).
    The random policy's rank is drawn once per chunk and row from
    `generator`."""
    stride, idx = st.stride, st.idx
    n = (st.length - st.r_idx) // stride
    evicting = spec.policy != "full"
    keep = bool(st.keep_attention)

    kv = st.r_idx
    trig, kv_before = [], []
    for _ in range(n):
        kv_before.append(kv)
        t = kv + stride > idx
        trig.append(t)
        kv = kv + stride - (stride if (t and evicting) else 0)
    trig_t = torch.tensor(trig, dtype=torch.bool, device=dev)[:, None].expand(n, B)

    starts = st.r_idx + stride * np.arange(n)
    pos = torch.as_tensor(starts[:, None] + np.arange(stride)[None, :], dtype=torch.int32,
                          device=dev)                                    # (n, C)
    cinit = _encode_counter_init(pos, idx, stride, keep)
    if spec.policy == "random":
        # uniform span start over ranks [0, S_enc - stride) (easykv.py:494-497)
        S_enc = idx + stride   # the reference's encode-phase buffer width
        u = torch.rand((n, B), generator=generator, device=dev)
        rand_rank = (u * (S_enc - stride)).to(torch.int32)
    else:
        rand_rank = torch.zeros((n, B), dtype=torch.int32, device=dev)
    ctxs = StepCtx(
        q_pos=pos[:, None, :].expand(n, B, stride).contiguous(),
        token_valid=torch.ones((n, B, stride), dtype=torch.bool, device=dev),
        counter_init=cinit[:, None, :].expand(n, B, stride).contiguous(),
        next_pos=torch.as_tensor(starts + stride, dtype=torch.int32,
                                 device=dev)[:, None].expand(n, B).contiguous(),
        prompt_len=torch.zeros((n, B), dtype=torch.int32, device=dev),
        evict_gate=(trig_t if evicting else torch.zeros_like(trig_t)).contiguous(),
        update_gate=(trig_t | keep).contiguous(),
        rand_rank=rand_rank,
    )
    return ctxs, trig, kv_before, kv


def _strided_encode_layer_major(st: EngineStatics, params: LlamaParams, cache: KVCache,
                                input_ids: torch.Tensor, spec: PolicySpec,
                                generator: torch.Generator, collect_ppl: bool):
    """Consume [r_idx, length) in chunks of `stride`, layer-major
    (llama.strided_encode_layer_major) on _encode_schedule's static
    schedule. Returns (last_logits (B, V), loss_sum (B,), kv_len (B,))."""
    B = input_ids.shape[0]
    dev = input_ids.device
    ctxs, trig, kv_before, kv = _encode_schedule(st, B, spec, generator, dev)
    n = len(trig)
    evicting = spec.policy != "full"
    tokens = input_ids[:, st.r_idx: st.r_idx + n * st.stride]
    h = llama.strided_encode_layer_major(params, st.cfg, cache, tokens, ctxs, spec,
                                         kv_before, [t and evicting for t in trig])
    last_logits = llama._logits_tail(h[:, -1:, :], params, st.cfg)[:, 0]
    loss_sum = (_ce_from_hidden(st, params, h, tokens) if collect_ppl
                else torch.zeros((B,), dtype=torch.float32, device=dev))
    return last_logits, loss_sum, torch.full((B,), kv, dtype=torch.int32, device=dev)


def _strided_encode(st: EngineStatics, params: LlamaParams, cache: KVCache,
                    input_ids: torch.Tensor, spec: PolicySpec, generator: torch.Generator,
                    collect_ppl: bool):
    """Consume [r_idx, length) in chunks of `stride`, chunk-major (the JAX
    package's _strided_encode, generate.py:385-464 there): each chunk
    through every layer with llama.forward over the StreamingLLM rank
    cache (a stride-1 chunk through _decode_forward and K1's rank variant),
    then, on the chunks the static schedule triggers, one eviction event
    across all layers (policies.evict_cache with the encode spec). With
    collect_ppl, the cross entropy of each chunk's tokens from the rows
    before them in the chunk, and of its first token from the previous
    chunk's last row. Returns (last_logits (B, V), loss_sum (B,), kv_len
    (B,))."""
    B = input_ids.shape[0]
    dev = input_ids.device
    stride = st.stride
    ctxs, trig, _, kv = _encode_schedule(st, B, spec, generator, dev)
    evicting = spec.policy != "full"
    stream = llama.stream_tables(cache.pos.shape[-1], st.cfg, dev, "rank")
    loss_sum = torch.zeros((B,), dtype=torch.float32, device=dev)
    last_logits = None
    for c in range(len(trig)):
        ctx = StepCtx(*(x[c] for x in ctxs))
        chunk = input_ids[:, st.r_idx + c * stride: st.r_idx + (c + 1) * stride]
        logits = llama.forward(params, st.cfg, cache, chunk, ctx, spec, stream=stream)
        if evicting and trig[c]:
            evict_cache(cache, spec, ctx.next_pos, ctx.prompt_len, ctx.rand_rank,
                        ctx.evict_gate)
        if collect_ppl:
            logp = torch.log_softmax(logits, dim=-1)
            tgt = chunk.long()
            loss_sum = loss_sum - logp[:, :-1].gather(-1, tgt[:, 1:, None])[..., 0].sum(-1)
            if last_logits is not None:
                prev = torch.log_softmax(last_logits, dim=-1)
                loss_sum = loss_sum - prev.gather(-1, tgt[:, :1])[:, 0]
        last_logits = logits[:, -1, :]
    return last_logits, loss_sum, torch.full((B,), kv, dtype=torch.int32, device=dev)


def _ce_from_hidden(st: EngineStatics, params: LlamaParams, h: torch.Tensor,
                    tokens: torch.Tensor, true_len: Optional[torch.Tensor] = None):
    """Teacher-forced CE from final hidden states: token j scored from row
    j-1, summed over j in [1, true_len) (reference easykv.py:896-899; the
    first fed token has no predictor). The LM head runs in PREFILL_CHUNK row
    blocks over f32 logits, so the (B, T, V) logits are never materialised.
    Returns (B,) f32."""
    B, T, _ = h.shape
    dev = h.device
    if true_len is None:
        true_len = torch.full((B,), T, dtype=torch.int32, device=dev)
    PC = min(PREFILL_CHUNK, _round_up(T, 8))
    T_pad = _round_up(T, PC)
    h = torch.nn.functional.pad(h, (0, 0, 0, T_pad - T))
    tgt = torch.nn.functional.pad(tokens, (0, T_pad - T + 1)).long()
    loss = torch.zeros((B,), dtype=torch.float32, device=dev)
    for s in range(0, T_pad, PC):
        logp = torch.log_softmax(llama._logits_tail(h[:, s:s + PC], params, st.cfg), dim=-1)
        ce = -logp.gather(-1, tgt[:, s + 1:s + 1 + PC, None])[..., 0]
        mask = (s + torch.arange(PC, device=dev))[None, :] + 1 < true_len[:, None]
        loss = loss + (ce * mask.to(torch.float32)).sum(dim=-1)
    return loss


# ---------------------------------------------------------------------------
# Decode loop (reference easykv.py:257-363 / :508-526 / :670-748)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _prerotate_cache(cache: KVCache, cfg: ModelConfig) -> None:
    """One-time transform entering pre-rotated ordered streaming decoding
    (flags.prerot_enabled), in place: every slot's K times R(slot). The
    `decoding` prefill cached K post-RoPE at its true position (== slot in
    the fresh ordered cache), so the composed R(slot)·R(pos)·k reproduces
    the reference's prefix double rotation (easykv.py:232 vs :253-256). An
    int8 cache is dequantized, rotated in f32 and requantized with
    quantize_kv. One layer at a time, so the f32 copy stays one layer."""
    cos, sin = llama.rotation_tables(cache.pos.shape[-1], cfg, cache.k.device)
    for l in range(cache.k.shape[0]):
        kf = cache.k[l].to(torch.float32)
        if cache.quantized:
            kf = kf * cache.k_scale[l][..., None]
        rot = rotate(kf, cos, sin)
        if cache.quantized:
            cache.k[l], cache.k_scale[l] = quantize_kv(rot)
        else:
            cache.k[l] = rot.to(cache.k.dtype)


def _compact_one(cache: KVCache, pos_mid: torch.Tensor) -> None:
    """Age-ordered compaction after a k=1 eviction event, in place: per
    (layer, batch, head), the slots above the victim (the first slot valid
    in pos_mid and invalid now) shift down by one, so the valid slots stay
    contiguous and age-ordered (reference truncate_kv_cache_silo,
    easykv.py:56-68). Kernel K8 over every cache array; a head without an
    eviction is left as it is."""
    fused_compact(pos_mid, cache.pos, cache.score, cache.score_sq, cache.counter, cache.k,
                  cache.v, cache.k_scale, cache.v_scale)


def _carry_ranks(ranks: torch.Tensor, pos_pre: torch.Tensor, pos_mid: torch.Tensor,
                 pos: torch.Tensor) -> torch.Tensor:
    """The age ranks (L, B, H, S) of the unordered StreamingLLM cache after
    one decode step, written into `ranks` (the ranks before it) and
    returned, from the cache's pos before the forward (pos_pre), after it
    (pos_mid) and after the step's eviction (pos; pos_mid itself when none
    ran). The written slot gets the pre-write valid count (every head of a
    row holds the same count); then, where a slot was evicted, every younger
    slot's rank drops by one and the victim's becomes 0. Equal to
    _age_ranks(pos) while every eviction removes at most one slot per head
    (the JAX package's inc_ranks, generate.py:854-877 there)."""
    written = (pos_mid >= 0) & (pos_pre < 0)
    n_valid = (pos_pre[:, :, :1, :] >= 0).sum(dim=-1, keepdim=True, dtype=torch.int32)
    new = torch.where(written, n_valid, ranks)
    if pos is not pos_mid:
        evicted = (pos_mid >= 0) & (pos < 0)
        rank_e = torch.where(evicted, new, -1).amax(dim=-1, keepdim=True)     # (L, B, H, 1)
        new = torch.where((new > rank_e) & (rank_e >= 0) & ~evicted, new - 1, new)
        new = torch.where(evicted, 0, new)
    return ranks.copy_(new)


class _Carry(NamedTuple):
    """The decode loop's state from step to step (the JAX package's
    while_loop carry, generate.py:880-885 there, less the cache and the
    key). Each step reads it and writes it in place, never rebinding a
    tensor, so that a CUDA graph of one step reads and writes the same
    storage on every replay."""
    n: torch.Tensor                  # (1,) int64 index of the step
    lastlog: torch.Tensor            # (B, V) f32 logits producing the next token
    done: torch.Tensor               # (B,) bool
    g: torch.Tensor                  # (B,) int32 live steps so far
    kv_len: torch.Tensor             # (B,) int32
    finite: torch.Tensor             # () bool: every step's logits finite
    out: torch.Tensor                # (B, M) int32, -1 past the end
    tps: Optional[torch.Tensor]      # (B, M) f32 with st.collect_stats
    confs: Optional[torch.Tensor]
    ranks: Optional[torch.Tensor]    # (L, B, H, S) int32: the rank cache's age ranks


def _uniform(generator: torch.Generator, B: int, device: torch.device) -> torch.Tensor:
    """The `random` policy's draw of a step, (B,) f32 in [0, 1)."""
    return torch.rand((B,), generator=generator, device=device)


@dataclasses.dataclass
class _DecodeStep:
    """One decode step of _decode_loop, reading and writing the carry and
    the cache in place: sample, record, one forward, the step's eviction,
    the carried ranks, the counts. Everything it keeps across steps is in
    the carry, so it can be called eagerly or captured once and replayed."""

    st: EngineStatics
    params: LlamaParams
    cache: KVCache
    c: _Carry
    start_pos: torch.Tensor
    prompt_len: torch.Tensor
    spec: Optional[PolicySpec]
    generator: torch.Generator
    temperature: float
    top_p: float
    evict_mode: str
    stream: Optional[llama.StreamRot]
    ordered: bool     # the age-ordered StreamingLLM cache: compact after each eviction
    evicts: bool      # evict_cache after the forward (the eviction is not folded into K2)

    def __post_init__(self):
        dev, B = self.c.out.device, self.c.out.shape[0]
        self.eos = (torch.tensor(self.st.eos_token_ids, dtype=torch.int32, device=dev)
                    if self.st.eos_token_ids else None)
        self.zeros_i = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.zeros_f = torch.zeros((B,), dtype=torch.float32, device=dev)

    def __call__(self) -> None:
        st, c, cache, spec = self.st, self.c, self.cache, self.spec
        token = sample_topp(self.generator, c.lastlog, self.temperature, self.top_p)
        c.out.index_copy_(1, c.n, torch.where(c.done, -1, token)[:, None])
        if st.collect_stats:
            raw = torch.softmax(c.lastlog / max(self.temperature, 1e-9), dim=-1)
            tp = torch.where(c.done, 0.0, raw.gather(-1, token[:, None].long())[:, 0])
            c.tps.index_copy_(1, c.n, tp[:, None])
            c.confs.index_copy_(1, c.n, torch.where(c.done, 0.0, confidence(raw))[:, None])
        newly_done = c.done | _isin_eos(token, self.eos)
        live = ~newly_done
        tok_pos = self.start_pos + c.g
        if self.evict_mode == "budget":
            gate_b = live & (c.g + 1 > st.budget)                 # easykv.py:302-303
            cinit = (st.budget - c.g).clamp(min=0).to(torch.float32)
        elif self.evict_mode == "always":
            gate_b = live                                         # easykv.py:670-748
            cinit = self.zeros_f
        else:
            gate_b = torch.zeros_like(live)
            cinit = self.zeros_f
        if spec is not None and spec.policy == "random":
            u = _uniform(self.generator, live.shape[0], live.device)
            if spec.phase == PHASE_DECODE:
                # uniform over retained generated tokens (easykv.py:353-362)
                n_rank = (c.g + 1).clamp(max=st.budget + 1)
            else:
                # encdec decode: uniform over non-sink valid slots
                n_rank = (c.kv_len + 1 - spec.sink_length).clamp(min=1)
            rand_rank = (u * n_rank.to(torch.float32)).to(torch.int32)
        else:
            rand_rank = self.zeros_i
        ctx = StepCtx(
            q_pos=torch.where(live, tok_pos, -1).to(torch.int32)[:, None],
            token_valid=live[:, None],
            counter_init=cinit[:, None],
            next_pos=tok_pos + 1,
            prompt_len=self.prompt_len,
            evict_gate=gate_b,
            update_gate=live,
            rand_rank=rand_rank,
        )
        stream = self.stream
        if c.ranks is not None:
            pos_pre = cache.pos.clone()
            stream = stream._replace(ranks=c.ranks)
        logits = llama._decode_forward(self.params, st.cfg, cache, token[:, None], ctx, spec,
                                       stream)
        pos_mid = cache.pos.clone() if self.evicts and st.streaming else cache.pos
        if self.evicts:
            evict_cache(cache, spec, ctx.next_pos, self.prompt_len, rand_rank, gate_b)
            if self.ordered:
                _compact_one(cache, pos_mid)
        if c.ranks is not None:
            _carry_ranks(c.ranks, pos_pre, pos_mid, cache.pos)
        c.finite.logical_and_(torch.isfinite(logits).all())
        c.lastlog.copy_(torch.where(newly_done[:, None], c.lastlog, logits[:, -1, :]))
        k_evict = spec.k if spec is not None else 0
        c.kv_len.add_(live.to(torch.int32) - gate_b.to(torch.int32) * k_evict)
        c.g.add_(live.to(torch.int32))
        c.done.copy_(newly_done)
        c.n.add_(1)


def _graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a captured graph (kept with keep_graph=True)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes failed ({err})")
    return n.value


class CapturedStep(NamedTuple):
    """One call of a step captured as a CUDA graph (capture_step)."""
    graph: torch.cuda.CUDAGraph
    launches: list          # [(wrapper, counter attribute, launches a replay)]
    capture_s: float        # host seconds of the capture and instantiation
    nodes: int              # the graph's nodes

    def replay(self) -> None:
        """Replays the graph and adds its launches to the wrappers' counts."""
        self.graph.replay()
        for fn, attr, d in self.launches:
            setattr(fn, attr, getattr(fn, attr) + d)


def capture_step(step, generator: torch.Generator) -> CapturedStep:
    """Captures one call of `step` (which must have run eagerly on the card
    once: that loads the kernels and makes the tables, ticket rows and
    library handles it keeps) as a CUDA graph, `generator` registered with
    it so that replayed draws equal eager ones. The wrappers bump their
    launch counts while the step is captured; those counts are put back
    (the capture ran nothing) and kept for the replays. A capture that
    fails raises."""
    t0 = time.perf_counter()
    counters = launch_counters()
    before = [getattr(fn, attr) for fn, attr in counters]
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.register_generator_state(generator)
    with torch.cuda.graph(g):
        step()
    launches = [(fn, attr, getattr(fn, attr) - b) for (fn, attr), b in zip(counters, before)]
    for (fn, attr), b in zip(counters, before):
        setattr(fn, attr, b)
    nodes = _graph_nodes(g)
    g.instantiate()
    return CapturedStep(g, launches, time.perf_counter() - t0, nodes)


def _drive(step: _DecodeStep, M: int, graph: bool) -> Tuple[float, int]:
    """Runs up to M steps, stopping early once every row is done (read back
    every ALL_DONE_CHECK_EVERY steps, only when there are EOS ids). Eager:
    each step called in turn. graph: step 0 runs eagerly, one step is
    captured (capture_step), and the graph is replayed for the others. A
    capture or replay that fails raises. Returns (the capture's seconds, the
    graph's nodes), (0, 0) without a graph."""
    c = step.c

    def all_done(n: int) -> bool:
        return (step.eos is not None and (n + 1) % ALL_DONE_CHECK_EVERY == 0
                and bool(c.done.all()))

    if not graph:
        for n in range(M):
            step()
            if all_done(n):
                break
        return 0.0, 0
    step()
    if M == 1 or all_done(0):
        return 0.0, 0
    captured = capture_step(step, step.generator)
    for n in range(1, M):
        captured.replay()
        if all_done(n):
            break
    return captured.capture_s, captured.nodes


@torch.no_grad()
def _decode_loop(
    st: EngineStatics,
    params: LlamaParams,
    cache: KVCache,
    first_logits: torch.Tensor,  # (B, V) logits producing token 1
    start_pos: torch.Tensor,     # (B,) position of the first generated token
    prompt_len: torch.Tensor,    # (B,)
    kv_len0: torch.Tensor,       # (B,)
    spec: Optional[PolicySpec],
    generator: torch.Generator,
    temperature: float,
    top_p: float,
    evict_mode: str,             # 'none' | 'budget' | 'always'
) -> DecodeResult:
    """Decode with the eviction cadence of `evict_mode`: 'budget' evicts
    once the generated count exceeds the budget (decoding), 'always' on
    every live step (encoding_decoding), 'none' never (encoding). A
    decode-phase k=1 spec folds its eviction into K2; any other spec is
    evicted by policies.evict_cache after the step.

    The loop is the JAX package's lax.while_loop (generate.py:730-903
    there) split in three: the carry (_Carry), one step that updates it and
    the cache in place (_DecodeStep), and the loop that runs it (_drive). On
    the card _drive replays a CUDA graph of the step, so that no kernel of a step
    waits for the host; on the CPU, or on the card inside
    flags.eager_decode_loop, it calls the step eagerly.

    StreamingLLM `decoding` (st.streaming, st.mode == "decoding") keeps
    the cache age-ordered: rank == slot, kept so by compacting each head at
    its victim after every eviction. With flags.prerot_enabled (the
    default) the cache is pre-rotated once after the prefill and each step
    folds eviction and compaction into K2 + K9; otherwise K1 rotates by
    slot at read time and each step runs evict_cache (K4) and _compact_one
    (K8) after the forward. K4, K8 and K9 launch every step: a head with
    nothing to evict is a no-op inside the kernel, so no host sync decides.

    StreamingLLM in the encoding family leaves an unordered cache: its
    decode rotates each slot by its age rank (K1's rank variant). The ranks
    are computed once before the loop (_age_ranks) and carried from step
    to step by _carry_ranks, with no sort per step (the JAX package's
    inc_ranks, its default); the step's eviction (k=1 or none) runs after
    the forward, as policies.evict_cache.

    With st.collect_stats each step also keeps the sampled token's
    probability under the raw temperature softmax and that softmax's
    exp(-entropy), on the device (no host sync per token)."""
    B = first_logits.shape[0]
    M = st.max_new_tokens
    dev = first_logits.device
    graph = dev.type == "cuda" and flags.decode_graph_enabled()
    ordered = st.streaming and st.mode == "decoding"
    prerot = ordered and flags.prerot_enabled()
    stream = ranks = None
    if st.streaming:
        kind = "prerotated" if prerot else "ordered" if ordered else "rank"
        stream = llama.stream_tables(cache.pos.shape[-1], st.cfg, dev, kind)
    if prerot:
        _prerotate_cache(cache, st.cfg)
    if st.streaming and not ordered:
        ranks = llama.age_ranks_all(cache.pos)
    tps = confs = None
    if st.collect_stats:
        tps = torch.zeros((B, M), dtype=torch.float32, device=dev)
        confs = torch.zeros_like(tps)
    c = _Carry(n=torch.zeros((1,), dtype=torch.int64, device=dev),
               lastlog=first_logits.to(torch.float32).clone(),
               done=torch.zeros((B,), dtype=torch.bool, device=dev),
               g=torch.zeros((B,), dtype=torch.int32, device=dev),
               kv_len=kv_len0.to(torch.int32).clone(),
               finite=torch.isfinite(first_logits).all(),
               out=torch.full((B, M), -1, dtype=torch.int32, device=dev),
               tps=tps, confs=confs, ranks=ranks)
    folded = (llama.decode_evict_folded(spec, st.streaming)
              or llama.decode_stream_folded(spec, st.streaming, ordered, prerot))
    step = _DecodeStep(st, params, cache, c, start_pos, prompt_len, spec, generator,
                       temperature, top_p, evict_mode, stream, ordered,
                       spec is not None and not folded)
    capture_s, nodes = _drive(step, M, graph) if M else (0.0, 0)
    emitted = (c.out >= 0).sum(dim=-1)
    return DecodeResult(c.out, emitted, c.kv_len, c.finite, tps, confs, capture_s, nodes)


def _engine_cache(st: EngineStatics, B: int, S: int, dtype: torch.dtype,
                  device: torch.device) -> KVCache:
    """The slot count is rounded up to a multiple of 128: spare slots are
    inert (validity is pos >= 0, eviction is budget-gated), and the kernels'
    measured shapes assume it."""
    S = _round_up(S, 128)
    c = st.cfg
    return init_cache(c.num_hidden_layers, B, c.num_key_value_heads, S, c.head_dim,
                      dtype=dtype, device=device, quantized=st.kv_quant)


# ---------------------------------------------------------------------------
# The kv_modes. Each run function returns its result, the final cache and the host-clock
# seconds of its phases (prefill, strided encode, decode).
# ---------------------------------------------------------------------------

class _Clock:
    """Host-clock seconds of consecutive phases, each ended by a sync."""

    def __init__(self, device: torch.device):
        self.device = device
        self.t = time.perf_counter()

    def lap(self) -> float:
        _sync(self.device)
        now = time.perf_counter()
        dt, self.t = now - self.t, now
        return dt


@torch.no_grad()
def _run_decoding(st: EngineStatics, params: LlamaParams, ids_pad: torch.Tensor,
                  prompt_len: torch.Tensor, temperature: float, top_p: float,
                  generator: torch.Generator,
                  dtype: torch.dtype) -> Tuple[DecodeResult, KVCache, float, float]:
    """kv_mode='decoding' (reference easykv.py:228-366). Returns the result,
    the final cache, and the prefill and decode host-clock seconds."""
    dev = ids_pad.device
    B = ids_pad.shape[0]
    gen_slots = st.max_new_tokens if st.policy == "full" else st.budget + 1
    cache = _engine_cache(st, B, st.length + gen_slots, dtype, dev)
    clock = _Clock(dev)
    last_logits = _prefill(st, params, cache, ids_pad, prompt_len)
    prefill_s = clock.lap()
    res = _decode_loop(st, params, cache, last_logits, prompt_len, prompt_len, prompt_len,
                       st.decode_spec(), generator, temperature, top_p,
                       "none" if st.policy == "full" else "budget")
    return res, cache, prefill_s, clock.lap()


def _encode_phases(st: EngineStatics, params, cache, input_ids, generator, collect_ppl):
    """Prefix prefill of [0, r_idx) (with the keep_attention bootstrap) and
    the strided encode: chunk-major under streaming, as the JAX package's
    _strided_encode takes it (generate.py:401 there), layer-major otherwise.
    The prefix prefill is never streaming: its K is cached post-RoPE at its
    true position and the streaming phases rotate it again by rank, the
    reference's double rotation (generate.py:274-283 there). Returns
    (last_logits, loss_sum, kv_len, prefill_s, encode_s)."""
    dev = input_ids.device
    B = input_ids.shape[0]
    spec = st.encode_spec()
    clock = _Clock(dev)
    prefix_len = torch.full((B,), st.r_idx, dtype=torch.int32, device=dev)
    last_logits = _prefill(st, params, cache, input_ids[:, :st.r_idx], prefix_len,
                           spec if st.keep_attention else None, "encode")
    prefill_s = clock.lap()
    loss_sum = torch.zeros((B,), dtype=torch.float32, device=dev)
    kv_len = prefix_len
    if (st.length - st.r_idx) // st.stride > 0:
        encode = _strided_encode if st.streaming else _strided_encode_layer_major
        last_logits, loss_sum, kv_len = encode(st, params, cache, input_ids, spec, generator,
                                               collect_ppl)
    return last_logits, loss_sum, kv_len, prefill_s, clock.lap()


@torch.no_grad()
def _run_encoding(st: EngineStatics, params: LlamaParams, input_ids: torch.Tensor,
                  temperature: float, top_p: float, generator: torch.Generator,
                  dtype: torch.dtype):
    """kv_mode='encoding' (reference easykv.py:367-529): strided prefill
    eviction, then decoding without eviction. Returns (result, encode
    kv_len (B,), cache, RunStats without the token counts)."""
    dev = input_ids.device
    B = input_ids.shape[0]
    cache = _engine_cache(st, B, st.idx + st.stride + st.max_new_tokens, dtype, dev)
    last_logits, _, kv_len, prefill_s, encode_s = _encode_phases(
        st, params, cache, input_ids, generator, collect_ppl=False)
    clock = _Clock(dev)
    length = torch.full((B,), st.length, dtype=torch.int32, device=dev)
    res = _decode_loop(st, params, cache, last_logits, length, length, kv_len, None,
                       generator, temperature, top_p, "none")
    return res, kv_len, cache, (prefill_s, encode_s, clock.lap())


@torch.no_grad()
def _run_encdec(st: EngineStatics, params: LlamaParams, input_ids: torch.Tensor,
                temperature: float, top_p: float, generator: torch.Generator,
                dtype: torch.dtype):
    """kv_mode='encoding_decoding' (reference easykv.py:530-753): strided
    prefill eviction, then one eviction per live decode step. Returns
    (result, cache, (prefill_s, encode_s, decode_s))."""
    dev = input_ids.device
    B = input_ids.shape[0]
    cache = _engine_cache(st, B, st.idx + st.stride, dtype, dev)
    last_logits, _, kv_len, prefill_s, encode_s = _encode_phases(
        st, params, cache, input_ids, generator, collect_ppl=False)
    clock = _Clock(dev)
    length = torch.full((B,), st.length, dtype=torch.int32, device=dev)
    res = _decode_loop(st, params, cache, last_logits, length, length, kv_len,
                       st.encdec_decode_spec(), generator, temperature, top_p, "always")
    return res, cache, (prefill_s, encode_s, clock.lap())


@torch.no_grad()
def _run_ppl(st: EngineStatics, params: LlamaParams, input_ids: torch.Tensor,
             generator: torch.Generator, dtype: torch.dtype):
    """kv_mode='ppl', budgeted (reference easykv.py:766-901). Returns (mean
    CE (B,), kv_len (B,), (prefill_s, encode_s))."""
    B = input_ids.shape[0]
    cache = _engine_cache(st, B, st.idx + st.stride, dtype, input_ids.device)
    _, loss_sum, kv_len, prefill_s, encode_s = _encode_phases(
        st, params, cache, input_ids, generator, collect_ppl=True)
    return loss_sum / (st.length - st.r_idx - 1), kv_len, (prefill_s, encode_s)


@torch.no_grad()
def _run_ppl_full(st: EngineStatics, params: LlamaParams, input_ids: torch.Tensor,
                  dtype: torch.dtype):
    """kv_mode='ppl', full cache (reference easykv.py:759-765): teacher
    forcing over the whole document through the layer-major prefill.
    Returns (mean CE (B,), prefill_s)."""
    dev = input_ids.device
    B, L = input_ids.shape
    PC = min(PREFILL_CHUNK, _round_up(L, 8))
    L_pad = _round_up(L, PC)
    ids = torch.nn.functional.pad(input_ids, (0, L_pad - L))
    cache = _engine_cache(st, B, L_pad, dtype, dev)
    true_len = torch.full((B,), L, dtype=torch.int32, device=dev)
    n = L_pad // PC
    clock = _Clock(dev)
    pos = (torch.arange(n, device=dev)[:, None] * PC
           + torch.arange(PC, device=dev)[None, :]).to(torch.int32)
    posb = pos[:, None, :].expand(n, B, PC)
    q_pos = torch.where(posb < L, posb, -1).to(torch.int32)
    h = llama.prefill_layer_major(params, st.cfg, cache, ids, q_pos,
                                  torch.zeros((n, B, PC), dtype=torch.float32, device=dev))
    loss = _ce_from_hidden(st, params, h, ids, true_len=true_len) / (L - 1)
    return loss, clock.lap()


# ---------------------------------------------------------------------------
# Public API (reference enable_fixed_kv, easykv.py:903-908)
# ---------------------------------------------------------------------------

class CausalLM:
    """Model wrapper binding config and parameters (and a tokenizer).

    The model runs on `device`: the card unless the caller asks for another
    (device="cpu"); without a card and without a device it raises. The
    activations take the parameters' dtype, and so does the KV cache unless
    kv_quant=True: then K/V are int8 with per-slot f32 scales."""

    def __init__(self, cfg: ModelConfig, params: LlamaParams, tokenizer=None,
                 device=None, kv_quant: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.tokenizer = tokenizer
        self.dtype = self.params.embed.dtype
        self.kv_quant = kv_quant
        self.last_run: Optional[RunStats] = None

    # bound by enable_fixed_kv:
    easykv_generate = None
    easykv_ppl = None


def enable_fixed_kv(model: CausalLM, tokenizer, mode: str, stride: int = 1,
                    verbose: bool = False) -> CausalLM:
    """Bind easykv_generate / easykv_ppl onto the model
    (reference easykv.py:903-908)."""
    model.tokenizer = tokenizer
    model.easykv_generate = functools.partial(
        generate, model, kv_mode=mode, stride=stride, report_decoding_latency=verbose
    )
    model.easykv_ppl = functools.partial(generate, model, kv_mode="ppl", stride=stride)
    print(f"Fixed KV Cache for {mode} enabled")
    return model


def set_dynamicntk_rope_length(model: CausalLM, max_length: int) -> None:
    """Pin the DynamicNTK RoPE base to `max_length` (reference utils.py:53-57)."""
    model.cfg = dataclasses.replace(model.cfg, rope_ntk_length=max_length)


def _as_batch(input_ids) -> np.ndarray:
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.cpu().numpy()
    arr = np.asarray(input_ids)
    if arr.ndim == 1:
        arr = arr[None, :]
    return arr.astype(np.int32)


def _is_full_budget(budget, length) -> bool:
    return (isinstance(budget, float) and budget >= 1.0) or (
        isinstance(budget, int) and budget >= length)


def _report_confidence(res: DecodeResult) -> None:
    """The verbose summary of the decode-loop bookkeeping of row 0
    (reference easykv.py:261 token_probs, :279 exp(-entropy)), as the JAX
    package prints it."""
    if res.confidence is None or not bool(res.confidence.any()):
        return
    emitted = res.out_ids[0] >= 0
    if not bool(emitted.any()):
        return
    conf = res.confidence[0][emitted].cpu().numpy()
    tp = res.token_probs[0][emitted].cpu().numpy()
    print(f"Decoding confidence exp(-entropy): mean {conf.mean():.4f} "
          f"min {conf.min():.4f}; token prob: mean {tp.mean():.4f} "
          f"min {tp.min():.4f}")


def _finalize(model: CausalLM, res: DecodeResult, kv_len: int, phases) -> list:
    """Record model.last_run and return row 0's tokens (decoded if a
    tokenizer is attached)."""
    out_ids = res.out_ids.cpu().numpy()
    prefill_s, encode_s, decode_s = phases
    model.last_run = RunStats(int(res.n_tokens[0]), kv_len, prefill_s, decode_s,
                              bool(res.finite), encode_s, res.capture_s, res.graph_nodes)
    ids_out = [int(t) for t in out_ids[0] if t >= 0]
    if model.tokenizer is not None:
        return model.tokenizer.decode(ids_out, skip_special_tokens=True).strip()
    return ids_out


def generate(
    model: CausalLM,
    input_ids,
    generation_config,
    kv_mode: str = "encoding",
    stride: int = 1,
    report_decoding_latency: bool = False,
):
    """Reference-parity entry point (reference easykv.py:199-901). Returns
    the decoded string if a tokenizer is attached, else the list of
    generated token ids; kv_mode='ppl' returns the perplexity float. Timings
    and counts go to model.last_run."""
    if isinstance(generation_config, GenerationConfig):
        gc = generation_config
    else:
        gc = GenerationConfig.from_dict(dict(generation_config))
    gc = gc.with_policy()
    ids = _as_batch(input_ids)
    B, length = ids.shape
    eos = gc.eos_token_ids
    if not eos and model.tokenizer is not None:
        tok_eos = getattr(model.tokenizer, "eos_token_id", None)
        if tok_eos is not None:
            eos = (int(tok_eos),)
    budget = gc.budget
    mode = kv_mode
    if mode == "auto":
        # reference easykv.py:220-227
        if not isinstance(budget, int):
            raise ValueError("auto mode requires an integer budget")
        if budget > length:
            mode, budget = "decoding", budget - length
        else:
            mode = "encoding_decoding"

    base = dict(cfg=model.cfg, policy=gc.kv_policy, stride=stride, eos_token_ids=tuple(eos),
                temp_length=gc.temp_length, keep_attention=gc.keep_attention,
                max_new_tokens=gc.max_new_tokens, kv_quant=model.kv_quant,
                streaming=gc.streaming, collect_stats=report_decoding_latency)
    dev = model.device
    generator = torch.Generator(device=dev).manual_seed(gc.seed)
    temp, top_p = float(gc.temperature), float(gc.top_p)
    ids_t = torch.from_numpy(ids).to(dev)

    if mode == "decoding":
        if not (isinstance(budget, int) or gc.kv_policy == "full"):
            raise ValueError("decoding mode requires an integer budget")
        b = int(budget)
        P_pad = _round_up(length, 64)
        st = EngineStatics(length=P_pad, budget=b, recent_window_dec=int(b * 0.3),  # easykv.py:308
                           **base)
        ids_pad = np.zeros((B, P_pad), np.int32)
        ids_pad[:, :length] = ids
        prompt_len = torch.full((B,), length, dtype=torch.int32, device=dev)
        res, _, prefill_s, decode_s = _run_decoding(
            st, model.params, torch.from_numpy(ids_pad).to(dev), prompt_len, temp, top_p,
            generator, model.dtype)
        kv_len = int(res.kv_len[0])
        out = _finalize(model, res, kv_len, (prefill_s, 0.0, decode_s))
        retained, n_out = kv_len - length, model.last_run.n_tokens
        if n_out:
            print(f"KV cache budget ratio: {retained / n_out * 100:.2f}%({retained}/{n_out})")
        if report_decoding_latency:
            print(f"Per-step decoding latency: {decode_s / max(n_out, 1):.3f}")
            _report_confidence(res)
        return out

    if mode in ("encoding", "ppl") and _is_full_budget(budget, length):
        if mode == "ppl":
            st = EngineStatics(mode="ppl", length=length, budget=length, **base)
            # never streaming: the reference runs the whole document through
            # stock attention (the JAX package's _run_ppl_full)
            loss, prefill_s = _run_ppl_full(st, model.params, ids_t, model.dtype)
            loss0 = float(loss[0])
            model.last_run = RunStats(0, length, prefill_s, 0.0, math.isfinite(loss0))
            return float(np.exp(loss0))
        # full-cache encoding: no eviction at all (reference easykv.py:372-377)
        st = EngineStatics(mode="encoding", length=length, budget=length, idx=length + stride,
                           r_idx=length, **{**base, "policy": "full"})
        res, _, _, phases = _run_encoding(st, model.params, ids_t, temp, top_p, generator,
                                          model.dtype)
        print(f"KV cache budget ratio: {length / length * 100:.2f}%({length}/{length})")
        return _finalize(model, res, int(res.kv_len[0]), phases)

    if mode in ("encoding", "ppl"):
        # reference easykv.py:385-392 budget resolution
        b = int(length * budget) + stride if isinstance(budget, float) else int(budget) + stride
        # ppl takes the ascending r_idx scan (a tiny prefix), like
        # encoding_decoding (reference easykv.py:777-780)
        idx, r_idx = (stride_align_encdec if mode == "ppl" else stride_align)(length, b, stride)
        if (length - r_idx) % stride != 0:
            raise ValueError(f"length={length}, stride={stride}, budget={budget}: prefix "
                             f"remainder not stride-aligned (idx={idx}, r_idx={r_idx})")
        st = EngineStatics(mode=mode, length=length, budget=b, idx=idx, r_idx=r_idx,
                           recent_window=int(b * gc.recent_ratio),
                           recent_window_dec=int(b * 0.3), **base)
        if mode == "ppl":
            loss, kv_len, (prefill_s, encode_s) = _run_ppl(
                st, model.params, ids_t, generator, model.dtype)
            kv, loss0 = int(kv_len[0]), float(loss[0])
            model.last_run = RunStats(0, kv, prefill_s, 0.0, math.isfinite(loss0), encode_s)
            print(f"KV cache budget ratio: {kv / length * 100:.2f}%({kv}/{length})")
            return float(np.exp(loss0))
        res, kv_len, _, phases = _run_encoding(st, model.params, ids_t, temp, top_p,
                                               generator, model.dtype)
        kv = int(kv_len[0])
        out = _finalize(model, res, int(res.kv_len[0]), phases)
        print(f"KV cache budget ratio: {kv / length * 100:.2f}%({kv}/{length})")
        if report_decoding_latency:
            n_out = model.last_run.n_tokens
            print(f"Per-step decoding latency: {phases[2] / max(n_out, 1):.3f}")
            _report_confidence(res)
        return out

    if mode == "encoding_decoding":
        if not (isinstance(budget, int) and budget <= length):
            raise ValueError("encoding_decoding requires an int budget <= prompt length")
        white = ["random", "recency", "tova", "roco"]
        if gc.kv_policy not in white:   # reference easykv.py:536-537
            raise ValueError(f"mode must be within {white}, get {gc.kv_policy} instead")
        b = budget + stride
        if b >= length:
            b -= stride
        idx, r_idx = stride_align_encdec(length, b, stride)
        st = EngineStatics(mode=mode, length=length, budget=b, idx=idx, r_idx=r_idx,
                           recent_window=int(b * gc.recent_ratio),
                           recent_window_dec=int(b * 0.3), **base)
        res, _, phases = _run_encdec(st, model.params, ids_t, temp, top_p, generator,
                                     model.dtype)
        kv = int(res.kv_len[0])
        out = _finalize(model, res, kv, phases)
        n_out = model.last_run.n_tokens
        print(f"KV Cache Budget ratio {kv / (length + n_out) * 100:.2f}%"
              f"[{kv}/({length}+{n_out})]")
        return out

    raise ValueError(f"unknown kv_mode {kv_mode!r}")
