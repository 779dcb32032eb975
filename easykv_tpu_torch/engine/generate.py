"""Generation engine, `decoding` kv_mode (counterpart of
easykv_tpu/engine/generate.py: EngineStatics, _prefill,
_prefill_layer_major, _decode_loop, _engine_cache, _run_decoding, CausalLM,
enable_fixed_kv, set_dynamicntk_rope_length, generate).

Budget semantics (reference easykv.py:228-366): the budget covers only
generated tokens, prompt KV is never evicted, one slot per (layer, head) is
evicted per step once the generated count exceeds the budget, and the
decode-phase recent window is the hard-coded 0.3 of the budget
(easykv.py:308).

The decode loop never waits for the host per token: the sampled token,
`done`, `out`, `g` and `kv_len` stay on the device, and the loop reads back
whether every row is done at most once every ALL_DONE_CHECK_EVERY steps
(only when there are EOS ids to stop on). Tokens after EOS are -1.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..cache import KVCache, init_cache
from ..config import GenerationConfig, ModelConfig, resolve_device
from ..models import llama
from ..models.llama import LlamaParams, StepCtx
from ..policies import PHASE_DECODE, PolicySpec
from ..sampling import sample_topp

# Width of the no-eviction prompt-prefill chunks. Any width gives the same
# result; peak memory for the per-chunk attention probabilities grows with it.
PREFILL_CHUNK = 128
ALL_DONE_CHECK_EVERY = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class EngineStatics:
    """What shapes one decoding run."""

    cfg: ModelConfig
    policy: str
    length: int               # prompt length, padded to a multiple of 64
    budget: int               # generated tokens kept
    max_new_tokens: int = 0
    eos_token_ids: Tuple[int, ...] = ()
    temp_length: int = 4
    recent_window_dec: int = 0  # decode-phase recent window (the 0.3 quirk)
    kv_quant: bool = False      # int8 KV cache with per-slot scales

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


class DecodeResult(NamedTuple):
    out_ids: torch.Tensor   # (B, max_new_tokens) int32, -1 past the end
    n_tokens: torch.Tensor  # (B,) tokens emitted (including EOS)
    kv_len: torch.Tensor    # (B,) final valid cache slots
    finite: torch.Tensor    # () bool: every step's logits were finite


@dataclasses.dataclass
class RunStats:
    """Host-clock timings and counts of the last generate() call."""

    n_tokens: int
    kv_len: int
    prefill_s: float
    decode_s: float
    logits_finite: bool


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _isin_eos(token: torch.Tensor, eos: Optional[torch.Tensor]) -> torch.Tensor:
    if eos is None:
        return torch.zeros_like(token, dtype=torch.bool)
    return (token[:, None] == eos).any(dim=-1)


def _prefill(st: EngineStatics, params: LlamaParams, cache: KVCache,
             ids: torch.Tensor, prefix_len: torch.Tensor) -> torch.Tensor:
    """Consume the prompt into the empty cache; returns the last real
    token's logits (B, V)."""
    B, A = ids.shape
    if A == 0:
        return torch.zeros((B, st.cfg.vocab_size), dtype=torch.float32, device=ids.device)
    PC = min(PREFILL_CHUNK, _round_up(A, 8))
    A_pad = _round_up(A, PC)
    ids = torch.nn.functional.pad(ids, (0, A_pad - A))
    return _prefill_layer_major(st, params, cache, ids, prefix_len, PC)


def _prefill_layer_major(st, params, cache, ids, prefix_len, PC) -> torch.Tensor:
    B, A_pad = ids.shape
    n = A_pad // PC
    dev = ids.device
    pos = (torch.arange(n, device=dev)[:, None] * PC
           + torch.arange(PC, device=dev)[None, :]).to(torch.int32)     # (n, PC)
    posb = pos[:, None, :].expand(n, B, PC)
    tok_valid = posb < prefix_len[None, :, None]
    q_pos = torch.where(tok_valid, posb, -1).to(torch.int32)
    cinit = torch.zeros((n, B, PC), dtype=torch.float32, device=dev)
    h = llama.prefill_layer_major(params, st.cfg, cache, ids, q_pos, cinit)
    last = (prefix_len - 1).clamp(min=0).long()
    h_last = h[torch.arange(B, device=dev), last][:, None]              # (B, 1, D)
    logits = llama._logits_tail(h_last, params, st.cfg)[:, 0]
    return torch.where((prefix_len > 0)[:, None], logits, 0.0)


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
) -> DecodeResult:
    B = first_logits.shape[0]
    M = st.max_new_tokens
    dev = first_logits.device
    eos = (torch.tensor(st.eos_token_ids, dtype=torch.int32, device=dev)
           if st.eos_token_ids else None)
    k_evict = spec.k if spec is not None else 0
    budgeted = spec is not None

    out = torch.full((B, M), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    g = torch.zeros((B,), dtype=torch.int32, device=dev)
    kv_len = kv_len0.clone()
    zeros_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    finite = torch.isfinite(first_logits).all()
    lastlog = first_logits
    for n in range(M):
        token = sample_topp(generator, lastlog, temperature, top_p)
        out[:, n] = torch.where(done, -1, token)
        newly_done = done | _isin_eos(token, eos)
        live = ~newly_done
        tok_pos = start_pos + g
        if budgeted:
            gate_b = live & (g + 1 > st.budget)                   # easykv.py:302-303
            cinit = (st.budget - g).clamp(min=0).to(torch.float32)
        else:
            gate_b = torch.zeros_like(live)
            cinit = torch.zeros((B,), dtype=torch.float32, device=dev)
        if budgeted and spec.policy == "random":
            # uniform over retained generated tokens (easykv.py:353-362)
            u = torch.rand((B,), generator=generator, device=dev)
            n_gen = (g + 1).clamp(max=st.budget + 1)
            rand_rank = (u * n_gen.to(torch.float32)).to(torch.int32)
        else:
            rand_rank = zeros_i
        ctx = StepCtx(
            q_pos=torch.where(live, tok_pos, -1).to(torch.int32)[:, None],
            token_valid=live[:, None],
            counter_init=cinit[:, None],
            next_pos=tok_pos + 1,
            prompt_len=prompt_len,
            evict_gate=gate_b,
            update_gate=live,
            rand_rank=rand_rank,
        )
        logits = llama._decode_forward(params, st.cfg, cache, token[:, None], ctx, spec)
        finite &= torch.isfinite(logits).all()
        lastlog = torch.where(newly_done[:, None], lastlog, logits[:, -1, :])
        g = g + live.to(torch.int32)
        kv_len = kv_len + live.to(torch.int32) - gate_b.to(torch.int32) * k_evict
        done = newly_done
        if eos is not None and (n + 1) % ALL_DONE_CHECK_EVERY == 0 and bool(done.all()):
            break
    emitted = (out >= 0).sum(dim=-1)
    return DecodeResult(out, emitted, kv_len, finite)


def _engine_cache(st: EngineStatics, B: int, S: int, dtype: torch.dtype,
                  device: torch.device) -> KVCache:
    """The slot count is rounded up to a multiple of 128: spare slots are
    inert (validity is pos >= 0, eviction is budget-gated), and the kernels'
    measured shapes assume it."""
    S = _round_up(S, 128)
    c = st.cfg
    return init_cache(c.num_hidden_layers, B, c.num_key_value_heads, S, c.head_dim,
                      dtype=dtype, device=device, quantized=st.kv_quant)


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
    t0 = time.perf_counter()
    last_logits = _prefill(st, params, cache, ids_pad, prompt_len)
    _sync(dev)
    t1 = time.perf_counter()
    res = _decode_loop(st, params, cache, last_logits, prompt_len, prompt_len, prompt_len,
                       st.decode_spec(), generator, temperature, top_p)
    _sync(dev)
    return res, cache, t1 - t0, time.perf_counter() - t1


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


def generate(
    model: CausalLM,
    input_ids,
    generation_config,
    kv_mode: str = "decoding",
    stride: int = 1,
    report_decoding_latency: bool = False,
):
    """Reference-parity entry point (reference easykv.py:199-901), `decoding`
    mode. Returns the decoded string if a tokenizer is attached, else the
    list of generated token ids; timings and counts go to model.last_run."""
    if kv_mode != "decoding":
        raise NotImplementedError(
            f"kv_mode {kv_mode!r} is not ported yet (ROADMAP.md open items 8-9: "
            "encoding family and ppl modes)")
    if isinstance(generation_config, GenerationConfig):
        gc = generation_config
    else:
        gc = GenerationConfig.from_dict(dict(generation_config))
    gc = gc.with_policy()
    if gc.streaming:
        raise NotImplementedError("streaming is not ported yet (ROADMAP.md open item 10)")
    ids = _as_batch(input_ids)
    B, length = ids.shape
    eos = gc.eos_token_ids
    if not eos and model.tokenizer is not None:
        tok_eos = getattr(model.tokenizer, "eos_token_id", None)
        if tok_eos is not None:
            eos = (int(tok_eos),)
    budget = gc.budget
    if not (isinstance(budget, int) or gc.kv_policy == "full"):
        raise ValueError("decoding mode requires an integer budget")
    b = int(budget)
    P_pad = _round_up(length, 64)
    st = EngineStatics(
        cfg=model.cfg, policy=gc.kv_policy, length=P_pad, budget=b,
        max_new_tokens=gc.max_new_tokens, eos_token_ids=tuple(eos),
        temp_length=gc.temp_length,
        recent_window_dec=int(b * 0.3),  # reference easykv.py:308 quirk
        kv_quant=model.kv_quant,
    )
    dev = model.device
    ids_pad = np.zeros((B, P_pad), np.int32)
    ids_pad[:, :length] = ids
    prompt_len = torch.full((B,), length, dtype=torch.int32, device=dev)
    generator = torch.Generator(device=dev).manual_seed(gc.seed)
    res, _, prefill_s, decode_s = _run_decoding(
        st, model.params, torch.from_numpy(ids_pad).to(dev), prompt_len,
        float(gc.temperature), float(gc.top_p), generator, model.dtype)
    out_ids = res.out_ids.cpu().numpy()
    kv_len = int(res.kv_len[0])
    n_out = int(res.n_tokens[0])
    model.last_run = RunStats(n_out, kv_len, prefill_s, decode_s, bool(res.finite))
    retained = kv_len - length
    if n_out:
        print(f"KV cache budget ratio: {retained / n_out * 100:.2f}%({retained}/{n_out})")
    if report_decoding_latency:
        print(f"Per-step decoding latency: {decode_s / max(n_out, 1):.3f}")
    ids_out = [int(t) for t in out_ids[0] if t >= 0]
    if model.tokenizer is not None:
        return model.tokenizer.decode(ids_out, skip_special_tokens=True).strip()
    return ids_out
