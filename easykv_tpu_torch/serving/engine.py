"""Continuous-batching serving engine over the budgeted KV cache (counterpart
of easykv_tpu/serving/engine.py: Request, _prefill_chunk, _decode_step,
_merged_step, _clear_row, ContinuousBatchEngine).

B batch rows (slots) share one cache, each row an independent budgeted
region, so a row evicts exactly as a single-request `decoding` run does
(reference easykv.py:228-366). Requests are admitted into free rows by a
masked chunked prefill that leaves the other rows untouched, the decode
step advances every active row together, and a finished row is recycled by
invalidating its slots. Every function here writes the cache in place.

The pure-decode tick (_DecodeTick) is _decode_step and one on-device
sample_topp over static (B,) buffers. On the card its first call runs
eagerly (loading the kernels and making the tables, ticket rows and
library handles the step keeps), the second is captured as a CUDA graph
and every later one replays it, the counterpart of the JAX package's
compiled decode step; flags.eager_decode_loop keeps it eager for the A/B.
A prefill chunk and the merged tick (serving/scheduled.py) run eagerly.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import flags
from ..cache import KVCache, init_cache
from ..config import ModelConfig, canonical_policy
from ..models import llama
from ..models.llama import StepCtx
from ..parallel.mesh import all_gather_cat
from ..policies import PHASE_DECODE, PolicySpec, evict_cache
from ..sampling import sample_topp

# the module (engine/__init__.py exports its `generate` function under the same name)
gen_mod = importlib.import_module("..engine.generate", __package__)


@dataclasses.dataclass
class Request:
    request_id: int
    ids: np.ndarray             # (T,) prompt tokens
    max_new_tokens: int = 128
    # filled by the engine:
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def serving_spec(kv_policy: str, budget: int) -> Optional[PolicySpec]:
    """The engines' decode spec: the decode-phase recent window is the
    reference's hard-coded 0.3 of the budget (easykv.py:308); None for
    `full`."""
    policy = canonical_policy(kv_policy)
    rw = int(budget * 0.3)
    return None if policy == "full" else PolicySpec(
        policy, PHASE_DECODE, 1, 4, rw, feasible_k=max(budget - rw, 1), protect_prompt=True)


def serving_cache(model, batch_slots: int, max_prompt: int, budget: int,
                  cfg: Optional[ModelConfig] = None) -> KVCache:
    """The engines' cache: S = max_prompt + budget + 1 rounded up to a
    multiple of 128 (spare slots are inert), in the model's dtype, int8 with
    kv_quant. cfg: the rank's config under a mesh (its kv-heads), else the
    model's."""
    cfg = model.cfg if cfg is None else cfg
    S = gen_mod._round_up(max_prompt + budget + 1, 128)
    return init_cache(cfg.num_hidden_layers, batch_slots, cfg.num_key_value_heads, S,
                      cfg.head_dim, model.dtype, model.device, quantized=model.kv_quant)


def _rand_rank(spec, budget, gen_count, generator, rows=None) -> torch.Tensor:
    """The `random` policy's rank over the retained generated tokens, drawn
    through the decode loop's _uniform (one (B,) draw a step; with rows =
    (first, total), one draw for all `total` slots, these B sliced); zeros
    for every other policy."""
    B, dev = gen_count.shape[0], gen_count.device
    if spec is None or spec.policy != "random":
        return torch.zeros((B,), dtype=torch.int32, device=dev)
    if rows is None:
        u = gen_mod._uniform(generator, B, dev)
    else:
        u = gen_mod._uniform(generator, rows[1], dev)[rows[0]:rows[0] + B]
    n_gen = (gen_count + 1).clamp(max=budget + 1)
    return (u * n_gen.to(torch.float32)).to(torch.int32)


@torch.no_grad()
def _prefill_chunk(cfg: ModelConfig, pc: int, params, cache: KVCache, chunk: torch.Tensor,
                   start: int, prefix_len: int, row: int,
                   window_end: Optional[int] = None) -> torch.Tensor:
    """Masked prefill: only batch row `row` consumes `chunk` (pc,), at
    positions [start, start + pc) below prefix_len (and window_end); every
    other row is padding, its cache and scores untouched. No spec: nothing
    is scored or evicted. Returns the row's logits (pc, V)."""
    B = cache.k.shape[1]
    dev = cache.k.device
    pos = start + torch.arange(pc, dtype=torch.int32, device=dev)[None, :]
    rows = torch.arange(B, device=dev) == row
    tok_valid = rows[:, None] & (pos < prefix_len)
    if window_end is not None:
        tok_valid = tok_valid & (pos < window_end)
    zeros_b = torch.zeros((B,), dtype=torch.bool, device=dev)
    ctx = StepCtx(
        q_pos=torch.where(tok_valid, pos, -1).to(torch.int32),
        token_valid=tok_valid,
        counter_init=torch.zeros((B, pc), dtype=torch.float32, device=dev),
        next_pos=torch.where(rows, min(start + pc, prefix_len), 0).to(torch.int32),
        prompt_len=torch.full((B,), prefix_len, dtype=torch.int32, device=dev),
        evict_gate=zeros_b,
        update_gate=zeros_b,
        rand_rank=torch.zeros((B,), dtype=torch.int32, device=dev),
    )
    logits = llama.forward(params, cfg, cache, chunk[None, :].expand(B, pc), ctx, None)
    return logits[row]


@torch.no_grad()
def _decode_step(cfg: ModelConfig, spec: Optional[PolicySpec], budget: int, params,
                 cache: KVCache, tokens: torch.Tensor, active: torch.Tensor,
                 prompt_len: torch.Tensor, gen_count: torch.Tensor,
                 generator: torch.Generator, rows=None) -> torch.Tensor:
    """One decode step for every active row (tokens, active, prompt_len,
    gen_count: (B,)); an inactive row is a no-op. A row evicts once its
    generated count passes the budget; the eviction is folded into K2 where
    llama.decode_evict_folded(spec) holds, else evict_cache runs after the
    forward. Returns the logits (B, V) f32. rows: (first, total) of a
    rank's slots under a mesh (_rand_rank)."""
    B = tokens.shape[0]
    tok_pos = prompt_len + gen_count
    gate_b = (active & (gen_count + 1 > budget) if spec is not None
              else torch.zeros((B,), dtype=torch.bool, device=tokens.device))
    rand_rank = _rand_rank(spec, budget, gen_count, generator, rows)
    ctx = StepCtx(
        q_pos=torch.where(active, tok_pos, -1).to(torch.int32)[:, None],
        token_valid=active[:, None],
        counter_init=(budget - gen_count).clamp(min=0).to(torch.float32)[:, None],
        next_pos=(tok_pos + 1).to(torch.int32),
        prompt_len=prompt_len,
        evict_gate=gate_b,
        update_gate=active,
        rand_rank=rand_rank,
    )
    logits = llama.forward(params, cfg, cache, tokens[:, None], ctx, spec)
    if spec is not None and not llama.decode_evict_folded(spec):
        evict_cache(cache, spec, ctx.next_pos, prompt_len, rand_rank, gate_b)
    return logits[:, -1, :]


@torch.no_grad()
def _merged_step(cfg: ModelConfig, spec: Optional[PolicySpec], budget: int, pc: int, params,
                 cache: KVCache, tokens: torch.Tensor, start: torch.Tensor, limit: torch.Tensor,
                 prompt_len: torch.Tensor, gen_count: torch.Tensor, is_decode: torch.Tensor,
                 active: torch.Tensor, generator: torch.Generator, rows=None) -> torch.Tensor:
    """A whole serving tick in one chunk-major forward at (B, pc): each row
    is a prefill window [start, limit) of its own prompt, a decode token (in
    the LAST column, so tova's last-query-row rule holds), or inactive.
    Scores update on decode rows only; one eviction event (evict_cache)
    follows the forward. tokens (B, pc); the rest (B,). Returns the logits
    (B, pc, V)."""
    B = tokens.shape[0]
    dev = tokens.device
    cols = torch.arange(pc, dtype=torch.int32, device=dev)[None, :]
    pos_grid = start[:, None] + cols
    pf_valid = (active & ~is_decode)[:, None] & (pos_grid < limit[:, None])
    tok_pos = prompt_len + gen_count
    dec_valid = (active & is_decode)[:, None] & (cols == pc - 1)
    dec_live = active & is_decode
    gate_b = (dec_live & (gen_count + 1 > budget) if spec is not None
              else torch.zeros((B,), dtype=torch.bool, device=dev))
    rand_rank = _rand_rank(spec, budget, gen_count, generator, rows)
    ctx = StepCtx(
        q_pos=torch.where(pf_valid, pos_grid,
                          torch.where(dec_valid, tok_pos[:, None], -1)).to(torch.int32),
        token_valid=pf_valid | dec_valid,
        counter_init=torch.where(
            dec_valid, (budget - gen_count).clamp(min=0).to(torch.float32)[:, None], 0.0),
        next_pos=torch.where(is_decode, tok_pos + 1, limit).to(torch.int32),
        prompt_len=prompt_len,
        evict_gate=gate_b,
        update_gate=dec_live,
        rand_rank=rand_rank,
    )
    logits = llama.forward(params, cfg, cache, tokens, ctx, spec)
    if spec is not None:
        evict_cache(cache, spec, ctx.next_pos, prompt_len, rand_rank, gate_b)
    return logits


def _clear_row(cache: KVCache, row: int) -> None:
    """Recycle a slot: invalidate every slot of batch row `row`, in place."""
    cache.pos[:, row] = -1


class _DecodeTick:
    """The pure-decode tick of an engine: the host's (B,) next tokens, active
    mask, prompt lengths and generated counts copied into static device
    buffers (one copy_ each), _decode_step and the on-device sample_topp
    into a static (B,) output, then one (B,) readback.

    On the card, outside flags.eager_decode_loop, the first call runs
    eagerly, the second captures the tick (generate.capture_step: the
    sampling generator registered, the launch counts kept per replay) and
    replays it, and every later call replays it. The graph reads the
    engine's cache and these buffers where they lay when it was captured:
    nothing may rebind them. A capture or replay that fails raises. On the
    CPU every call runs eagerly.

    Under a mesh (eng.tp) the buffers hold the rank's slots [eng.row0,
    eng.row0 + eng.Bl), the tick runs under the mesh, its tokens are gathered
    over `data` into all B, and under gloo every tick is eager (its
    collectives cannot be captured)."""

    def __init__(self, eng):
        self.eng = eng
        B, dev = eng.Bl, eng.device
        self.tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.active = torch.zeros((B,), dtype=torch.bool, device=dev)
        self.prompt_len = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.gen_count = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.out = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.graph: Optional[gen_mod.CapturedStep] = None
        self.warm = False         # an eager tick ran on this device
        self.replays = 0

    def _body(self) -> None:
        e = self.eng
        logits = _decode_step(e.cfg, e.spec, e.budget, e.params, e.cache, self.tokens,
                              self.active, self.prompt_len, self.gen_count, e.generator, e.rows)
        self.out.copy_(sample_topp(e.generator, logits, e.temperature, e.top_p, rows=e.rows))

    @property
    def capture_s(self) -> float:
        return 0.0 if self.graph is None else self.graph.capture_s

    @property
    def nodes(self) -> int:
        return 0 if self.graph is None else self.graph.nodes

    @torch.no_grad()
    def __call__(self, tokens: np.ndarray, active: np.ndarray, prompt_len: np.ndarray,
                 gen_count: np.ndarray) -> np.ndarray:
        tp, r0, n = self.eng.tp, self.eng.row0, self.eng.Bl
        for buf, host in ((self.tokens, tokens), (self.active, active),
                          (self.prompt_len, prompt_len), (self.gen_count, gen_count)):
            buf.copy_(torch.from_numpy(np.ascontiguousarray(host[r0:r0 + n])))
        if (self.eng.device.type != "cuda" or not flags.decode_graph_enabled()
                or not gen_mod.decode_graph_ok(tp) or not self.warm):
            self._body()
            self.warm = self.eng.device.type == "cuda"
        else:
            if self.graph is None:
                self.graph = gen_mod.capture_step(self._body, self.eng.generator)
            self.graph.replay()
            self.replays += 1
        if tp is None:
            return self.out.cpu().numpy()
        return all_gather_cat(self.out, tp[0], tp[1], dim=0).cpu().numpy()


class ContinuousBatchEngine:
    """Admits requests into B slots (a whole prompt prefilled in chunks on
    admission), then advances every active slot a token a step; a finished
    slot is recycled. Runs on the model's device: the card unless the model
    was made with device="cpu"."""

    def __init__(
        self,
        model,
        batch_slots: int = 4,
        max_prompt: int = 512,
        budget: int = 200,
        kv_policy: str = "roco",
        temperature: float = 1.0,
        top_p: float = 1.0,
        eos_token_ids: Tuple[int, ...] = (),
        prefill_chunk: int = 128,
        seed: int = 0,
    ):
        # The JAX engine's materialize_params_resident has no counterpart:
        # an int4 leaf stays packed (ops/quant.py's docstring).
        self.model = model
        self.params = model.params
        self.cfg: ModelConfig = model.cfg
        self.device = model.device
        self.B = batch_slots
        self.tp, self.row0, self.Bl, self.rows = None, 0, batch_slots, None   # one device
        self.max_prompt = max_prompt
        self.budget = budget
        self.pc = min(prefill_chunk, max_prompt)
        self.eos = tuple(eos_token_ids)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.spec = serving_spec(kv_policy, budget)
        self.cache = serving_cache(model, batch_slots, max_prompt, budget)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.decode_tick = _DecodeTick(self)
        # host-side slot state
        self.slots: List[Optional[Request]] = [None] * self.B
        self.prompt_len = np.zeros(self.B, np.int32)
        self.gen_count = np.zeros(self.B, np.int32)
        self.next_token = np.zeros(self.B, np.int32)
        self.pending: List[Request] = []
        self.finished: Dict[int, Request] = {}

    def submit(self, req: Request) -> None:
        if len(req.ids) > self.max_prompt:
            raise ValueError(f"prompt of {len(req.ids)} tokens exceeds max_prompt {self.max_prompt}")
        self.pending.append(req)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return sample_topp(self.generator, logits, self.temperature, self.top_p).cpu().numpy()

    def _admit(self, slot: int, req: Request) -> None:
        ids = np.asarray(req.ids, np.int32)
        T = len(ids)
        n_chunks = (T + self.pc - 1) // self.pc
        ids_pad = np.zeros(n_chunks * self.pc, np.int32)
        ids_pad[:T] = ids
        ids_dev = torch.from_numpy(ids_pad).to(self.device)
        last_logits = None
        for c in range(n_chunks):
            logits = _prefill_chunk(self.cfg, self.pc, self.params, self.cache,
                                    ids_dev[c * self.pc:(c + 1) * self.pc], c * self.pc, T, slot)
            last_idx = T - 1 - c * self.pc
            if 0 <= last_idx < self.pc:
                last_logits = logits[last_idx]
        tok = int(self._sample(last_logits[None])[0])
        self.slots[slot] = req
        self.prompt_len[slot] = T
        self.gen_count[slot] = 0
        self.next_token[slot] = tok
        req.out.append(tok)

    def _active_mask(self) -> np.ndarray:
        return np.array([s is not None for s in self.slots])

    def _finish(self, slot: int) -> None:
        req = self.slots[slot]
        req.done = True
        self.finished[req.request_id] = req
        self.slots[slot] = None
        _clear_row(self.cache, slot)

    def step(self) -> List[Tuple[int, int]]:
        """Admit pending requests into free slots, then advance every active
        slot by one token. Returns [(request_id, token), ...] emitted."""
        for slot in range(self.B):
            if self.slots[slot] is None and self.pending:
                self._admit(slot, self.pending.pop(0))
        if not self._active_mask().any():
            return []
        # check EOS / max for the tokens sampled last round BEFORE forwarding them
        emitted: List[Tuple[int, int]] = []
        for slot in range(self.B):
            req = self.slots[slot]
            if req is None:
                continue
            tok = int(self.next_token[slot])
            emitted.append((req.request_id, tok))
            if (self.eos and tok in self.eos) or len(req.out) >= req.max_new_tokens:
                self._finish(slot)
        active = self._active_mask()
        if not active.any():
            return emitted
        toks = self.decode_tick(self.next_token, active, self.prompt_len, self.gen_count)
        for slot in range(self.B):
            if self.slots[slot] is None:
                continue
            self.gen_count[slot] += 1
            self.next_token[slot] = toks[slot]
            self.slots[slot].out.append(int(toks[slot]))
        return emitted

    def run_all(self) -> Dict[int, List[int]]:
        """Drain all pending and active requests."""
        while self.pending or self._active_mask().any():
            self.step()
        return {rid: r.out for rid, r in self.finished.items()}
