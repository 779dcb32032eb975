"""LLaMa-family decoder over the budgeted KV ring buffer (counterpart of
easykv_tpu/models/llama.py: init_params, rmsnorm, _proj_qkv, _mlp, forward,
prefill_layer_major, strided_encode_layer_major, ring_prefill_forward,
decode_evict_folded, decode_stream_folded, _decode_forward, _logits_tail,
_lm_head, _age_ranks).

Parameters keep the JAX package's orientation: every projection is
(in, out) and applies as `x @ w`; each layer's weights live in their own
module (the JAX tree stacks them over a leading L axis), split (wq, wk, wv,
wg, wu) or fused (wqkv, wgu, bqkv: ops.quant.fuse_gemv_params). Every
projection goes through ops.quant.mm: a plain weight is `torch.matmul`, as
the JAX package leaves it to XLA; a QuantLinear (int8 or int4) runs K10-K13
or their plain branches by the shape of the product (ops/quant.py). The
int8 LM head is K13 with f32 logits (ops.quant.lm_head_mm). The decode step
always runs two CUDA kernels: decode attention per layer (K1), then one
sidecar pass with the folded eviction and the step's K/V rows (K2, which
took the row write K3 into its launch) for all layers; over the fused
arithmetic-int4 tree the layers are one launch of the one-kernel decode
step, K14 at B = 1 and K15 at 1 < B <= 16 (8 for GQA) (mega_tree, as the
JAX package's default). Where use_chunk_kernel
holds (the JAX package's _use_chunk_kernel, llama.py:150-169 there: by
default an int8 cache only, flags.chunk_kernel_mode), the prompt prefill and
the chunk-major forward attend through the chunk kernel (K5) and the
strided encode of the encoding family writes and attends each chunk
through K6 (llama.py:429-440, 489-495 there); elsewhere the chunk is
written, the cache dequantized and the plain `attend` run, as the JAX
package leaves it to XLA. The encode-phase score updates and evictions are
plain PyTorch (policies.py), unless use_step_kernel holds (roco and
h2o_head, flags.step_kernel_enabled, off by default): then the strided
encode runs each chunk of a layer as one call of the chunk step K7, which
also updates the scores, evicts and hands the next chunk its write mask. StreamingLLM `decoding` (streaming=True) keeps the
cache age-ordered: over the pre-rotated cache the step runs K2 with
`compact` and then K9 (the K/V shift with R(-theta)); over the
rotate-at-read cache K1 runs its `ordered` variant and the engine runs K4
and K8 after the step. StreamingLLM in the encoding family encodes
chunk-major (`forward`) over an unordered cache whose raw K rotates by its
age rank at attend time, and its decode steps (and stride-1 encode chunks)
run K1's `rank` variant. `forward`'s non-streaming C == 1 bootstrap branch
attends through `fused_decode_attend`. On CPU tensors each wrapper runs its
plain version.

Under a (data, model) mesh (flags.tp_mesh: parallel/mesh.py) the params and
the cache are this rank's shards (parallel/sharding.py) and the config is
the rank's (parallel.local_config: Hq / m, Hkv / m, F / m), so every
function here runs as on one card over B / d rows and Hkv / m kv-heads,
with the collectives GSPMD inserts in the JAX package called by name: the
all-reduce over `model` after wo and after wd (ops.quant.mm_row_parallel),
the all-gather of the vocab-sharded logits before anything reads them
(_logits_tail: a greedy argmax then keeps the lowest id on ties, as
jnp.argmax), and tova's cross-head mean in the encode phase
(policies.update_scores). The kernels K1, K2, K5, K6 and K7 go through
their `*_sharded` wrappers (the JAX package's dispatch, llama.py:173-255
and :880-1000 there), and, as there (llama.py:717-771, :812-819), the
one-kernel steps K14 / K15 and the folded evictions are off: K2 runs
unfolded and the engine evicts with K4 (policies.evict_cache).

Under a sequence-parallel mesh (flags.sp_mesh) the engine's prefix prefill
is ring_prefill_forward: each rank runs its T / n columns through the
layers with ring attention (ops/ring_attention.py, plain PyTorch as the
JAX package's XLA) and every rank writes the whole, gathered prefix into
its own cache; everything after the prefill runs on one rank's whole cache
as on one card.
"""
from __future__ import annotations

import functools

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..cache import (KVCache, kv_dequant, quantize_kv, write_tokens, write_tokens_at,
                     write_tokens_slice)
from ..config import ModelConfig, resolve_device
from ..ops.attention import attend
from ..ops.cuda.chunk_attention import (STEP_POLICIES, fused_chunk_attend,
                                        fused_chunk_attend_sharded, fused_chunk_step,
                                        fused_chunk_step_sharded, fused_chunk_write_attend,
                                        fused_chunk_write_attend_sharded, wa_fits)
from .. import flags
from ..ops.cuda.decode_attention import (fused_decode_attend, fused_decode_attend_inflight,
                                         fused_decode_attend_inflight_sharded)
from ..ops.cuda.fused_decode import fused_decode_step
from ..ops.cuda.fused_decode_batch import fused_decode_step_batch, max_rows
from ..ops.cuda.kv_compact import fused_kv_compact, shift_rotation
from ..ops.cuda.sidecar_update import (evict_supported, fused_write_update,
                                       fused_write_update_sharded)
from ..ops.quant import QuantLinear, lm_head_mm, mm, mm_row_parallel
from ..parallel.mesh import all_gather_cat
from ..ops.rope import apply_rope, rope_base_for, rope_cos_sin, rope_inv_freq, rotate
from ..policies import PolicySpec, evict_layer, update_scores, update_scores_reduced

LAYER_KEYS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd", "ln_attn", "ln_mlp")
FUSED_LAYER_KEYS = ("wqkv", "wo", "wgu", "wd", "ln_attn", "ln_mlp")
BIAS_KEYS = ("bq", "bk", "bv")
FUSED_BIAS_KEYS = ("bqkv",)


class StepCtx(NamedTuple):
    """Per-chunk context: (B, C) and (B,) tensors for one chunk (C = 1 for a
    decode token); the layer-major encode takes every field stacked over a
    leading (n_chunks,) axis."""

    q_pos: torch.Tensor         # (B, C) int32 position ids; -1 = padding / dead row
    token_valid: torch.Tensor   # (B, C) bool
    counter_init: torch.Tensor  # (B, C) f32 initial observation counters
    next_pos: torch.Tensor      # (B,) int32 position the next token would get
    prompt_len: torch.Tensor    # (B,) int32
    evict_gate: torch.Tensor    # (B,) bool: run an eviction event this chunk
    update_gate: torch.Tensor   # (B,) bool: apply score updates
    rand_rank: torch.Tensor     # (B,) int32 pre-drawn rank for the random policy


def _keep(t):
    return t if isinstance(t, QuantLinear) else nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One layer's weights: LAYER_KEYS (or FUSED_LAYER_KEYS), and BIAS_KEYS
    (FUSED_BIAS_KEYS) with attention_bias. Each projection is a tensor or a
    QuantLinear."""

    def __init__(self, tensors: Dict[str, Union[torch.Tensor, QuantLinear]]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _keep(t))


class LlamaParams(nn.Module):
    """embed (V, D), final_norm (D,), layers (one DecoderLayer each),
    lm_head (D, V), a tensor or a QuantLinear, unless the embedding is
    tied."""

    def __init__(self, embed: torch.Tensor, final_norm: torch.Tensor,
                 layers: List[Dict[str, Union[torch.Tensor, QuantLinear]]],
                 lm_head: Optional[Union[torch.Tensor, QuantLinear]] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.layers = nn.ModuleList(DecoderLayer(t) for t in layers)
        self.lm_head = None if lm_head is None else _keep(lm_head)


@torch.no_grad()
def init_params(cfg: ModelConfig, seed: int, dtype: torch.dtype = torch.float32,
                device=None) -> LlamaParams:
    """Random init (normal scaled by fan_in^-1/2), drawn on `device` from a
    generator seeded with `seed`: a 7B model is built on the card without
    passing through host memory. The draws are not jax.random's; to
    compare the two packages, convert the JAX tree (models/convert.py)."""
    device = resolve_device(device)
    L, D, F_ = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    V = cfg.vocab_size
    gen = torch.Generator(device=device).manual_seed(seed)

    def norm(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        return t.mul_(fan_in ** -0.5)

    def layer():
        w = {
            "wq": norm((D, Hq * Dh), D),
            "wk": norm((D, Hkv * Dh), D),
            "wv": norm((D, Hkv * Dh), D),
            "wo": norm((Hq * Dh, D), Hq * Dh),
            "wg": norm((D, F_), D),
            "wu": norm((D, F_), D),
            "wd": norm((F_, D), F_),
            "ln_attn": torch.ones((D,), dtype=dtype, device=device),
            "ln_mlp": torch.ones((D,), dtype=dtype, device=device),
        }
        if cfg.attention_bias:
            w.update(bq=norm((Hq * Dh,), Hq * Dh), bk=norm((Hkv * Dh,), Hkv * Dh),
                     bv=norm((Hkv * Dh,), Hkv * Dh))
        return w

    layers = [layer() for _ in range(L)]
    lm_head = None if cfg.tie_word_embeddings else norm((D, V), D)
    return LlamaParams(norm((V, D), D), torch.ones((D,), dtype=dtype, device=device),
                       layers, lm_head)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _qkv(x: torch.Tensor, p: DecoderLayer, name: str) -> torch.Tensor:
    y = mm(x, getattr(p, "w" + name))
    bias = getattr(p, "b" + name, None)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _proj_qkv(x, p, B, C, Hq, Hkv, Dh):
    """(q (B, Hq, C, Dh), k (B, Hkv, C, Dh), v) from the split wq / wk / wv
    or the fused wqkv (one product, split at Hq*Dh and Hkv*Dh)."""
    if hasattr(p, "wqkv"):
        y = _qkv(x, p, "qkv")
        nq, nk = Hq * Dh, Hkv * Dh
        q, k, v = y[..., :nq], y[..., nq:nq + nk], y[..., nq + nk:]
    else:
        q, k, v = _qkv(x, p, "q"), _qkv(x, p, "k"), _qkv(x, p, "v")
    return (q.reshape(B, C, Hq, Dh).transpose(1, 2),
            k.reshape(B, C, Hkv, Dh).transpose(1, 2),
            v.reshape(B, C, Hkv, Dh).transpose(1, 2))


def _mlp(x2: torch.Tensor, p: DecoderLayer) -> torch.Tensor:
    """SwiGLU MLP; the fused wgu is gate|up, split at F."""
    if hasattr(p, "wgu"):
        gu = mm(x2, p.wgu)
        F_ = gu.shape[-1] // 2
        return mm_row_parallel(F.silu(gu[..., :F_]) * gu[..., F_:], p.wd)
    return mm_row_parallel(F.silu(mm(x2, p.wg)) * mm(x2, p.wu), p.wd)


def _attn_block(h, p, cfg: ModelConfig, out: torch.Tensor):
    """Residual O projection and MLP after attention; out (B, Hq, C, Dh)."""
    B, _, C, _ = out.shape
    attn_out = out.transpose(1, 2).reshape(B, C, -1)
    h = h + mm_row_parallel(attn_out, p.wo)
    x2 = rmsnorm(h, p.ln_mlp, cfg.rms_norm_eps)
    return h + _mlp(x2, p)


def _on_mesh(fn, sharded):
    """`fn`, or under a mesh its `*_sharded` wrapper bound to the mesh."""
    tp = flags.tp_mesh()
    if tp is None:
        return fn
    return functools.partial(sharded, mesh=tp[0], data_axis=tp[1], model_axis=tp[2])


def use_chunk_kernel(kv_dtype: torch.dtype) -> bool:
    """Whether a chunk of C > 1 queries over a cache of kv_dtype attends
    through the chunk kernels (K5, K6): the JAX package's _use_chunk_kernel
    (llama.py:150-169 there). 'auto' takes them for an int8 cache only. Its
    mesh branch (even shards, else off) holds by construction here: a rank
    holds its own (B / d, Hkv / m) shard, parallel.shard_cache and the
    engine's cache having refused uneven ones."""
    mode = flags.chunk_kernel_mode()
    return mode == "on" or (mode == "auto" and kv_dtype == torch.int8)


def use_step_kernel(cfg: ModelConfig, spec: Optional[PolicySpec], kv_dtype: torch.dtype,
                    S: int, C: int) -> bool:
    """Whether the strided encode runs each chunk as one K7 call: the JAX
    package's use_step (llama.py:441-452 there), predicate for predicate."""
    rep = cfg.num_attention_heads // cfg.num_key_value_heads
    return (use_chunk_kernel(kv_dtype) and S % 128 == 0 and spec is not None
            and spec.policy != "full" and spec.k == C
            and wa_fits(rep * C, C, S, cfg.head_dim, kv_dtype.itemsize)
            and spec.policy in STEP_POLICIES and flags.step_kernel_enabled())


def _plain_attend(cl: KVCache, q, q_pos, cfg: ModelConfig):
    """The plain `attend` over the cache, dequantized when it is int8 (the
    JAX package's path without the chunk kernel)."""
    k, v = kv_dequant(cl, q.dtype)
    return attend(q, k, v, cl.pos, q_pos, sliding_window=cfg.sliding_window,
                  scale=cfg.head_dim ** -0.5)


@torch.no_grad()
def prefill_layer_major(
    params: LlamaParams,
    cfg: ModelConfig,
    cache: KVCache,
    token_ids: torch.Tensor,     # (B, A_pad), A_pad = n_chunks * C
    q_pos: torch.Tensor,         # (n_chunks, B, C) int32, -1 = padding
    counter_init: torch.Tensor,  # (n_chunks, B, C) f32
    spec: Optional[PolicySpec] = None,  # keep_attention bootstrap, or None
) -> torch.Tensor:
    """Layer-major no-eviction prefill: one whole-width QKV/MLP matmul per
    layer; attention and the cache writes go chunk by chunk. Token j lands in
    slot j of the empty cache (write_tokens_slice); padding tokens write
    pos = -1, so their slots stay invalid. Where use_chunk_kernel holds
    (by default an int8 cache) K5 attends over the cache's own rows (int8
    with their scales), the chunk's tokens included; elsewhere the plain
    `attend` over the dequantized cache. With a spec, every chunk's
    attention mass bootstraps the scores (reference h2o_head_score,
    easykv.py:173-186): K5's statistics, or the plain probabilities. Fills
    `cache` in place and returns h (B, A_pad, D) before the final norm."""
    B, T = token_ids.shape
    n, _, C = q_pos.shape
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    inv_freq = rope_inv_freq(Dh, rope_base_for(cfg), token_ids.device)
    q_pos_flat = q_pos.permute(1, 0, 2).reshape(B, T)
    cos, sin = rope_cos_sin(q_pos_flat[:, None, :], inv_freq)   # shared by all layers
    boot = torch.ones((B,), dtype=torch.bool, device=token_ids.device)
    use_ck = use_chunk_kernel(cache.k.dtype)
    chunk_attend = _on_mesh(fused_chunk_attend, fused_chunk_attend_sharded)

    h = params.embed[token_ids.clamp(min=0)]
    for l, p in enumerate(params.layers):
        x = rmsnorm(h, p.ln_attn, cfg.rms_norm_eps)
        q, k, v = _proj_qkv(x, p, B, T, Hq, Hkv, Dh)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        cl = cache.layer(l)
        outs = []
        for c in range(n):
            sl = slice(c * C, (c + 1) * C)
            write_tokens_slice(cl, k[:, :, sl], v[:, :, sl], q_pos[c],
                               counter_init[c], c * C)
            if use_ck:
                out, ssum, ssq, last = chunk_attend(
                    q[:, :, sl].contiguous(), cl.k, cl.v, cl.pos, q_pos[c], cl.k_scale,
                    cl.v_scale, need_scores=spec is not None,
                    sliding_window=cfg.sliding_window)
                if spec is not None:
                    update_scores_reduced(cl, ssum, ssq, last, spec, boot, bootstrap=True)
            else:
                out, probs = _plain_attend(cl, q[:, :, sl], q_pos[c], cfg)
                if spec is not None:
                    update_scores(cl, probs, spec, boot, bootstrap=True)
            outs.append(out)
        h = _attn_block(h, p, cfg, torch.cat(outs, dim=2))
    return h


@torch.no_grad()
def strided_encode_layer_major(
    params: LlamaParams,
    cfg: ModelConfig,
    cache: KVCache,
    token_ids: torch.Tensor,     # (B, T), T = n_chunks * C
    ctxs: StepCtx,               # every field stacked over a leading (n_chunks,) axis
    spec: PolicySpec,            # the encode spec (policy 'full' evicts nothing)
    write_start: Sequence[int],  # (n_chunks,) valid slots before each chunk
    evict_at: Sequence[bool],    # (n_chunks,) some row's eviction gate fires
) -> torch.Tensor:
    """Strided encoding with per-chunk eviction, layer-major (reference
    easykv.py:426-499): per layer, one whole-width QKV/MLP matmul over all T
    tokens; then chunk by chunk the write and attention (K6 where
    use_chunk_kernel holds, by default an int8 cache; write_tokens_at and
    the plain `attend` over the dequantized cache elsewhere), the score
    update, and the gated eviction on the chunks the host schedule marks
    (evict_at: no host sync per chunk). Write slots are carried, not
    searched: contiguous while the cache fills, the sorted evicted ids of the
    previous event afterwards. Where use_step_kernel holds, each chunk is one
    K7 call instead, which also updates the scores, evicts under the chunk's
    evict_gate and returns the next chunk's write mask (the carried slots as
    a mask); the evict_at schedule then launches nothing more. Updates
    `cache` in place and returns h (B, T, D) before the final norm."""
    B, T = token_ids.shape
    n = len(write_start)
    C = T // n
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    dev = token_ids.device
    inv_freq = rope_inv_freq(Dh, rope_base_for(cfg), dev)
    evicting = spec is not None and spec.policy != "full"
    need = spec is not None and spec.policy in ("h2o_head", "roco", "tova")
    q_pos_flat = ctxs.q_pos.permute(1, 0, 2).reshape(B, T)
    cos, sin = rope_cos_sin(q_pos_flat[:, None, :], inv_freq)   # shared by all layers
    ar = torch.arange(C, dtype=torch.int32, device=dev)
    use_ck = use_chunk_kernel(cache.k.dtype)
    S = cache.k.shape[-2]
    use_step = use_step_kernel(cfg, spec, cache.k.dtype, S, C)
    chunk_step = _on_mesh(fused_chunk_step, fused_chunk_step_sharded)
    chunk_write_attend = _on_mesh(fused_chunk_write_attend, fused_chunk_write_attend_sharded)

    def contiguous_ids(start: int) -> torch.Tensor:
        return (start + ar).expand(B, Hkv, C).contiguous()

    if use_step:
        # K7 carries the write slots as a mask (the JAX package's use_step,
        # llama.py:481-488, 525-531 there): the contiguous window first,
        # then each call's next mask; next_start = write_start[c] + C
        starts = torch.tensor(list(write_start), dtype=torch.int32, device=dev)
        next_start = (starts + C)[:, None].expand(n, B).contiguous()     # (n, B)
        iota = torch.arange(S, dtype=torch.int32, device=dev)
        first = ((iota >= write_start[0]) & (iota < write_start[0] + C)).to(torch.int32)
        first = first.expand(B, Hkv, S).contiguous()
        kw = dict(policy=spec.policy, feasible_k=spec.feasible_k, sink=spec.sink_length,
                  recent_window=spec.recent_window, sliding_window=cfg.sliding_window)
    else:
        first = contiguous_ids(write_start[0])

    h = params.embed[token_ids.clamp(min=0)]
    for l, p in enumerate(params.layers):
        x = rmsnorm(h, p.ln_attn, cfg.rms_norm_eps)
        q, k, v = _proj_qkv(x, p, B, T, Hq, Hkv, Dh)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        cl = cache.layer(l)
        wids = first
        outs = []
        for c in range(n):
            sl = slice(c * C, (c + 1) * C)
            qp, cinit, gate = ctxs.q_pos[c], ctxs.counter_init[c], ctxs.update_gate[c]
            if use_step:
                out, _, wids = chunk_step(
                    q[:, :, sl].contiguous(), k[:, :, sl].contiguous(),
                    v[:, :, sl].contiguous(), wids, qp, cinit, gate, ctxs.evict_gate[c],
                    ctxs.next_pos[c], next_start[c], cl.k, cl.v, cl.pos, cl.score,
                    cl.score_sq, cl.counter, cl.k_scale, cl.v_scale, **kw)
                outs.append(out)
                continue
            if use_ck:
                out, ssum, ssq, last = chunk_write_attend(
                    q[:, :, sl].contiguous(), k[:, :, sl].contiguous(),
                    v[:, :, sl].contiguous(), wids, qp, cinit, cl.k, cl.v, cl.pos, cl.score,
                    cl.score_sq, cl.counter, cl.k_scale, cl.v_scale, need_scores=need,
                    sliding_window=cfg.sliding_window)
                if need:
                    update_scores_reduced(cl, ssum, ssq, last, spec, gate)
            else:
                write_tokens_at(cl, k[:, :, sl], v[:, :, sl], qp, cinit, wids)
                out, probs = _plain_attend(cl, q[:, :, sl], qp, cfg)
                if evicting:
                    update_scores(cl, probs, spec, gate)
                del probs
            outs.append(out)
            contig = contiguous_ids(write_start[c] + C)
            if evicting and evict_at[c]:
                eg = ctxs.evict_gate[c]
                eids = evict_layer(cl, spec, ctxs.next_pos[c], ctxs.prompt_len[c],
                                   ctxs.rand_rank[c], eg)
                wids = torch.where(eg[:, None, None], eids.sort(dim=-1).values, contig)
            else:
                wids = contig
        h = _attn_block(h, p, cfg, torch.cat(outs, dim=2))
    return h


@torch.no_grad()
def ring_prefill_forward(
    params: LlamaParams,
    cfg: ModelConfig,
    cache: KVCache,
    token_ids: torch.Tensor,     # (B, T) the whole prefix; T divisible by the sp axis
    ctx: StepCtx,                # (B, T) / (B,) fields over the whole prefix
    spec: Optional[PolicySpec],  # collect the bootstrap scores?
    *,
    mesh,
    axis: str = "sp",
) -> torch.Tensor:
    """Whole-prefix prefill with the sequence sharded over the sp mesh's
    `axis` (the JAX package's ring_prefill_forward, llama.py:632-710
    there): this rank embeds its T / n columns and runs each layer's
    RMSNorm, QKV projection (K11 / K13 over a quantized tree, at M = B·T/n),
    RoPE at the global positions, ring attention (ops/ring_attention.py),
    wo and the MLP on them. With a PolicySpec the travelling Σp / Σp²
    accumulators are the keep_attention bootstrap (reference h2o_head_score,
    easykv.py:173-186).

    Every rank ends with the whole cache: each layer's post-RoPE K / V (one
    gather) and Σp / Σp² (one more) are gathered over the axis and written
    for all T columns
    (write_tokens: valid tokens form a per-row column prefix, so token j
    lands in slot j, and the scores add into [0, T)); an int8 cache is
    quantized from the same gathered rows on every rank, so the ranks'
    caches are bit-identical. Returns the logits (B, V) f32 of each row's
    last real token, the same on every rank: the rank holding it hands its
    final hidden row over in a gather."""
    from ..ops.ring_attention import INT_MAX, ring_attention

    B, T = token_ids.shape
    n, r = mesh.shape[axis], mesh.index(axis)
    Tl = T // n
    cols = slice(r * Tl, (r + 1) * Tl)
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    inv_freq = rope_inv_freq(Dh, rope_base_for(cfg), token_ids.device)
    collect = spec is not None
    q_pos = ctx.q_pos[:, cols].contiguous()
    # padding keys get INT_MAX so no query attends them (-1 would be
    # causally visible to every query)
    k_pos = torch.where(ctx.token_valid[:, cols], q_pos, INT_MAX).to(torch.int32)
    cos, sin = rope_cos_sin(q_pos[:, None, :], inv_freq)        # shared by all layers

    h = params.embed[token_ids[:, cols].clamp(min=0)]
    for l, p in enumerate(params.layers):
        x = rmsnorm(h, p.ln_attn, cfg.rms_norm_eps)
        q, k, v = _proj_qkv(x, p, B, Tl, Hq, Hkv, Dh)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        out, ssum, ssq = ring_attention(q, k, v, q_pos, mesh, axis, collect_scores=collect,
                                        k_pos=k_pos)
        cl = cache.layer(l)
        kv = all_gather_cat(torch.stack((k, v)), mesh, axis, 3)    # one gather of both
        write_tokens(cl, kv[0], kv[1], ctx.q_pos, ctx.counter_init, ctx.token_valid)
        if collect:
            # token j sits in slot j; padding columns carry exactly zero mass
            sc = all_gather_cat(torch.stack((ssum, ssq)), mesh, axis, 3)
            cl.score[:, :, :T] += sc[0]
            cl.score_sq[:, :, :T] += sc[1]
        del q, k, v, kv, ssum, ssq
        h = _attn_block(h, p, cfg, out)
    # the logits of the last REAL token only: its rank's row, gathered
    last = (ctx.token_valid.sum(dim=1) - 1).clamp(min=0)          # (B,)
    mine = h[torch.arange(B, device=h.device), (last - r * Tl).clamp(0, Tl - 1)]
    rows = all_gather_cat(mine[:, None], mesh, axis, 1)          # (B, n, D)
    h_last = rows[torch.arange(B, device=h.device), last // Tl][:, None]
    return _logits_tail(h_last, params, cfg)[:, 0]


def _lm_head(h: torch.Tensor, head: Union[torch.Tensor, QuantLinear]) -> torch.Tensor:
    """LM head with float32 accumulation and a float32 result."""
    if isinstance(head, QuantLinear):
        return lm_head_mm(h, head)
    if head.dtype == torch.float32:
        return h.to(torch.float32) @ head
    if h.device.type == "cpu":
        return h.to(torch.float32) @ head.to(torch.float32)
    h2 = h.reshape(-1, h.shape[-1])
    return torch.mm(h2, head, out_dtype=torch.float32).reshape(h.shape[:-1] + (-1,))


def _logits_tail(h: torch.Tensor, params: LlamaParams, cfg: ModelConfig) -> torch.Tensor:
    """f32 logits (.., V) of the final norm of h. Under a mesh the LM head is
    vocab-sharded and this rank's logits are gathered over `model`, so every
    rank holds all V (a tied head is the replicated embedding)."""
    h = rmsnorm(h, params.final_norm, cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        return _lm_head(h, params.embed.t())
    logits = _lm_head(h, params.lm_head)
    tp = flags.tp_mesh()
    return logits if tp is None else all_gather_cat(logits, tp[0], tp[2], dim=-1)


def decode_evict_folded(spec: Optional[PolicySpec], streaming: bool = False) -> bool:
    """True when _decode_forward folds the step's gated eviction into K2:
    decode-phase k=1 specs, not streaming (the JAX package's
    decode_evict_folded), and not under a mesh (as there: the sharded K2
    does not fold). The engine evicts with policies.evict_cache otherwise."""
    return not streaming and evict_supported(spec) and flags.tp_mesh() is None


def decode_stream_folded(spec: Optional[PolicySpec], streaming: bool, ordered: bool,
                         prerotated: bool) -> bool:
    """StreamingLLM decoding over the age-ordered, pre-rotated cache: K2
    also compacts the sidecars at each row's victim and K9 shifts the K/V
    rows, so the engine runs neither evict_cache nor _compact_one (the JAX
    package's decode_stream_folded). The unordered cache of the encoding
    family (not ordered) evicts in two phases: K2 without the fold, then
    policies.evict_cache. Off under a mesh, as in the JAX package."""
    return (streaming and ordered and prerotated and evict_supported(spec)
            and flags.tp_mesh() is None)


def rotation_tables(S: int, cfg: ModelConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of R(s * theta) for every slot s, f32 (S, D/2): what K1's
    ordered and rank variants rotate a raw cached K row by (table row s, or
    row rank[s]). They depend only on S, so the engine builds them once per
    run."""
    inv_freq = rope_inv_freq(cfg.head_dim, rope_base_for(cfg), device)
    cos, sin = rope_cos_sin(torch.arange(S, dtype=torch.int32, device=device), inv_freq)
    return cos.contiguous(), sin.contiguous()


STREAM_KINDS = ("prerotated", "ordered", "rank")


class StreamRot(NamedTuple):
    """The StreamingLLM cache of a run and the rotation tables its decode
    step reads, built once per run by stream_tables. `kind`:

      prerotated  the age-ordered cache of `decoding` (rank == slot), K
                  stored rotated by its slot (flags.prerot_enabled); cos,
                  sin are K9's R(theta), (D/2,);
      ordered     the age-ordered cache, raw K; K1 rotates slot s by table
                  row s of cos, sin (S, D/2);
      rank        the unordered cache of the encoding family, raw K; K1
                  rotates slot s by table row ranks[l, b, h, s], its age
                  rank, of the same tables. `ranks` (L, B, Hkv, S) int32
                  are the step's ranks (the decode loop carries them);
                  None: the step computes them with _age_ranks."""

    kind: str
    cos: torch.Tensor
    sin: torch.Tensor
    ranks: Optional[torch.Tensor] = None


def stream_tables(S: int, cfg: ModelConfig, device, kind: str) -> StreamRot:
    if kind not in STREAM_KINDS:
        raise ValueError(f"stream kind {kind!r}, not one of {STREAM_KINDS}")
    if kind == "prerotated":
        inv_freq = rope_inv_freq(cfg.head_dim, rope_base_for(cfg), device)
        return StreamRot(kind, *shift_rotation(inv_freq))
    return StreamRot(kind, *rotation_tables(S, cfg, device))


def _age_ranks(pos: torch.Tensor) -> torch.Tensor:
    """Rank of each valid slot by position (0 = oldest) over the last axis;
    invalid slots get rank 0 (masked out of attention anyway). The double
    stable argsort of the JAX package's _age_ranks (llama.py:1218-1228
    there), exact against it."""
    key = torch.where(pos >= 0, pos, torch.iinfo(torch.int32).max)
    ranks = torch.argsort(torch.argsort(key, dim=-1, stable=True), dim=-1, stable=True)
    return torch.where(pos >= 0, ranks.to(torch.int32), 0)


def age_ranks_all(pos: torch.Tensor) -> torch.Tensor:
    """_age_ranks of a whole cache's pos (L, B, Hkv, S), over all L*B rows
    at once."""
    L, B, H, S = pos.shape
    return _age_ranks(pos.reshape(L * B, H, S)).reshape(L, B, H, S)


def mega_tree(params: LlamaParams) -> bool:
    """The fused arithmetic-int4 tree K14 decodes: wqkv with its carrier and
    bf16 scale pair, wgu's carrier, no bqkv (the JAX package's mega_tree,
    llama.py:818-826 there; the dual tree's int8 copy beside them passes
    too)."""
    p = params.layers[0]
    wqkv, wgu = getattr(p, "wqkv", None), getattr(p, "wgu", None)
    return (isinstance(wqkv, QuantLinear) and "q4a" in wqkv and "gs3" in wqkv
            and isinstance(wgu, QuantLinear) and "q4a" in wgu and not hasattr(p, "bqkv"))


@torch.no_grad()
def _decode_forward(
    params: LlamaParams,
    cfg: ModelConfig,
    cache: KVCache,
    token_ids: torch.Tensor,     # (B, 1)
    ctx: StepCtx,
    spec: Optional[PolicySpec],  # None: full cache, no scores, no eviction
    stream: Optional[StreamRot] = None,   # None: not StreamingLLM
) -> torch.Tensor:
    """One decode token through all layers with a late cache write: the
    token's K/V joins each layer's softmax in flight (K1); after the layers
    one sidecar pass picks every (layer, head)'s write slot, updates the
    scores with the policy's rule, when decode_evict_folded(spec) applies
    the step's gated eviction, and writes the step's K/V rows at the write
    slots (K2; on CPU tensors its plain version, then row_write's plain K3).
    An int8 cache folds its scales into K1; the step's rows are quantized
    once after the layers, and K2 writes their scales and int8 bytes.
    Updates `cache` in place and returns logits (B, 1, V) f32.

    StreamingLLM (`stream`, reference llama_patch.py:251-379): q and the
    in-flight K rotate by the token's cache-relative position, each layer's
    pre-write valid count (head 0's; every head of a layer holds the same
    count), while the mask still compares true positions. By stream.kind:
    `prerotated` (the age-ordered cache of `decoding`, K already rotated by
    its slot): attention is the plain K1, the stored row is the rotated K,
    and when decode_stream_folded the step runs K2 with `compact` (victim
    slots out; the rows at the pre-compact write slot), then K9 (shift +
    R(-theta) of the moved rows, from stream's tables). `ordered` (the
    age-ordered cache, raw K): K1 rotates every slot by its index from
    stream's (S, D/2) tables, and the engine evicts (K4) and compacts (K8)
    after the step. `rank` (the unordered cache of the encoding family, raw
    K): K1's rank variant rotates every slot by its age rank, stream.ranks
    (carried by the decode loop) or, without them, _age_ranks of the cache
    over all L*B rows at once (a stride-1 encode chunk); the stored row is
    the raw K and the engine evicts after the step.

    Over the fused arithmetic-int4 tree (mega_tree), not streaming or
    streaming over the pre-rotated cache (the JAX package's `ordered and
    prerotated`), with flags.mega_kernel_enabled,
    the layers are one launch instead (the JAX package's use_mega /
    use_mega_b, llama.py:818-833 there): K14 at B == 1
    (ops/cuda/fused_decode.py: f32 residual, two-plane int8 activations),
    K15 at 1 < B <= max_rows(cfg) (16 MHA, 8 GQA) with
    flags.mega_batch_enabled (ops/cuda/fused_decode_batch.py: f32 residual,
    activations rounded to the compute dtype); RoPE at layer 0's pre-write
    valid count of each row under streaming; their outputs feed the same
    tail."""
    B = token_ids.shape[0]
    q_pos = ctx.q_pos                                           # (B, 1)
    q_pos_b = q_pos[:, 0].contiguous()
    streaming = stream is not None
    prerotated = streaming and stream.kind == "prerotated"
    ordered = streaming and stream.kind != "rank"
    h = params.embed[token_ids.clamp(min=0)]
    mega = ((not streaming or prerotated) and flags.mega_kernel_enabled()
            and flags.tp_mesh() is None and mega_tree(params))
    scales = (cache.k_scale, cache.v_scale) if cache.quantized else ()
    if mega and B == 1:
        rope_pos = ((cache.pos[0, 0, 0] >= 0).sum(dtype=torch.int32)[None]
                    if streaming else None)
        hm, kn, vn, probs, p_new = fused_decode_step(
            params.layers, cfg, cache.k, cache.v, cache.pos, h[0], q_pos_b, *scales,
            rope_pos=rope_pos)
        h = hm[None]                                            # (1, 1, D)
        kn, vn = kn[:, None], vn[:, None]                       # (L, 1, Hkv, 1, Dh)
        probs = probs[:, None, :, 0, :]                         # (L, 1, Hkv, S)
        p_new = p_new[:, None, :, None]                         # (L, 1, Hkv, 1)
    elif mega and 1 < B <= max_rows(cfg) and flags.mega_batch_enabled():
        rope_pos = ((cache.pos[0, :, 0] >= 0).sum(dim=-1, dtype=torch.int32)
                    if streaming else None)
        hm, kn, vn, probs, p_new = fused_decode_step_batch(
            params.layers, cfg, cache.k, cache.v, cache.pos, h[:, 0], q_pos_b, *scales,
            rope_pos=rope_pos)
        h = hm[:, None]                                         # (B, 1, D)
        probs = probs[:, :, :, 0, :]                            # (L, B, Hkv, S)
        p_new = p_new[..., None]                                # (L, B, Hkv, 1)
    else:
        h, kn, vn, probs, p_new = _decode_layers(params, cfg, cache, h, q_pos, stream)
    fold_stream = decode_stream_folded(spec, streaming, ordered, prerotated)
    ekw = {}
    if decode_evict_folded(spec, streaming) or fold_stream:
        ekw = dict(espec=spec, evict_gate=ctx.evict_gate, next_pos=ctx.next_pos,
                   prompt_len=ctx.prompt_len, rand_rank=ctx.rand_rank, compact=fold_stream)
    if cache.quantized:
        kn, k_sc = quantize_kv(kn)
        vn, v_sc = quantize_kv(vn)
        ekw.update(k_sc_new=k_sc, v_sc_new=v_sc, k_scale=cache.k_scale,
                   v_scale=cache.v_scale)
    else:
        kn, vn = kn.to(cache.k.dtype), vn.to(cache.v.dtype)
    res = _on_mesh(fused_write_update, fused_write_update_sharded)(
        cache.pos, cache.score, cache.score_sq, cache.counter, probs, p_new,
        q_pos_b, ctx.token_valid[:, 0].contiguous(), ctx.update_gate,
        ctx.counter_init[:, 0].contiguous(), None if spec is None else spec.policy,
        k=cache.k, v=cache.v, kn=kn.contiguous(), vn=vn.contiguous(), **ekw)
    if fold_stream:
        # the rows just written shift too, as evict_cache + _compact_one would
        fused_kv_compact(cache.k, cache.v, res[-1][..., 0].contiguous(), cache.k_scale,
                         cache.v_scale, rot=(stream.cos, stream.sin))
    return _logits_tail(h, params, cfg)


def _decode_layers(params: LlamaParams, cfg: ModelConfig, cache: KVCache, h: torch.Tensor,
                   q_pos: torch.Tensor, stream: Optional[StreamRot]):
    """_decode_forward's per-layer loop (K1 per layer): returns (h, kn, vn
    (L, B, Hkv, 1, Dh), probs (L, B, Hkv, S), p_new (L, B, Hkv, 1))."""
    B = h.shape[0]
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    inv_freq = rope_inv_freq(Dh, rope_base_for(cfg), h.device)
    q_pos_b = q_pos[:, 0].contiguous()
    streaming = stream is not None
    kind = stream.kind if streaming else None
    if streaming:
        n_valid = (cache.pos[:, :, 0, :] >= 0).sum(dim=-1, dtype=torch.int32)  # (L, B)
        cos_all, sin_all = rope_cos_sin(n_valid[:, :, None, None], inv_freq)  # (L, B, 1, 1, D/2)
    else:
        cos, sin = rope_cos_sin(q_pos[:, None, :], inv_freq)    # shared by all layers
    k1_rot = (stream.cos, stream.sin) if kind in ("ordered", "rank") else None
    ranks = None
    if kind == "rank":
        ranks = stream.ranks if stream.ranks is not None else age_ranks_all(cache.pos)

    attend_inflight = _on_mesh(fused_decode_attend_inflight, fused_decode_attend_inflight_sharded)
    kn_all, vn_all, probs_all, pnew_all = [], [], [], []
    for l, p in enumerate(params.layers):
        x = rmsnorm(h, p.ln_attn, cfg.rms_norm_eps)
        q, k, v = _proj_qkv(x, p, B, 1, Hq, Hkv, Dh)
        if streaming:
            cos, sin = cos_all[l], sin_all[l]
        q_att, kn_att = rotate(q, cos, sin), rotate(k, cos, sin)
        v = v.contiguous()
        scales = (cache.k_scale[l], cache.v_scale[l]) if cache.quantized else ()
        out, probs, p_new = attend_inflight(
            q_att, kn_att, v, cache.k[l], cache.v[l], cache.pos[l], q_pos_b, *scales,
            sliding_window=cfg.sliding_window, rot=k1_rot,
            rank=None if ranks is None else ranks[l])
        h = _attn_block(h, p, cfg, out)
        kn_all.append(k if k1_rot is not None else kn_att)
        vn_all.append(v)
        probs_all.append(probs[:, :, 0, :])
        pnew_all.append(p_new)
    return (h, torch.stack(kn_all), torch.stack(vn_all), torch.stack(probs_all),
            torch.stack(pnew_all))


@torch.no_grad()
def forward(
    params: LlamaParams,
    cfg: ModelConfig,
    cache: KVCache,
    token_ids: torch.Tensor,     # (B, C) int32
    ctx: StepCtx,                # (B, C) / (B,) fields of this chunk
    spec: Optional[PolicySpec],  # None: plain append, no scores
    *,
    bootstrap: bool = False,     # keep_attention prefix accumulation
    stream: Optional[StreamRot] = None,  # StreamingLLM: the rank cache's tables
) -> torch.Tensor:
    """One chunk through all layers, chunk-major (the JAX package's
    forward, llama.py:257-385 there). Updates `cache` in place and returns
    logits (B, C, V) f32. Eviction is not done here: the engine runs one
    eviction event across all layers after the chunk.

    A C == 1 chunk that is not the bootstrap goes to _decode_forward (late
    write; under streaming with `stream`, K1's rank variant over ranks it
    computes). Otherwise, per layer:

      * not streaming: q and K rotate by their true positions (q_pos), the
        chunk is written to the lowest free slots (cache.write_tokens), then
          - C == 1 bootstrap: fused_decode_attend, then update_scores with
            the bootstrap's sum and sum of squares;
          - C > 1 where use_chunk_kernel holds (by default an int8
            cache): K5 (fused_chunk_attend) and update_scores_reduced from
            its statistics;
          - C > 1 elsewhere: the plain `attend` over the dequantized cache
            and update_scores;
      * streaming (`stream`, kind `rank`; reference llama_patch.py:251-379):
        the raw K is written, the cache is dequantized, every cached K
        rotates by its age rank (_age_ranks of the written cache), q by its
        cache-relative position (the post-write valid count, less the
        chunk's valid tokens, plus each token's offset among them), then the
        plain `attend` masked by true positions and update_scores. The JAX
        package runs this branch through XLA's attend, outside any Pallas
        kernel."""
    B, C = token_ids.shape
    if stream is not None and stream.kind != "rank":
        raise ValueError(f"forward's streaming cache is the rank one, got {stream.kind!r}")
    if C == 1 and not bootstrap:
        return _decode_forward(params, cfg, cache, token_ids, ctx, spec, stream)
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    dev = token_ids.device
    inv_freq = rope_inv_freq(Dh, rope_base_for(cfg), dev)
    scale = Dh ** -0.5
    streaming = stream is not None
    if streaming:
        tv = ctx.token_valid.to(torch.int32)
        q_off = tv.cumsum(dim=-1) - tv.sum(dim=-1, keepdim=True) - 1   # (B, C), + n_valid
    else:
        cos, sin = rope_cos_sin(ctx.q_pos[:, None, :], inv_freq)    # shared by all layers
    score = spec is not None and (bootstrap or spec.policy != "full")

    h = params.embed[token_ids.clamp(min=0)]
    for l, p in enumerate(params.layers):
        cl = cache.layer(l)
        x = rmsnorm(h, p.ln_attn, cfg.rms_norm_eps)
        q, k, v = _proj_qkv(x, p, B, C, Hq, Hkv, Dh)
        if not streaming:
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        write_tokens(cl, k, v, ctx.q_pos, ctx.counter_init, ctx.token_valid)
        probs = None
        if streaming:
            k_raw, v_raw = kv_dequant(cl, h.dtype)
            k_att = apply_rope(k_raw, _age_ranks(cl.pos), inv_freq)
            n_valid = (cl.pos[:, 0, :] >= 0).sum(dim=-1, keepdim=True)   # (B, 1)
            q_att = apply_rope(q, (n_valid + q_off)[:, None, :], inv_freq)
            out, probs = attend(q_att, k_att, v_raw, cl.pos, ctx.q_pos,
                                sliding_window=cfg.sliding_window, scale=scale)
        elif C == 1:
            out, probs = fused_decode_attend(
                q.contiguous(), cl.k, cl.v, cl.pos, ctx.q_pos[:, 0].contiguous(),
                *((cl.k_scale, cl.v_scale) if cl.quantized else ()),
                sliding_window=cfg.sliding_window)
        elif use_chunk_kernel(cl.k.dtype):
            need = spec is not None and (bootstrap or spec.policy in ("h2o_head", "roco", "tova"))
            out, ssum, ssq, last = _on_mesh(fused_chunk_attend, fused_chunk_attend_sharded)(
                q.contiguous(), cl.k, cl.v, cl.pos, ctx.q_pos, cl.k_scale, cl.v_scale,
                need_scores=need, sliding_window=cfg.sliding_window)
            if need:
                update_scores_reduced(cl, ssum, ssq, last, spec, ctx.update_gate,
                                      bootstrap=bootstrap)
        else:
            out, probs = _plain_attend(cl, q, ctx.q_pos, cfg)
        if probs is not None and score:
            update_scores(cl, probs, spec, ctx.update_gate, bootstrap=bootstrap)
        h = _attn_block(h, p, cfg, out)
    return _logits_tail(h, params, cfg)
