"""End to end on the CPU with quantized weights: the port's engine against
the JAX package's on the same converted int8, int4-arithmetic-fused,
int4-halves-split and dual (int4 arithmetic + int8 copy, fused) trees, at
temperature 1e-9.

- A decode lockstep (B = 1: every product at M = 1, K10 / K12 / K13's plain
  versions; B = 2: K11 / K12 / K13 at M = 2, the dual tree's int8 copy):
  logits within 1e-4, pos and counters equal after every step.
- `generate` in `decoding` (roco and `full`, float and int8 KV), through
  `_run_decoding` at B = 2 (both rows' tokens and kv_len), in `encoding`
  (roco) and `ppl` (roco, within 2e-4 relative, as the float trees are
  held): equal greedy tokens and printed budget ratio.

The JAX package runs its default CPU path (XLA: its mm's einsum and
dequant-dot branches, the int8 matmul in f32); the port's wrappers run
their plain versions, so only the order of f32 sums differs.
"""
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easykv_tpu
import easykv_tpu_torch
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops import quant as jq
from easykv_tpu.policies import evict_cache

from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.quant import QuantLinear

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=768, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
TREES = {
    "int8": jq.quantize_params,
    "int4 arith fused": lambda p: jq.fuse_gemv_params(jq.quantize_params_int4(p, layout="arith")),
    "int4 halves split": jq.quantize_params_int4,
    "dual fused": lambda p: jq.fuse_gemv_params(
        jq.quantize_params_int4(p, layout="arith", dual_int8=True)),
}
LENGTH, STRIDE = 90, 8


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def trees():
    jcfg = JModelConfig(**CFG)
    base = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    out = {}
    for name, quantize in TREES.items():
        jparams = quantize(base)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        assert isinstance(tparams.layers[0].wo, QuantLinear)
        out[name] = (jparams, tparams)
    return jcfg, ModelConfig(**CFG), out


def _models(trees, name, kv_quant=False):
    jcfg, tcfg, tr = trees
    jparams, tparams = tr[name]
    return (easykv_tpu.CausalLM(jcfg, jparams, kv_quant=kv_quant),
            easykv_tpu_torch.CausalLM(tcfg, tparams, device="cpu", kv_quant=kv_quant))


def _ratio(text):
    return re.findall(r"(?i)KV cache budget ratio.*", text)


def _gc(policy, budget, **kw):
    return dict({"budget": budget, "kv_policy": policy, "max_new_tokens": 12,
                 "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}, **kw)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("tree", list(TREES))
def test_decode_lockstep_matches_jax(trees, tree, B):
    jcfg, tcfg, tr = trees
    jparams, tparams = tr[tree]
    P, budget, steps = 24, 6, 12
    rng = np.random.default_rng(B + len(tree))
    ids = rng.integers(1, 500, size=(B, P)).astype(np.int32)
    plen = np.full((B,), P, np.int32)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", policy="roco", stride=1, length=P,
                             budget=budget, recent_window_dec=1)
    spec_j = jst.decode_spec()
    spec_t = tgen.EngineStatics(cfg=tcfg, policy="roco", length=P, budget=budget,
                                recent_window_dec=1).decode_spec()
    cache = jgen._engine_cache(jst, B, P + budget + 1)
    cache, _ = jax.jit(lambda c: jgen._prefill(jst, jparams, c, jnp.asarray(ids),
                                               jnp.asarray(plen), None, "zero"))(cache)
    tcache = KVCache(*(t(x) for x in tuple(cache)[:6]))
    fwd = jax.jit(lambda c, tok, ctx: jllama.forward(jparams, jcfg, c, tok, ctx, spec_j,
                                                     fold_evict=False))
    evict = jax.jit(lambda c, ctx: evict_cache(c, spec_j, ctx.next_pos, ctx.prompt_len,
                                               ctx.rand_rank, ctx.evict_gate))
    toks = rng.integers(1, 500, size=(steps, B)).astype(np.int32)
    for g in range(steps):
        tok_pos = np.full((B,), P + g, np.int32)
        ctx_np = dict(q_pos=tok_pos[:, None], token_valid=np.ones((B, 1), bool),
                      counter_init=np.full((B, 1), max(budget - g, 0), np.float32),
                      next_pos=tok_pos + 1, prompt_len=plen,
                      evict_gate=np.full((B,), g + 1 > budget), update_gate=np.ones((B,), bool),
                      rand_rank=np.zeros((B,), np.int32))
        jctx = jllama.StepCtx(**{k: jnp.asarray(v) for k, v in ctx_np.items()})
        tctx = tllama.StepCtx(**{k: t(v) for k, v in ctx_np.items()})
        jlog, cache = fwd(cache, jnp.asarray(toks[g][:, None]), jctx)
        cache = evict(cache, jctx)
        tlog = tllama._decode_forward(tparams, tcfg, tcache, t(toks[g][:, None]), tctx, spec_t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(cache.pos),
                                      err_msg=f"pos, step {g}")
        np.testing.assert_array_equal(tcache.counter.numpy(), np.asarray(cache.counter),
                                      err_msg=f"counter, step {g}")
    assert ((tcache.pos >= 0).sum(-1) == P + budget).all()


@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("policy", ["roco", "full"])
@pytest.mark.parametrize("tree", list(TREES))
def test_generate_decoding_matches_jax(trees, tree, policy, kv, capsys):
    jm, tm = _models(trees, tree, kv == "int8")
    ids = np.random.default_rng(len(tree) + len(policy)).integers(1, 500, size=(30,))
    gc = _gc(policy, 6)
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode="decoding")
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="decoding")
    assert out == ref and len(out) == 12
    assert _ratio(capsys.readouterr().out) == jprint and len(jprint) == 1
    assert tm.last_run.kv_len == 30 + (6 if policy == "roco" else 12)


@pytest.mark.parametrize("tree", list(TREES))
def test_decoding_batch_rows_match_jax(trees, tree):
    """B = 2 through _run_decoding, roco, row 1's prompt shorter (padding):
    both rows' tokens and kv_len equal the JAX package's."""
    jcfg, tcfg, tr = trees
    jparams, tparams = tr[tree]
    kv_quant = tree in ("int8", "dual fused")
    P = 64
    ids = np.random.default_rng(17).integers(1, 500, size=(2, P)).astype(np.int32)
    plen = np.array([40, 33], np.int32)
    ids[0, 40:] = 0
    ids[1, 33:] = 0
    common = dict(policy="roco", length=P, budget=6, max_new_tokens=12, recent_window_dec=1,
                  kv_quant=kv_quant)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", stride=1, **common)
    jr = jgen._run_decoding(jst, jparams, jnp.asarray(ids), jnp.asarray(plen),
                            jnp.float32(1e-9), jnp.float32(1.0), jax.random.PRNGKey(0))
    tst = tgen.EngineStatics(cfg=tcfg, **common)
    tr_, _, _, _ = tgen._run_decoding(tst, tparams, t(ids), t(plen), 1e-9, 1.0,
                                      torch.Generator().manual_seed(0), torch.float32)
    np.testing.assert_array_equal(tr_.out_ids.numpy(), np.asarray(jr.out_ids))
    np.testing.assert_array_equal(tr_.kv_len.numpy(), np.asarray(jr.kv_len))


@pytest.mark.parametrize("tree", list(TREES))
def test_encoding_matches_jax(trees, tree, capsys):
    jm, tm = _models(trees, tree, kv_quant=tree == "int4 arith fused")
    ids = np.random.default_rng(len(tree)).integers(1, 500, size=(LENGTH,))
    gc = _gc("roco", 0.5)
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode="encoding", stride=STRIDE)
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="encoding", stride=STRIDE)
    assert out == ref and len(out) == 12
    assert _ratio(capsys.readouterr().out) == jprint and len(jprint) == 1


@pytest.mark.parametrize("tree", list(TREES))
def test_ppl_matches_jax(trees, tree, capsys):
    jm, tm = _models(trees, tree, kv_quant=tree == "int8")
    ids = np.random.default_rng(len(tree) + 3).integers(1, 500, size=(LENGTH,))
    gc = {"budget": 0.5, "kv_policy": "roco", "seed": 9}
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode="ppl", stride=STRIDE)
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="ppl", stride=STRIDE)
    assert isinstance(out, float) and np.isfinite(out)
    assert out == pytest.approx(ref, rel=2e-4)
    assert _ratio(capsys.readouterr().out) == jprint
