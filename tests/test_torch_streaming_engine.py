"""StreamingLLM `decoding` of the port against the JAX package's, on the CPU.

  lockstep           the port's _decode_forward (+ evict_cache / K4 and
                     _compact_one / K8 with the rotate-at-read cache; K2
                     `compact` + K9 folded with the pre-rotated one) against
                     the JAX package's forward(streaming=True, ordered=True)
                     + evict_cache + _compact_one on its default CPU path,
                     from the same prefilled cache, the five policies, every
                     rand_rank drawn once and fed to both: pos and counter
                     exact every step; f32: scores within 1e-6, K/V 1e-5,
                     logits 1e-4; int8: K/V within one step, scales 1e-5
                     relative, scores 2e-5, logits 2e-3 (the two packages'
                     f32 projections differ in their last bits, as in
                     tests/test_torch_int8.py, and a requant of a value one
                     step apart moves the scores it feeds)
  generate           greedy tokens and the budget-ratio line equal to the
                     JAX package's, f32 and int8 caches, GQA and MHA, the
                     prerot flag set alike in both packages
  B=2                _run_decoding with one row stopped by EOS: both rows'
                     tokens and kv_len equal to the JAX package's
  prerot on vs off   the port's two ordered strategies give equal tokens
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
from easykv_tpu import flags as jflags
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops.rope import rope_base_for as jrope_base, rope_inv_freq as jinv_freq
from easykv_tpu.policies import evict_cache as jevict_cache

from easykv_tpu_torch import flags as tflags
from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.policies import evict_cache as tevict_cache

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)


def t(x):
    return torch.from_numpy(np.array(x))


def cache_from_jax(cache) -> KVCache:
    leaves = [np.array(x) for x in tuple(cache)]
    quant = leaves[0].dtype == np.int8
    return KVCache(*map(torch.from_numpy, leaves[:6]),
                   *(map(torch.from_numpy, leaves[6:8]) if quant else (None, None)))


def assert_cache_close(tc: KVCache, jc, what: str):
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos), err_msg=f"pos, {what}")
    np.testing.assert_array_equal(tc.counter.numpy(), np.asarray(jc.counter),
                                  err_msg=f"counter, {what}")
    # an int8 value one step apart moves a probability by ~1e-6 and the
    # scores add them up over the steps
    atol = 2e-5 if tc.quantized else 1e-6
    for name in ("score", "score_sq"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   rtol=0, atol=atol, err_msg=f"{name}, {what}")
    if tc.quantized:
        for name in ("k", "v"):
            d = np.abs(getattr(tc, name).numpy().astype(np.int32)
                       - np.asarray(getattr(jc, name)).astype(np.int32))
            assert d.max() <= 1, f"{name}, {what}: int8 values differ by {d.max()}"
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       rtol=1e-5, atol=0, err_msg=f"{name}, {what}")
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       rtol=0, atol=1e-5, err_msg=f"{name}, {what}")


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ModelConfig(**CFG), tparams


@pytest.fixture
def prerot():
    """Sets both packages' prerot flag; puts both back after the test."""
    def set_both(on):
        jflags.use_prerot(on)
        tflags.use_prerot(on)
    yield set_both
    set_both(None)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("pre", [True, False], ids=["prerot", "rotate-at-read"])
@pytest.mark.parametrize("policy", ["roco", "h2o_head", "tova", "recency", "random"])
def test_streaming_decode_lockstep(models, policy, pre, quant):
    """Two batch rows, 16 steps, 10 past a budget of 6: every step evicts
    and compacts once the budget is full."""
    jcfg, jparams, tcfg, tparams = models
    B, P, budget, steps = 2, 24, 6, 16
    rng = np.random.default_rng(sum(map(ord, policy)) + 7 * pre + quant)
    ids = rng.integers(1, 120, size=(B, P)).astype(np.int32)
    plen = np.full((B,), P, np.int32)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", policy=policy, stride=1, length=P,
                             budget=budget, recent_window_dec=int(budget * 0.3),
                             streaming=True, kv_quant=quant)
    spec_j = jst.decode_spec()
    tst = tgen.EngineStatics(cfg=tcfg, policy=policy, length=P, budget=budget,
                             recent_window_dec=int(budget * 0.3), kv_quant=quant,
                             streaming=True)
    spec_t = tst.decode_spec()
    cache, _ = jax.jit(lambda c: jgen._prefill(jst, jparams, c, jnp.asarray(ids),
                                               jnp.asarray(plen), None, "zero"))(
        jgen._engine_cache(jst, B, P + budget + 1))
    tcache = cache_from_jax(cache)
    stream = tllama.stream_tables(tcache.pos.shape[-1], tcfg, "cpu",
                                  "prerotated" if pre else "ordered")
    if pre:
        cache = jax.jit(lambda c: jgen._prerotate_cache(c, jcfg))(cache)
        tgen._prerotate_cache(tcache, tcfg)
        assert_cache_close(tcache, cache, "after _prerotate_cache")
    rot_if = jinv_freq(jcfg.head_dim, jrope_base(jcfg)) if pre else None

    @jax.jit
    def jstep(c, tok, ctx):
        logits, c = jllama.forward(jparams, jcfg, c, tok, ctx, spec_j, streaming=True,
                                   ordered=True, prerotated=pre, fold_evict=False)
        pos_mid = c.pos
        c = jevict_cache(c, spec_j, ctx.next_pos, ctx.prompt_len, ctx.rand_rank,
                         ctx.evict_gate)
        return logits, jgen._compact_one(c, pos_mid, rot_inv_freq=rot_if)

    folded = tllama.decode_stream_folded(spec_t, True, True, pre)
    assert folded == pre
    toks = rng.integers(1, 120, size=(steps, B)).astype(np.int32)
    for g in range(steps):
        tok_pos = np.full((B,), P + g, np.int32)
        ctx_np = dict(
            q_pos=tok_pos[:, None], token_valid=np.ones((B, 1), bool),
            counter_init=np.full((B, 1), max(budget - g, 0), np.float32),
            next_pos=tok_pos + 1, prompt_len=plen,
            evict_gate=np.full((B,), g + 1 > budget), update_gate=np.ones((B,), bool),
            rand_rank=(rng.random(B) * min(g + 1, budget + 1)).astype(np.int32),
        )
        jctx = jllama.StepCtx(**{k: jnp.asarray(v) for k, v in ctx_np.items()})
        tctx = tllama.StepCtx(**{k: t(v) for k, v in ctx_np.items()})
        jlog, cache = jstep(cache, jnp.asarray(toks[g][:, None]), jctx)
        tlog = tllama._decode_forward(tparams, tcfg, tcache, t(toks[g][:, None]), tctx, spec_t,
                                      stream)
        if not folded:
            pos_mid = tcache.pos.clone()
            tevict_cache(tcache, spec_t, tctx.next_pos, tctx.prompt_len, tctx.rand_rank,
                         tctx.evict_gate)
            tgen._compact_one(tcache, pos_mid)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=2e-3 if quant else 1e-4, err_msg=f"logits, step {g}")
        assert_cache_close(tcache, cache, f"step {g}")
    # ordered: valid slots contiguous from 0, positions increasing
    pos = tcache.pos
    n = (pos >= 0).sum(-1)
    assert (n == P + budget).all()
    head = pos[..., :P + budget]
    assert (head >= 0).all() and (head[..., 1:] > head[..., :-1]).all()


def _ratio(text):
    return re.findall(r"KV cache budget ratio: .*", text)


GEN_CASES = [  # policy, kv_quant, variant
    ("roco", False, {}), ("h2o_head", False, {}), ("tova", False, {}),
    ("recency", False, {}), ("full", False, {}),
    ("roco", True, {}), ("tova", True, {}), ("full", True, {}),
    ("roco", False, dict(num_key_value_heads=4)),
]


@pytest.mark.parametrize("pre", [True, False], ids=["prerot", "rotate-at-read"])
@pytest.mark.parametrize("policy,quant,variant", GEN_CASES,
                         ids=[f"{p}-{'int8' if q else 'f32'}{'-mha' if v else ''}"
                              for p, q, v in GEN_CASES])
def test_streaming_generate_matches_jax(models, policy, quant, variant, pre, prerot, capsys):
    if variant:
        kw = dict(CFG, **variant)
        jcfg = JModelConfig(**kw)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1))
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        tcfg = ModelConfig(**kw)
    else:
        jcfg, jparams, tcfg, tparams = models
    prerot(pre)
    jm = easykv_tpu.CausalLM(jcfg, jparams, kv_quant=quant)
    tm = easykv_tpu_torch.CausalLM(tcfg, tparams, device="cpu", kv_quant=quant)
    ids = np.random.default_rng(sum(map(ord, policy)) + 5).integers(1, 120, size=(30,))
    gc = {"budget": 8, "kv_policy": policy, "max_new_tokens": 22, "streaming": True,
          "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode="decoding")
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="decoding")
    tprint = _ratio(capsys.readouterr().out)
    assert out == ref
    assert tprint == jprint and len(tprint) == 1
    if policy != "full":
        assert tm.last_run.kv_len - 30 == 8


@pytest.mark.parametrize("pre", [True, False], ids=["prerot", "rotate-at-read"])
def test_streaming_batch_eos_matches_jax(models, pre, prerot):
    """B=2 through _run_decoding, roco, row 1's prompt shorter (padding);
    the EOS id is the token row 0 emits fifth, so some row stops early.
    Both rows' tokens and kv_len equal the JAX package's."""
    jcfg, jparams, tcfg, tparams = models
    prerot(pre)
    rng = np.random.default_rng(13)
    P = 64
    ids = rng.integers(1, 120, size=(2, P)).astype(np.int32)
    plen = np.array([40, 33], np.int32)
    ids[1, 33:] = 0
    ids[0, 40:] = 0
    common = dict(policy="roco", length=P, budget=6, max_new_tokens=20,
                  recent_window_dec=1, streaming=True)

    def run_jax(eos):
        st = jgen.EngineStatics(cfg=jcfg, mode="decoding", stride=1, eos_token_ids=eos,
                                **common)
        r = jgen._run_decoding(st, jparams, jnp.asarray(ids), jnp.asarray(plen),
                               jnp.float32(1e-9), jnp.float32(1.0), jax.random.PRNGKey(0))
        return np.asarray(r.out_ids), np.asarray(r.kv_len)

    def run_torch(eos):
        st = tgen.EngineStatics(cfg=tcfg, eos_token_ids=eos, **common)
        r, _, _, _ = tgen._run_decoding(st, tparams, t(ids), t(plen), 1e-9, 1.0,
                                        torch.Generator().manual_seed(0), torch.float32)
        return r.out_ids.numpy(), r.kv_len.numpy()

    free_j, _ = run_jax(())
    eos = (int(free_j[0, 4]),)
    jo, jk = run_jax(eos)
    to, tk = run_torch(eos)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tk, jk)
    assert (jo == -1).any()                     # a row stopped at its EOS


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_prerotated_matches_rotate_at_read(quant, prerot):
    """The port's twin of the JAX package's
    test_prerotated_matches_rank_rotation: the pre-rotated cache and the
    rotate-at-read cache give the same greedy tokens over a budgeted
    streaming decode that evicts every step."""
    cfg = ModelConfig(vocab_size=96, hidden_size=64, intermediate_size=112,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=256)
    params = tllama.init_params(cfg, seed=5, device="cpu")
    ids = np.random.default_rng(29).integers(1, 90, size=(21,))
    gc = {"budget": 8, "kv_policy": "roco", "max_new_tokens": 16, "temperature": 1e-9,
          "top_p": 1.0, "streaming": True, "eos_token_ids": [], "seed": 5}
    outs = []
    for on in (True, False):
        prerot(on)
        outs.append(easykv_tpu_torch.generate(
            easykv_tpu_torch.CausalLM(cfg, params, device="cpu", kv_quant=quant), ids,
            dict(gc), kv_mode="decoding"))
    assert outs[0] == outs[1]
