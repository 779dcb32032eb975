"""Decode-step lockstep: the port's _decode_forward with the folded
eviction (K1, K2, K3 through their plain versions on the CPU) against the
JAX package's llama.forward(fold_evict=False) followed by
policies.evict_cache on its default CPU path, for every evicting policy.

Both start from the same prefilled cache (the JAX engine's prefill,
converted) and take the same StepCtx every step, including an injected
rand_rank, for 20 steps past the budget. pos and counter must be equal
after every step, scores within 1e-6."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.policies import evict_cache

from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)
P, BUDGET, STEPS = 24, 6, 26


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ModelConfig(**CFG), tparams


@pytest.mark.parametrize("policy", ["roco", "h2o_head", "tova", "recency", "random"])
def test_decode_lockstep(models, policy):
    jcfg, jparams, tcfg, tparams = models
    B = 2
    rng = np.random.default_rng(sum(map(ord, policy)))
    ids = rng.integers(1, 120, size=(B, P)).astype(np.int32)
    plen = np.full((B,), P, np.int32)

    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", policy=policy, stride=1,
                             length=P, budget=BUDGET, recent_window_dec=int(BUDGET * 0.3))
    spec_j = jst.decode_spec()
    spec_t = tgen.EngineStatics(cfg=tcfg, policy=policy, length=P, budget=BUDGET,
                                recent_window_dec=int(BUDGET * 0.3)).decode_spec()
    cache = jgen._engine_cache(jst, B, P + BUDGET + 1)
    cache, _ = jax.jit(lambda c: jgen._prefill(jst, jparams, c, jnp.asarray(ids),
                                               jnp.asarray(plen), None, "zero"))(cache)
    tcache = KVCache(*(torch.from_numpy(np.array(x)) for x in tuple(cache)[:6]))

    fwd = jax.jit(lambda c, tok, ctx: jllama.forward(jparams, jcfg, c, tok, ctx, spec_j,
                                                     fold_evict=False))
    evict = jax.jit(lambda c, ctx: evict_cache(c, spec_j, ctx.next_pos, ctx.prompt_len,
                                               ctx.rand_rank, ctx.evict_gate))
    toks = rng.integers(1, 120, size=(STEPS, B)).astype(np.int32)
    for g in range(STEPS):
        tok_pos = np.full((B,), P + g, np.int32)
        u = rng.random(B)
        ctx_np = dict(
            q_pos=tok_pos[:, None], token_valid=np.ones((B, 1), bool),
            counter_init=np.full((B, 1), max(BUDGET - g, 0), np.float32),
            next_pos=tok_pos + 1, prompt_len=plen,
            evict_gate=np.full((B,), g + 1 > BUDGET),
            update_gate=np.ones((B,), bool),
            rand_rank=(u * min(g + 1, BUDGET + 1)).astype(np.int32),
        )
        jctx = jllama.StepCtx(**{k: jnp.asarray(v) for k, v in ctx_np.items()})
        tctx = tllama.StepCtx(**{k: torch.from_numpy(np.array(v)) for k, v in ctx_np.items()})
        jlog, cache = fwd(cache, jnp.asarray(toks[g][:, None]), jctx)
        cache = evict(cache, jctx)
        tlog = tllama._decode_forward(tparams, tcfg, tcache, torch.from_numpy(toks[g][:, None]),
                                      tctx, spec_t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(cache.pos),
                                      err_msg=f"pos, step {g}")
        np.testing.assert_array_equal(tcache.counter.numpy(), np.asarray(cache.counter),
                                      err_msg=f"counter, step {g}")
        for name in ("score", "score_sq"):
            np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                       np.asarray(getattr(cache, name)), rtol=0, atol=1e-6,
                                       err_msg=f"{name}, step {g}")
    # the budget held: prompt + BUDGET valid slots per (layer, row, head)
    assert ((tcache.pos >= 0).sum(-1) == P + BUDGET).all()
