"""The int8 KV cache of the port against the JAX package's, on the CPU.

  quantize_kv, kv_dequant         bit-exact (int8 values and f32 scales)
  K5 plain chunk attention        against Pallas `fused_chunk_attend` in
                                  interpret mode, 1-pass and 2-pass flash
                                  (out 1e-5, ssq / last 1e-6, ssum 1e-5)
  K1 / K2 / K3 with int8 K/V      against their Pallas kernels (K1 1e-5;
                                  K2 pos / slot / counter / scale rows exact,
                                  scores 1e-6; K3 exact)
  prefill and decode lockstep     pos and counter exact; int8 K/V within one
                                  quantization step, scales within 1e-5
                                  relative and logits within 2e-3: the two
                                  packages' f32 projections differ in their
                                  last bits (up to ~1.2e-6 relative here),
                                  which moves a scale by as much and may
                                  round a value across an int8 boundary
  generate(kv_quant=True)         greedy tokens and budget ratio equal to the
                                  JAX package's, for roco also with the JAX
                                  package's Pallas kernels (interpret mode)
"""
import functools
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easykv_tpu
import easykv_tpu_torch
from easykv_tpu import flags
from easykv_tpu import policies as jpol
from easykv_tpu.cache import LayerCache
from easykv_tpu.cache import kv_dequant as jkv_dequant
from easykv_tpu.cache import quantize_kv as jquantize
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops.pallas import chunk_attention as jca
from easykv_tpu.ops.pallas.decode_attention import fused_decode_attend_inflight as jk1
from easykv_tpu.ops.pallas.row_write import write_rows as jk3
from easykv_tpu.ops.pallas.sidecar_update import fused_write_update as jk2
from easykv_tpu.policies import evict_cache

from easykv_tpu_torch import policies as tpol
from easykv_tpu_torch.cache import KVCache, kv_dequant, quantize_kv
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.cuda import chunk_attention as tca
from easykv_tpu_torch.ops.cuda.chunk_attention import fused_chunk_attend as tk5
from easykv_tpu_torch.ops.cuda.decode_attention import fused_decode_attend_inflight as tk1
from easykv_tpu_torch.ops.cuda.row_write import write_rows as tk3
from easykv_tpu_torch.ops.cuda.sidecar_update import fused_write_update as tk2

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)
POLICIES = [None, "h2o_head", "tova", "roco", "recency", "random"]


def t(x):
    return torch.from_numpy(np.array(x))


def cache_from_jax(cache) -> KVCache:
    """A JAX KVCache (or its leaves) as the port's: the int8 K/V with their
    scale rows, or a float cache whose (L, B, H, 1) scale dummies become
    None."""
    leaves = [np.array(x) for x in tuple(cache)]
    quant = leaves[0].dtype == np.int8
    return KVCache(*map(torch.from_numpy, leaves[:6]),
                   *(map(torch.from_numpy, leaves[6:8]) if quant else (None, None)))


def assert_kv_close(tcache: KVCache, jcache, what: str):
    """int8 K/V within one quantization step, scales within 1e-5 relative."""
    for name in ("k", "v"):
        diff = np.abs(getattr(tcache, name).numpy().astype(np.int32)
                      - np.asarray(getattr(jcache, name)).astype(np.int32))
        assert diff.max() <= 1, f"{name}, {what}: int8 values differ by {diff.max()}"
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                   np.asarray(getattr(jcache, name)), rtol=1e-5, atol=0,
                                   err_msg=f"{name}, {what}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 4, 33, 64)) * rng.choice([1e-3, 1.0, 40.0], size=(3, 4, 33, 1)))
    x[0, 0, 0] = 0.0                      # amax 0: the 1e-8 floor
    x[0, 0, 1] = 0.5                      # every value on a half step
    xj = jnp.asarray(x.astype(np.float32), getattr(jnp, dtype))
    qj, sj = jax.jit(jquantize)(xj)
    qt, st = quantize_kv(t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32), np.asarray(sj).view(np.int32))


# --------------------------------------------------------------------------
# K5 chunk attention
# --------------------------------------------------------------------------

K5_CASES = {
    # name: (quant, need_scores, flash, rep, Hkv, C, S, window, pad)
    "int8-onepass-scores-gqa-pad": (True, True, False, 2, 2, 16, 200, None, True),
    "f32-onepass-scores-mha-window": (False, True, False, 1, 2, 8, 130, 9, False),
    "int8-onepass-noscores": (True, False, False, 1, 2, 16, 128, None, False),
    "int8-flash-scores-window-pad": (True, True, True, 2, 1, 8, 300, 40, True),
    "f32-flash-noscores-gqa": (False, False, True, 4, 1, 8, 260, None, False),
    "f32-flash-scores-pad": (False, True, True, 1, 2, 16, 200, None, True),
}


def _k5_inputs(quant, rep, Hkv, C, S, pad, seed):
    B, D = 2, 64
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hkv * rep, C, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    pos = rng.integers(0, 60, size=(B, Hkv, S)).astype(np.int32)
    pos[:, :, ::7] = -1
    pos[:, :, :C] = 60 + np.arange(C)      # the chunk's own tokens
    q_pos = np.broadcast_to(60 + np.arange(C, dtype=np.int32), (B, C)).copy()
    if pad:
        q_pos[1, C - 3:] = -1              # padding rows, the last one included
    if not quant:
        return (q, k, v, pos, q_pos), ()
    kq, ks = jax.jit(jquantize)(jnp.asarray(k))
    vq, vs = jax.jit(jquantize)(jnp.asarray(v))
    return (q, np.asarray(kq), np.asarray(vq), pos, q_pos), (np.asarray(ks), np.asarray(vs))


@pytest.mark.parametrize("case", list(K5_CASES))
def test_k5_plain_matches_pallas(case, monkeypatch):
    quant, need_scores, flash, rep, Hkv, C, S, window, pad = K5_CASES[case]
    args, scales = _k5_inputs(quant, rep, Hkv, C, S, pad, seed=len(case))
    if flash:
        monkeypatch.setattr(jca, "_ONEPASS_VMEM_CAP", 0)
    fn = functools.partial(jca.fused_chunk_attend.__wrapped__, interpret=True,
                           need_scores=need_scores, sliding_window=window)
    ref = jax.jit(fn)(*map(jnp.asarray, args + scales))
    out = tk5(*map(t, args + scales), need_scores=need_scores, sliding_window=window)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    if pad:
        assert (out[0][1, :, C - 3:] == 0).all()
    if not need_scores:
        assert ref[1] is None and out[1:] == (None, None, None)
        return
    for name, a, b, atol in (("ssum", out[1], ref[1], 1e-5), ("ssq", out[2], ref[2], 1e-6),
                             ("last", out[3], ref[3], 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol, err_msg=name)
    if pad:
        assert (out[3][1] == 0).all()      # the padding last row gives zeros


# --------------------------------------------------------------------------
# K1 / K2 / K3 with an int8 cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("Hq,Hkv,q_pos,window", [
    (4, 4, (30, 35), None),     # MHA
    (8, 2, (30, 35), None),     # GQA
    (4, 2, (30, -1), None),     # dead second row
    (4, 2, (30, 35), 9),        # sliding window
])
def test_k1_int8_plain_matches_pallas(Hq, Hkv, q_pos, window):
    B, S, D = 2, 128, 64
    rng = np.random.default_rng(3)
    q, kn, vn = (rng.normal(size=(B, h, 1, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))
    kq, ks = (np.asarray(a) for a in jquantize(jnp.asarray(rng.normal(size=(B, Hkv, S, D)),
                                                           jnp.float32)))
    vq, vs = (np.asarray(a) for a in jquantize(jnp.asarray(rng.normal(size=(B, Hkv, S, D)),
                                                           jnp.float32)))
    pos = rng.integers(0, 40, size=(B, Hkv, S)).astype(np.int32)
    pos[:, :, ::7] = -1
    args = (q, kn, vn, kq, vq, pos, np.array(q_pos, np.int32))
    ref = jax.jit(functools.partial(jk1, sliding_window=window, interpret=True))(
        *map(jnp.asarray, args), k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    out = tk1(*map(t, args), t(ks), t(vs), sliding_window=window)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_k2_scale_rows_plain_matches_pallas(policy):
    """Gate on for row 0; row 1 is dead, so its pos stays but its scale
    rows are written anyway (the write is not gated on liveness)."""
    L, B, H, S, budget = 2, 2, 2, 128, 20
    rng = np.random.default_rng(8)
    pos = np.full((L, B, H, S), -1, np.int32)
    pos[..., :48] = np.arange(48)
    for idx in np.ndindex(L, B, H):
        pos[idx][rng.choice(np.arange(12, 44), 3, replace=False)] = -1
    valid = pos >= 0
    score = np.where(valid, rng.random(pos.shape), 0).astype(np.float32)
    ssq = (score * rng.random(pos.shape)).astype(np.float32)
    counter = np.where(valid, rng.integers(0, 30, pos.shape), 0).astype(np.float32)
    probs = np.where(valid, rng.random(pos.shape) / S, 0).astype(np.float32)
    p_new = rng.random((L, B, H, 1)).astype(np.float32) * 0.1
    live = np.array([True, False])
    scales = (rng.random((L, B, H, 1)).astype(np.float32), rng.random((L, B, H, 1)).astype(np.float32),
              rng.random((L, B, H, S)).astype(np.float32), rng.random((L, B, H, S)).astype(np.float32))
    args = (pos, score, ssq, counter, probs, p_new, np.array([48, 48], np.int32), live,
            live.copy(), np.array([3.0, 0.0], np.float32))
    jspec, jkw, tkw = {}, {}, {}
    if policy is not None:
        rw = int(budget * 0.3)
        spec = dict(policy=policy, phase="decode", k=1, sink_length=4, recent_window=rw,
                    feasible_k=budget - rw, protect_prompt=True)
        extra = dict(evict_gate=np.array([True, False]), next_pos=np.array([49, 49], np.int32),
                     prompt_len=np.full((B,), 12, np.int32), rand_rank=np.array([5, 17], np.int32))
        jspec = dict(espec=jpol.PolicySpec(**spec))
        jkw = {k: jnp.asarray(v) for k, v in extra.items()}
        tkw = dict(espec=tpol.PolicySpec(**spec), **{k: t(v) for k, v in extra.items()})
    names = ("k_sc_new", "v_sc_new", "k_scale", "v_scale")
    ref = jax.jit(functools.partial(jk2, policy=policy, interpret=True, **jspec))(
        *map(jnp.asarray, args), **jkw, **{n: jnp.asarray(x) for n, x in zip(names, scales)})
    out = tk2(*map(t, args), policy=policy, **tkw, **{n: t(x) for n, x in zip(names, scales)})
    assert len(out) == len(ref) == 7
    for name, a, b in zip(("pos", "score", "score_sq", "counter", "slot", "k_scale", "v_scale"),
                          out, ref):
        if name in ("score", "score_sq"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    slot = out[4].numpy()[:, 1, :, 0]      # the dead row's scales moved too
    np.testing.assert_array_equal(
        np.take_along_axis(out[5].numpy()[:, 1], slot[..., None], -1), scales[0][:, 1])


def test_k3_int8_plain_matches_pallas():
    L, B, H, S, Dh = 2, 2, 2, 128, 128
    rng = np.random.default_rng(4)
    k, v = (rng.integers(-127, 128, size=(L, B, H, S, Dh)).astype(np.int8) for _ in range(2))
    kn, vn = (rng.integers(-127, 128, size=(L, B, H, 1, Dh)).astype(np.int8) for _ in range(2))
    slots = rng.integers(0, S, size=(L, B, H)).astype(np.int32)
    rk, rv = jax.jit(functools.partial(jk3, interpret=True))(*map(jnp.asarray, (k, v, kn, vn, slots)))
    ok, ov = tk3(*map(t, (k, v, kn, vn, slots)))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(rv))


# --------------------------------------------------------------------------
# the slice: prefill, decode lockstep, generate
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ModelConfig(**CFG), tparams


def test_int8_prefill_matches_jax(models, monkeypatch):
    """Two prompt chunks of 32 (the second padded in row 1): the int8 writes
    and K5's attention over the chunk's own int8 rows."""
    jcfg, jparams, tcfg, tparams = models
    ids = np.random.default_rng(6).integers(1, 120, size=(2, 64)).astype(np.int32)
    plen = np.array([64, 45], np.int32)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", policy="full", stride=1,
                             length=64, budget=0, kv_quant=True)
    jcache, jlog = jax.jit(lambda c, i, p: jgen._prefill(jst, jparams, c, i, p, None, "zero"))(
        jgen._engine_cache(jst, 2, 128), jnp.asarray(ids), jnp.asarray(plen))
    tst = tgen.EngineStatics(cfg=tcfg, policy="full", length=64, budget=0, kv_quant=True)
    tcache = tgen._engine_cache(tst, 2, 128, torch.float32, torch.device("cpu"))
    monkeypatch.setattr(tgen, "PREFILL_CHUNK", 32)
    tlog = tgen._prefill(tst, tparams, tcache, t(ids), t(plen))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    assert_kv_close(tcache, jcache, "after the prefill")
    # kv_dequant of the same int8 layer: the same f32 products
    for dtype in ("float32", "bfloat16"):
        jk, jv = jkv_dequant(LayerCache(*(x[1] for x in jcache)), getattr(jnp, dtype))
        tk, tv = kv_dequant(cache_from_jax(jcache).layer(1), getattr(torch, dtype))
        for a, b in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(b.astype(jnp.float32)))


@pytest.mark.parametrize("policy", ["roco", "h2o_head", "tova", "recency", "random"])
def test_int8_decode_lockstep(models, policy):
    """The port's _decode_forward (K1, K2, K3 through their plain versions)
    against the JAX package's forward(fold_evict=False) + evict_cache on its
    default CPU path, from the same prefilled int8 cache, 20 steps past the
    budget."""
    jcfg, jparams, tcfg, tparams = models
    B, P, budget, steps = 2, 24, 6, 26
    rng = np.random.default_rng(sum(map(ord, policy)) + 1)
    ids = rng.integers(1, 120, size=(B, P)).astype(np.int32)
    plen = np.full((B,), P, np.int32)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", policy=policy, stride=1, length=P,
                             budget=budget, recent_window_dec=int(budget * 0.3), kv_quant=True)
    spec_j = jst.decode_spec()
    spec_t = tgen.EngineStatics(cfg=tcfg, policy=policy, length=P, budget=budget,
                                recent_window_dec=int(budget * 0.3),
                                kv_quant=True).decode_spec()
    cache, _ = jax.jit(lambda c: jgen._prefill(jst, jparams, c, jnp.asarray(ids),
                                               jnp.asarray(plen), None, "zero"))(
        jgen._engine_cache(jst, B, P + budget + 1))
    tcache = cache_from_jax(cache)
    assert tcache.quantized

    fwd = jax.jit(lambda c, tok, ctx: jllama.forward(jparams, jcfg, c, tok, ctx, spec_j,
                                                     fold_evict=False))
    evict = jax.jit(lambda c, ctx: evict_cache(c, spec_j, ctx.next_pos, ctx.prompt_len,
                                               ctx.rand_rank, ctx.evict_gate))
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
        jlog, cache = fwd(cache, jnp.asarray(toks[g][:, None]), jctx)
        cache = evict(cache, jctx)
        tlog = tllama._decode_forward(tparams, tcfg, tcache, t(toks[g][:, None]), tctx, spec_t)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=2e-3)
        np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(cache.pos),
                                      err_msg=f"pos, step {g}")
        np.testing.assert_array_equal(tcache.counter.numpy(), np.asarray(cache.counter),
                                      err_msg=f"counter, step {g}")
        for name in ("score", "score_sq"):
            np.testing.assert_allclose(getattr(tcache, name).numpy(),
                                       np.asarray(getattr(cache, name)), rtol=0, atol=1e-6,
                                       err_msg=f"{name}, step {g}")
        assert_kv_close(tcache, cache, f"step {g}")
    assert ((tcache.pos >= 0).sum(-1) == P + budget).all()


def _ratio(text):
    return re.findall(r"KV cache budget ratio: .*", text)


@pytest.mark.parametrize("policy,pallas", [
    ("roco", False), ("h2o_head", False), ("tova", False), ("recency", False),
    ("full", False), ("roco", True)])
def test_generate_int8_matches_jax(models, policy, pallas, capsys):
    jcfg, jparams, tcfg, tparams = models
    jm = easykv_tpu.CausalLM(jcfg, jparams, kv_quant=True)
    tm = easykv_tpu_torch.CausalLM(tcfg, tparams, device="cpu", kv_quant=True)
    ids = np.random.default_rng(sum(map(ord, policy)) + 2).integers(1, 120, size=(30,))
    gc = {"budget": 8, "kv_policy": policy, "max_new_tokens": 22,
          "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    flags.use_pallas(pallas)
    try:
        ref = easykv_tpu.generate(jm, ids, gc, kv_mode="decoding")
    finally:
        flags.use_pallas(None)
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="decoding")
    tprint = _ratio(capsys.readouterr().out)
    assert out == ref
    assert tprint == jprint and len(tprint) == 1
    if policy != "full":
        assert tm.last_run.kv_len - 30 == 8


@pytest.mark.parametrize("B,Hkv,rep,C,S", [(1, 32, 1, 128, 768), (1, 32, 1, 96, 2304),
                                          (2, 8, 4, 96, 2304), (1, 32, 1, 96, 2176),
                                          (2, 8, 1, 128, 256), (1, 4, 2, 17, 100),
                                          (1, 1, 32, 1, 64), (3, 2, 3, 200, 4096)])
def test_k5_attention_runs_cover_every_tile(B, Hkv, rep, C, S):
    """The attention launch's runs (csrc/chunk_attention.cu: run z walks slot
    tiles [z per, (z + 1) per), per = ceil(tiles / runs)) walk every 64-slot
    tile exactly once, none empty, at most one a tile; at the main path's
    shapes at least 132 blocks run (one per SM of an H100)."""
    runs = tca.attend_splits(B, Hkv, rep, C, S)
    tiles = -(-S // tca.TILE_SLOTS)
    per = -(-tiles // runs)
    walked = [t for z in range(runs) for t in range(z * per, min(tiles, (z + 1) * per))]
    assert 1 <= runs <= tiles and sorted(walked) == list(range(tiles))
    assert all(z * per < tiles for z in range(runs))
    blocks = B * Hkv * -(-rep * C // tca.TILE_ROWS) * runs
    if (C, S) in ((128, 768), (96, 2304)):
        assert blocks >= 132
    assert tca.attend_splits(B, Hkv, rep, C, S, exact=True) == 1   # f32: one run
