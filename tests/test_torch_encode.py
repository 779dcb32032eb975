"""The encoding family's modules of the port against the JAX package's, on
the CPU, from the same numpy inputs:

  stride_align, stride_align_encdec,     exact on a grid of lengths, budgets
  _encode_counter_init                   and strides
  _kth_smallest                          exact (f32 with negatives and +-inf)
  select_evictions                       ids exact: 5 policies x 3 phases,
                                         k = 1, 5 (JAX top_k) and 12 (JAX
                                         sort), with ties and short rows
  update_scores(_reduced), evict_layer,  pos / counter / ids exact, scores
  evict_cache                            within 1e-6
  write_tokens_at                        exact against JAX write_tokens_at
                                         and write_tokens_dense (f32, int8)
  K6 plain                               against Pallas fused_chunk_write_attend
                                         in interpret mode (1-pass and flash)
                                         for counters >= 0, and against
                                         write_tokens_dense + fused_chunk_attend
                                         for negative ones: cache arrays exact,
                                         out 1e-5, statistics 1e-6 / 1e-5
  prefill keep_attention bootstrap,      pos / counter exact, scores 1e-6 (int8:
  strided_encode_layer_major             1e-5) plus 1e-6 relative, h 1e-4; int8
                                         K/V within one
                                         step (the packages' f32 projections
                                         differ in their last bits)
  encoding_decoding decode lockstep      pos / counter exact per step
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easykv_tpu_torch
from easykv_tpu import policies as jpol
from easykv_tpu.cache import LayerCache
from easykv_tpu.cache import quantize_kv as jquantize
from easykv_tpu.cache import write_tokens_at as jwrite_at
from easykv_tpu.cache import write_tokens_dense as jwrite_dense
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops.pallas import chunk_attention as jca

from easykv_tpu_torch import policies as tpol
from easykv_tpu_torch.cache import KVCache, write_tokens_at
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.cuda.chunk_attention import fused_chunk_write_attend as tk6

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=1024)
PHASES = [tpol.PHASE_DECODE, tpol.PHASE_ENCODE, tpol.PHASE_ENCDEC_DECODE]
EVICTING = ["roco", "h2o_head", "tova", "recency", "random"]


def t(x):
    return torch.from_numpy(np.array(x))


def stepctx_from_jax(ctxs) -> tllama.StepCtx:
    """A JAX StepCtx (any leading axes; numpy or JAX leaves) as the port's."""
    return tllama.StepCtx(**{k: t(v) for k, v in ctxs._asdict().items()})


def cache_from_jax(cache) -> KVCache:
    """A JAX KVCache / LayerCache as the port's (float caches: scales None)."""
    leaves = [np.array(x) for x in tuple(cache)]
    quant = leaves[0].dtype == np.int8
    return KVCache(*map(torch.from_numpy, leaves[:6]),
                   *(map(torch.from_numpy, leaves[6:8]) if quant else (None, None)))


def assert_sidecars(tc: KVCache, jc, what, score_atol=1e-6):
    """pos and counter exact; scores within score_atol plus 1e-6 relative:
    sums of many f32 probabilities taken in another order differ by an ulp
    of the sum."""
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos), err_msg=f"pos, {what}")
    np.testing.assert_array_equal(tc.counter.numpy(), np.asarray(jc.counter),
                                  err_msg=f"counter, {what}")
    for name in ("score", "score_sq"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   rtol=1e-6, atol=score_atol, err_msg=f"{name}, {what}")


# --------------------------------------------------------------------------
# budget resolution
# --------------------------------------------------------------------------

def test_stride_align_and_counter_init_match_jax():
    for length in (17, 90, 257, 4096):
        for stride in (1, 7, 8, 96):
            for budget in (0, 5, length // 3, length // 2 + stride, length - 1):
                assert tgen.stride_align(length, budget, stride) == \
                    jgen.stride_align(length, budget, stride)
                assert tgen.stride_align_encdec(length, budget, stride) == \
                    jgen.stride_align_encdec(length, budget, stride)
    pos = np.arange(-3, 300, dtype=np.int32)[None, :]
    for idx, stride, keep in ((50, 8, False), (50, 8, True), (2080, 96, False), (7, 1, True)):
        ref = np.asarray(jgen._encode_counter_init(jnp.asarray(pos), idx, stride, keep))
        out = tgen._encode_counter_init(t(pos), idx, stride, keep).numpy()
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))  # -0.0 too
    assert easykv_tpu_torch.stride_align is tgen.stride_align
    assert easykv_tpu_torch.stride_align_encdec is tgen.stride_align_encdec


# --------------------------------------------------------------------------
# selection
# --------------------------------------------------------------------------

def test_kth_smallest_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4, 50)).astype(np.float32) * 10
    x[0, 0, :5] = np.inf
    x[0, 1, :5] = -np.inf
    x[1, :, ::3] = 0.0
    x[1, 2, ::5] = -0.0
    x[2, 0] = 1e30
    x[2, 1, :20] = 3.25                       # ties
    for k in (1, 2, 7, 25, 50):
        ref = np.asarray(jax.jit(jpol._kth_smallest, static_argnums=1)(jnp.asarray(x), k))
        out = tpol._kth_smallest(t(x), k).numpy()
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out[..., 0], np.sort(x, axis=-1)[..., k - 1])


def _sidecars(seed, B=2, H=3, S=64):
    """pos with distinct positions and holes, one short row (3 valid slots),
    scores on a coarse grid (many ties), counters >= 1."""
    rng = np.random.default_rng(seed)
    pos = np.full((B, H, S), -1, np.int32)
    for b in range(B):
        for h in range(H):
            n = 3 if (b, h) == (1, 2) else int(rng.integers(30, 50))
            slots = rng.choice(S, n, replace=False)
            pos[b, h, slots] = np.sort(rng.choice(60, n, replace=False))
    score = (np.round(rng.random((B, H, S)) * 4) / 4).astype(np.float32)
    ssq = (score * np.round(rng.random((B, H, S)) * 2) / 2).astype(np.float32)
    counter = rng.integers(1, 20, size=(B, H, S)).astype(np.float32)
    return pos, score, ssq, counter


@pytest.mark.parametrize("phase", PHASES)
@pytest.mark.parametrize("policy", EVICTING)
def test_select_evictions_matches_jax(policy, phase):
    pos, score, ssq, counter = _sidecars(len(policy) + len(phase))
    B = pos.shape[0]
    next_pos = np.array([60, 60], np.int32)
    prompt_len = np.array([10, 25], np.int32)
    rand_rank = np.array([3, 17], np.int32)
    for k in (1, 5, 12):                      # JAX: top_k, top_k, stable sort
        for fk in (20, 70):                   # 70: beyond every row's candidates
            kw = dict(policy=policy, phase=phase, k=k, sink_length=4, recent_window=6,
                      feasible_k=fk, protect_prompt=phase == tpol.PHASE_DECODE)
            jc = LayerCache(None, None, *map(jnp.asarray, (pos, score, ssq, counter)))
            ref = jax.jit(lambda c, a, b_, r: jpol.select_evictions(
                c, jpol.PolicySpec(**kw), a, b_, r))(
                jc, *map(jnp.asarray, (next_pos, prompt_len, rand_rank)))
            tc = KVCache(None, None, *map(t, (pos, score, ssq, counter)))
            out = tpol.select_evictions(tc, tpol.PolicySpec(**kw), *map(t, (
                next_pos, prompt_len, rand_rank)))
            assert out.shape == (B, 3, k) and out.dtype == torch.int32
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref), err_msg=str(kw))


def _layer(seed, B=2, H=3, S=64, D=16, quant=False):
    pos, score, ssq, counter = _sidecars(seed, B, H, S)
    rng = np.random.default_rng(seed + 100)
    k = rng.normal(size=(B, H, S, D)).astype(np.float32)
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)
    if not quant:
        return (k, v, pos, score, ssq, counter), ()
    kq, ks = jquantize(jnp.asarray(k))
    vq, vs = jquantize(jnp.asarray(v))
    return (np.asarray(kq), np.asarray(vq), pos, score, ssq, counter), (np.asarray(ks),
                                                                          np.asarray(vs))


@pytest.mark.parametrize("policy", ["roco", "h2o_head", "tova", "recency", "random", "full"])
def test_update_scores_match_jax(policy):
    arrs, _ = _layer(3)
    B, H, S = arrs[2].shape
    rng = np.random.default_rng(4)
    probs = (rng.random((B, H, 5, S)) / S).astype(np.float32)
    gate = np.array([True, False])
    stats = (probs.sum(2), (probs * probs).sum(2), probs[:, :, -1])
    for phase in (tpol.PHASE_ENCODE, tpol.PHASE_DECODE):
        for boot in (False, True):
            kw = dict(policy=policy, phase=phase, k=8, sink_length=4, recent_window=6)
            jc = LayerCache(*map(jnp.asarray, arrs))
            ref = jpol.update_scores(jc, jnp.asarray(probs), jpol.PolicySpec(**kw),
                                     jnp.asarray(gate), bootstrap=boot)
            tc = KVCache(*map(t, arrs))
            tpol.update_scores(tc, t(probs), tpol.PolicySpec(**kw), t(gate), bootstrap=boot)
            assert_sidecars(tc, ref, f"update_scores {kw} boot={boot}")
            ref = jpol.update_scores_reduced(jc, *map(jnp.asarray, stats),
                                             jpol.PolicySpec(**kw), jnp.asarray(gate),
                                             bootstrap=boot)
            tc = KVCache(*map(t, arrs))
            tpol.update_scores_reduced(tc, *map(t, stats), tpol.PolicySpec(**kw), t(gate),
                                       bootstrap=boot)
            assert_sidecars(tc, ref, f"update_scores_reduced {kw} boot={boot}")


@pytest.mark.parametrize("policy", EVICTING)
def test_evict_layer_and_evict_cache_match_jax(policy):
    arrs, _ = _layer(5)
    gate = np.array([True, False])
    next_pos = np.array([60, 60], np.int32)
    prompt_len = np.zeros(2, np.int32)
    rand_rank = np.array([2, 9], np.int32)
    kw = dict(policy=policy, phase=tpol.PHASE_ENCODE, k=8, sink_length=4, recent_window=6,
              feasible_k=20)
    jc = LayerCache(*map(jnp.asarray, arrs))
    ref, jids = jax.jit(lambda c, *a: jpol.evict_layer(c, jpol.PolicySpec(**kw), *a))(
        jc, *map(jnp.asarray, (next_pos, prompt_len, rand_rank, gate)))
    tc = KVCache(*map(t, arrs))
    ids = tpol.evict_layer(tc, tpol.PolicySpec(**kw),
                           *map(t, (next_pos, prompt_len, rand_rank, gate)))
    assert_sidecars(tc, ref, "evict_layer")
    np.testing.assert_array_equal(ids.numpy()[0], np.asarray(jids)[0])   # the gated row
    assert ((tc.pos >= 0).sum(-1)[0] == (t(arrs[2]) >= 0).sum(-1)[0] - 8).all()

    # evict_cache over stacked layers, encdec-decode phase (k = 1, no prompt
    # protection) and decode phase
    stacked = [np.stack([a, b]) for a, b in zip(arrs, _layer(6)[0])]
    for phase in (tpol.PHASE_ENCDEC_DECODE, tpol.PHASE_DECODE):
        kw = dict(policy=policy, phase=phase, k=1, sink_length=4, recent_window=6,
                  feasible_k=20, protect_prompt=phase == tpol.PHASE_DECODE)
        jc = jgen.KVCache(*map(jnp.asarray, stacked), None, None)
        pl = np.array([12, 12], np.int32)
        ref = jax.jit(lambda c, *a: jpol.evict_cache(c, jpol.PolicySpec(**kw), *a))(
            jc, *map(jnp.asarray, (next_pos, pl, rand_rank, gate)))
        tc = KVCache(*map(t, stacked))
        tpol.evict_cache(tc, tpol.PolicySpec(**kw), *map(t, (next_pos, pl, rand_rank, gate)))
        assert_sidecars(tc, ref, f"evict_cache {phase}")


# --------------------------------------------------------------------------
# cache writes and K6
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_write_tokens_at_matches_jax(quant):
    arrs, scales = _layer(7, quant=quant)
    B, H, S, D = arrs[0].shape
    C = 6
    rng = np.random.default_rng(8)
    new_k = rng.normal(size=(B, H, C, D)).astype(np.float32)
    new_v = rng.normal(size=(B, H, C, D)).astype(np.float32)
    new_pos = (70 + np.arange(C, dtype=np.int32))[None].repeat(B, 0)
    cinit = np.array([[0, -1, -2, -3, -4, -5], [2, 1, 0, -0.0, -1, 3]], np.float32)
    ids = np.stack([rng.choice(S, C, replace=False) for _ in range(B * H)]).reshape(
        B, H, C).astype(np.int32)
    args = (new_k, new_v, new_pos, cinit, ids)
    if not quant:
        scales = (np.zeros((B, H, 1), np.float32),) * 2
    jc = LayerCache(*map(jnp.asarray, arrs + tuple(scales)))
    tc = cache_from_jax(jc)
    write_tokens_at(tc, *map(t, args))
    for ref in (jwrite_at(jc, *map(jnp.asarray, args)),
                jwrite_dense(jc, *map(jnp.asarray, args))):
        for name in ("k", "v", "pos", "score", "score_sq", "counter") + (
                ("k_scale", "v_scale") if quant else ()):
            np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                          np.asarray(getattr(ref, name)), err_msg=name)


K6_CASES = {
    # name: (quant, need_scores, flash, rep, Hkv, window, negative counters)
    "int8-scores-gqa": (True, True, False, 2, 2, None, False),
    "f32-scores-mha-window": (False, True, False, 1, 2, 9, False),
    "int8-noscores": (True, False, False, 1, 2, None, False),
    "int8-flash-scores-window": (True, True, True, 2, 1, 40, False),
    "f32-flash-noscores-gqa": (False, False, True, 4, 1, None, False),
    "f32-flash-scores": (False, True, True, 1, 2, None, False),
    "int8-negative-counters": (True, True, False, 2, 2, None, True),
    "f32-negative-counters-window": (False, True, False, 1, 2, 20, True),
}


@pytest.mark.parametrize("case", list(K6_CASES))
def test_k6_plain_matches_pallas(case, monkeypatch):
    """Counters >= 0: against Pallas fused_chunk_write_attend (interpret
    mode, 1-pass or forced flash). Negative counters: against JAX's
    write_tokens_dense + fused_chunk_attend, because the Pallas kernel
    clamps them to 0 (its max-based pick) where the XLA path and the port
    write them exactly."""
    quant, scores, flash, rep, Hkv, window, negative = K6_CASES[case]
    B, C, S, D = 2, 8, 384, 64
    rng = np.random.default_rng(len(case))
    kf = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    vf = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    if quant:
        k, ks = (np.asarray(a) for a in jquantize(jnp.asarray(kf)))
        v, vs = (np.asarray(a) for a in jquantize(jnp.asarray(vf)))
        scales = (ks, vs)
    else:
        k, v, scales = kf, vf, ()
    pos = rng.integers(0, 90, size=(B, Hkv, S)).astype(np.int32)
    pos[:, :, ::3] = -1
    side = [np.abs(rng.normal(size=(B, Hkv, S))).astype(np.float32) for _ in range(3)]
    q = rng.normal(size=(B, Hkv * rep, C, D)).astype(np.float32)
    k_c = rng.normal(size=(B, Hkv, C, D)).astype(np.float32)
    v_c = rng.normal(size=(B, Hkv, C, D)).astype(np.float32)
    q_pos = np.broadcast_to(90 + np.arange(C, dtype=np.int32), (B, C)).copy()
    cinit = (-(np.arange(B * C) % 5) if negative else rng.integers(0, 9, B * C)).astype(
        np.float32).reshape(B, C)
    ids = np.stack([np.sort(rng.choice(S, C, replace=False)) for _ in range(B * Hkv)]
                   ).reshape(B, Hkv, C).astype(np.int32)
    cache = (k, v, pos, *side) + scales
    names = ("k", "v", "pos", "score", "score_sq", "counter", "k_scale", "v_scale")

    if negative:
        jscales = scales or (np.zeros((B, Hkv, 1), np.float32),) * 2
        jc = jwrite_dense(LayerCache(*map(jnp.asarray, cache[:6] + tuple(jscales))),
                          *map(jnp.asarray, (k_c, v_c, q_pos, cinit, ids)))
        ref = jca.fused_chunk_attend(
            jnp.asarray(q), jc.k, jc.v, jc.pos, jnp.asarray(q_pos),
            k_scale=jc.k_scale if quant else None, v_scale=jc.v_scale if quant else None,
            need_scores=scores, sliding_window=window, interpret=True)
        ref_cache = [getattr(jc, n) for n in names[:len(cache)]]
    else:
        if flash:
            monkeypatch.setattr(jca, "wa_fits", lambda *a: False)
        fn = functools.partial(jca.fused_chunk_write_attend.__wrapped__, interpret=True,
                               need_scores=scores, sliding_window=window)
        sc = dict(zip(("k_scale", "v_scale"), map(jnp.asarray, scales)))
        res = jax.jit(fn)(*map(jnp.asarray, (q, k_c, v_c, ids, q_pos, cinit) + cache[:6]),
                          **sc)
        ref, ref_cache = res[:4], res[4]
    tcache = [t(a) for a in cache]
    out = tk6(*map(t, (q, k_c, v_c, ids, q_pos, cinit)), *tcache, need_scores=scores,
              sliding_window=window)
    for name, a, b in zip(names, tcache, ref_cache):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if negative:
        written = np.take_along_axis(tcache[5].numpy(), ids, -1)
        assert (written < 0).any() and (written == cinit[:, None, :]).all()
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)
    if not scores:
        assert out[1:] == (None, None, None)
        return
    for name, a, b, atol in (("ssum", out[1], ref[1], 1e-5), ("ssq", out[2], ref[2], 1e-6),
                             ("last", out[3], ref[3], 1e-6)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol, err_msg=name)


# --------------------------------------------------------------------------
# the model: bootstrap prefill, strided encode, encdec decode
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ModelConfig(**CFG), tparams


def assert_kv(tc: KVCache, jc, what):
    if tc.quantized:
        for name in ("k", "v"):
            diff = np.abs(getattr(tc, name).numpy().astype(np.int32)
                          - np.asarray(getattr(jc, name)).astype(np.int32))
            assert diff.max() <= 1, f"{name}, {what}: int8 values differ by {diff.max()}"
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)), rtol=1e-5, atol=0,
                                       err_msg=f"{name}, {what}")
    else:
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-5, atol=1e-5)


def _encode_statics(jcfg, tcfg, policy, quant, keep, length=90, stride=8):
    budget = int(length * 0.5) + stride
    idx, r_idx = jgen.stride_align(length, budget, stride)
    kw = dict(policy=policy, length=length, budget=budget, idx=idx, r_idx=r_idx,
              stride=stride, temp_length=4, recent_window=int(budget * 0.1),
              recent_window_dec=int(budget * 0.3), keep_attention=keep, kv_quant=quant)
    return (jgen.EngineStatics(cfg=jcfg, mode="encoding", **kw),
            tgen.EngineStatics(cfg=tcfg, mode="encoding", **kw))


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("policy", ["roco", "h2o_head", "tova", "recency", "random", "full"])
def test_strided_encode_layer_major_matches_jax(models, policy, quant):
    """From the same prefix-prefilled cache (the JAX engine's, with the
    keep_attention bootstrap for h2o_head), the same tokens and the same
    stacked StepCtx (rand_rank injected), chunk by chunk."""
    jcfg, jparams, tcfg, tparams = models
    keep = policy == "h2o_head"
    jst, tst = _encode_statics(jcfg, tcfg, policy, quant, keep)
    B, stride = 2, jst.stride
    ids = np.random.default_rng(len(policy)).integers(1, 120, size=(B, jst.length)).astype(
        np.int32)
    plen = np.full((B,), jst.r_idx, np.int32)
    S = jst.idx + stride + 8
    spec_j, spec_t = jst.encode_spec(), tst.encode_spec()
    boot_j = spec_j if keep else None
    jcache, _ = jax.jit(lambda c: jgen._prefill(jst, jparams, c, jnp.asarray(ids[:, :jst.r_idx]),
                                                jnp.asarray(plen), boot_j, "encode"))(
        jgen._engine_cache(jst, B, S))
    # the port's own bootstrap prefill from the empty cache gives the same
    tc0 = tgen._engine_cache(tst, B, S, torch.float32, torch.device("cpu"))
    tgen._prefill(tst, tparams, tc0, t(ids[:, :jst.r_idx]), t(plen),
                  spec_t if keep else None, "encode")
    assert_sidecars(tc0, jcache, "prefix prefill", 1e-6)
    assert_kv(tc0, jcache, "prefix prefill")

    # the engine's static schedule (generate.py _strided_encode_layer_major)
    n = (jst.length - jst.r_idx) // stride
    kv, trig, kv_before = jst.r_idx, [], []
    evicting = policy != "full"
    for _ in range(n):
        kv_before.append(kv)
        trig.append(kv + stride > jst.idx)
        kv = kv + stride - (stride if (trig[-1] and evicting) else 0)
    starts = jst.r_idx + stride * np.arange(n)
    pos = (starts[:, None] + np.arange(stride)[None, :]).astype(np.int32)
    cinit = np.asarray(jgen._encode_counter_init(jnp.asarray(pos), jst.idx, stride, keep))
    trig_b = np.broadcast_to(np.array(trig)[:, None], (n, B))
    ctx_np = jllama.StepCtx(
        q_pos=np.broadcast_to(pos[:, None], (n, B, stride)),
        token_valid=np.ones((n, B, stride), bool),
        counter_init=np.broadcast_to(cinit[:, None], (n, B, stride)).astype(np.float32),
        next_pos=np.broadcast_to((starts + stride).astype(np.int32)[:, None], (n, B)),
        prompt_len=np.zeros((n, B), np.int32),
        evict_gate=trig_b & evicting,
        update_gate=trig_b | keep,
        rand_rank=np.random.default_rng(9).integers(0, jst.idx, size=(n, B)).astype(np.int32),
    )
    tokens = ids[:, jst.r_idx: jst.r_idx + n * stride]
    write_start = np.broadcast_to(np.array(kv_before, np.int32)[:, None], (n, B))
    jh, jcache = jax.jit(lambda c, x, cx, ws: jllama.strided_encode_layer_major(
        jparams, jcfg, c, x, cx, spec_j, ws))(
        jcache, jnp.asarray(tokens), jllama.StepCtx(*map(jnp.asarray, ctx_np)),
        jnp.asarray(write_start))
    th = tllama.strided_encode_layer_major(tparams, tcfg, tc0, t(tokens),
                                           stepctx_from_jax(ctx_np), spec_t, kv_before,
                                           [x and evicting for x in trig])
    assert_sidecars(tc0, jcache, "strided encode", 1e-5 if quant else 1e-6)
    assert_kv(tc0, jcache, "strided encode")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    if evicting:
        assert ((tc0.pos >= 0).sum(-1) == jst.idx).all()


@pytest.mark.parametrize("policy", ["roco", "tova", "recency", "random"])
def test_encdec_decode_lockstep(models, policy):
    """The encoding_decoding decode phase: K2 with the policy's score update
    and no fold, then policies.evict_cache, against the JAX package's
    forward(fold_evict=False) + evict_cache, one eviction every step: no
    prompt protection, recency / random from sink_length, tova a plain
    argmin, feasible_k clamped to idx."""
    jcfg, jparams, tcfg, tparams = models
    B, P, b, stride = 2, 40, 24, 8
    idx, r_idx = jgen.stride_align_encdec(P, b, stride)
    kw = dict(policy=policy, length=P, budget=b, idx=idx, r_idx=r_idx, stride=stride,
              recent_window=int(b * 0.1), recent_window_dec=int(b * 0.3),
              keep_attention=True)
    jst = jgen.EngineStatics(cfg=jcfg, mode="encoding_decoding", **kw)
    tst = tgen.EngineStatics(cfg=tcfg, mode="encoding_decoding", **kw)
    spec_j, spec_t = jst.encdec_decode_spec(), tst.encdec_decode_spec()
    assert spec_t == tpol.PolicySpec(**vars(spec_j))
    assert not tllama.decode_evict_folded(spec_t)
    rng = np.random.default_rng(len(policy))
    ids = rng.integers(1, 120, size=(B, P)).astype(np.int32)
    plen = np.full((B,), P, np.int32)
    # start from the bootstrapped prompt (keep_attention): roco's variance
    # is then real, not the rounding noise of p^2 - p^2 after one step
    jcache, _ = jax.jit(lambda c: jgen._prefill(jst, jparams, c, jnp.asarray(ids),
                                                jnp.asarray(plen), jst.encode_spec(),
                                                "encode"))(jgen._engine_cache(jst, B, P + 8))
    tcache = cache_from_jax(jcache)
    fwd = jax.jit(lambda c, tok, ctx: jllama.forward(jparams, jcfg, c, tok, ctx, spec_j,
                                                     fold_evict=False))
    evict = jax.jit(lambda c, ctx: jpol.evict_cache(c, spec_j, ctx.next_pos, ctx.prompt_len,
                                                    ctx.rand_rank, ctx.evict_gate))
    for g in range(10):
        tok_pos = np.full((B,), P + g, np.int32)
        ctx_np = dict(q_pos=tok_pos[:, None], token_valid=np.ones((B, 1), bool),
                      counter_init=np.zeros((B, 1), np.float32), next_pos=tok_pos + 1,
                      prompt_len=plen, evict_gate=np.ones((B,), bool),
                      update_gate=np.ones((B,), bool),
                      rand_rank=rng.integers(0, P - 4, size=B).astype(np.int32))
        tok = rng.integers(1, 120, size=(B, 1)).astype(np.int32)
        jctx = jllama.StepCtx(**{k: jnp.asarray(v) for k, v in ctx_np.items()})
        _, jcache = fwd(jcache, jnp.asarray(tok), jctx)
        jcache = evict(jcache, jctx)
        tctx = stepctx_from_jax(jllama.StepCtx(**ctx_np))
        tllama._decode_forward(tparams, tcfg, tcache, t(tok), tctx, spec_t)
        tpol.evict_cache(tcache, spec_t, tctx.next_pos, tctx.prompt_len, tctx.rand_rank,
                         tctx.evict_gate)
        assert_sidecars(tcache, jcache, f"step {g}")
    assert ((tcache.pos >= 0).sum(-1) == P).all()
