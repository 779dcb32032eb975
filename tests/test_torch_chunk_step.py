"""The strided encode's one-call chunk step K7 of the port against the JAX
package's, on the CPU, from the same numpy inputs:

  plain K7                 against the Pallas fused_chunk_step in interpret
                           mode (counter_init >= 0, where the Pallas pick is
                           exact): roco and h2o_head x gates x f32 / int8,
                           GQA rep 2 with a window, B=2 with mixed gates,
                           h2o_head with fewer than C candidates; out within
                           2e-6 + 1e-5 relative, score / score_sq 1e-6,
                           every other array and the next mask exact
                           against the JAX XLA composition (write_tokens_dense,
                           attend, update_scores, evict_layer) with the
                           engine's negative initial counters: every
                           discrete array exact
  the chunk / step gates   the branch the port's strided encode takes
                           equals the JAX package's (llama.py:150-169,
                           :441-452 there) over modes, dtypes, policies,
                           slot counts, chunk widths and the step switch
  the strided encode       K7 against the port without it (every array
                           exact), against the JAX default path (pos and
                           counters exact, scores 1e-6) and, for h2o_head,
                           against the JAX package's own K7
  generate()               encoding and ppl with the step kernel on against
                           it off (tokens / ppl and the final cache exact)
                           and against the JAX package's default path
  chunk-kernel modes       'on' (a float cache through K5 / K6) and 'off'
                           (an int8 cache through the dequantized plain
                           attend) against the JAX package's same modes
"""
import contextlib
import dataclasses
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easykv_tpu
import easykv_tpu_torch
from easykv_tpu import flags as jflags
from easykv_tpu import policies as jpol
from easykv_tpu.cache import LayerCache
from easykv_tpu.cache import quantize_kv as jquantize
from easykv_tpu.cache import write_tokens_dense as jwrite_dense
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops.attention import attend as jattend
from easykv_tpu.ops.pallas import chunk_attention as jca

from easykv_tpu_torch import flags as tflags
from easykv_tpu_torch.cache import KVCache, init_cache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.cuda import chunk_attention as tca

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)
LENGTH, STRIDE = 90, 8
CACHE = ("k", "v", "pos", "score", "score_sq", "counter", "k_scale", "v_scale")


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(autouse=True)
def _switches():
    """Every test starts and ends with both packages' switches at their
    defaults."""
    yield
    for fn in (tflags.use_step_kernel, tflags.use_chunk_kernel, jflags.use_pallas,
               jflags.use_chunk_kernel):
        fn(None)


# --------------------------------------------------------------------------
# plain K7 against the Pallas kernel and the XLA composition
# --------------------------------------------------------------------------

def _k7_inputs(seed, policy, gates, quant, B=2, Hkv=3, rep=2, C=8, S=128, D=64,
               negative=False, few=False):
    """The JAX package's test inputs (tests/test_chunk_kernel.py:320-423): a
    mostly full cache (positions 0..S-1, holes at 17 and 63), per-head
    sorted write slots, the chunk at positions S..S+C-1. gates: per-row
    (update, evict) pairs. negative: the engine's -((pos - idx) % C)
    counters; few: a recent window that leaves fewer than C h2o_head
    candidates. Returns a dict of numpy arrays and the statics."""
    rng = np.random.default_rng(seed)
    kf = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    vf = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    if quant:
        (k, ks), (v, vs) = (tuple(map(np.asarray, jquantize(jnp.asarray(x)))) for x in (kf, vf))
    else:
        k, v, ks, vs = kf, vf, None, None
    pos = np.tile(np.arange(S, dtype=np.int32), (B, Hkv, 1))
    pos[:, :, 17] = -1
    pos[:, :, 63] = -1
    f3 = lambda: np.abs(rng.normal(size=(B, Hkv, S))).astype(np.float32)  # noqa: E731
    cnt = (1.0 + np.abs(rng.normal(size=(B, Hkv, S)))).astype(np.float32)
    score, ssq = f3(), f3()
    q = rng.normal(size=(B, Hkv * rep, C, D)).astype(np.float32)
    k_c = rng.normal(size=(B, Hkv, C, D)).astype(np.float32)
    v_c = rng.normal(size=(B, Hkv, C, D)).astype(np.float32)
    q_pos = np.broadcast_to(S + np.arange(C, dtype=np.int32)[None], (B, C)).copy()
    if negative:
        cinit = -((q_pos - (S + 3)) % C).astype(np.float32)
    else:
        cinit = np.abs(rng.normal(size=(B, C))).astype(np.float32)
    ids = np.stack([np.sort(rng.choice(S, size=C, replace=False))
                    for _ in range(B * Hkv)]).reshape(B, Hkv, C).astype(np.int32)
    wm = np.zeros((B, Hkv, S), np.int32)
    np.put_along_axis(wm, ids, 1, axis=-1)
    g = np.array(gates, bool).reshape(-1, 2)
    g = np.broadcast_to(g, (B, 2))
    statics = dict(policy=policy, feasible_k=min(S - 1, 40), sink=4,
                   recent_window=S + C - 10 if few else 10)
    return dict(q=q, k_c=k_c, v_c=v_c, wm=wm, ids=ids, q_pos=q_pos, cinit=cinit,
                ug=g[:, 0].copy(), eg=g[:, 1].copy(), next_pos=(q_pos[:, -1] + 1).copy(),
                nstart=np.full((B,), 3, np.int32), k=k, v=v, pos=pos, score=score, ssq=ssq,
                cnt=cnt, ks=ks, vs=vs), statics


def _port_k7(a, statics, window=None):
    scales = () if a["ks"] is None else (t(a["ks"]), t(a["vs"]))
    out, arrs, wm = tca.fused_chunk_step(
        t(a["q"]), t(a["k_c"]), t(a["v_c"]), t(a["wm"]), t(a["q_pos"]), t(a["cinit"]),
        t(a["ug"]), t(a["eg"]), t(a["next_pos"]), t(a["nstart"]), t(a["k"]), t(a["v"]),
        t(a["pos"]), t(a["score"]), t(a["ssq"]), t(a["cnt"]), *scales,
        sliding_window=window, **statics)
    return out.numpy(), [x.numpy() for x in arrs], wm.numpy()


def _pallas_k7(a, statics, window=None):
    j = {key: None if x is None else jnp.asarray(x) for key, x in a.items()}
    out, arrs, wm = jca.fused_chunk_step(
        j["q"], j["k_c"], j["v_c"], j["wm"], j["q_pos"], j["cinit"], j["ug"], j["eg"],
        j["next_pos"], j["nstart"], j["k"], j["v"], j["pos"], j["score"], j["ssq"], j["cnt"],
        k_scale=j["ks"], v_scale=j["vs"], sliding_window=window, interpret=True, **statics)
    return np.asarray(out), [np.asarray(x) for x in arrs], np.asarray(wm)


GATES = [(True, True), (True, False), (False, True)]
PALLAS_CASES = (
    [(f"{policy}-{'int8' if quant else 'f32'}-gates{int(g[0])}{int(g[1])}",
      dict(seed=41, policy=policy, gates=g, quant=quant), None)
     for policy in jca.STEP_POLICIES for quant in (False, True) for g in GATES]
    + [("roco-f32-gqa2-window", dict(seed=42, policy="roco", gates=(True, True), quant=False,
                                     Hkv=2, rep=2), 40),
       ("roco-int8-B2-mixed-gates", dict(seed=43, policy="roco", quant=True,
                                         gates=[(True, False), (False, True)]), None),
       ("h2o-f32-fewer-candidates", dict(seed=44, policy="h2o_head", gates=(True, True),
                                         quant=False, few=True), None)])


@pytest.fixture(scope="module")
def pallas_k7():
    """The Pallas K7 of every case, computed once."""
    res = {}
    for name, kw, window in PALLAS_CASES:
        a, statics = _k7_inputs(**kw)
        res[name] = (a, statics, window, _pallas_k7(a, statics, window))
    return res


@pytest.mark.parametrize("name", [c[0] for c in PALLAS_CASES])
def test_k7_plain_matches_pallas(pallas_k7, name):
    a, statics, window, (out_j, arrs_j, wm_j) = pallas_k7[name]
    out_t, arrs_t, wm_t = _port_k7(a, statics, window)
    np.testing.assert_allclose(out_t, out_j, atol=2e-6, rtol=1e-5)
    for key, x, y in zip(CACHE, arrs_t, arrs_j):
        if key in ("score", "score_sq"):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(x, y, err_msg=key)
    np.testing.assert_array_equal(wm_t, wm_j)
    eg = a["eg"]
    assert (wm_t.sum(-1) == 8).all()
    victims = wm_t.astype(bool) & eg[:, None, None]        # the gated rows' next slots
    assert (arrs_t[2][victims] == -1).all() and victims.sum() == 8 * wm_t.shape[1] * eg.sum()
    if name.startswith("h2o-f32-fewer"):
        cand = (arrs_t[2] >= 4) & (arrs_t[2] < a["next_pos"][:, None, None] - statics[
            "recent_window"])
        assert (cand.sum(-1) == 0).all()     # every candidate went, and the fill took more


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("policy", list(jca.STEP_POLICIES))
def test_k7_plain_matches_xla_composition_negative_counters(policy, quant):
    """write_tokens_dense + attend + update_scores + evict_layer of the JAX
    package, with the engine's negative initial counters (which the Pallas
    K7 clamps to 0 and the XLA path writes exactly)."""
    a, statics = _k7_inputs(45, policy, [(True, True), (False, False)], quant, negative=True)
    out_t, arrs_t, wm_t = _port_k7(a, statics)
    B, C = a["q_pos"].shape
    spec = jpol.PolicySpec(policy=policy, phase=jpol.PHASE_ENCODE, k=C,
                           sink_length=statics["sink"], recent_window=statics["recent_window"],
                           feasible_k=statics["feasible_k"])
    zeros = jnp.zeros((B, 1), jnp.float32)
    cl = LayerCache(*(jnp.asarray(a[key]) for key in ("k", "v", "pos", "score", "ssq", "cnt")),
                    *((jnp.asarray(a["ks"]), jnp.asarray(a["vs"])) if quant else (zeros, zeros)))
    cl = jwrite_dense(cl, jnp.asarray(a["k_c"]), jnp.asarray(a["v_c"]), jnp.asarray(a["q_pos"]),
                      jnp.asarray(a["cinit"]), jnp.asarray(a["ids"]))
    kd = cl.k.astype(jnp.float32) * cl.k_scale[..., None] if quant else cl.k
    vd = cl.v.astype(jnp.float32) * cl.v_scale[..., None] if quant else cl.v
    out_j, probs = jattend(jnp.asarray(a["q"]), kd, vd, cl.pos, jnp.asarray(a["q_pos"]),
                           scale=a["q"].shape[-1] ** -0.5)
    cl = jpol.update_scores(cl, probs, spec, jnp.asarray(a["ug"]))
    cl, eids = jpol.evict_layer(cl, spec, jnp.asarray(a["next_pos"]), jnp.zeros((B,), jnp.int32),
                                jnp.zeros((B,), jnp.int32), jnp.asarray(a["eg"]))
    np.testing.assert_allclose(out_t, np.asarray(out_j), atol=2e-6, rtol=1e-5)
    assert (arrs_t[5][1][a["wm"][1] != 0] < 0).any()      # negative counters written
    for key, x in zip(CACHE, arrs_t):
        y = np.asarray(getattr(cl, key))
        if key in ("score", "score_sq"):
            np.testing.assert_allclose(x, y, atol=1e-6, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(x, y, err_msg=key)
    contig = a["nstart"][:, None, None] + np.arange(C)
    nxt = np.where(a["eg"][:, None, None], np.sort(np.asarray(eids), -1),
                   np.broadcast_to(contig, eids.shape))
    want = np.zeros_like(wm_t)
    np.put_along_axis(want, nxt, 1, axis=-1)
    np.testing.assert_array_equal(wm_t, want)


def test_k7_plain_mask_with_fewer_rows_drops_the_rest():
    """A mask with fewer than C set slots takes the first rows in slot order
    and drops the others, as the Pallas kernel does."""
    a, statics = _k7_inputs(46, "h2o_head", (True, False), False)
    a["wm"][..., :] = 0
    a["wm"][..., [5, 90, 100]] = 1
    before = a["pos"].copy()
    out_t, arrs_t, _ = _port_k7(a, statics)
    _, arrs_j, _ = _pallas_k7(a, statics)
    for key, x, y in zip(CACHE, arrs_t, arrs_j):
        if key not in ("score", "score_sq"):
            np.testing.assert_array_equal(x, y, err_msg=key)
    changed = np.argwhere((arrs_t[2] != before).any(axis=(0, 1)))[:, 0]
    assert list(changed) == [5, 90, 100]
    np.testing.assert_array_equal(arrs_t[2][..., [5, 90, 100]],
                                  np.broadcast_to(a["q_pos"][:, None, :3], (2, 3, 3)))


# --------------------------------------------------------------------------
# the gates: the branch each package's strided encode takes
# --------------------------------------------------------------------------

class Chose(Exception):
    pass


def _raise(name):
    def f(*_, **__):
        raise Chose(name)
    return f


def _jax_branch(cfg, spec, quant, S, C, n=2, B=1):
    params = jllama.init_params(cfg, jax.random.PRNGKey(0))
    from easykv_tpu.cache import init_cache
    cache = init_cache(cfg.num_hidden_layers, B, cfg.num_key_value_heads, S, cfg.head_dim,
                       jnp.float32, quantized=quant)
    ctxs = jllama.StepCtx(
        q_pos=jnp.zeros((n, B, C), jnp.int32), token_valid=jnp.ones((n, B, C), bool),
        counter_init=jnp.zeros((n, B, C), jnp.float32), next_pos=jnp.zeros((n, B), jnp.int32),
        prompt_len=jnp.zeros((n, B), jnp.int32), evict_gate=jnp.ones((n, B), bool),
        update_gate=jnp.ones((n, B), bool), rand_rank=jnp.zeros((n, B), jnp.int32))
    patches = [mock.patch.object(jllama, "_chunk_step", _raise("step")),
               mock.patch.object(jllama, "_chunk_write_attend", _raise("chunk kernel")),
               mock.patch.object(jllama, "_chunk_attend", _raise("chunk kernel")),
               mock.patch.object(jllama, "attend", _raise("plain"))]
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        try:
            jllama.strided_encode_layer_major(params, cfg, cache, jnp.ones((B, n * C), jnp.int32),
                                              ctxs, spec, jnp.zeros((n, B), jnp.int32))
        except Chose as e:
            return str(e)
    raise AssertionError("no branch taken")


def _port_branch(cfg, spec, quant, S, C, n=2, B=1):
    params = tllama.init_params(cfg, 0, device="cpu")
    cache = init_cache(cfg.num_hidden_layers, B, cfg.num_key_value_heads, S, cfg.head_dim,
                            torch.float32, torch.device("cpu"), quantized=quant)
    ctxs = tllama.StepCtx(
        q_pos=torch.zeros((n, B, C), dtype=torch.int32),
        token_valid=torch.ones((n, B, C), dtype=torch.bool),
        counter_init=torch.zeros((n, B, C)), next_pos=torch.zeros((n, B), dtype=torch.int32),
        prompt_len=torch.zeros((n, B), dtype=torch.int32),
        evict_gate=torch.ones((n, B), dtype=torch.bool),
        update_gate=torch.ones((n, B), dtype=torch.bool),
        rand_rank=torch.zeros((n, B), dtype=torch.int32))
    with mock.patch.object(tllama, "fused_chunk_step", _raise("step")), \
            mock.patch.object(tllama, "fused_chunk_write_attend", _raise("chunk kernel")), \
            mock.patch.object(tllama, "_plain_attend", _raise("plain")):
        try:
            tllama.strided_encode_layer_major(params, cfg, cache,
                                              torch.ones((B, n * C), dtype=torch.int32), ctxs,
                                              spec, [0] * n, [True] * n)
        except Chose as e:
            return str(e)
    raise AssertionError("no branch taken")


GATE_CASES = [  # chunk mode, step, quant, policy, S, C, spec.k
    ("auto", "1", True, "roco", 128, 8, 8), ("auto", "1", False, "roco", 128, 8, 8),
    ("auto", "0", True, "roco", 128, 8, 8), ("auto", "1", True, "h2o_head", 128, 8, 8),
    ("auto", "1", True, "tova", 128, 8, 8), ("auto", "1", True, "full", 128, 8, 8),
    ("on", "1", False, "roco", 128, 8, 8), ("on", "1", False, "h2o_head", 128, 8, 8),
    ("on", "0", False, "h2o_head", 128, 8, 8), ("on", "1", False, "recency", 128, 8, 8),
    ("off", "1", True, "roco", 128, 8, 8), ("off", "1", False, "roco", 128, 8, 8),
    ("on", "1", True, "roco", 192, 8, 8), ("on", "1", True, "roco", 128, 8, 4),
    ("on", "1", False, "roco", 7168, 96, 96), ("on", "1", True, "roco", 7168, 96, 96),
    ("auto", "1", True, "h2o_head", 1280, 96, 96),
]


@pytest.mark.parametrize("mode,step,quant,policy,S,C,k", GATE_CASES)
def test_step_and_chunk_gates_match_jax(mode, step, quant, policy, S, C, k, monkeypatch):
    """The first chunk's branch: the JAX package under use_pallas(True) (its
    chunk-kernel mode is 'off' without Pallas) against the port, with
    EASYKV_TPU_CHUNK_KERNEL and EASYKV_TPU_STEP_KERNEL set for both. At
    Dh=16 the f32 cache misses wa_fits at S=7168, C=96 and the int8 one
    fits."""
    monkeypatch.setenv("EASYKV_TPU_CHUNK_KERNEL", mode)
    monkeypatch.setenv("EASYKV_TPU_STEP_KERNEL", step)
    jflags.use_pallas(True)
    spec = jpol.PolicySpec(policy=policy, phase=jpol.PHASE_ENCODE, k=k, sink_length=4,
                           recent_window=4, feasible_k=8)
    tspec = tllama.PolicySpec(policy, "encode", k, 4, 4, feasible_k=8)
    cfg = dict(CFG, max_position_embeddings=S + 256)
    want = _jax_branch(JModelConfig(**cfg), spec, quant, S, C)
    got = _port_branch(ModelConfig(**cfg), tspec, quant, S, C)
    assert got == want
    assert tllama.use_step_kernel(ModelConfig(**cfg), tspec, torch.int8 if quant else torch.float32,
                                  S, C) == (want == "step")


# --------------------------------------------------------------------------
# the strided encode and the prefill, module level
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(2))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ModelConfig(**CFG), tparams


def _cache_from_jax(cache) -> KVCache:
    leaves = [np.array(x) for x in tuple(cache)]
    quant = leaves[0].dtype == np.int8
    return KVCache(*map(torch.from_numpy, leaves[:6]),
                   *(map(torch.from_numpy, leaves[6:8]) if quant else (None, None)))


def _clone(c: KVCache) -> KVCache:
    return KVCache(*(None if x is None else x.clone() for x in (
        c.k, c.v, c.pos, c.score, c.score_sq, c.counter, c.k_scale, c.v_scale)))


def _encode_setup(weights, policy, quant, B):
    """The engine's encode of LENGTH tokens at budget 0.5, stride 8: the JAX
    engine's prefix-prefilled cache (keep_attention bootstrap for h2o_head)
    and the static schedule's stacked StepCtx, as the engine builds them."""
    jcfg, jparams, tcfg, tparams = weights
    keep = policy == "h2o_head"
    budget = int(LENGTH * 0.5) + STRIDE
    idx, r_idx = jgen.stride_align(LENGTH, budget, STRIDE)
    jst = jgen.EngineStatics(cfg=jcfg, mode="encoding", policy=policy, length=LENGTH,
                             budget=budget, idx=idx, r_idx=r_idx, stride=STRIDE, temp_length=4,
                             recent_window=int(budget * 0.1),
                             recent_window_dec=int(budget * 0.3), keep_attention=keep,
                             kv_quant=quant)
    ids = np.random.default_rng(len(policy) + B).integers(1, 120, size=(B, LENGTH)).astype(
        np.int32)
    S = jgen._round_up(idx + STRIDE, 128)
    spec = jst.encode_spec()
    jcache, _ = jax.jit(lambda c: jgen._prefill(
        jst, jparams, c, jnp.asarray(ids[:, :r_idx]), jnp.full((B,), r_idx, jnp.int32),
        spec if keep else None, "encode"))(jgen._engine_cache(jst, B, S))
    n = (LENGTH - r_idx) // STRIDE
    kv, trig, kv_before = r_idx, [], []
    for _ in range(n):
        kv_before.append(kv)
        trig.append(kv + STRIDE > idx)
        kv = kv + STRIDE - (STRIDE if trig[-1] else 0)
    starts = r_idx + STRIDE * np.arange(n)
    pos = (starts[:, None] + np.arange(STRIDE)[None, :]).astype(np.int32)
    cinit = np.asarray(jgen._encode_counter_init(jnp.asarray(pos), idx, STRIDE, keep))
    trig_b = np.broadcast_to(np.array(trig)[:, None], (n, B))
    ctx = jllama.StepCtx(
        q_pos=np.broadcast_to(pos[:, None], (n, B, STRIDE)),
        token_valid=np.ones((n, B, STRIDE), bool),
        counter_init=np.broadcast_to(cinit[:, None], (n, B, STRIDE)).astype(np.float32),
        next_pos=np.broadcast_to((starts + STRIDE).astype(np.int32)[:, None], (n, B)),
        prompt_len=np.zeros((n, B), np.int32), evict_gate=trig_b.copy(),
        update_gate=trig_b | keep, rand_rank=np.zeros((n, B), np.int32))
    tokens = ids[:, r_idx: r_idx + n * STRIDE]
    return dict(spec=spec, tspec=tllama.PolicySpec(**dataclasses.asdict(jst.encode_spec())), jcache=jcache,
                ctx=ctx, tokens=tokens, kv_before=kv_before, trig=trig, idx=idx, n=n)


def _jax_encode(weights, e):
    jcfg, jparams = weights[:2]
    ws = np.broadcast_to(np.array(e["kv_before"], np.int32)[:, None], e["ctx"].next_pos.shape)
    return jax.jit(lambda c, x, cx, w: jllama.strided_encode_layer_major(
        jparams, jcfg, c, x, cx, e["spec"], w))(
        e["jcache"], jnp.asarray(e["tokens"]), jllama.StepCtx(*map(jnp.asarray, e["ctx"])),
        jnp.asarray(ws))


def _port_encode(weights, e, step, chunk):
    """The port's strided encode from the JAX prefix cache; returns (h, the
    cache, the K7 calls)."""
    tcfg, tparams = weights[2:]
    tflags.use_step_kernel(step)
    tflags.use_chunk_kernel(chunk)
    cache = _cache_from_jax(e["jcache"])
    with mock.patch.object(tllama, "fused_chunk_step", wraps=tca.fused_chunk_step) as k7:
        h = tllama.strided_encode_layer_major(
            tparams, tcfg, cache, t(e["tokens"]),
            tllama.StepCtx(**{k: t(v) for k, v in e["ctx"]._asdict().items()}), e["tspec"],
            e["kv_before"], e["trig"])
    return h, cache, k7.call_count


def _assert_cache_equal(a: KVCache, b: KVCache):
    for name in CACHE:
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert torch.equal(x, y), name


@pytest.mark.parametrize("quant,B", [(False, 1), (True, 2)], ids=["f32-B1", "int8-B2"])
@pytest.mark.parametrize("policy", list(tca.STEP_POLICIES))
def test_strided_encode_step_matches_port_and_jax(weights, policy, quant, B):
    """K7 against the port's K6 path (every array and h exact), and against
    the JAX package's default (XLA) path: pos and counters exact, scores
    within 1e-6 (int8: 1e-5) plus 1e-6 relative, h within 1e-4."""
    e = _encode_setup(weights, policy, quant, B)
    h7, c7, calls = _port_encode(weights, e, True, True)
    h6, c6, none = _port_encode(weights, e, False, True)
    assert calls == CFG["num_hidden_layers"] * e["n"] and none == 0
    _assert_cache_equal(c7, c6)
    assert torch.equal(h7, h6)
    jh, jc = _jax_encode(weights, e)
    np.testing.assert_array_equal(c7.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(c7.counter.numpy(), np.asarray(jc.counter))
    for name in ("score", "score_sq"):
        np.testing.assert_allclose(getattr(c7, name).numpy(), np.asarray(getattr(jc, name)),
                                   rtol=1e-6, atol=1e-5 if quant else 1e-6, err_msg=name)
    np.testing.assert_allclose(h7.numpy(), np.asarray(jh), rtol=0, atol=1e-4)
    assert ((c7.pos >= 0).sum(-1) == e["idx"]).all()


def test_strided_encode_h2o_step_matches_jax_step_kernel(weights, monkeypatch):
    """h2o_head never reads the counters, so the port's K7 takes the JAX
    package's Pallas K7 victims (interpret mode) also where the Pallas pick
    clamps the negative initial counters: pos exact, scores within 1e-6."""
    e = _encode_setup(weights, "h2o_head", False, 1)
    _, c7, _ = _port_encode(weights, e, True, True)
    monkeypatch.setenv("EASYKV_TPU_STEP_KERNEL", "1")
    jflags.use_pallas(True)
    jflags.use_chunk_kernel(True)
    with mock.patch.object(jllama, "_chunk_step", wraps=jllama._chunk_step) as jk7:
        _, jc = _jax_encode(weights, e)
    assert jk7.call_count >= 1
    np.testing.assert_array_equal(c7.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_allclose(c7.score.numpy(), np.asarray(jc.score), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode,quant,policy", [("on", False, "h2o_head"), ("off", True, "roco")],
                         ids=["on-f32", "off-int8"])
def test_chunk_kernel_modes_match_jax(weights, mode, quant, policy, monkeypatch):
    """'on' sends a float cache through K5 (the prefill) and K6 (the strided
    encode), 'off' an int8 cache through the write, the dequantized cache
    and the plain `attend`, in both packages: the prefill's and the strided
    encode's pos exact, scores within 1e-6 (int8: 1e-5) plus 1e-6 relative,
    and the counters exact. The JAX package's 'on' runs its Pallas kernels
    in interpret mode, whose K6 clamps negative initial counters to 0: there
    h2o_head, which never reads them, and the counters are not compared."""
    jcfg, jparams, tcfg, tparams = weights
    monkeypatch.setenv("EASYKV_TPU_CHUNK_KERNEL", mode)
    jflags.use_pallas(mode == "on")
    e = _encode_setup(weights, policy, quant, 1)
    # the prefill: the keep_attention bootstrap of the first 40 tokens
    B, A = 1, 40
    st = jgen.EngineStatics(cfg=jcfg, mode="encoding", policy="roco", length=LENGTH,
                            budget=53, idx=48, r_idx=40, stride=STRIDE, temp_length=4,
                            recent_window=5, recent_window_dec=15, keep_attention=True,
                            kv_quant=quant)
    ids = np.random.default_rng(11).integers(1, 120, size=(B, A)).astype(np.int32)
    jp, _ = jax.jit(lambda c: jgen._prefill(st, jparams, c, jnp.asarray(ids),
                                            jnp.full((B,), A, jnp.int32), st.encode_spec(),
                                            "encode"))(jgen._engine_cache(st, B, 128))
    tst = tgen.EngineStatics(cfg=tcfg, mode="encoding", policy="roco", length=LENGTH,
                             budget=53, idx=48, r_idx=40, stride=STRIDE, temp_length=4,
                             recent_window=5, recent_window_dec=15, keep_attention=True,
                             kv_quant=quant)
    tp = init_cache(2, B, 2, 128, 16, torch.float32, torch.device("cpu"), quantized=quant)
    with mock.patch.object(tllama, "fused_chunk_attend", wraps=tllama.fused_chunk_attend) as k5, \
            mock.patch.object(tllama, "_plain_attend", wraps=tllama._plain_attend) as plain:
        tgen._prefill(tst, tparams, tp, t(ids), torch.full((B,), A, dtype=torch.int32),
                      tst.encode_spec(), "encode")
        _, tc, _ = _port_encode(weights, e, False, None)
    assert (k5.call_count > 0) == (mode == "on") and (plain.call_count > 0) == (mode == "off")
    _, jc = _jax_encode(weights, e)
    for what, tcache, jcache in (("prefill", tp, jp), ("encode", tc, jc)):
        np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
        if mode == "off":
            np.testing.assert_array_equal(tcache.counter.numpy(), np.asarray(jcache.counter))
        for name in ("score", "score_sq"):
            for l in range(CFG["num_hidden_layers"]):
                # the port's own int8 prefill: a later layer's rows are quantized
                # from hidden states that differ in their last f32 bits, so some
                # land one int8 step apart and move its scores by up to ~2e-3
                atol = 2e-3 if quant and what == "prefill" and l else 1e-5 if quant else 1e-6
                np.testing.assert_allclose(getattr(tcache, name)[l].numpy(),
                                           np.asarray(getattr(jcache, name))[l], rtol=1e-6,
                                           atol=atol, err_msg=f"{what} {name} layer {l}")


# --------------------------------------------------------------------------
# generate()
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(weights):
    jcfg, jparams, tcfg, tparams = weights
    return {quant: (easykv_tpu.CausalLM(jcfg, jparams, kv_quant=quant),
                    easykv_tpu_torch.CausalLM(tcfg, tparams, device="cpu", kv_quant=quant))
            for quant in (False, True)}


@contextlib.contextmanager
def _caches():
    """Records every KV cache the port's engine allocates."""
    made, make = [], tgen._engine_cache

    def record(*args):
        made.append(make(*args))
        return made[-1]
    with mock.patch.object(tgen, "_engine_cache", record):
        yield made


def _gc(policy):
    return {"budget": 0.5, "kv_policy": policy, "max_new_tokens": 8, "temperature": 1e-9,
            "top_p": 1.0, "eos_token_ids": [], "seed": 3}


def _port_generate(tm, ids, gc, mode, step, chunk):
    tflags.use_step_kernel(step)
    tflags.use_chunk_kernel(chunk)
    with _caches() as made, \
            mock.patch.object(tllama, "fused_chunk_step", wraps=tca.fused_chunk_step) as k7, \
            mock.patch.object(tllama, "fused_chunk_write_attend",
                              wraps=tca.fused_chunk_write_attend) as k6:
        out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode=mode, stride=STRIDE)
    return out, made[-1], (k7.call_count, k6.call_count)


ENGINE_CASES = [  # mode, policy, quant, B
    ("encoding", "roco", False, 1), ("encoding", "roco", True, 2),
    ("encoding", "h2o_head", False, 2), ("encoding", "h2o_head", True, 1),
    ("ppl", "roco", True, 1), ("ppl", "h2o_head", False, 1)]


@pytest.mark.parametrize("mode,policy,quant,B", ENGINE_CASES)
def test_generate_step_kernel_matches_off_and_jax(models, mode, policy, quant, B):
    """With the step kernel on, every strided-encode chunk of every layer is
    one K7 call, and tokens (ppl) and the final cache equal the run with it
    off (both with the chunk kernels: a float cache needs them on); tokens
    equal the JAX package's default path, ppl within 2e-4 relative (its
    bound between its own two encode paths)."""
    jm, tm = models[quant]
    ids = np.random.default_rng(len(policy) + B).integers(1, 120, size=(B, LENGTH))
    ids = ids[0] if B == 1 else ids
    gc = _gc(policy)
    chunk = None if quant else True
    out7, c7, calls7 = _port_generate(tm, ids, gc, mode, True, chunk)
    out6, c6, calls6 = _port_generate(tm, ids, gc, mode, False, chunk)
    align = jgen.stride_align if mode == "encoding" else jgen.stride_align_encdec
    n = (LENGTH - align(LENGTH, LENGTH // 2 + STRIDE, STRIDE)[1]) // STRIDE
    assert calls7 == (CFG["num_hidden_layers"] * n, 0) and calls6 == calls7[::-1]
    assert out7 == out6
    _assert_cache_equal(c7, c6)
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode=mode, stride=STRIDE)
    if mode == "ppl":
        assert out7 == pytest.approx(ref, rel=2e-4)
    else:
        assert out7 == ref and len(out7) == 8     # row 0 of a batch, as generate returns it


def test_generate_h2o_step_matches_jax_step_kernel(models, monkeypatch):
    """h2o_head with the step kernel on in both packages (the JAX package's
    Pallas kernels in interpret mode, its K7 among them): equal tokens."""
    jm, tm = models[True]
    ids = np.random.default_rng(12).integers(1, 120, size=(LENGTH,))
    gc = dict(_gc("h2o_head"), max_new_tokens=4)
    out, _, calls = _port_generate(tm, ids, gc, "encoding", True, None)
    assert calls[0] > 0
    monkeypatch.setenv("EASYKV_TPU_STEP_KERNEL", "1")
    jflags.use_pallas(True)
    jflags.use_chunk_kernel(True)
    with mock.patch.object(jllama, "_chunk_step", wraps=jllama._chunk_step) as jk7:
        ref = easykv_tpu.generate(jm, ids, gc, kv_mode="encoding", stride=STRIDE)
    assert jk7.call_count >= 1
    assert out == ref
