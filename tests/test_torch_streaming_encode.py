"""StreamingLLM in the encoding family (`encoding`, `encoding_decoding`,
`auto`, `ppl`) of the port against the JAX package's, on the CPU, from the
same numpy inputs. The Pallas kernels run in interpret mode.

  _age_ranks       exact against the JAX package's (holes, dead rows)
  write_tokens     exact against JAX write_tokens: pos, counters, scores,
                   f32 K/V, int8 K/V and scales; with padding columns
  K1 `rank` plain  against Pallas `fused_decode_attend_inflight(rank=)` and
                   against the XLA route (apply_rope by rank, then
                   attend_inflight); MHA and GQA, f32 and int8, a dead row:
                   within 1e-5
  fused_decode_attend plain  against Pallas `fused_decode_attend` and
                   against `attend` at T = 1 (int8: over the dequantized
                   cache); MHA and GQA, f32 and int8, a sliding window:
                   within 1e-5
  forward          every branch against JAX `forward`: streaming C > 1 and
                   C == 1, non-streaming bootstrap C == 1 (the JAX package
                   under use_pallas(True), so that it takes
                   fused_decode_attend), non-streaming float C > 1 and int8
                   C > 1 (K5, the JAX default's branch): logits within 1e-4
                   (int8 2e-3), pos and counters exact, scores and K/V as
                   below
  lockstep         the chunk-major streaming encode (forward + evict_cache
                   per chunk) and then the decode over the rank cache
                   (_decode_forward with carried ranks + evict_cache,
                   _carry_ranks) against the JAX package's forward +
                   evict_cache, five policies, stride 1 and 8, f32 and
                   int8, every rand_rank drawn once and fed to both: pos,
                   counters and the carried ranks (against _age_ranks of
                   the JAX cache) exact at every chunk and step; scores
                   within 1e-6 (int8 2e-5) plus 1e-6 relative, f32 K/V 1e-5,
                   int8 K/V within one step and scales 1e-5 relative, as
                   tests/test_torch_streaming_engine.py
                   (every policy at strides 1 and 8 with an f32 cache, at
                   one of them with an int8 cache)

generate() of both packages is compared in
tests/test_torch_streaming_encode_engine.py.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu import flags as jflags
from easykv_tpu import policies as jpol
from easykv_tpu.cache import LayerCache
from easykv_tpu.cache import quantize_kv as jquantize
from easykv_tpu.cache import write_tokens as jwrite_tokens
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops.attention import attend as jattend
from easykv_tpu.ops import pallas as jpallas
from easykv_tpu.ops.attention import attend_inflight as jattend_inflight
from easykv_tpu.ops.pallas.decode_attention import fused_decode_attend as jda
from easykv_tpu.ops.pallas.decode_attention import fused_decode_attend_inflight as jk1
from easykv_tpu.ops.rope import apply_rope as japply_rope
from easykv_tpu.ops.rope import rope_inv_freq as jinv_freq

from easykv_tpu_torch import policies as tpol
from easykv_tpu_torch.cache import KVCache, write_tokens
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.cuda.decode_attention import fused_decode_attend as tda
from easykv_tpu_torch.ops.cuda.decode_attention import fused_decode_attend_inflight as tk1

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)
POLICIES = ["roco", "h2o_head", "tova", "recency", "random"]


def t(x):
    return torch.from_numpy(np.array(x))


def cache_from_jax(cache) -> KVCache:
    """A JAX KVCache / LayerCache as the port's (float caches: scales None)."""
    leaves = [np.array(x) for x in tuple(cache)]
    quant = leaves[0].dtype == np.int8
    return KVCache(*map(torch.from_numpy, leaves[:6]),
                   *(map(torch.from_numpy, leaves[6:8]) if quant else (None, None)))


def assert_cache_close(tc: KVCache, jc, what: str):
    """pos and counters exact; scores within 1e-6 (int8 2e-5: an int8 value
    one step apart moves a probability by ~1e-6) plus 1e-6 relative; K/V
    within 1e-5 (f32) or one int8 step, scales 1e-5 relative."""
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos), err_msg=f"pos, {what}")
    np.testing.assert_array_equal(tc.counter.numpy(), np.asarray(jc.counter),
                                  err_msg=f"counter, {what}")
    atol = 2e-5 if tc.quantized else 1e-6
    for name in ("score", "score_sq"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   rtol=1e-6, atol=atol, err_msg=f"{name}, {what}")
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


def scrambled_pos(rng, B, H, S, n_valid, dead_row=False):
    """Positions of an unordered cache: n_valid distinct positions scattered
    over random slots of each (B, H), the rest -1 (a dead row all -1)."""
    pos = np.full((B, H, S), -1, np.int32)
    for b in range(B):
        for h in range(H):
            slots = rng.permutation(S)[:n_valid]
            pos[b, h, slots] = np.sort(rng.permutation(3 * S)[:n_valid])
    if dead_row:
        pos[-1] = -1
    return pos


# --------------------------------------------------------------------------
# _age_ranks, write_tokens
# --------------------------------------------------------------------------

def test_age_ranks_match_jax():
    rng = np.random.default_rng(0)
    pos = scrambled_pos(rng, 3, 4, 70, 50, dead_row=True)
    pos[0, 0] = np.arange(70)                       # a full, ordered head
    ranks = tllama._age_ranks(t(pos))
    assert ranks.dtype == torch.int32
    np.testing.assert_array_equal(ranks.numpy(), np.asarray(jllama._age_ranks(jnp.asarray(pos))))
    np.testing.assert_array_equal(ranks[0, 0].numpy(), np.arange(70))
    L_pos = np.stack([pos, pos[::-1]])
    np.testing.assert_array_equal(tllama.age_ranks_all(t(L_pos)).numpy()[1],
                                  np.asarray(jllama._age_ranks(jnp.asarray(pos[::-1]))))


@pytest.mark.parametrize("padding", [False, True], ids=["all-valid", "padding"])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_write_tokens_matches_jax(quant, padding):
    """C = 6 tokens into a cache with 4 to 9 free slots per head: valid
    tokens take the lowest free slots in column order, padding columns
    (one row: the middle two, the other: the last) write nothing, and a row
    with fewer free slots than tokens overwrites valid slots in slot order,
    as the JAX package does."""
    rng = np.random.default_rng(1 + quant + 2 * padding)
    B, H, S, C, D = 2, 3, 24, 6, 16
    pos = scrambled_pos(rng, B, H, S, S - 9)
    pos[1, 0, np.flatnonzero(pos[1, 0] < 0)[:5]] = 100   # 4 free slots only
    k = rng.normal(size=(B, H, S, D)).astype(np.float32)
    v = rng.normal(size=(B, H, S, D)).astype(np.float32)
    side = [rng.random((B, H, S)).astype(np.float32) for _ in range(3)]
    leaves = [k, v, pos, *side]
    if quant:
        (kq, ks), (vq, vs) = (tuple(np.asarray(x) for x in jquantize(jnp.asarray(a)))
                              for a in (k, v))
        leaves = [kq, vq, pos, *side, ks, vs]
    else:
        leaves += [np.zeros((B, H, 1), np.float32)] * 2
    jc = LayerCache(*map(jnp.asarray, leaves))
    new_k, new_v = (rng.normal(size=(B, H, C, D)).astype(np.float32) for _ in range(2))
    new_pos = (200 + np.arange(C) + 10 * np.arange(B)[:, None]).astype(np.int32)
    cinit = rng.normal(size=(B, C)).astype(np.float32)
    tv = None
    if padding:
        tv = np.ones((B, C), bool)
        tv[0, 2:4] = False
        tv[1, -1] = False
    jout = jwrite_tokens(jc, *map(jnp.asarray, (new_k, new_v, new_pos, cinit)),
                         None if tv is None else jnp.asarray(tv))
    tc = cache_from_jax(LayerCache(*leaves))
    write_tokens(tc, *map(t, (new_k, new_v, new_pos, cinit)), None if tv is None else t(tv))
    names = ["k", "v", "pos", "score", "score_sq", "counter"] + (
        ["k_scale", "v_scale"] if quant else [])
    for name in names:
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jout, name)),
                                      err_msg=name)
    written = (tc.pos.numpy() >= 200).sum(-1)
    assert (written == (C if tv is None else tv.sum(-1)[:, None])).all()


# --------------------------------------------------------------------------
# K1 `rank`, fused_decode_attend
# --------------------------------------------------------------------------

def _attend_inputs(rng, B, Hq, Hkv, S, D, quant):
    q, kn, vn = (rng.normal(size=(B, h, 1, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    scales = ()
    if quant:
        (k, ks), (v, vs) = (tuple(np.asarray(x) for x in jquantize(jnp.asarray(a)))
                            for a in (k, v))
        scales = (ks, vs)
    return q, kn, vn, k, v, scales


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_k1_rank_plain_matches_pallas_and_rope(Hq, Hkv, quant):
    """A scrambled cache with holes (S = 120, 90 valid slots a head) and a
    dead row: each cached K rotated by its age rank."""
    B, S, D = 2, 120, 64
    rng = np.random.default_rng(41 + Hkv + quant)
    q, kn, vn, k, v, scales = _attend_inputs(rng, B, Hq, Hkv, S, D, quant)
    pos = scrambled_pos(rng, B, Hkv, S, 90)
    q_pos = np.array([3 * S, -1], np.int32)
    ranks = np.asarray(jllama._age_ranks(jnp.asarray(pos)))
    inv_freq = jinv_freq(D, 10000.0)
    jkw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1])) if quant else {}
    ref_p = jax.jit(functools.partial(jk1, interpret=True))(
        *map(jnp.asarray, (q, kn, vn, k, v, pos, q_pos)), rank=jnp.asarray(ranks),
        inv_freq=inv_freq, **jkw)
    # the JAX package's XLA route (llama.py:894-899 there): dequantize, rotate
    # by rank, plain in-flight attention
    kd = k.astype(np.float32) * (scales[0][..., None] if quant else 1)
    vd = v.astype(np.float32) * (scales[1][..., None] if quant else 1)
    k_rot = japply_rope(jnp.asarray(kd), jnp.asarray(ranks), inv_freq)
    ref_x = jattend_inflight(*map(jnp.asarray, (q, kn, vn)), k_rot, jnp.asarray(vd),
                             jnp.asarray(pos), jnp.asarray(q_pos))
    cfg = ModelConfig(vocab_size=8, hidden_size=D * Hq, intermediate_size=8,
                      num_hidden_layers=1, num_attention_heads=Hq, num_key_value_heads=Hkv)
    rot = tllama.rotation_tables(S, cfg, "cpu")
    out = tk1(*map(t, (q, kn, vn, k, v, pos, q_pos)), *map(t, scales), rot=rot, rank=t(ranks))
    for a, b, c in zip(out, ref_p, ref_x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-5)
    assert (out[0][1] == 0).all() and (out[1][1] == 0).all()      # the dead row
    by_slot = tk1(*map(t, (q, kn, vn, k, v, pos, q_pos)), *map(t, scales), rot=rot)
    assert (by_slot[1] - out[1]).abs().max() > 1e-3               # ranks are not slots here


@pytest.mark.parametrize("quant,window", [(False, None), (True, None), (False, 40),
                                          (True, 40)], ids=["f32", "int8", "f32-window",
                                                            "int8-window"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_decode_attend_plain_matches_pallas_and_attend(Hq, Hkv, quant, window):
    B, S, D = 2, 130, 64
    rng = np.random.default_rng(51 + Hkv + quant + (window or 0))
    q, _, _, k, v, scales = _attend_inputs(rng, B, Hq, Hkv, S, D, quant)
    pos = scrambled_pos(rng, B, Hkv, S, 100)
    q_pos = np.array([3 * S, int(pos[1].max())], np.int32)
    jkw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1])) if quant else {}
    ref_p = jax.jit(functools.partial(jda, interpret=True, sliding_window=window))(
        *map(jnp.asarray, (q, k, v, pos, q_pos)), **jkw)
    kd = k.astype(np.float32) * (scales[0][..., None] if quant else 1)
    vd = v.astype(np.float32) * (scales[1][..., None] if quant else 1)
    ref_x = jattend(*map(jnp.asarray, (q, kd, vd, pos, q_pos[:, None])),
                    sliding_window=window)
    out = tda(*map(t, (q, k, v, pos, q_pos)), *map(t, scales), sliding_window=window)
    for a, b, c in zip(out, ref_p, ref_x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# forward, every branch
# --------------------------------------------------------------------------

def cache_to_jax(tc: KVCache, template):
    """A copy of the port's cache as a JAX KVCache / LayerCache shaped as
    `template` (a float cache keeps the template's placeholder scales). It
    copies: a JAX array may share a numpy buffer, and the port writes its
    cache in place."""
    copy = lambda x: jnp.asarray(x.numpy().copy())  # noqa: E731
    leaves = [copy(x) for x in (tc.k, tc.v, tc.pos, tc.score, tc.score_sq, tc.counter)]
    scales = ([copy(tc.k_scale), copy(tc.v_scale)] if tc.quantized
              else [template.k_scale, template.v_scale])
    return type(template)(*leaves, *scales)


def _prefilled(jst, tst, tparams, ids, B, S):
    """Both packages' caches after the port's prefix prefill of ids (the
    encode counters, the keep_attention bootstrap of the encode spec), so
    that each lockstep starts from one cache without compiling the JAX
    prefill."""
    tcache = tgen._engine_cache(tst, B, S, torch.float32, torch.device("cpu"))
    plen = torch.full((B,), ids.shape[1], dtype=torch.int32)
    tgen._prefill(tst, tparams, tcache, t(ids), plen, tst.encode_spec(), "encode")
    return tcache, cache_to_jax(tcache, jgen._engine_cache(jst, B, tcache.pos.shape[-1]))


def _holed_cache(jcfg, tparams, B, P, S, quant, rng):
    """Both packages' caches with P prompt tokens prefilled (keep_attention
    bootstrap) and then one roco eviction of 6 slots a head: unordered,
    with holes."""
    kw = dict(policy="roco", length=P, budget=P, idx=P, r_idx=P, stride=6, kv_quant=quant,
              keep_attention=True)
    jst = jgen.EngineStatics(cfg=jcfg, mode="encoding", **kw)
    tst = tgen.EngineStatics(cfg=ModelConfig(**CFG), mode="encoding", **kw)
    tcache, _ = _prefilled(jst, tst, tparams, rng.integers(1, 120, size=(B, P)), B, S)
    spec = dataclasses.replace(tst.encode_spec(), feasible_k=P - 8)
    zeros = torch.zeros((B,), dtype=torch.int32)
    tpol.evict_cache(tcache, spec, torch.full((B,), P, dtype=torch.int32), zeros, zeros,
                     torch.ones((B,), dtype=torch.bool))
    return tcache, cache_to_jax(tcache, jgen._engine_cache(jst, B, S))


FORWARD_CASES = {  # name: (C, streaming, bootstrap, quant)
    "stream-C8": (8, True, False, False), "stream-C8-int8": (8, True, False, True),
    "stream-C1": (1, True, False, False), "boot-C1": (1, False, True, False),
    "boot-C1-int8": (1, False, True, True), "float-C8": (8, False, False, False),
    "int8-C8": (8, False, False, True),
}


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_forward_matches_jax(models, case, monkeypatch):
    jcfg, jparams, tcfg, tparams = models
    C, streaming, bootstrap, quant = FORWARD_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    B, P = 2, 30
    tcache, jcache = _holed_cache(jcfg, tparams, B, P, 128, quant, rng)
    spec = tpol.PolicySpec("roco", tpol.PHASE_ENCODE, C, 4, 3, feasible_k=20)
    spec_j = jpol.PolicySpec(**vars(spec))
    q_pos = (P + np.arange(C) + np.arange(B)[:, None]).astype(np.int32)
    ctx_np = dict(q_pos=q_pos, token_valid=np.ones((B, C), bool),
                  counter_init=-(np.arange(C) % 3 + np.zeros((B, 1))).astype(np.float32),
                  next_pos=q_pos[:, -1] + 1, prompt_len=np.zeros((B,), np.int32),
                  evict_gate=np.zeros((B,), bool), update_gate=np.array([True, False]),
                  rand_rank=np.zeros((B,), np.int32))
    tok = rng.integers(1, 120, size=(B, C)).astype(np.int32)
    # the JAX forward calls the Pallas kernel without interpret=, which
    # only a TPU runs; here it runs in interpret mode
    monkeypatch.setattr(jpallas, "fused_decode_attend", functools.partial(jda, interpret=True))
    jflags.use_pallas(bootstrap or None)
    try:
        jlog, jcache = jax.jit(lambda c, x, cx: jllama.forward(
            jparams, jcfg, c, x, cx, spec_j, bootstrap=bootstrap, streaming=streaming))(
            jcache, jnp.asarray(tok), jllama.StepCtx(**{k: jnp.asarray(v)
                                                        for k, v in ctx_np.items()}))
    finally:
        jflags.use_pallas(None)
    stream = tllama.stream_tables(128, tcfg, "cpu", "rank") if streaming else None
    counts = (tda.launches, tk1.launches)
    tlog = tllama.forward(tparams, tcfg, tcache, t(tok), tllama.StepCtx(
        **{k: t(v) for k, v in ctx_np.items()}), spec, bootstrap=bootstrap, stream=stream)
    assert (tda.launches, tk1.launches) == counts        # CPU tensors: the plain versions
    assert tlog.shape == (B, C, 128)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                               atol=2e-3 if quant else 1e-4)
    assert_cache_close(tcache, jcache, case)


# --------------------------------------------------------------------------
# lockstep: the streaming strided encode, then the decode over the rank cache
# --------------------------------------------------------------------------

_STEPS = {}


def _jax_steps(jcfg, jparams, spec_enc, spec_dec):
    """Jitted JAX chunk forward + evict_cache, and decode forward (ranks
    recomputed by argsort) + evict_cache, for one pair of specs (kept for
    the other cache dtype, which retraces them)."""
    if (spec_enc, spec_dec) in _STEPS:
        return _STEPS[spec_enc, spec_dec]

    @jax.jit
    def chunk(c, tok, ctx):
        logits, c = jllama.forward(jparams, jcfg, c, tok, ctx, spec_enc, streaming=True)
        c = jpol.evict_cache(c, spec_enc, ctx.next_pos, ctx.prompt_len, ctx.rand_rank,
                             ctx.evict_gate)
        return logits, c

    @jax.jit
    def step(c, tok, ctx):
        L, B, H, S = c.pos.shape
        ranks = jllama._age_ranks(c.pos.reshape(L * B, H, S)).reshape(L, B, H, S)
        logits, c = jllama.forward(jparams, jcfg, c, tok, ctx, spec_dec, streaming=True,
                                   ranks_all=ranks, fold_evict=False)
        c = jpol.evict_cache(c, spec_dec, ctx.next_pos, ctx.prompt_len, ctx.rand_rank,
                             ctx.evict_gate)
        return logits, c
    _STEPS[spec_enc, spec_dec] = chunk, step
    return chunk, step


# every policy at both strides with an f32 cache; with an int8 cache every
# policy at one stride, both strides covered
LOCKSTEP_CASES = [(p, s, False) for p in POLICIES for s in (8, 1)] + [
    ("roco", 8, True), ("roco", 1, True), ("h2o_head", 8, True), ("tova", 1, True),
    ("recency", 8, True), ("random", 1, True)]


@pytest.mark.parametrize("policy,stride,quant", LOCKSTEP_CASES,
                         ids=[f"{p}-s{s}-{'int8' if q else 'f32'}" for p, s, q in LOCKSTEP_CASES])
def test_streaming_lockstep(models, policy, stride, quant):
    """B = 2, a 40-token prompt, budget 24 (encoding_decoding's resolution),
    keep_attention: the prefix prefill (JAX), then every encode chunk and 6
    decode steps with an eviction each (the encdec decode spec), held after
    every chunk and step. The decode's ranks are carried by the port
    (_carry_ranks) and recomputed by argsort on the JAX side."""
    jcfg, jparams, tcfg, tparams = models
    B, P, b = 2, 40, 24 + stride
    idx, r_idx = jgen.stride_align_encdec(P, b, stride)
    kw = dict(policy=policy, length=P, budget=b, idx=idx, r_idx=r_idx, stride=stride,
              recent_window=int(b * 0.1), recent_window_dec=int(b * 0.3), keep_attention=True,
              kv_quant=quant, streaming=True)
    jst = jgen.EngineStatics(cfg=jcfg, mode="encoding_decoding", **kw)
    tst = tgen.EngineStatics(cfg=tcfg, mode="encoding_decoding", **kw)
    spec_enc, spec_dec = tst.encode_spec(), tst.encdec_decode_spec()
    assert spec_enc == tpol.PolicySpec(**vars(jst.encode_spec()))
    chunk, step = _jax_steps(jcfg, jparams, jst.encode_spec(), jst.encdec_decode_spec())
    rng = np.random.default_rng(sum(map(ord, policy)) + 3 * stride + quant)
    ids = rng.integers(1, 120, size=(B, P)).astype(np.int32)
    tcache, jcache = _prefilled(jst, tst, tparams, ids[:, :r_idx], B, idx + stride)
    S = tcache.pos.shape[-1]
    stream = tllama.stream_tables(S, tcfg, "cpu", "rank")

    ctxs, trig, _, kv = tgen._encode_schedule(tst, B, spec_enc, None, torch.device("cpu"))
    n = len(trig)
    ctxs = ctxs._replace(rand_rank=t(rng.integers(0, idx, size=(n, B)).astype(np.int32)))
    for c in range(n):
        ctx = tllama.StepCtx(*(x[c] for x in ctxs))
        tok = ids[:, r_idx + c * stride: r_idx + (c + 1) * stride]
        jlog, jcache = chunk(jcache, jnp.asarray(tok),
                             jllama.StepCtx(*(jnp.asarray(x.numpy()) for x in ctx)))
        tlog = tllama.forward(tparams, tcfg, tcache, t(tok), ctx, spec_enc, stream=stream)
        if trig[c]:
            tpol.evict_cache(tcache, spec_enc, ctx.next_pos, ctx.prompt_len, ctx.rand_rank,
                             ctx.evict_gate)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=2e-3 if quant else 1e-4, err_msg=f"logits, chunk {c}")
        assert_cache_close(tcache, jcache, f"chunk {c}")
    assert ((tcache.pos >= 0).sum(-1) == kv).all() and kv == idx

    ranks = tllama.age_ranks_all(tcache.pos)
    for g in range(6):
        tok_pos = np.full((B,), P + g, np.int32)
        ctx_np = dict(q_pos=tok_pos[:, None], token_valid=np.ones((B, 1), bool),
                      counter_init=np.zeros((B, 1), np.float32), next_pos=tok_pos + 1,
                      prompt_len=np.full((B,), P, np.int32), evict_gate=np.ones((B,), bool),
                      update_gate=np.ones((B,), bool),
                      rand_rank=rng.integers(0, idx - 4, size=B).astype(np.int32))
        tok = rng.integers(1, 120, size=(B, 1)).astype(np.int32)
        jlog, jcache = step(jcache, jnp.asarray(tok),
                            jllama.StepCtx(**{k: jnp.asarray(v) for k, v in ctx_np.items()}))
        tctx = tllama.StepCtx(**{k: t(v) for k, v in ctx_np.items()})
        pos_pre = tcache.pos.clone()
        tlog = tllama._decode_forward(tparams, tcfg, tcache, t(tok), tctx, spec_dec,
                                      stream._replace(ranks=ranks))
        pos_mid = tcache.pos.clone()
        tpol.evict_cache(tcache, spec_dec, tctx.next_pos, tctx.prompt_len, tctx.rand_rank,
                         tctx.evict_gate)
        ranks = tgen._carry_ranks(ranks, pos_pre, pos_mid, tcache.pos)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0,
                                   atol=2e-3 if quant else 1e-4, err_msg=f"logits, step {g}")
        assert_cache_close(tcache, jcache, f"step {g}")
        L_, B_, H_, S_ = jcache.pos.shape
        np.testing.assert_array_equal(
            ranks.numpy(), np.asarray(jllama._age_ranks(jcache.pos.reshape(L_ * B_, H_, S_)))
            .reshape(L_, B_, H_, S_), err_msg=f"carried ranks, step {g}")
    assert ((tcache.pos >= 0).sum(-1) == idx).all()


@pytest.mark.parametrize("mode", ["encoding", "decoding"])
def test_one_kernel_step_stays_off_over_the_rank_cache(models, mode, monkeypatch):
    """Over the fused arithmetic-int4 tree the decode step is one K14
    launch (mega_tree) only on the ordered, pre-rotated streaming cache of
    `decoding` (the JAX package requires `ordered and prerotated`); the
    rank cache of the encoding family decodes layer by layer through K1's
    rank variant."""
    from easykv_tpu_torch.ops.quant import fuse_gemv_params, quantize_params_int4
    _, _, tcfg, tparams = models
    tree = fuse_gemv_params(quantize_params_int4(tparams, group_size=16, layout="arith"))
    assert tllama.mega_tree(tree)
    calls = {"K14": 0, "rank": 0}
    real_k14, real_k1 = tllama.fused_decode_step, tllama.fused_decode_attend_inflight

    def k14(*a, **kw):
        calls["K14"] += 1
        return real_k14(*a, **kw)

    def k1(*a, **kw):
        calls["rank"] += kw.get("rank") is not None
        return real_k1(*a, **kw)
    monkeypatch.setattr(tllama, "fused_decode_step", k14)
    monkeypatch.setattr(tllama, "fused_decode_attend_inflight", k1)
    ids = np.random.default_rng(3).integers(1, 120, size=(40,))
    gc = {"budget": 0.5 if mode == "encoding" else 6, "kv_policy": "roco",
          "max_new_tokens": 4, "streaming": True, "temperature": 1e-9, "top_p": 1.0,
          "eos_token_ids": [], "seed": 3}
    import easykv_tpu_torch
    easykv_tpu_torch.generate(easykv_tpu_torch.CausalLM(tcfg, tree, device="cpu"), ids, gc,
                              kv_mode=mode, stride=8)
    L = tcfg.num_hidden_layers
    assert calls == ({"K14": 0, "rank": 4 * L} if mode == "encoding"
                     else {"K14": 4, "rank": 0})
