"""The batched one-kernel decode step K15 of the port against the JAX
package's, on the CPU, over the fused arithmetic-int4 tree
(quantize_params_int4(layout="arith") + fuse_gemv_params) at tiny widths,
L = 2, f32.

With an f32 compute dtype K15's feed does not round (its rows are rounded
to the compute dtype), so K15 equals the per-layer scan up to the order of
its f32 sums: the JAX package holds its kernel to its scan within 1e-4
(tests/test_fused_decode_batch.py), and so does this file.

- plain K15 against the Pallas `fused_decode_step_batch` in interpret mode,
  every output within atol = rtol = 1e-4: GQA at B = 3 with a sliding
  window, scattered dead slots and a dead row; MHA at B = 5 with an int8
  cache and rope_pos; MHA at B = 16 (each computed once, in a module
  fixture);
- `_run_decoding` (the engine of `generate("decoding")`) by both packages,
  the port through K15 (its plain version here), the JAX package through
  its default CPU path, the per-layer scan: equal greedy tokens and final
  kv_len per row, roco and `full`, f32 and int8 KV, MHA at B = 2 and 16,
  GQA at B = 8, StreamingLLM roco over the pre-rotated cache at B = 2;
  and `generate` at B = 2 with its printed budget ratio line;
- a two-step decode lockstep of `_decode_forward` against the JAX one under
  flags.use_pallas(True) (its K15 in interpret mode) at B = 3 with an int8
  cache: logits within 1e-4, pos and counters equal;
- step_bars.rms_lanes (the card tests' feed-check norm, in K15's order of
  its sums): the same bits per row at any B, within f32 rounding of the
  JAX package's rmsnorm;
- gating: K15 launches once a decode step at 1 < B <= 16 (MHA) or 8 (GQA)
  (counted by a stand-in around the plain version), and never at B = 1,
  past those B, for the split tree or with either mega flag off.
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
from easykv_tpu.cache import quantize_kv as jquantize_kv
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops import quant as jq
from easykv_tpu.ops.pallas.fused_decode_batch import fused_decode_step_batch as jk15
from easykv_tpu.policies import evict_cache as jevict_cache

from easykv_tpu_torch import flags as tflags
from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.cuda import fused_decode_batch as k15_mod

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
TOL = 1e-4
NAMES = ("h", "kn", "vn", "probs", "p_new")


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def trees():
    """{(Hkv, window): (jcfg, JAX tree, tcfg, port tree)}, group 16."""
    out = {}
    for hkv, window in ((2, None), (2, 9), (4, None)):
        cfg = dict(CFG, num_key_value_heads=hkv, sliding_window=window)
        jcfg = JModelConfig(**cfg)
        base = jllama.init_params(jcfg, jax.random.PRNGKey(hkv))
        jp = jq.materialize_params(jq.fuse_gemv_params(
            jq.quantize_params_int4(base, group_size=16, layout="arith")))
        tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
        out[(hkv, window)] = (jcfg, jp, ModelConfig(**cfg), tp)
    return out


PALLAS_CASES = {  # Hkv, window, B, cache, rope_pos, dead slots and row 1 dead
    "gqa-B3-f32-window-dead-row": (2, 9, 3, "f32", False, True),
    "mha-B5-int8-rope_pos": (4, None, 5, "int8", True, False),
    "mha-B16-f32": (4, None, 16, "f32", False, False),
}


@pytest.fixture(scope="module")
def pallas_results(trees):
    """{case: (port plain K15 outputs, Pallas K15 outputs)}, each computed
    once: the interpret-mode kernel takes seconds a call."""
    out = {}
    for case, (hkv, window, B, kv, with_rope, dead) in PALLAS_CASES.items():
        jcfg, jp, tcfg, tp = trees[(hkv, window)]
        L, S, Dh, D = 2, 48, tcfg.head_dim, tcfg.hidden_size
        rng = np.random.default_rng(sum(map(ord, case)))
        k = rng.standard_normal((L, B, hkv, S, Dh)).astype(np.float32)
        v = rng.standard_normal((L, B, hkv, S, Dh)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (L, B, hkv, S)).copy()
        pos[..., 40:] = -1
        q_pos = (40 - np.arange(B) % 5).astype(np.int32)
        if dead:
            pos[rng.random(pos.shape) < 0.3] = -1
            q_pos[1] = -1
        rope_pos = (33 - np.arange(B)).astype(np.int32) if with_rope else None
        h0 = (rng.standard_normal((B, D)) * 0.5).astype(np.float32)
        scales = ()
        if kv == "int8":
            (k, ks), (v, vs) = (jax.tree.map(np.asarray, jquantize_kv(jnp.asarray(x)))
                                for x in (k, v))
            scales = (ks, vs)
        ref = jk15(jp["layers"], jcfg, *(jnp.asarray(x) for x in (k, v, pos, h0, q_pos)),
                   *(jnp.asarray(x) for x in scales),
                   rope_pos=None if rope_pos is None else jnp.asarray(rope_pos), interpret=True)
        got = k15_mod.fused_decode_step_batch(
            tp.layers, tcfg, *(t(x) for x in (k, v, pos, h0, q_pos)), *(t(x) for x in scales),
            rope_pos=None if rope_pos is None else t(rope_pos))
        out[case] = (got, [np.asarray(x) for x in ref])
    return out


@pytest.mark.parametrize("case", list(PALLAS_CASES))
def test_plain_k15_matches_pallas(pallas_results, case):
    got, ref = pallas_results[case]
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL, err_msg=name)
    if PALLAS_CASES[case][-1]:                        # row 1 dead: no probability anywhere
        assert not got[3][:, 1].any() and not got[4][:, 1].any()


RUNS = {  # Hkv, B, policy, int8 KV, streaming (pre-rotated cache)
    "mha-B2-roco-f32": (4, 2, "roco", False, False),
    "mha-B16-full-int8": (4, 16, "full", True, False),
    "gqa-B8-roco-int8": (2, 8, "roco", True, False),
    "mha-B2-streaming-roco-f32": (4, 2, "roco", False, True),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_decoding_matches_jax(trees, case):
    """_run_decoding of both packages, row 1's prompt shorter (padding):
    every row's greedy tokens and final kv_len equal; K15 once a step."""
    hkv, B, policy, kv_quant, streaming = RUNS[case]
    jcfg, jp, tcfg, tp = trees[(hkv, None)]
    P = 32
    ids = np.random.default_rng(len(case)).integers(1, 120, size=(B, P)).astype(np.int32)
    plen = np.full((B,), P, np.int32)
    plen[1] = 25
    ids[1, 25:] = 0
    common = dict(policy=policy, length=P, budget=6, max_new_tokens=10, recent_window_dec=1,
                  kv_quant=kv_quant, streaming=streaming)
    jr = jgen._run_decoding(jgen.EngineStatics(cfg=jcfg, mode="decoding", stride=1, **common),
                            jp, jnp.asarray(ids), jnp.asarray(plen), jnp.float32(1e-9),
                            jnp.float32(1.0), jax.random.PRNGKey(0))
    calls = []
    real = tllama.fused_decode_step_batch
    tllama.fused_decode_step_batch = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        tr, _, _, _ = tgen._run_decoding(tgen.EngineStatics(cfg=tcfg, **common), tp, t(ids),
                                         t(plen), 1e-9, 1.0, torch.Generator().manual_seed(0),
                                         torch.float32)
    finally:
        tllama.fused_decode_step_batch = real
    np.testing.assert_array_equal(tr.out_ids.numpy(), np.asarray(jr.out_ids))
    np.testing.assert_array_equal(tr.kv_len.numpy(), np.asarray(jr.kv_len))
    assert len(calls) == 10


def test_generate_b2_matches_jax(trees, capsys):
    """generate("decoding") on two prompts: equal greedy tokens and printed
    budget ratio line."""
    jcfg, jp, tcfg, tp = trees[(2, None)]
    ids = np.random.default_rng(9).integers(1, 120, size=(2, 30))
    gc = {"budget": 6, "kv_policy": "roco", "max_new_tokens": 12, "temperature": 1e-9,
          "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    ref = easykv_tpu.generate(easykv_tpu.CausalLM(jcfg, jp), ids, gc, kv_mode="decoding")
    jprint = re.findall(r"KV cache budget ratio: .*", capsys.readouterr().out)
    out = easykv_tpu_torch.generate(easykv_tpu_torch.CausalLM(tcfg, tp, device="cpu"), ids, gc,
                                    kv_mode="decoding")
    assert out == ref
    assert re.findall(r"KV cache budget ratio: .*", capsys.readouterr().out) == jprint
    assert len(jprint) == 1


def test_decode_lockstep_matches_pallas(trees, monkeypatch):
    """B = 3, int8 cache, two steps past a budget of 6 (an eviction each);
    the JAX side runs its K15, sidecar and row-write kernels in interpret
    mode, the path it takes on its chip (its K15 is traced into the step).
    K15 once a step."""
    jcfg, jp, tcfg, tp = trees[(2, None)]
    B, P, budget, steps = 3, 24, 6, 2
    rng = np.random.default_rng(3)
    ids = rng.integers(1, 120, size=(B, P)).astype(np.int32)
    plen = np.full((B,), P, np.int32)
    common = dict(policy="roco", length=P, budget=budget, recent_window_dec=1, kv_quant=True)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", stride=1, **common)
    spec_j = jst.decode_spec()
    spec_t = tgen.EngineStatics(cfg=tcfg, **common).decode_spec()
    cache, _ = jax.jit(lambda c: jgen._prefill(jst, jp, c, jnp.asarray(ids), jnp.asarray(plen),
                                               None, "zero"))(
        jgen._engine_cache(jst, B, P + budget + 1))
    leaves = [np.array(x) for x in tuple(cache)]
    tcache = KVCache(*map(torch.from_numpy, leaves))
    calls, traced = [], []
    real = tllama.fused_decode_step_batch
    tllama.fused_decode_step_batch = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    jk15_mod = importlib.import_module("easykv_tpu.ops.pallas.fused_decode_batch")
    monkeypatch.setattr(jk15_mod, "fused_decode_step_batch",
                        lambda *a, **kw: traced.append(1) or jk15(*a, **kw))

    @jax.jit
    def jstep(c, tok, ctx):
        logits, c = jllama.forward(jp, jcfg, c, tok, ctx, spec_j, fold_evict=False)
        return logits, jevict_cache(c, spec_j, ctx.next_pos, ctx.prompt_len, ctx.rand_rank,
                                    ctx.evict_gate)

    toks = rng.integers(1, 120, size=(steps, B)).astype(np.int32)
    jflags.use_pallas(True)
    try:
        for g in range(steps):
            tok_pos = np.full((B,), P + budget + g, np.int32)
            ctx_np = dict(q_pos=tok_pos[:, None], token_valid=np.ones((B, 1), bool),
                          counter_init=np.zeros((B, 1), np.float32), next_pos=tok_pos + 1,
                          prompt_len=plen, evict_gate=np.ones((B,), bool),
                          update_gate=np.ones((B,), bool), rand_rank=np.zeros((B,), np.int32))
            jctx = jllama.StepCtx(**{k: jnp.asarray(v) for k, v in ctx_np.items()})
            tctx = tllama.StepCtx(**{k: t(v) for k, v in ctx_np.items()})
            jlog, cache = jstep(cache, jnp.asarray(toks[g][:, None]), jctx)
            tlog = tllama._decode_forward(tp, tcfg, tcache, t(toks[g][:, None]), tctx, spec_t)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=TOL, atol=TOL,
                                       err_msg=f"logits, step {g}")
            np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(cache.pos),
                                          err_msg=f"pos, step {g}")
            np.testing.assert_array_equal(tcache.counter.numpy(), np.asarray(cache.counter),
                                          err_msg=f"counter, step {g}")
    finally:
        jflags.use_pallas(None)
        tllama.fused_decode_step_batch = real
    assert len(calls) == steps and len(traced) == 1


def _decode_launches(params, cfg, B, n=3):
    """Decode n tokens at B rows through _run_decoding; returns the number
    of K15 launches (counted by a stand-in around the plain version)."""
    P = 16
    ids = torch.from_numpy(np.random.default_rng(B).integers(1, 120, size=(B, P)).astype(np.int32))
    st = tgen.EngineStatics(cfg=cfg, policy="roco", length=P, budget=4, max_new_tokens=n,
                            recent_window_dec=1)
    calls = []
    real = tllama.fused_decode_step_batch
    tllama.fused_decode_step_batch = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        tgen._run_decoding(st, params, ids, torch.full((B,), P, dtype=torch.int32), 1e-9, 1.0,
                           torch.Generator().manual_seed(0), torch.float32)
    finally:
        tllama.fused_decode_step_batch = real
    return len(calls)


GATING = {  # Hkv, B, tree, flag switched off, K15 a step
    "gqa-B2": (2, 2, "fused", None, True),
    "gqa-B8": (2, 8, "fused", None, True),
    "gqa-B9": (2, 9, "fused", None, False),
    "mha-B16": (4, 16, "fused", None, True),
    "mha-B17": (4, 17, "fused", None, False),
    "gqa-B1": (2, 1, "fused", None, False),
    "split-gqa-B2": (2, 2, "split", None, False),
    "mega-off-gqa-B2": (2, 2, "fused", "mega", False),
    "mega-batch-off-gqa-B2": (2, 2, "fused", "mega_batch", False),
}


@pytest.mark.parametrize("case", list(GATING))
def test_k15_gating(trees, case):
    hkv, B, tree, off, launches = GATING[case]
    jcfg, jp, tcfg, tp = trees[(hkv, None)]
    if tree == "split":
        base = jllama.init_params(jcfg, jax.random.PRNGKey(hkv))
        split = jq.quantize_params_int4(base, group_size=16, layout="arith")
        tp = from_jax_params(jax.tree.map(np.asarray, split), device="cpu")
    assert tllama.mega_tree(tp) == (tree == "fused")
    switch = {"mega": tflags.use_mega, "mega_batch": tflags.use_mega_batch}
    if off is not None:
        switch[off](False)
    try:
        n = _decode_launches(tp, tcfg, B)
    finally:
        for fn in switch.values():
            fn(None)
    assert n == (3 if launches else 0)


@pytest.mark.parametrize("D", [4096, 200])
def test_rms_lanes_sums_in_one_order_at_every_batch_size(D):
    """step_bars.rms_lanes, the RMSNorm in K15's order of the first norm's
    sums (the reference of the card tests' feed check): each row's result
    is the same bits at B = 9 as alone, lies within f32 rounding of the JAX
    package's rmsnorm on the same f32 inputs, and D need not be a multiple
    of 32 (200: the last lanes add fewer squares)."""
    from easykv_tpu_torch.ops.cuda.step_bars import rms_lanes
    rng = np.random.default_rng(11)
    x = rng.standard_normal((9, D)).astype(np.float32) * 3
    w = rng.standard_normal(D).astype(np.float32)
    got = rms_lanes(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert all(torch.equal(got[b], rms_lanes(torch.from_numpy(x[b:b + 1]), torch.from_numpy(w),
                                             1e-5)[0]) for b in range(9))
    ref = np.asarray(jllama.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-6, atol=2e-6)
