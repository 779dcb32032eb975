"""The one-kernel decode step K14 of the port against the JAX package's, on
the CPU, over the fused arithmetic-int4 tree (quantize_params_int4(layout=
"arith") + fuse_gemv_params) at tiny widths, L = 2, f32.

Why the float tolerances are not f32 rounding. K14's two-plane activation
feed rounds each product input to sr * (P1 + P2 / 127), sr = max|X_g| / 127:
where X / sr lands near a rounding boundary, a difference of one ulp in X
moves P2 by one and the fed value by max|X_g| / 127^2 (6.2e-5 of the
group's largest |x|). The two packages cannot agree to the ulp before that
rounding: XLA's CPU rsqrt, exp, cos and sin differ from PyTorch's in 5-34%
of their values, and their sums run in other orders. So a step of either
package moves under one-ulp noise of its input by the feed's step, not by
f32 rounding: test_k14_moves_by_the_feed_step_under_one_ulp measures it on
the plain K14 itself: its logits move by up to 4.0e-4 at these widths
(logits of |3-4|), more than 1e-4. So K14 alone is held to 5e-4 of each
output's largest |value|, and the lockstep's logits to 8e-4, twice that
largest movement, not to 1e-4.

The lockstep shows what that bar catches. It steps two wrong functions
beside K14 on the same tokens: K14 with each product's output rounded to
bf16 (what the per-layer scan does in bf16) must miss the bar in every
case (it reads 1.6-2.8e-2 at these seeds), and the port's per-layer scan
(mega flag off) must miss it with an int8 cache (1.8e-3 and 3.3e-3:
the cache's rounding spreads the difference). With a float cache the
scan differs from K14 only by the feed's own rounding, which moves the
logits by about as much as one-ulp noise does (4.7e-4 and 5.0e-4 at these
seeds, against K14's 2.8e-4 and 2.4e-4): no logits bar tells those two
apart, and the lockstep does not claim to.

- plain K14 against the Pallas `fused_decode_step` in interpret mode (its
  default two-plane int8 activation feed): MHA and GQA, a float and an int8
  cache, rope_pos given and absent, a sliding window, dead slots and a dead
  row, groups of 16 and 32 rows.
- a decode lockstep of the port's _decode_forward (K14's plain version)
  against the JAX package's under flags.use_pallas(True) (its K14, sidecar
  and row-write kernels in interpret mode, which is the path it takes on
  its chip), B = 1, roco and `full`, float and int8 KV, not streaming and
  streaming over the pre-rotated cache: logits within 8e-4, pos and
  counters equal after every step; K14 with bf16-rounded products, and
  with an int8 cache the per-layer scan, stepped beside it, miss that
  bar.
- `generate("decoding")` by both packages in that mode: equal greedy tokens
  and printed ratio line.
- gating: K14's launch count equals the decode steps for the fused tree at
  B = 1 (the plain version counts nothing, so the count is read off a
  stand-in that calls it); 0 at B = 2, for the split tree and with the
  port's mega flag off.
- the verbose confidence line (report_decoding_latency=True) of both
  packages in `decoding` and `encoding`, parsed numbers within 1e-4.
"""
import importlib
import re
from unittest import mock

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
from easykv_tpu.ops.pallas.fused_decode import fused_decode_step as jk14
from easykv_tpu.policies import evict_cache as jevict_cache
from easykv_tpu.ops.rope import rope_base_for as jrope_base, rope_inv_freq as jinv_freq

from easykv_tpu_torch import flags as tflags
from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.cuda import fused_decode as k14_mod

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)


def t(x):
    return torch.from_numpy(np.array(x))


def _fused(base, group):
    return jq.materialize_params(jq.fuse_gemv_params(
        jq.quantize_params_int4(base, group_size=group, layout="arith")))


@pytest.fixture(scope="module")
def trees():
    """{(Hkv, group): (jcfg, JAX tree, tcfg, port tree)}."""
    out = {}
    for hkv in (2, 4):
        cfg = dict(CFG, num_key_value_heads=hkv)
        jcfg = JModelConfig(**cfg)
        base = jllama.init_params(jcfg, jax.random.PRNGKey(hkv))
        for group in (16, 32):
            jp = _fused(base, group)
            tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
            out[(hkv, group)] = (jcfg, jp, ModelConfig(**cfg), tp)
    return out


K14_TOL = 5e-4       # of each output's largest |value|: a few steps of the feed (see above)
LOGITS_TOL = 8e-4    # twice the largest one-ulp movement of the logits (see above)


K14_CASES = {  # Hkv, cache, rope_pos, sliding window, group, dead slots, dead row
    "mha-f32": (4, "f32", False, None, 16, False, False),
    "gqa-int8-rope_pos": (2, "int8", True, None, 16, False, False),
    "gqa-f32-window-dead-slots-group32": (2, "f32", True, 9, 32, True, False),
    "mha-int8-dead-row-group32": (4, "int8", False, None, 32, True, True),
}


@pytest.mark.parametrize("case", list(K14_CASES))
def test_plain_k14_matches_pallas(trees, case):
    hkv, kv, with_rope, window, group, dead, dead_row = K14_CASES[case]
    jcfg, jp, tcfg, tp = trees[(hkv, group)]
    if window is not None:
        jcfg = JModelConfig(**dict(CFG, num_key_value_heads=hkv, sliding_window=window))
        tcfg = ModelConfig(**dict(CFG, num_key_value_heads=hkv, sliding_window=window))
    L, S, Dh, D = 2, 48, tcfg.head_dim, tcfg.hidden_size
    rng = np.random.default_rng(sum(map(ord, case)))
    k = rng.standard_normal((L, 1, hkv, S, Dh)).astype(np.float32)
    v = rng.standard_normal((L, 1, hkv, S, Dh)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (L, 1, hkv, S)).copy()
    pos[..., 40:] = -1
    if dead:
        pos[rng.random(pos.shape) < 0.3] = -1
    q_pos = np.array([-1 if dead_row else 40], np.int32)
    rope_pos = np.array([33], np.int32) if with_rope else None
    h0 = (rng.standard_normal((1, D)) * 0.5).astype(np.float32)
    scales = ()
    if kv == "int8":
        (k, ks), (v, vs) = (jax.tree.map(np.asarray, jquantize_kv(jnp.asarray(x)))
                            for x in (k, v))
        scales = (ks, vs)
    ref = jk14(jp["layers"], jcfg, *(jnp.asarray(x) for x in (k, v, pos, h0, q_pos)),
               *(jnp.asarray(x) for x in scales),
               rope_pos=None if rope_pos is None else jnp.asarray(rope_pos), interpret=True)
    got = k14_mod.fused_decode_step(tp.layers, tcfg, *(t(x) for x in (k, v, pos, h0, q_pos)),
                                    *(t(x) for x in scales),
                                    rope_pos=None if rope_pos is None else t(rope_pos))
    names = ("h", "kn", "vn", "probs", "p_new")
    for name, a, b in zip(names, got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=K14_TOL * max(np.abs(b).max(), 1e-30),
                                   err_msg=name)
    if dead_row:
        assert not got[3].any() and not got[4].any()


def test_k14_moves_by_the_feed_step_under_one_ulp(trees):
    """The plain K14 against itself, h0 moved by at most one ulp in 16 seeded
    ways: its logits move by more than f32 rounding would (above 1e-4
    absolute, a rounding step of the two-plane feed) and stay within the
    bars above."""
    _, _, tcfg, tp = trees[(2, 16)]
    L, S, Dh = 2, 48, tcfg.head_dim
    rng = np.random.default_rng(0)
    k, v = (t(rng.standard_normal((L, 1, 2, S, Dh)).astype(np.float32)) for _ in range(2))
    pos = t(np.broadcast_to(np.arange(S, dtype=np.int32), (L, 1, 2, S)))
    h0 = t((rng.standard_normal((1, tcfg.hidden_size)) * 0.5).astype(np.float32))
    q_pos = torch.tensor([S - 1], dtype=torch.int32)

    def step(h):
        out = k14_mod.fused_decode_step(tp.layers, tcfg, k, v, pos, h, q_pos)
        return out[0], tllama._logits_tail(out[0][None], tp, tcfg)

    h_ref, log_ref = step(h0)
    moved_h, moved_log = [], []
    for seed in range(16):
        up = torch.rand(h0.shape, generator=torch.Generator().manual_seed(seed)) < 0.5
        h1 = torch.where(up, torch.nextafter(h0, torch.full_like(h0, np.inf)), h0)
        h, logits = step(h1)
        moved_h.append(float((h - h_ref).abs().max() / h_ref.abs().max()))
        moved_log.append(float((logits - log_ref).abs().max()))
    assert max(moved_log) > 1e-4
    assert max(moved_log) < LOGITS_TOL and max(moved_h) < K14_TOL


def _cache_from_jax(cache) -> KVCache:
    leaves = [np.array(x) for x in tuple(cache)]
    quant = leaves[0].dtype == np.int8
    return KVCache(*map(torch.from_numpy, leaves[:6]),
                   *(map(torch.from_numpy, leaves[6:8]) if quant else (None, None)))


LOCKSTEP = {  # policy, int8 KV, streaming over the pre-rotated cache
    "roco-f32": ("roco", False, False),
    "full-int8": ("full", True, False),
    "roco-int8-streaming": ("roco", True, True),
    "full-f32-streaming": ("full", False, True),
}


@pytest.mark.parametrize("case", list(LOCKSTEP))
def test_decode_lockstep_matches_pallas(trees, case, monkeypatch):
    """B = 1, 10 steps, 4 past a budget of 6; K14 once a step on both
    sides. Two more port caches step on the same tokens through wrong
    functions: K14 with bf16-rounded products, and the per-layer scan (mega
    flag off). The first must miss the bar at some step, and the second
    too with an int8 cache (see the module docstring)."""
    policy, quant, streaming = LOCKSTEP[case]
    jcfg, jp, tcfg, tp = trees[(2, 16)]
    P, budget, steps = 24, 6, 10
    rng = np.random.default_rng(len(case))
    ids = rng.integers(1, 120, size=(1, P)).astype(np.int32)
    plen = np.full((1,), P, np.int32)
    common = dict(policy=policy, length=P, budget=budget, recent_window_dec=int(budget * 0.3),
                  kv_quant=quant, streaming=streaming)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", stride=1, **common)
    spec_j = jst.decode_spec()
    spec_t = tgen.EngineStatics(cfg=tcfg, **common).decode_spec()
    cache, _ = jax.jit(lambda c: jgen._prefill(jst, jp, c, jnp.asarray(ids), jnp.asarray(plen),
                                               None, "zero"))(
        jgen._engine_cache(jst, 1, P + (budget + 1 if policy == "roco" else steps)))
    if streaming:
        cache = jax.jit(lambda c: jgen._prerotate_cache(c, jcfg))(cache)
    tcache, scache, bcache = (_cache_from_jax(cache) for _ in range(3))
    stream = (tllama.stream_tables(tcache.pos.shape[-1], tcfg, "cpu", "prerotated")
              if streaming else None)
    rot_if = jinv_freq(jcfg.head_dim, jrope_base(jcfg))
    calls = []
    monkeypatch.setattr(tllama, "fused_decode_step",
                        lambda *a, **kw: calls.append(1) or k14_mod.fused_decode_step(*a, **kw))

    @jax.jit
    def jstep(c, tok, ctx):
        logits, c = jllama.forward(jp, jcfg, c, tok, ctx, spec_j, streaming=streaming,
                                   ordered=streaming, prerotated=streaming, fold_evict=False)
        if spec_j is None:
            return logits, c
        pos_mid = c.pos
        c = jevict_cache(c, spec_j, ctx.next_pos, ctx.prompt_len, ctx.rand_rank, ctx.evict_gate)
        if streaming:
            c = jgen._compact_one(c, pos_mid, rot_inv_freq=rot_if)
        return logits, c

    toks = rng.integers(1, 120, size=(steps, 1)).astype(np.int32)
    miss = {"bf16": 0.0, "scan": 0.0}
    real = k14_mod._product
    jflags.use_pallas(True)
    try:
        for g in range(steps):
            tok_pos = np.full((1,), P + g, np.int32)
            ctx_np = dict(
                q_pos=tok_pos[:, None], token_valid=np.ones((1, 1), bool),
                counter_init=np.full((1, 1), max(budget - g, 0), np.float32),
                next_pos=tok_pos + 1, prompt_len=plen,
                evict_gate=np.full((1,), policy != "full" and g + 1 > budget),
                update_gate=np.ones((1,), bool), rand_rank=np.zeros((1,), np.int32))
            jctx = jllama.StepCtx(**{k: jnp.asarray(v) for k, v in ctx_np.items()})
            tctx = tllama.StepCtx(**{k: t(v) for k, v in ctx_np.items()})
            jlog, cache = jstep(cache, jnp.asarray(toks[g][:, None]), jctx)
            tlog = tllama._decode_forward(tp, tcfg, tcache, t(toks[g][:, None]), tctx, spec_t,
                                          stream)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=LOGITS_TOL,
                                       err_msg=f"logits, step {g}")
            np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(cache.pos),
                                          err_msg=f"pos, step {g}")
            np.testing.assert_array_equal(tcache.counter.numpy(), np.asarray(cache.counter),
                                          err_msg=f"counter, step {g}")
            with mock.patch.object(k14_mod, "_product", lambda x, w: real(x, w).to(
                    torch.bfloat16).float()):
                blog = tllama._decode_forward(tp, tcfg, bcache, t(toks[g][:, None]), tctx,
                                              spec_t, stream)
            tflags.use_mega(False)
            try:
                slog = tllama._decode_forward(tp, tcfg, scache, t(toks[g][:, None]), tctx,
                                              spec_t, stream)
            finally:
                tflags.use_mega(None)
            for name, log in (("bf16", blog), ("scan", slog)):
                miss[name] = max(miss[name], np.abs(log.numpy() - np.asarray(jlog)).max())
    finally:
        jflags.use_pallas(None)
    assert len(calls) == 2 * steps                   # K14 and its bf16 variant
    assert miss["bf16"] > LOGITS_TOL, miss
    if quant:
        assert miss["scan"] > LOGITS_TOL, miss


def _ratio(text):
    return re.findall(r"KV cache budget ratio: .*", text)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_generate_decoding_matches_pallas(trees, kv, capsys):
    jcfg, jp, tcfg, tp = trees[(2, 16)]
    jm = easykv_tpu.CausalLM(jcfg, jp, kv_quant=kv == "int8")
    tm = easykv_tpu_torch.CausalLM(tcfg, tp, device="cpu", kv_quant=kv == "int8")
    ids = np.random.default_rng(5 + len(kv)).integers(1, 120, size=(30,))
    gc = {"budget": 8, "kv_policy": "roco", "max_new_tokens": 24, "temperature": 1e-9,
          "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    jflags.use_pallas(True)
    try:
        ref = easykv_tpu.generate(jm, ids, gc, kv_mode="decoding")
    finally:
        jflags.use_pallas(None)
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="decoding")
    assert out == ref and len(out) == 24
    assert _ratio(capsys.readouterr().out) == jprint and len(jprint) == 1


def _decode_once(params, cfg, B, n=3):
    """Decode n tokens at B rows through _run_decoding; returns the number
    of K14 launches (counted by a stand-in around the plain version)."""
    P = 16
    ids = torch.from_numpy(np.random.default_rng(B).integers(1, 120, size=(B, P)).astype(np.int32))
    st = tgen.EngineStatics(cfg=cfg, policy="roco", length=P, budget=4, max_new_tokens=n,
                            recent_window_dec=1)
    calls = []
    real = tllama.fused_decode_step
    tllama.fused_decode_step = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        tgen._run_decoding(st, params, ids, torch.full((B,), P, dtype=torch.int32), 1e-9, 1.0,
                           torch.Generator().manual_seed(0), torch.float32)
    finally:
        tllama.fused_decode_step = real
    return len(calls)


@pytest.mark.parametrize("case", ["fused-B1", "fused-B2", "split-B1", "mega-off-B1"])
def test_k14_gating(trees, case):
    jcfg, jp, tcfg, tp = trees[(2, 16)]
    if case == "split-B1":
        base = jllama.init_params(jcfg, jax.random.PRNGKey(2))
        split = jq.quantize_params_int4(base, group_size=16, layout="arith")
        tp = from_jax_params(jax.tree.map(np.asarray, split), device="cpu")
    assert tllama.mega_tree(tp) == (case != "split-B1")
    if case == "mega-off-B1":
        tflags.use_mega(False)
    try:
        n = _decode_once(tp, tcfg, 2 if case == "fused-B2" else 1)
    finally:
        tflags.use_mega(None)
    assert n == (3 if case == "fused-B1" else 0)


def test_k14_layer_table_follows_the_layers(trees):
    """The per-layer pointer table is kept while every tensor it points at
    is still the layers' own; a weight or a layer put in place of one, in
    any layer, builds a new table that points at the new tensor."""
    import copy
    _, _, tcfg, tp = trees[(2, 16)]
    layers = copy.deepcopy(tp.layers)
    D, F_, Hq, Hkv, Dh = (tcfg.hidden_size, tcfg.intermediate_size, tcfg.num_attention_heads,
                          tcfg.num_key_value_heads, tcfg.head_dim)
    carriers = {"wqkv": (D // 2, (Hq + 2 * Hkv) * Dh), "wo": (Hq * Dh // 2, D),
                "wgu": (D // 2, 2 * F_), "wd": (F_ // 2, D)}
    table = lambda: k14_mod._layer_table(layers, carriers, torch.float32,  # noqa: E731
                                         torch.device("cpu"))[0]
    first = table()
    assert table() is first
    wo = layers[1].wo
    wo.register_buffer("gs3", wo["gs3"].clone())          # layer 1's wo scales replaced
    second = table()
    assert second is not first
    assert int(second[1, 3]) == wo["gs3"].data_ptr() != int(first[1, 3])
    layers[0].wgu = copy.deepcopy(layers[0].wgu)          # layer 0's gate|up replaced
    third = table()
    assert third is not second and int(third[0, 4]) == layers[0].wgu["q4a"].data_ptr()
    layers[1].ln_mlp.data = layers[1].ln_mlp.data.clone()  # a norm's storage swapped
    fourth = table()
    assert fourth is not third and int(fourth[1, 9]) == layers[1].ln_mlp.data_ptr()
    assert table() is fourth


CONF = re.compile(r"Decoding confidence exp\(-entropy\): mean (\S+) min (\S+); "
                  r"token prob: mean (\S+) min (\S+)")


@pytest.mark.parametrize("mode", ["decoding", "encoding"])
def test_confidence_line_matches_jax(trees, mode, capsys):
    """temperature 1 with top_p 0: the nucleus holds only the most likely
    token, so both packages decode greedily while the raw softmax they
    report on is a real distribution."""
    jcfg, jp, tcfg, tp = trees[(2, 16)]
    jm = easykv_tpu.CausalLM(jcfg, jp)
    tm = easykv_tpu_torch.CausalLM(tcfg, tp, device="cpu")
    ids = np.random.default_rng(11).integers(1, 120, size=(40,))
    gc = {"budget": 8 if mode == "decoding" else 0.5, "kv_policy": "roco",
          "max_new_tokens": 10, "temperature": 1.0, "top_p": 0.0, "eos_token_ids": [],
          "seed": 3}
    kw = dict(kv_mode=mode, stride=8 if mode == "encoding" else 1,
              report_decoding_latency=True)
    ref = easykv_tpu.generate(jm, ids, gc, **kw)
    jout = capsys.readouterr().out
    out = easykv_tpu_torch.generate(tm, ids, gc, **kw)
    tout = capsys.readouterr().out
    assert out == ref
    jl, tl = jout.strip().splitlines(), tout.strip().splitlines()
    assert len(jl) == len(tl) == 3
    assert _ratio(jout) == _ratio(tout)
    assert jl[1].startswith("Per-step decoding latency") and tl[1].startswith(
        "Per-step decoding latency")
    jnum, tnum = CONF.fullmatch(jl[2]), CONF.fullmatch(tl[2])
    assert jnum and tnum, (jl[2], tl[2])
    np.testing.assert_allclose([float(x) for x in tnum.groups()],
                               [float(x) for x in jnum.groups()], rtol=0, atol=1e-4)
    assert float(tnum.group(1)) < 1.0          # a spread distribution, not one-hot


# (D, F, Hq, Hkv, Dh, groups) of K14's widths: LLaMa-2-7B (groups of 128
# packed rows, wd in 43), Mistral-7B (GQA), the card tests' small and ragged
# widths (groups of 64 and 12 rows)
K14_WIDTHS = {"7b": (4096, 11008, 32, 32, 128, (16, 16, 16, 43)),
              "mistral": (4096, 14336, 32, 8, 128, (16, 16, 16, 56)),
              "small": (256, 512, 4, 2, 64, (2, 2, 2, 4)),
              "ragged": (72, 192, 9, 9, 8, (3, 3, 3, 8))}


@pytest.mark.parametrize("blocks", [1, 3, 64, 132, 200])
@pytest.mark.parametrize("width", list(K14_WIDTHS))
def test_k14_items_cover_every_unit_once(width, blocks):
    """K14's dealing of each product's items (csrc/fused_decode.cu
    deal_of, mirrored by fused_decode.items): over the blocks and their
    slot warps, every (scale group, 128 columns) of every product is taken
    exactly once, so every (group, column) of the carrier is; a block
    needs one group's input where the blocks outnumber the groups; and the
    item a warp asks for ahead of a product (its first) is the one it
    takes first."""
    D, F_, Hq, Hkv, Dh, groups = K14_WIDTHS[width]
    for P in k14_mod.products(D, F_, Hq, Hkv, Dh, groups):
        for slots in (1, 12):
            taken = k14_mod.items(P, blocks, slots)
            hits = np.zeros((P.gch, P.tiles), np.int64)
            for (b, w), its in taken.items():
                for j, t in its:
                    hits[j, t] += 1
                if blocks >= P.gch:
                    assert len({j for j, _ in its}) <= 1
                if its:   # the ahead item: group b mod gch (or b), tile rank + nb w
                    spread = blocks >= P.gch
                    j0 = b % P.gch if spread else b
                    nb = (blocks - j0 + P.gch - 1) // P.gch if spread else 1
                    assert its[0] == (j0, (b // P.gch if spread else 0) + nb * w)
            assert (hits == 1).all()
            cols = np.zeros(P.N, np.int64)
            for t in range(P.tiles):
                cols[t * k14_mod.TILE:(t + 1) * k14_mod.TILE] += 1
            assert (cols == 1).all() and P.G * P.gch == P.kh


@pytest.mark.parametrize("width,kv_bytes", [(w, b) for w in K14_WIDTHS for b in (1, 2, 4)
                                             if K14_WIDTHS[w][4] % (16 // b) == 0])
def test_k14_slots_and_prep_fit_shared_memory(width, kv_bytes):
    """The carrier slots (which the attention's chunk shares), their
    barriers and the input prep fit a block's 232,448 bytes of shared
    memory at the main path's cache (S = 768) and at the card tests' (S =
    256), with 12 slot warps at every width here."""
    D, F_, Hq, Hkv, Dh, groups = K14_WIDTHS[width]
    prods = k14_mod.products(D, F_, Hq, Hkv, Dh, groups)
    for S in (256, 768):
        slot, slots, total = k14_mod.slot_layout(prods, Hq, Hkv, Dh, S, kv_bytes)
        assert total <= 232448 and slots == k14_mod.MAX_SLOTS
        assert slot % 128 == 0 and slot >= 4 * k14_mod.TILE + max(P.G for P in prods) * 128
