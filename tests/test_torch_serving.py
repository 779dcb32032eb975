"""The port's serving layer against the JAX package's, on the CPU, at the JAX
serving tests' tiny config (vocab 96, hidden 48, 2 layers, 4 / 2 heads),
f32 weights carried across by models/convert.py:

  NativeScheduler        the same plan() actions, dump() rows, slots and
                         counts as the JAX binding over one scripted
                         submit / report sequence
  _prefill_chunk,        each step from the same cache (the JAX run's,
  _decode_step,          converted), f32 and int8 KV, roco: logits within
  _merged_step,          1e-4; pos and counter exact; float K/V within 1e-5
  _clear_row             and scores within 1e-5; int8 K/V within one step,
                         scales within 1e-5 relative (tests/test_torch_int8.py
                         says why); the rows a step leaves alone bit-identical
  run_all                ContinuousBatchEngine and ScheduledBatchEngine, roco,
                         recency with an EOS id, `random` with the JAX
                         engines' draws injected through the port's
                         _uniform, the int4 arithmetic fused tree with both
                         packages' one-kernel decode step off: greedy tokens
                         equal to the JAX engines' and (but for `random`,
                         whose draws differ) to the port's single-request
                         generate; every row invalid after run_all
  the merged tick        issues no separate decode step
  snapshot / resume      mid-flight, equal to the uninterrupted run
  the decode tick        keeps every buffer's and cache array's storage
                         across ticks (what lets the card replay a graph)
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import easykv_tpu
import easykv_tpu_torch
from easykv_tpu.cache import init_cache as jinit_cache
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.native import scheduler as jsched_bind
from easykv_tpu.ops import quant as jq
from easykv_tpu.policies import PHASE_DECODE
from easykv_tpu.policies import PolicySpec as JPolicySpec
from easykv_tpu.serving import ContinuousBatchEngine as JCBE
from easykv_tpu.serving import Request as JRequest
from easykv_tpu.serving.scheduled import ScheduledBatchEngine as JSBE

from easykv_tpu_torch import flags as tflags
from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.native import scheduler as tsched_bind
from easykv_tpu_torch.serving import ContinuousBatchEngine, Request, ScheduledBatchEngine
from easykv_tpu_torch.serving import engine as tserve
from easykv_tpu_torch.serving import scheduled as tsched

jserve = importlib.import_module("easykv_tpu.serving.engine")
jsched = importlib.import_module("easykv_tpu.serving.scheduled")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=96, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
ENGINE = dict(batch_slots=2, max_prompt=64, budget=8, temperature=1e-9, top_p=1.0)
PC = 16
LOGITS_TOL = 1e-4


@pytest.fixture(scope="module")
def trees():
    """{tree: (JAX CausalLM, port CausalLM on the CPU, int8 KV twin)}: f32, and the
    int4 arithmetic fused tree of the same weights."""
    jcfg = JModelConfig(**CFG)
    base = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    out = {}
    for name, jparams in (("f32", base), ("int4 arith fused", jq.fuse_gemv_params(
            jq.quantize_params_int4(base, group_size=16, layout="arith")))):
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        out[name] = (easykv_tpu.CausalLM(jcfg, jparams),
                     easykv_tpu_torch.CausalLM(ModelConfig(**CFG), tparams, device="cpu"),
                     easykv_tpu_torch.CausalLM(ModelConfig(**CFG), tparams, device="cpu",
                                               kv_quant=True))
    return out


@pytest.fixture
def per_layer_decode(monkeypatch):
    """Both packages decode the fused int4 tree per layer."""
    monkeypatch.setenv("EASYKV_TPU_MEGA", "0")
    tflags.use_mega(False)
    yield
    tflags.use_mega(None)


def t(x):
    return torch.from_numpy(np.array(x))


def cache_from_jax(jcache) -> KVCache:
    leaves = [t(x) for x in tuple(jcache)]
    quant = leaves[0].dtype == torch.int8
    return KVCache(*leaves[:6], *(leaves[6:8] if quant else (None, None)))


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def test_scheduler_plans_like_the_jax_binding():
    """One scripted sequence (priorities, a shared prefill budget with a
    per-request cap, a mixed tick, EOS, slot recycling, a duplicate id,
    dump / restore into a fresh scheduler) through both bindings: every
    plan, dump, slot and count equal, and the library built into the
    port's own build directory."""
    def script(bind):
        s = bind.NativeScheduler(2, 40, chunk_cap=24)
        seen = []

        def note(acts=None):
            seen.append((acts, s.dump(), s.num_waiting, s.num_active,
                         [s.slot_of(r) for r in range(1, 6)]))
        s.submit(1, 50, 3)
        s.submit(2, 10, 2, priority=1)
        s.submit(3, 30, 4)
        with pytest.raises(ValueError):
            s.submit(1, 4, 4)
        for tick in range(12):
            acts = [dataclasses.astuple(a) for a in s.plan()]
            note(acts)
            for kind, rid, _, _, n in acts:
                if kind == bind.PREFILL_CHUNK:
                    s.report_prefill(rid, n)
                else:
                    s.report_token(rid, is_eos=(rid == 3 and tick == 7))
            if tick == 2:
                s.submit(4, 20, 2, priority=2)
                s.submit(5, 5, 1)
        rows = s.dump()
        fresh = bind.NativeScheduler(2, 40, chunk_cap=24)
        for row in rows:
            fresh.restore(row)
        seen.append(([dataclasses.astuple(a) for a in fresh.plan()], fresh.dump()))
        s.close()
        fresh.close()
        return seen

    assert script(tsched_bind) == script(jsched_bind)
    assert tsched_bind.library_path().exists()
    assert tsched_bind.library_path().parent == tsched_bind.BUILD


# ---------------------------------------------------------------------------
# the step functions, each from the same cache
# ---------------------------------------------------------------------------

def _assert_cache(tc: KVCache, jc, before: KVCache, untouched, what):
    """pos / counter exact, K / V and scores close (int8: one step, scales
    1e-5 relative), and `untouched` rows of every array bit-identical to
    `before`."""
    for name in ("pos", "counter"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                      err_msg=f"{what}: {name}")
    for name in ("score", "score_sq"):
        np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=f"{what}: {name}")
    if tc.quantized:
        for name in ("k", "v"):
            diff = np.abs(getattr(tc, name).numpy().astype(np.int32)
                          - np.asarray(getattr(jc, name)).astype(np.int32))
            assert diff.max() <= 1, f"{what}: int8 {name} differs by {diff.max()}"
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       rtol=1e-5, atol=0, err_msg=f"{what}: {name}")
    else:
        for name in ("k", "v"):
            np.testing.assert_allclose(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                       atol=1e-5, err_msg=f"{what}: {name}")
    for f in dataclasses.fields(KVCache):
        a, b = getattr(tc, f.name), getattr(before, f.name)
        if a is not None:
            for r in untouched:
                assert torch.equal(a[:, r], b[:, r]), f"{what}: row {r} of {f.name} moved"


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_steps_match_jax_from_the_same_cache(trees, quant):
    """A JAX serving sequence on B = 3 rows (row 0's 23-token prompt in two
    chunks, row 2's 9-token one through a window that ends mid-chunk, six
    decode steps of rows 0 and 2 at budget 4, so both evict from the fifth;
    a merged tick that prefills row 1 while rows 0 and 2 decode; clearing
    row 0), each port step run from the JAX run's cache before it."""
    jm, tm, tm8 = trees["f32"]
    model = tm8 if quant else tm
    B, budget, S = 3, 4, 128
    spec = tserve.serving_spec("roco", budget)
    jspec = JPolicySpec("roco", PHASE_DECODE, 1, 4, spec.recent_window,
                        feasible_k=spec.feasible_k, protect_prompt=True)
    jc = jinit_cache(2, B, 2, S, 12, jnp.float32, quantized=quant)
    gen = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(5)
    p0, p2 = rng.integers(1, 90, size=23), rng.integers(1, 90, size=9)

    def prefill(jc, ids, c, row, window_end=None):
        chunk = np.zeros(PC, np.int32)
        part = ids[c * PC:(c + 1) * PC]
        chunk[:len(part)] = part
        before = cache_from_jax(jc)
        tc = cache_from_jax(jc)
        jl, jc = jserve._prefill_chunk(jm.cfg, None, PC, jm.params, jc, jnp.asarray(chunk),
                                       jnp.int32(c * PC), jnp.asarray([len(ids)], jnp.int32),
                                       jnp.int32(row), window_end)
        tl = tserve._prefill_chunk(model.cfg, PC, model.params, tc, t(chunk), c * PC, len(ids),
                                   row, window_end)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL)
        _assert_cache(tc, jc, before, [r for r in range(B) if r != row], f"prefill row {row}")
        return jc

    jc = prefill(jc, p0, 0, 0)
    jc = prefill(jc, p0, 1, 0)
    jc = prefill(jc, p2, 0, 2, window_end=7)
    plen = np.array([23, 0, 7], np.int32)
    active = np.array([True, False, True])
    tokens = np.array([5, 0, 17], np.int32)
    for g in range(6):
        gcount = np.array([g, 0, g], np.int32)
        before = cache_from_jax(jc)
        tc = cache_from_jax(jc)
        jl, jc = jserve._decode_step(jm.cfg, jspec, budget, jm.params, jc, jnp.asarray(tokens),
                                     jnp.asarray(active), jnp.asarray(plen), jnp.asarray(gcount),
                                     jax.random.PRNGKey(g))
        tl = tserve._decode_step(model.cfg, spec, budget, model.params, tc, t(tokens), t(active),
                                 t(plen), t(gcount), gen)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL)
        _assert_cache(tc, jc, before, [1], f"decode step {g}")
        tokens = np.asarray(jl).argmax(-1).astype(np.int32)
    p1 = rng.integers(1, 90, size=30)
    toks = np.zeros((B, PC), np.int32)
    toks[1] = p1[:PC]
    toks[:, -1] = np.where(active, tokens, toks[:, -1])
    args = [toks, np.array([0, 0, 0], np.int32), np.array([0, PC, 0], np.int32),
            np.array([23, 30, 7], np.int32), np.array([6, 0, 6], np.int32),
            np.array([True, False, True]), np.array([True, True, True])]
    before = cache_from_jax(jc)
    tc = cache_from_jax(jc)
    jl, jc = jserve._merged_step(jm.cfg, jspec, budget, PC, jm.params, jc,
                                 *map(jnp.asarray, args), jax.random.PRNGKey(9))
    tl = tserve._merged_step(model.cfg, spec, budget, PC, model.params, tc, *map(t, args), gen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_TOL)
    _assert_cache(tc, jc, before, [], "merged tick")
    assert (tc.pos[:, [0, 2]] >= 0).sum(-1).eq(torch.tensor([23 + budget, 7 + budget])[:, None]).all()
    before = KVCache(*(None if x is None else x.clone() for x in vars(tc).values()))
    tserve._clear_row(tc, 0)
    jc = jserve._clear_row(jc, jnp.int32(0))
    _assert_cache(tc, jc, before, [1, 2], "clear row 0")
    assert (tc.pos[:, 0] == -1).all()


# ---------------------------------------------------------------------------
# whole engines
# ---------------------------------------------------------------------------

def _jax_draws(monkeypatch, B):
    """Records the keys the JAX engines hand their decode and merged steps;
    returns the list of their (B,) uniform draws, in call order."""
    keys = []

    def recording(fn):
        def wrapped(*args, **kw):
            keys.append(args[-1])
            return fn(*args, **kw)
        return wrapped
    for mod in (jserve, jsched):
        for name in ("_decode_step", "_merged_step"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, recording(getattr(mod, name)))
    return lambda: [np.asarray(jax.random.uniform(jnp.asarray(k), (B,))) for k in keys]


def _port_single(model, prompt, policy, new, eos=()):
    return easykv_tpu_torch.generate(
        model, prompt, {"budget": ENGINE["budget"], "kv_policy": policy, "max_new_tokens": new,
                        "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": list(eos)},
        kv_mode="decoding")


ENGINE_CASES = [("continuous", "roco", "f32"), ("scheduled", "roco", "f32"),
                ("continuous", "recency-eos", "f32"), ("scheduled", "recency-eos", "f32"),
                ("continuous", "random", "f32"), ("scheduled", "random", "f32"),
                ("continuous", "roco", "int4 arith fused"),
                ("scheduled", "roco", "int4 arith fused")]


@pytest.mark.parametrize("kind,policy,tree", ENGINE_CASES,
                         ids=[f"{k}-{p}-{t_}" for k, p, t_ in ENGINE_CASES])
def test_run_all_matches_the_jax_engines(trees, kind, policy, tree, monkeypatch, capsys,
                                         per_layer_decode):
    """Three requests through two slots (one waits for a recycled slot):
    the port's greedy tokens equal the JAX engine's; roco and recency equal
    the port's single-request generate too. recency-eos: the first request's
    first greedy token is the EOS id, so it stops at once and its slot
    recycles. `random`: the port's _uniform returns the JAX engine's draws,
    step by step."""
    jm, tm, _ = trees[tree]
    rng = np.random.default_rng(sum(map(ord, kind + policy)))
    prompts = [rng.integers(1, 90, size=n) for n in (17, 40, 9)]
    new = [10, 6, 12]
    pol = policy.split("-")[0]
    eos = ()
    if policy.endswith("eos"):
        eos = (_port_single(tm, prompts[0], pol, 1)[0],)
    jcls, tcls = (JCBE, ContinuousBatchEngine) if kind == "continuous" else (JSBE,
                                                                            ScheduledBatchEngine)
    kw = dict(ENGINE, kv_policy=pol, eos_token_ids=eos, prefill_chunk=PC)
    draws = _jax_draws(monkeypatch, ENGINE["batch_slots"])
    jeng = jcls(jm, **kw)
    for i, p in enumerate(prompts):
        jeng.submit(JRequest(request_id=i, ids=p, max_new_tokens=new[i]))
    want = jeng.run_all()
    if pol == "random":
        it = iter(draws())
        monkeypatch.setattr(tgen, "_uniform", lambda *_: torch.tensor(next(it)))
    teng = tcls(tm, **kw)
    for i, p in enumerate(prompts):
        teng.submit(Request(request_id=i, ids=p, max_new_tokens=new[i]))
    got = teng.run_all()
    assert got == want
    if pol == "random":
        assert next(it, None) is None, "the port drew fewer times than the JAX engine"
    else:
        for i, p in enumerate(prompts):
            assert got[i] == _port_single(tm, p, pol, new[i], eos), f"request {i}"
    if eos:
        assert got[0] == [eos[0]]
    assert (teng.cache.pos == -1).all()
    capsys.readouterr()


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 90, size=n) for n in lens]


def test_merged_tick_issues_no_separate_decode_step(trees, monkeypatch):
    """A request decoding while a newcomer prefills: the tick that holds the
    prefill runs one merged step and no decode step, and the decoding
    request still emits its token in it."""
    _, tm, _ = trees["f32"]
    a, b = _prompts(3, (10, 48))
    eng = ScheduledBatchEngine(tm, **ENGINE, kv_policy="roco", prefill_chunk=PC)
    eng.submit(Request(request_id=1, ids=a, max_new_tokens=12))
    for _ in range(3):
        eng.tick()
    eng.submit(Request(request_id=2, ids=b, max_new_tokens=3))
    calls = {"decode": 0, "merged": 0}
    for name, key in (("_decode_step", "decode"), ("_merged_step", "merged")):
        mod = tserve if name == "_decode_step" else tsched
        real = getattr(mod, name)

        def counting(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, counting)
    ev = eng.tick()
    assert calls == {"decode": 0, "merged": 1}, calls
    assert any(rid == 1 for rid, _ in ev), "the decoding request starved during the prefill"
    monkeypatch.undo()
    outs = eng.run_all()
    assert len(outs[1]) == 12 and len(outs[2]) == 3


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_snapshot_resume_mid_flight(trees, quant, tmp_path):
    """An engine snapshotted after four ticks (one request decoding, one
    prefilling, one waiting), dropped and resumed into a fresh engine, ends
    with the outputs of an uninterrupted run, sampled at T = 1.0 (the
    generator's state travels with the snapshot)."""
    _, tm, tm8 = trees["f32"]
    model = tm8 if quant else tm
    prompts = _prompts(11, (15, 40, 12))
    kw = dict(ENGINE, kv_policy="roco", prefill_chunk=PC, temperature=1.0, top_p=0.9, seed=3)

    def fresh():
        eng = ScheduledBatchEngine(model, **kw)
        for i, p in enumerate(prompts):
            eng.submit(Request(request_id=i, ids=p, max_new_tokens=9))
        return eng
    expected = fresh().run_all()
    eng = fresh()
    for _ in range(4):
        eng.tick()
    assert eng.sched.num_waiting == 1 and len(eng.requests) == 3
    snap = str(tmp_path / "engine.snap")
    eng.snapshot(snap)
    del eng
    resumed = ScheduledBatchEngine.resume(snap, model, **kw)
    assert resumed.run_all() == expected


def test_decode_tick_keeps_its_storage(trees):
    """Ticks of both engines write their (B,) buffers and every cache array
    in place: a graph captured once reads and writes the same storage on
    every replay."""
    _, _, tm8 = trees["f32"]
    for cls in (ContinuousBatchEngine, ScheduledBatchEngine):
        eng = cls(tm8, **dict(ENGINE, budget=2), kv_policy="roco", prefill_chunk=PC)
        for i, p in enumerate(_prompts(4, (12, 20, 7))):
            eng.submit(Request(request_id=i, ids=p, max_new_tokens=10))
        tick = eng.decode_tick
        calls, body = [], tick._body
        tick._body = lambda: (calls.append(1), body())

        def held():
            bufs = [getattr(tick, n) for n in ("tokens", "active", "prompt_len", "gen_count",
                                               "out")]
            return [x.data_ptr() for x in bufs + [x for x in vars(eng.cache).values()
                                                   if x is not None]]
        before = held()
        for _ in range(12):
            eng.step() if cls is ContinuousBatchEngine else eng.tick()
        assert held() == before and len(calls) >= 8, len(calls)
        assert tick.graph is None and tick.replays == 0
