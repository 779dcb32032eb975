"""The decode loop split into its carry, one step and _drive (the port's
counterpart of the JAX package's on-device lax.while_loop, replayed on the
card as a CUDA graph of the step), on the CPU, where _drive calls the
step eagerly: the step keeps the storage of every carried tensor and cache
array (what lets a graph replay it), the driven loop gives the JAX
_decode_loop's tokens, final pos, counters and kv_len (f32 and int8 KV;
roco, `random` with the JAX loop's draws injected, `full`; StreamingLLM
over the pre-rotated cache and over the rank cache), and _decode_forward
still writes the step's K/V rows through plain K2 and then plain K3.
Tiny configs, float32."""
import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama

from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import llama as tllama
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops.cuda import row_write, sidecar_update

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)
B, P, BUDGET, NEW, STRIDE = 2, 24, 6, 14, 8


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(4))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, ModelConfig(**CFG), tparams


def _cache(jcache) -> KVCache:
    leaves = [torch.from_numpy(np.array(x)) for x in tuple(jcache)]
    quant = leaves[0].dtype == torch.int8
    return KVCache(*leaves[:6], *(leaves[6:8] if quant else (None, None)))


def _statics(jcfg, tcfg, policy, quant, mode):
    """policy "stream": StreamingLLM roco (the ordered, pre-rotated cache in
    `decoding`; encoding_decoding is always StreamingLLM roco here)."""
    streaming = policy == "stream" or mode != "decoding"
    kw = dict(policy="roco" if streaming else policy, length=P, budget=BUDGET,
              max_new_tokens=NEW, recent_window_dec=int(BUDGET * 0.3), kv_quant=quant,
              streaming=streaming, mode=mode, stride=1)
    if mode != "decoding":
        idx, r_idx = jgen.stride_align_encdec(P, BUDGET + STRIDE, STRIDE)
        kw.update(budget=BUDGET + STRIDE, idx=idx, r_idx=r_idx, stride=STRIDE,
                  recent_window=int((BUDGET + STRIDE) * 0.1))
    return jgen.EngineStatics(cfg=jcfg, **kw), tgen.EngineStatics(cfg=tcfg, **kw)


_PREFILLED = {}


def _prefilled(jparams, quant, mode):
    """The JAX prefill of a fixed prompt, one compile per cache kind and
    mode: (cache, last logits)."""
    if (quant, mode) in _PREFILLED:
        return _PREFILLED[(quant, mode)]
    jst = _statics(JModelConfig(**CFG), ModelConfig(**CFG), "roco", quant, mode)[0]
    ids = np.random.default_rng(0).integers(1, 120, size=(B, P)).astype(np.int32)
    kind = "zero" if mode == "decoding" else "encode"   # the counters each mode starts from
    _PREFILLED[(quant, mode)] = jax.jit(
        lambda c: jgen._prefill(jst, jparams, c, jnp.asarray(ids), jnp.full((B,), P, jnp.int32),
                                None, kind))(jgen._engine_cache(jst, B, P + NEW + BUDGET + STRIDE))
    return _PREFILLED[(quant, mode)]


def _start(models, policy, quant, mode="decoding"):
    """Both packages' statics and the same prefilled cache (the JAX prefill's,
    converted), first logits and positions."""
    jcfg, jparams, tcfg, _ = models
    jcache, logits = _prefilled(jparams, quant, mode)
    return (*_statics(jcfg, tcfg, policy, quant, mode), jcache, logits, np.full((B,), P, np.int32))


def _spec_mode(st):
    if st.mode != "decoding":
        return st.encdec_decode_spec(), "always"
    return st.decode_spec(), "none" if st.policy == "full" else "budget"


@contextlib.contextmanager
def _final_carry(monkeypatch):
    """The JAX _decode_loop's final while_loop carry (its cache among it)."""
    seen = []
    real = jax.lax.while_loop

    def loop(cond, body, init):
        out = real(cond, body, init)
        seen.append(out)
        return out
    monkeypatch.setattr(jax.lax, "while_loop", loop)
    yield seen
    monkeypatch.setattr(jax.lax, "while_loop", real)


CASES = [("roco", False, "decoding"), ("random", True, "decoding"), ("full", False, "decoding"),
         ("stream", False, "decoding"), ("stream", True, "encoding_decoding")]


@pytest.mark.parametrize("policy,quant,mode", CASES,
                         ids=[f"{p}-{'int8' if q else 'f32'}-{m}" for p, q, m in CASES])
def test_driven_loop_matches_jax_decode_loop(models, policy, quant, mode, monkeypatch):
    """The port's _decode_loop (eager on the CPU) against the JAX package's
    from the same prefilled cache and logits, greedy: equal tokens, final
    pos and counters and kv_len. `random` draws the JAX loop's own
    uniforms (fold_in(seed, step + 1)) through the port's _uniform. The
    encoding_decoding case decodes over the rank cache with carried ranks
    (StreamingLLM, an eviction a step)."""
    _, jparams, _, tparams = models
    jst, tst, jcache, logits, plen = _start(models, policy, quant, mode)
    seed = jax.random.PRNGKey(9)
    draws = iter(np.asarray(jax.random.uniform(jax.random.fold_in(seed, n + 1), (B,)))
                 for n in range(NEW))
    monkeypatch.setattr(tgen, "_uniform", lambda *_: torch.tensor(next(draws)))
    tcache = _cache(jcache)
    jspec, jmode = _spec_mode(jst)
    with _final_carry(monkeypatch) as carry:
        jres = jgen._decode_loop(jst, jparams, jcache, logits, jnp.asarray(plen),
                                 jnp.asarray(plen), jnp.asarray(plen), jspec, seed,
                                 jnp.float32(1e-9), jnp.float32(1.0), jmode)
    jfinal = carry[-1][0]
    tspec, tmode = _spec_mode(tst)
    pl = torch.from_numpy(plen)
    tres = tgen._decode_loop(tst, tparams, tcache, torch.from_numpy(np.array(logits)), pl, pl,
                             pl, tspec, torch.Generator().manual_seed(0), 1e-9, 1.0, tmode)
    np.testing.assert_array_equal(tres.out_ids.numpy(), np.asarray(jres.out_ids))
    np.testing.assert_array_equal(tres.kv_len.numpy(), np.asarray(jres.kv_len))
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jfinal.pos))
    np.testing.assert_array_equal(tcache.counter.numpy(), np.asarray(jfinal.counter))
    assert bool(tres.finite) and tres.capture_s == 0 and tres.graph_nodes == 0


def test_step_keeps_the_storage_of_its_carry_and_cache(models):
    """_DecodeStep driven for a few steps (roco over an int8 cache, evicting
    from the first step, StreamingLLM rank cache with carried ranks) writes
    every carried tensor and cache array in place: a graph captured once
    would read and write the same storage on every replay."""
    for policy, quant, mode in (("roco", True, "decoding"), ("stream", True, "encoding_decoding")):
        _, _, _, tparams = models
        _, tst, jcache, logits, plen = _start(models, policy, quant, mode)
        tst = tgen.dataclasses.replace(tst, budget=1) if mode == "decoding" else tst
        cache = _cache(jcache)
        spec, emode = _spec_mode(tst)
        ranks = tllama.age_ranks_all(cache.pos) if mode != "decoding" else None
        stream = (tllama.stream_tables(cache.pos.shape[-1], tst.cfg, "cpu", "rank")
                  if mode != "decoding" else None)
        first = torch.from_numpy(np.array(logits))
        c = tgen._Carry(torch.zeros(1, dtype=torch.int64), first.clone(),
                        torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32),
                        torch.from_numpy(plen).clone(), torch.isfinite(first).all(),
                        torch.full((B, NEW), -1, dtype=torch.int32), None, None, ranks)
        pl = torch.from_numpy(plen)
        # roco's decode eviction is folded into K2; the encdec one runs after the forward
        step = tgen._DecodeStep(tst, tparams, cache, c, pl, pl, spec,
                                torch.Generator().manual_seed(0), 1e-9, 1.0, emode, stream,
                                ordered=False, evicts=mode != "decoding")
        held = [(n, t.data_ptr()) for n, t in list(c._asdict().items()) + list(vars(cache).items())
                if t is not None]
        pos0 = cache.pos.clone()
        for _ in range(4):
            step()
        assert [(n, t.data_ptr()) for n, t in list(c._asdict().items())
                + list(vars(cache).items()) if t is not None] == held
        assert int(c.n) == 4 and (c.out[:, :4] >= 0).all() and (c.out[:, 4:] == -1).all()
        assert not torch.equal(cache.pos, pos0) and (c.g == 4).all()
        if ranks is not None:
            assert torch.equal(c.ranks, tllama.age_ranks_all(cache.pos))


def test_decode_forward_on_cpu_runs_plain_k2_then_plain_k3(models, monkeypatch):
    """On CPU tensors _decode_forward hands the step's rows to K2's wrapper,
    which runs the plain K2 and then the plain K3 at the write slot: the
    rows land where the plain K2 + write_rows_plain sequence puts them."""
    _, _, tcfg, tparams = models
    calls = []
    real = row_write.write_rows_plain

    def plain_k3(k, v, kn, vn, slots):
        calls.append(slots.clone())
        return real(k, v, kn, vn, slots)
    monkeypatch.setattr(sidecar_update, "write_rows_plain", plain_k3)
    _, tst, jcache, _, plen = _start(models, "roco", True)
    cache, twin = _cache(jcache), _cache(jcache)
    tok = torch.tensor([[5], [9]], dtype=torch.int32)
    on = torch.ones(B, dtype=torch.bool)
    ctx = tllama.StepCtx(q_pos=torch.full((B, 1), P, dtype=torch.int32), token_valid=on[:, None],
                         counter_init=torch.zeros((B, 1)),
                         next_pos=torch.full((B,), P + 1, dtype=torch.int32),
                         prompt_len=torch.from_numpy(plen), evict_gate=on, update_gate=on,
                         rand_rank=torch.zeros(B, dtype=torch.int32))
    spec = tst.decode_spec()
    tllama._decode_forward(tparams, tcfg, cache, tok, ctx, spec)
    assert len(calls) == 1
    # the same step, its rows written by hand where the plain K2 chose
    real_k2 = sidecar_update.fused_write_update_plain
    seen = {}

    def k2_without_rows(*a, k=None, v=None, kn=None, vn=None, **kw):
        res = real_k2(*a, **kw)
        seen.update(slot=res[4], kn=kn, vn=vn)
        return res
    monkeypatch.setattr(tllama, "fused_write_update", k2_without_rows)
    tllama._decode_forward(tparams, tcfg, twin, tok, ctx, spec)
    real(twin.k, twin.v, seen["kn"], seen["vn"], seen["slot"][..., 0])
    assert torch.equal(calls[0], seen["slot"][..., 0])
    for name in ("k", "v", "pos", "counter", "k_scale", "v_scale"):
        assert torch.equal(getattr(cache, name), getattr(twin, name)), name
