"""The port's sequence-parallel ring prefill on the CPU against the JAX
package's.

Each sp width, 2 and 4, is one spawn of gloo ranks
(tests/test_torch_sp_worker.py, which imports only the port; a file://
rendezvous under tmp_path, one thread a rank) that runs all of its cases,
while this process computes the JAX references on sub-meshes ("sp",) of the
virtual 8-device mesh (tests/conftest.py):

  * ring_attention and ring_attention_scores, each rank's columns put
    together, against the JAX functions (GQA rep 2 at sp = 2, MHA at 4; B =
    2, padding keys): out within 1e-5, Σp / Σp² within 1e-6 + 1e-5 relative;
  * `_prefill` with the ring (B = 2, a prefix of 45 tokens, which 2 and 4
    do not divide, and a row of 38) against JAX `_prefill` with st.sp, f32
    KV at sp = 2, int8 KV at 4: pos and counter exact, the rest within
    tests/test_sp_prefill.py's bars (int8: K / V within one int8 step and
    the scales within 1e-5 relative, as the port's int8 lockstep holds the
    two packages' f32 projections), every rank's cache bit-identical;
  * generate under set_sp_mesh against JAX generate under its set_sp_mesh:
    at sp = 2 `encoding` (roco with keep_attention, h2o_head without),
    `decoding` and `ppl`, at 4 `encoding` (h2o_head with keep_attention) and
    `ppl`: greedy tokens and the printed budget ratio equal, ppl within
    1e-4 relative, and the ring taken once a run.

Without a spawn: a prefix whose padding to the sp width overflows the
cache takes the chunked path in both packages, and an sp mesh together with
a (data, model) mesh raises.
"""
import contextlib
import importlib
import io
import multiprocessing
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import easykv_tpu
import test_torch_sp_worker as W
from easykv_tpu import flags as jflags
from easykv_tpu.cache import init_cache as jinit_cache
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.engine.generate import EngineStatics as JEngineStatics
from easykv_tpu.engine.generate import _prefill as jprefill
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops.ring_attention import ring_attention as jring_attention

WIDTHS = (2, 4)
RATIO = re.compile(r"KV [Cc]ache [Bb]udget ratio.*")
GC = dict(max_new_tokens=8, temperature=1e-9, top_p=1.0, eos_token_ids=[])


def _enc(policy, keep):
    return dict(mode="encoding", stride=8, ids="doc",
                gc=dict(GC, budget=0.5, kv_policy=policy, keep_attention=keep))


GEN = {
    "enc_roco": _enc("roco", True),
    "enc_h2o_keep": _enc("h2o_head", True),
    "enc_h2o": _enc("h2o_head", False),
    "dec": dict(mode="decoding", stride=1, ids="b2",
                gc=dict(GC, budget=8, kv_policy="roco", max_new_tokens=12)),
    "ppl": dict(mode="ppl", stride=8, ids="doc",
                gc=dict(budget=0.5, kv_policy="roco", keep_attention=True)),
}
# the cases of each sp width: each JAX reference compiles its own run, so
# the cases are dealt between the widths, each width holding tokens and ppl
RING_AT = {2: ["gqa"], 4: ["mha"]}
PREFILL_AT = {2: [False], 4: [True]}
GEN_AT = {2: ["enc_roco", "enc_h2o", "dec", "ppl"], 4: ["enc_h2o_keep", "ppl"]}


def _ring_inputs(rng):
    """(q, k, v, q_pos, k_pos) at B = 2, T = 16, D = 8: MHA (2 heads) and
    GQA rep 2 (4 query heads over 2); row 1's last 3 columns are padding
    (q_pos -1, k_pos INT_MAX)."""
    B, T, D = 2, 16, 8
    q_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    q_pos[1, 13:] = -1
    k_pos = np.where(q_pos >= 0, q_pos, 2**31 - 1).astype(np.int32)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {name: (f(B, hq, T, D), f(B, hkv, T, D), f(B, hkv, T, D), q_pos, k_pos)
            for name, hq, hkv in (("mha", 2, 2), ("gqa", 4, 2))}


def _jcfg():
    return JModelConfig(**W.CFG)


def _jmesh(n):
    return JMesh(np.array(jax.devices()[:n]), ("sp",))


def _jax_prefill(jparams, inp, kv_quant, sp, slots=W.PREFILL_SLOTS):
    cfg = _jcfg()
    st = JEngineStatics(cfg=cfg, dtype="float32", kv_quant=kv_quant, sp=sp, **W.PREFILL_ST)
    ids, plen = inp
    cache = jinit_cache(cfg.num_hidden_layers, ids.shape[0], cfg.num_key_value_heads, slots,
                        cfg.head_dim, jnp.float32, quantized=kv_quant)
    cache, logits = jprefill(st, jparams, cache, jnp.asarray(ids), jnp.asarray(plen),
                             st.encode_spec(), "encode")
    return [np.asarray(x) for x in cache], np.asarray(logits)


def _jax_generate(jparams, ids, case, n):
    model = easykv_tpu.CausalLM(_jcfg(), jparams)
    buf = io.StringIO()
    jflags.set_sp_mesh(_jmesh(n), "sp")
    try:
        with contextlib.redirect_stdout(buf):
            out = easykv_tpu.generate(model, ids, case["gc"], kv_mode=case["mode"],
                                      stride=case["stride"])
    finally:
        jflags.set_sp_mesh(None)
    return out, RATIO.findall(buf.getvalue())


def _start(tmp, n, inputs):
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.worker, args=(r, n, tmp)) for r in range(n)]
    for p in procs:
        p.start()
    return procs


def _join(tmp, procs):
    for p in procs:
        p.join(timeout=240)
    res = []
    for r, p in enumerate(procs):
        if p.is_alive():
            p.kill()
        path = os.path.join(tmp, f"rank{r}.pkl")
        assert os.path.exists(path), f"rank {r} wrote nothing (exit code {p.exitcode})"
        with open(path, "rb") as f:
            res.append(pickle.load(f))
        assert "error" not in res[-1], f"rank {r}:\n{res[-1]['error']}"
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each spawn's results, the JAX references and the inputs."""
    jparams = jllama.init_params(_jcfg(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    inputs = dict(params=jax.tree.map(np.asarray, jparams), ring=_ring_inputs(rng),
                  prefill=(rng.integers(1, 120, size=(2, 45)), np.array([45, 38], np.int32)),
                  ids={"doc": rng.integers(1, 120, size=(103,)),
                       "b2": rng.integers(1, 120, size=(2, 30))},
                  )
    procs = {}
    for n in WIDTHS:
        tmp = str(tmp_path_factory.mktemp(f"sp{n}"))
        procs[n] = (tmp, _start(tmp, n, dict(inputs, gen={k: GEN[k] for k in GEN_AT[n]},
                                             prefill_kv=PREFILL_AT[n])))
    ref = {}
    for n in WIDTHS:
        jm = _jmesh(n)
        for name in RING_AT[n]:
            q, k, v, q_pos, k_pos = inputs["ring"][name]
            out, ssum, ssq = jring_attention(*map(jnp.asarray, (q, k, v, q_pos)), jm,
                                             collect_scores=True, k_pos=jnp.asarray(k_pos))
            ref["ring", n, name] = [np.asarray(x) for x in (out, ssum, ssq)]
        for kvq in PREFILL_AT[n]:
            ref["prefill", n, kvq] = _jax_prefill(jparams, inputs["prefill"], kvq, (jm, "sp"))
        for name in GEN_AT[n]:
            ref[n, name] = _jax_generate(jparams, inputs["ids"][GEN[name]["ids"]], GEN[name], n)
    results = {n: _join(tmp, p) for n, (tmp, p) in procs.items()}
    return inputs, results, ref, jparams


@pytest.mark.parametrize("n,name", [(n, name) for n in WIDTHS for name in RING_AT[n]])
def test_ring_attention_matches_jax(runs, n, name):
    _, results, ref, _ = runs
    want = ref["ring", n, name]
    got = [np.concatenate([r["ring"][name][i] for r in results[n]], axis=2) for i in range(3)]
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0, err_msg="out")
    np.testing.assert_allclose(got[1], want[1], atol=1e-6, rtol=1e-5, err_msg="score sum")
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=1e-5, err_msg="score_sq sum")


def _hold_prefill(got, want, kv_quant):
    """A prefill's cache and logits against the JAX package's:
    tests/test_sp_prefill.py's bars; an int8 cache's K / V within one int8
    step, its scales within 1e-5 relative."""
    (arrays, logits), (jarrays, jlogits) = got, want
    k, v, pos, score, ssq, counter, ks, vs = arrays
    jk, jv, jpos, jscore, jssq, jcounter, jks, jvs = jarrays
    np.testing.assert_allclose(logits, jlogits, atol=2e-4, rtol=2e-3)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(counter, jcounter)
    np.testing.assert_allclose(score, jscore, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ssq, jssq, atol=1e-6, rtol=1e-4)
    if kv_quant:
        for a, b, sa, sb in ((k, jk, ks, jks), (v, jv, vs, jvs)):
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(k, jk, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(v, jv, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("n,kv_quant", [(n, kvq) for n in WIDTHS for kvq in PREFILL_AT[n]])
def test_ring_prefill_matches_jax(runs, n, kv_quant):
    """_prefill under the sp mesh (A = 45 padded to A_pad = 46 / 48): every
    rank holds the whole cache, bit-identical, and it is the JAX
    package's."""
    _, results, ref, _ = runs
    ranks = [r["prefill", kv_quant] for r in results[n]]
    for other in ranks[1:]:
        for a, b in zip(other[0] + [other[1]], ranks[0][0] + [ranks[0][1]]):
            assert (a is None and b is None) or np.array_equal(a, b)
    _hold_prefill(ranks[0], ref["prefill", n, kv_quant], kv_quant)


@pytest.mark.parametrize("n,name", [(n, name) for n in WIDTHS for name in GEN_AT[n]])
def test_generate_under_sp_mesh_matches_jax(runs, n, name):
    _, results, ref, _ = runs
    jax_out, jax_printed = ref[n, name]
    for r in results[n]:
        got = r[name]
        assert got["ring"] == 1
        assert got["printed"] == jax_printed
        if GEN[name]["mode"] == "ppl":
            assert abs(got["out"] - jax_out) / jax_out < 1e-4, (got["out"], jax_out)
        else:
            assert got["out"] == jax_out


def test_prefix_past_the_slots_takes_the_chunked_path(runs, monkeypatch):
    """A 40-token prefix into 40 slots under an sp width of 3: padded to 42
    it does not fit, so both packages take the chunked path (the port's
    ring is never called) and agree. No rank is needed: the chunked path
    never reads the mesh."""
    inputs, _, _, jparams = runs
    from easykv_tpu_torch.parallel.mesh import SeqMesh

    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")

    def refused(*a, **k):
        raise AssertionError("the ring prefill ran")

    monkeypatch.setattr(gen_mod, "_ring_prefill", refused)
    ids, plen = inputs["prefill"]
    case = dict(inputs, prefill=(ids[:, :40], np.array([40, 33], np.int32)), slots=40)
    got = W.run_prefill(case, False, (SeqMesh("sp", 3, torch.device("cpu")), "sp"))
    want = _jax_prefill(jparams, case["prefill"], False, (_jmesh(3), "sp"), slots=40)
    _hold_prefill(got, want, False)


def test_sp_with_a_data_model_mesh_raises():
    import easykv_tpu_torch
    from easykv_tpu_torch import flags
    from easykv_tpu_torch.config import MeshConfig, ModelConfig
    from easykv_tpu_torch.models.llama import init_params
    from easykv_tpu_torch.parallel.mesh import Mesh, SeqMesh

    cfg = ModelConfig(**W.CFG)
    model = easykv_tpu_torch.CausalLM(cfg, init_params(cfg, 0, device="cpu"), device="cpu")
    flags.set_sp_mesh(SeqMesh("sp", 2, torch.device("cpu")))
    flags.set_active_mesh(Mesh(MeshConfig(1, 2), torch.device("cpu")))
    try:
        with pytest.raises(ValueError, match="sp mesh"):
            easykv_tpu_torch.generate(model, [1, 2, 3], GEN["dec"]["gc"], kv_mode="decoding")
    finally:
        flags.set_sp_mesh(None)
        flags.set_active_mesh(None)
