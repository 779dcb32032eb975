"""The port's (data, model) mesh on the CPU against the JAX package's.

Each mesh shape, (1, 2), (2, 1) and (2, 2), is one spawn of gloo ranks
(tests/test_torch_parallel_worker.py, which imports only the port; a
file:// rendezvous under tmp_path, one thread a rank) that runs all of its
cases, while this process computes the JAX references on its virtual
8-device mesh (tests/conftest.py), Pallas in interpret mode:

  * the six sharded kernel wrappers (plain versions) on (2, 2), each rank's
    outputs gathered, against the JAX `*_sharded` functions: integers
    exact, floats within 1e-5;
  * shard_params / shard_cache against param_pspecs_tree / cache_pspecs
    (the JAX shard of each leaf, bit for bit; a row-parallel int4 leaf,
    re-packed by the port, through its dequantized rows) for f32, int8,
    int4 halves and arithmetic, and dual trees; a fused tree raises;
  * generate under the mesh against JAX generate under set_active_mesh:
    greedy tokens and the printed budget-ratio line (decoding: f32, int8
    KV, int8 / int4 trees; encoding with the chunk kernels; tova encoding,
    whose score is a mean over all heads; pre-rotated StreamingLLM
    decoding on every mesh, int8 KV too on (1, 2)), every row of the batch
    (gathered over data) against the one-process port run, with the f32
    StreamingLLM run's final pos and counters on each rank's shard, and the
    sampled / `random` runs (draws made for the global batch, sliced)
    against it;
  * ScheduledBatchEngine(mesh=) at (2, 1), sampled, against the one-process
    engine, and its two-process snapshot / resume against the
    uninterrupted run.
"""
import contextlib
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

import easykv_tpu
import test_torch_parallel_worker as W
from easykv_tpu import flags as jflags
from easykv_tpu.cache import KVCache as JKVCache
from easykv_tpu.cache import quantize_kv as jquantize
from easykv_tpu.config import MeshConfig as JMeshConfig
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops.pallas import chunk_attention as jca
from easykv_tpu.ops.pallas.decode_attention import fused_decode_attend_inflight_sharded
from easykv_tpu.ops.pallas.sidecar_update import fused_evict_sharded, fused_write_update_sharded
from easykv_tpu.ops.quant import quantize_params as jquantize_params
from easykv_tpu.ops.quant import quantize_params_int4 as jquantize_params_int4
from easykv_tpu.parallel import make_mesh, shard_cache, shard_params
from easykv_tpu.policies import PHASE_DECODE, PolicySpec

from easykv_tpu_torch.ops.quant import QuantLinear, dequantize

MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
GC_DEC = {"budget": 8, "kv_policy": "roco", "max_new_tokens": 12, "temperature": 1e-9,
          "top_p": 1.0, "eos_token_ids": [], "seed": 3}
GC_ENC = {"budget": 0.5, "kv_policy": "roco", "max_new_tokens": 8, "temperature": 1e-9,
          "top_p": 1.0, "eos_token_ids": [], "seed": 1}


def _dec(tree="f32", kv_quant=False, **gc):
    return dict(tree=tree, kv_quant=kv_quant, mode="decoding", stride=1, ids="b2",
                gc=dict(GC_DEC, **gc))


def _enc(**gc):
    return dict(tree="f32", kv_quant=False, mode="encoding", stride=8, ids="long",
                gc=dict(GC_ENC, **gc), chunk_kernel=True)


# (mesh, case): the JAX reference is JAX generate under the same mesh;
# dec_stream* is pre-rotated StreamingLLM `decoding` (the default strategy)
JAX_CASES = {
    "1x2": {"dec_f32": _dec(), "dec_int8kv": _dec(kv_quant=True), "dec_int8": _dec("int8"),
            "dec_int4": _dec("int4"), "enc_chunk": _enc(),
            "enc_tova": _enc(kv_policy="tova"), "dec_stream": _dec(streaming=True),
            "dec_stream_int8kv": _dec(kv_quant=True, streaming=True)},
    "2x1": {"dec_f32": _dec(), "dec_stream": _dec(streaming=True)},
    "2x2": {"dec_f32": _dec(), "enc_chunk": _enc(), "dec_stream": _dec(streaming=True)},
}
# (mesh, case): held to the one-process port run (the draws are torch's)
PORT_CASES = {
    "1x2": {"dec_sampled": dict(_dec(temperature=0.8, top_p=0.9), report=True),
            "dec_arith": _dec("arith")},
    "2x1": {"dec_random": _dec(kv_policy="random"),
            "dec_sampled": dict(_dec(temperature=0.8, top_p=0.9), report=True)},
}
SERVING = dict(engine=dict(batch_slots=4, max_prompt=32, budget=8, kv_policy="roco",
                           temperature=0.8, top_p=0.9, prefill_chunk=16, seed=5),
               new=8, snap_after=6)
EXTRA = {"2x2": ["wrappers", "params", "cache"], "2x1": ["serving"], "1x2": []}
RATIO = re.compile(r"KV [Cc]ache [Bb]udget ratio.*")


def _wrapper_inputs():
    """Global inputs of each sharded wrapper: B = 2, Hkv = 2 (GQA rep 2),
    S = 128, D = 32; K2 / K4 at L = 2; K5 over an int8 cache; K6 / K7 with
    counters >= 0 (the Pallas chunk kernels clamp negative ones)."""
    rng = np.random.default_rng(7)
    B, Hkv, rep, S, D, C, L = 2, 2, 2, 128, 32, 8, 2
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    pos = rng.integers(0, 90, size=(B, Hkv, S)).astype(np.int32)
    pos[:, :, ::5] = -1
    side = lambda: np.abs(f(B, Hkv, S))  # noqa: E731
    q_pos = np.broadcast_to(90 + np.arange(C, dtype=np.int32), (B, C)).copy()
    ids = np.stack([np.sort(rng.choice(S, C, replace=False)) for _ in range(B * Hkv)]
                   ).reshape(B, Hkv, C).astype(np.int32)
    wm = np.zeros((B, Hkv, S), np.int32)
    np.put_along_axis(wm, ids, 1, axis=-1)
    k8, ks = (np.asarray(a) for a in jquantize(jnp.asarray(f(B, Hkv, S, D))))
    v8, vs = (np.asarray(a) for a in jquantize(jnp.asarray(f(B, Hkv, S, D))))
    lpos = np.full((L, B, Hkv, S), -1, np.int32)
    lpos[..., :48] = np.arange(48)
    lpos[..., 20:24] = -1
    valid = lpos >= 0
    lside = lambda: np.where(valid, rng.random(lpos.shape), 0).astype(np.float32)  # noqa: E731
    lcnt = np.where(valid, rng.integers(1, 30, lpos.shape), 0).astype(np.float32)
    rows = lambda *v: np.array(v)  # noqa: E731
    spec = dict(policy="roco", phase=PHASE_DECODE, k=1, sink_length=4, recent_window=2,
                feasible_k=6, protect_prompt=True)
    return {
        "k1": dict(args=(f(B, Hkv * rep, 1, D), f(B, Hkv, 1, D), f(B, Hkv, 1, D),
                         f(B, Hkv, S, D), f(B, Hkv, S, D), pos, rows(95, 60).astype(np.int32))),
        "k2": dict(args=(lpos, lside(), lside(), lcnt, lside() / S,
                         rng.random((L, B, Hkv, 1)).astype(np.float32),
                         rows(48, 48).astype(np.int32), rows(True, False), rows(True, True),
                         rows(3.0, 0.0).astype(np.float32)), policy="roco"),
        "k4": dict(args=(lpos, lside(), lside(), lcnt, rows(True, False),
                         rows(49, 49).astype(np.int32), rows(12, 12).astype(np.int32),
                         rows(0, 0).astype(np.int32)), spec=spec),
        "k5": dict(args=(f(B, Hkv * rep, C, D), k8, v8, pos, q_pos, ks, vs)),
        "k6": dict(args=(f(B, Hkv * rep, C, D), f(B, Hkv, C, D), f(B, Hkv, C, D), ids, q_pos,
                         np.abs(f(B, C)), f(B, Hkv, S, D), f(B, Hkv, S, D), pos, side(), side(),
                         1.0 + side())),
        "k7": dict(args=(f(B, Hkv * rep, C, D), f(B, Hkv, C, D), f(B, Hkv, C, D), wm, q_pos,
                         np.abs(f(B, C)), rows(True, True), rows(True, False),
                         (q_pos[:, -1] + 1).copy(), rows(3, 3).astype(np.int32),
                         f(B, Hkv, S, D), f(B, Hkv, S, D),
                         np.tile(np.arange(S, dtype=np.int32), (B, Hkv, 1)), side(), side(),
                         1.0 + side()),
                   statics=dict(policy="roco", feasible_k=40, sink=4, recent_window=10)),
    }


def _jax_wrappers(inp, jmesh):
    j = {k: [jnp.asarray(a) for a in v["args"]] for k, v in inp.items()}
    kw = dict(mesh=jmesh, interpret=True)
    spec = PolicySpec(**inp["k4"]["spec"])
    out = {
        "k1": fused_decode_attend_inflight_sharded(*j["k1"], **kw),
        "k2": fused_write_update_sharded(*j["k2"], policy="roco", **kw),
        "k4": fused_evict_sharded(*j["k4"], spec=spec, **kw),
        "k5": jca.fused_chunk_attend_sharded(*j["k5"][:5], k_scale=j["k5"][5],
                                             v_scale=j["k5"][6], **kw),
    }
    res = jca.fused_chunk_write_attend_sharded(*j["k6"], **kw)
    out["k6"] = tuple(res[:4]) + tuple(res[4])
    o, arrs, wm = jca.fused_chunk_step_sharded(*j["k7"], **inp["k7"]["statics"], **kw)
    out["k7"] = (o,) + tuple(arrs) + (wm,)
    return {k: [None if x is None else np.asarray(x) for x in v] for k, v in out.items()}


def _start(tmp, data, model, inputs):
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=W.worker, args=(r, data * model, data, model, tmp))
             for r in range(data * model)]
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


def _jax_generate(jcfg, params, ids, case, jmesh):
    """JAX generate of `case` under jmesh: (returned tokens, ratio lines)."""
    model = easykv_tpu.CausalLM(jcfg, params, kv_quant=case["kv_quant"])
    buf = io.StringIO()
    jflags.set_active_mesh(jmesh, "data", "model")
    try:
        with contextlib.redirect_stdout(buf):
            out = easykv_tpu.generate(model, ids, case["gc"], kv_mode=case["mode"],
                                      stride=case["stride"])
    finally:
        jflags.set_active_mesh(None)
    return out, RATIO.findall(buf.getvalue())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn's results, the JAX references and the inputs."""
    jcfg = JModelConfig(**W.CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    cache_arrays = [rng.normal(size=(2, 2, 2, 8, 4)).astype(np.float32) for _ in range(2)]
    cache_arrays.append(rng.integers(-1, 9, size=(2, 2, 2, 8)).astype(np.int32))
    cache_arrays += [rng.random((2, 2, 2, 8)).astype(np.float32) for _ in range(5)]
    inputs = dict(params=jax.tree.map(np.asarray, jparams),
                  ids={"b2": rng.integers(1, 120, size=(2, 30)),
                       "long": rng.integers(1, 120, size=(2, 56))},
                  wrappers=_wrapper_inputs(), cache=cache_arrays, serving=SERVING,
                  requests=[rng.integers(1, 120, size=(n,)) for n in (10, 25, 17, 30, 12, 21)])
    procs = {}
    for name, (d, m) in MESHES.items():
        gen = {**JAX_CASES.get(name, {}), **PORT_CASES.get(name, {})}
        tmp = str(tmp_path_factory.mktemp(f"mesh{name}"))
        procs[name] = (tmp, _start(tmp, d, m, dict(inputs, gen=gen,
                                                   cases=list(gen) + EXTRA[name])))

    ref = {}
    trees = {"f32": jparams, "int8": jquantize_params(jparams),
             "int4": jquantize_params_int4(jparams, group_size=W.GROUP),
             "arith": jquantize_params_int4(jparams, group_size=W.GROUP, layout="arith"),
             "dual": jquantize_params_int4(jparams, group_size=W.GROUP, dual_int8=True)}
    for name, cases in JAX_CASES.items():
        d, m = MESHES[name]
        mc = JMeshConfig(d, m)
        jmesh = make_mesh(mc)
        for cname, case in cases.items():
            sp = shard_params(trees[case["tree"]], jcfg, mc, jmesh)
            ids = inputs["ids"][case["ids"]]
            ref[name, cname] = _jax_generate(jcfg, sp, ids, case, jmesh)
    jmesh22 = make_mesh(JMeshConfig(2, 2))
    ref["wrappers"] = _jax_wrappers(inputs["wrappers"], jmesh22)
    ref["params"] = {k: shard_params(v, jcfg, JMeshConfig(2, 2), jmesh22)
                     for k, v in trees.items()}
    ref["cache"] = shard_cache(JKVCache(*map(jnp.asarray, cache_arrays)), JMeshConfig(2, 2),
                               jmesh22)
    ref["jmesh22"] = jmesh22
    results = {name: _join(tmp, p) for name, (tmp, p) in procs.items()}
    return inputs, results, ref


def _shard_of(arr, jmesh, i, j):
    """The JAX shard of a sharded array on the device at mesh position (i, j)."""
    dev = jmesh.devices[i, j]
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))


def _assemble(parts, coords, bdim):
    """The global array from each rank's local block: data coordinates along
    bdim, model coordinates along bdim + 1."""
    d = 1 + max(c[0] for c in coords)
    m = 1 + max(c[1] for c in coords)
    grid = [[None] * m for _ in range(d)]
    for p, (i, j) in zip(parts, coords):
        grid[i][j] = p
    return np.concatenate([np.concatenate(row, axis=bdim + 1) for row in grid], axis=bdim)


@pytest.mark.parametrize("name", ["k1", "k2", "k4", "k5", "k6", "k7"])
def test_sharded_wrapper_matches_jax(runs, name):
    _, results, ref = runs
    ranks = results["2x2"]
    coords = [r["coords"] for r in ranks]
    bdim = 1 if name in ("k2", "k4") else 0
    want = ref["wrappers"][name]
    assert len(ranks[0]["wrappers"][name]) == len(want)
    for k, w in enumerate(want):
        got = _assemble([r["wrappers"][name][k] for r in ranks], coords, bdim)
        assert got.shape == w.shape, (name, k)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5, err_msg=f"{name}[{k}]")
        else:
            np.testing.assert_array_equal(got, w, err_msg=f"{name}[{k}]")


ROW_PARALLEL = ("wo", "wd")
INT4 = ("int4", "arith", "dual")


@pytest.mark.parametrize("kind", ["f32", "int8", "int4", "arith", "dual"])
def test_shard_params_match_jax_specs(runs, kind):
    _, results, ref = runs
    jtree, jmesh = ref["params"][kind], ref["jmesh22"]
    for r in results["2x2"]:
        i, j = r["coords"]
        port = r["params"][kind]
        checked = 0
        for name, got in port.items():
            parts = name.split(".")
            repacked = kind in INT4 and len(parts) == 3 and parts[1] in ROW_PARALLEL
            if parts[-1] == "gs3" or (parts[-1] == "w" and not repacked):
                continue        # derived leaves: gs3 from gs, w the dequantized weight
            if repacked and parts[2] in ("q4p", "q4a"):
                continue        # re-packed: held through its dequantized rows (w)
            if parts[0] in ("embed", "final_norm"):
                want = _shard_of(jtree[parts[0]], jmesh, i, j)
            elif parts[0] == "head":
                leaf = jtree["lm_head"] if len(parts) == 1 else jtree["lm_head"][parts[1]]
                want = _shard_of(leaf, jmesh, i, j)
            else:
                l, lname = int(parts[0]), parts[1]
                leaf = jtree["layers"][lname]
                if repacked and parts[2] == "w":     # the rank's rows of the weight
                    full = {k: np.asarray(v)[l] for k, v in leaf.items()}
                    w = dequantize(QuantLinear(**{k: torch.from_numpy(np.array(v))
                                                  for k, v in full.items()})).numpy()
                    n = w.shape[0] // 2
                    want = w[j * n:(j + 1) * n]
                else:
                    arr = leaf if len(parts) == 2 else leaf[parts[2]]
                    want = _shard_of(arr, jmesh, i, j)[l]
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {name} at {(i, j)}")
            checked += 1
        assert checked >= 12


def test_fused_tree_is_not_sharded(runs):
    _, results, _ = runs
    for r in results["2x2"]:
        assert "split tree" in r["params"]["fused_raises"]


def test_shard_cache_matches_jax_specs(runs):
    _, results, ref = runs
    for r in results["2x2"]:
        i, j = r["coords"]
        for got, arr in zip(r["cache"], ref["cache"]):
            np.testing.assert_array_equal(got, _shard_of(arr, ref["jmesh22"], i, j))
            assert got.shape[1:3] == (1, 1)


def _tokens(row):
    return [int(x) for x in row if x >= 0]


@pytest.mark.parametrize("name,case", [(m, c) for m, cs in JAX_CASES.items() for c in cs])
def test_generate_under_mesh_matches_jax(runs, name, case):
    """Row 0's tokens and the printed budget ratio against the JAX package
    under the same mesh; every row (row 1 on data rank 1 of a data-sharded
    mesh) against the one-process port run."""
    inputs, results, ref = runs
    jax_tokens, jax_printed = ref[name, case]
    one = W.run_case(inputs, JAX_CASES[name][case])
    for r in results[name]:
        got = r[case]
        assert got["out"] == jax_tokens, (name, case, r["coords"])
        assert [p for p in got["printed"] if RATIO.match(p)] == jax_printed
        assert _tokens(got["rows"][0]) == got["out"]
        for a, b in zip(got["rows"], one["rows"]):
            assert _tokens(a) == _tokens(b)
        assert got["kv_len"] == one["kv_len"]
        if case == "dec_stream":
            # an f32 cache: the rank's shard of the final pos and counters is
            # the one-process run's, exactly
            i, j = r["coords"]
            for f, want in one["cache"].items():
                b, h = got["cache"][f].shape[1:3]
                np.testing.assert_array_equal(
                    got["cache"][f], want[:, i * b:(i + 1) * b, j * h:(j + 1) * h], err_msg=f)


@pytest.mark.parametrize("name,case", [(m, c) for m, cs in PORT_CASES.items() for c in cs])
def test_draws_under_mesh_match_one_process(runs, name, case):
    """Sampled and `random` runs, and the int4 arithmetic tree: each row
    draws what it draws without a mesh (the draws are made for the global
    batch and sliced), and the printed lines (budget ratio, the confidence
    line read from all V logits) are the one-process run's."""
    inputs, results, _ = runs
    one = W.run_case(inputs, PORT_CASES[name][case])
    for r in results[name]:
        got = r[case]
        np.testing.assert_array_equal(got["rows"], one["rows"])
        assert got["out"] == one["out"]
        keep = [p for p in one["printed"] if not p.startswith("Per-step")]
        assert [p for p in got["printed"] if not p.startswith("Per-step")] == keep
        assert any("confidence" in p for p in keep) == bool(PORT_CASES[name][case].get("report"))


def test_scheduled_engine_under_mesh_snapshot_resume(runs):
    inputs, results, _ = runs
    single, _ = W.serve(inputs, SERVING)
    for r in results["2x1"]:
        outs, resumed = r["serving"]
        assert outs == single
        assert resumed == outs
        assert all(len(v) == SERVING["new"] for v in outs.values())
