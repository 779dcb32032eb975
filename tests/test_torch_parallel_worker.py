"""The rank processes of tests/test_torch_parallel.py (no tests here). A
rank imports only the port: it joins a gloo process group on the CPU
through a file:// rendezvous, makes the (data, model) mesh, runs every case
its mesh is given on its own shards and pickles what it found for the test
process, which holds it against the JAX package. `run_case` also runs a
case without a mesh, in the test process, for the port's own one-process
reference.
"""
import contextlib
import importlib
import io
import os
import pickle
import traceback

import numpy as np
import torch

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
           num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512)
GROUP = 16      # the int4 trees' group: a row-parallel shard (32 rows of wo) holds two


def t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def port_tree(inp, kind):
    """The port's global tree of `kind` from the JAX package's f32 weights."""
    from easykv_tpu_torch.models.convert import from_jax_params
    from easykv_tpu_torch.ops.quant import (fuse_gemv_params, quantize_params,
                                            quantize_params_int4)

    tree = from_jax_params(inp["params"], device="cpu")
    if kind == "int8":
        return quantize_params(tree)
    if kind in ("int4", "arith", "dual"):
        return quantize_params_int4(tree, group_size=GROUP, dual_int8=kind == "dual",
                                    layout="arith" if kind == "arith" else "halves")
    if kind == "fused":
        return fuse_gemv_params(tree)
    return tree


def _leaves(params):
    """name -> numpy of every leaf of a LlamaParams (a QuantLinear's under
    name.leaf, and its dequantized weight under name.w; gs3, made from gs,
    left out)."""
    from easykv_tpu_torch.ops.quant import QuantLinear, dequantize

    out = {"embed": params.embed, "final_norm": params.final_norm}
    for i, p in enumerate(params.layers):
        for k, w in p.named_parameters(recurse=False):
            out[f"{i}.{k}"] = w
        for k, ql in p.named_children():
            out.update({f"{i}.{k}.{leaf}": b for leaf, b in ql.named_buffers() if leaf != "gs3"})
            out[f"{i}.{k}.w"] = dequantize(ql)
    head = params.lm_head
    if isinstance(head, QuantLinear):
        out.update({f"head.{leaf}": b for leaf, b in head.named_buffers()})
    elif head is not None:
        out["head"] = head
    return {k: v.detach().numpy() for k, v in out.items()}


def case_params(inp, mesh, mc):
    """This rank's shards of each tree kind, and whether a fused tree raises."""
    from easykv_tpu_torch.config import ModelConfig
    from easykv_tpu_torch.parallel import shard_params

    cfg = ModelConfig(**CFG)
    res = {kind: _leaves(shard_params(port_tree(inp, kind), cfg, mc, mesh))
           for kind in ("f32", "int8", "int4", "arith", "dual")}
    try:
        shard_params(port_tree(inp, "fused"), cfg, mc, mesh)
        res["fused_raises"] = ""
    except ValueError as e:
        res["fused_raises"] = str(e)
    return res


def case_cache(inp, mesh, mc):
    from easykv_tpu_torch.cache import KVCache
    from easykv_tpu_torch.parallel import shard_cache

    local = shard_cache(KVCache(*map(t, inp["cache"])), mc, mesh)
    return [None if x is None else x.numpy() for x in
            (getattr(local, f) for f in KVCache.__dataclass_fields__)]


WRAPPER_SPECS = {   # per argument: the mesh axes of its dims (d, m, or None)
    "k1": ("dm..", "dm..", "dm..", "dm..", "dm..", "dm.", "d"),
    "k2": ("", "dm.", "dm.", "dm.", "dm.", "dm.", "dm.", "d", "d", "d", "d"),
    "k4": ("", "dm.", "dm.", "dm.", "dm.", "d", "d", "d", "d"),
    "k5": ("dm..", "dm..", "dm..", "dm.", "d.", "dm.", "dm."),
    "k6": ("dm..", "dm..", "dm..", "dm.", "d.", "d.", "dm..", "dm..", "dm.", "dm.", "dm.",
           "dm."),
    "k7": ("dm..", "dm..", "dm..", "dm.", "d.", "d.", "d", "d", "d", "d", "dm..", "dm..", "dm.",
           "dm.", "dm.", "dm."),
}


def _spec(code, mc):
    """'dm.' -> (data, model, None); a leading '' marks the L axis of K2 / K4."""
    return tuple({"d": mc.axis_data, "m": mc.axis_model, ".": None}[c] for c in code)


def case_wrappers(inp, mesh, mc):
    """Each sharded wrapper on this rank's shards of the global inputs."""
    from easykv_tpu_torch.ops.cuda import chunk_attention as ca
    from easykv_tpu_torch.ops.cuda import decode_attention as da
    from easykv_tpu_torch.ops.cuda import sidecar_update as su
    from easykv_tpu_torch.parallel.sharding import _shard
    from easykv_tpu_torch.policies import PolicySpec

    kw = dict(mesh=mesh, data_axis=mc.axis_data, model_axis=mc.axis_model)
    res = {}
    for name, case in inp["wrappers"].items():
        specs = WRAPPER_SPECS[name]
        if specs[0] == "":                       # (L, B, H, S): the L axis is whole
            specs = tuple("." + s if len(s) == 3 else s for s in specs[1:])
        args = [_shard(t(a), _spec(s, mc), mesh, "cpu") for a, s in zip(case["args"], specs)]
        if name == "k1":
            out = da.fused_decode_attend_inflight_sharded(*args, **kw)
        elif name == "k2":
            out = su.fused_write_update_sharded(*args, case["policy"], **kw)
        elif name == "k4":
            out = su.fused_evict_sharded(*args, spec=PolicySpec(**case["spec"]), **kw)
        elif name == "k5":
            out = ca.fused_chunk_attend_sharded(*args, **kw)
        elif name == "k6":
            out = ca.fused_chunk_write_attend_sharded(*args, **kw)
            out = tuple(out) + tuple(args[6:12])   # the cache arrays, written in place
        else:
            o, arrs, wm = ca.fused_chunk_step_sharded(*args, **case["statics"], **kw)
            out = (o,) + tuple(arrs) + (wm,)
        res[name] = [None if x is None else x.numpy() for x in out]
    return res


def run_case(inp, case, mesh=None, mc=None):
    """One generate() call of `case` (on this rank's shards under a mesh):
    its returned tokens, every row's tokens (gathered over data), the
    printed lines, last_run's kv_len and n_tokens, and the final cache's
    pos and counter (the rank's shard)."""
    import easykv_tpu_torch
    from easykv_tpu_torch import flags
    from easykv_tpu_torch.config import ModelConfig
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    from easykv_tpu_torch.parallel import shard_params

    cfg = ModelConfig(**CFG)
    tree = port_tree(inp, case["tree"])
    params = tree if mesh is None else shard_params(tree, cfg, mc, mesh)
    model = easykv_tpu_torch.CausalLM(cfg, params, device="cpu", kv_quant=case["kv_quant"])
    seen = []
    gather = gen_mod._gather_result

    def keep(st, res):
        res = gather(st, res)
        seen.append(res.out_ids.numpy().copy())
        return res

    made = []
    engine_cache = gen_mod._engine_cache

    def recorded(*a, **k):
        made.append(engine_cache(*a, **k))
        return made[-1]

    buf = io.StringIO()
    gen_mod._gather_result = keep
    gen_mod._engine_cache = recorded
    if mesh is not None:
        flags.set_active_mesh(mesh, mc.axis_data, mc.axis_model)
    flags.use_chunk_kernel(case.get("chunk_kernel"))
    flags.use_prerot(case.get("prerot"))
    try:
        with contextlib.redirect_stdout(buf):
            out = easykv_tpu_torch.generate(model, inp["ids"][case["ids"]], case["gc"],
                                            kv_mode=case["mode"], stride=case["stride"],
                                            report_decoding_latency=case.get("report", False))
    finally:
        gen_mod._gather_result = gather
        gen_mod._engine_cache = engine_cache
        flags.set_active_mesh(None)
        flags.use_chunk_kernel(None)
        flags.use_prerot(None)
    final = {f: getattr(made[-1], f).numpy() for f in ("pos", "counter")} if made else None
    return dict(out=out, rows=seen[-1] if seen else None, printed=buf.getvalue().splitlines(),
                kv_len=model.last_run.kv_len, n_tokens=model.last_run.n_tokens, cache=final)


def serve(inp, case, tmp=None, mesh=None, mc=None):
    """The scheduled engine over case's requests: run_all uninterrupted,
    and (with tmp) a twin snapshotted after `snap_after` ticks and resumed
    by a fresh engine. Returns (outs, resumed outs or None)."""
    import easykv_tpu_torch
    from easykv_tpu_torch.config import ModelConfig
    from easykv_tpu_torch.serving import Request, ScheduledBatchEngine

    cfg = ModelConfig(**CFG)
    model = easykv_tpu_torch.CausalLM(cfg, port_tree(inp, "f32"), device="cpu")
    kw = dict(case["engine"], mesh=mesh, mesh_config=mc)

    def submitted(eng):
        for rid, ids in enumerate(inp["requests"]):
            eng.submit(Request(rid, np.asarray(ids), max_new_tokens=case["new"]))
        return eng

    outs = submitted(ScheduledBatchEngine(model, **kw)).run_all()
    if tmp is None:
        return outs, None
    eng = submitted(ScheduledBatchEngine(model, **kw))
    for _ in range(case["snap_after"]):
        eng.tick()
    path = os.path.join(tmp, "snapshot")
    eng.snapshot(path)
    assert os.path.isdir(path) == (mesh is not None and mesh.size > 1)
    resumed = ScheduledBatchEngine.resume(path, model, **kw).run_all()
    return outs, resumed


def worker(rank, world, data, model, tmp):
    """A rank: every case of inputs.pkl's `cases`, pickled to rank{rank}.pkl."""
    torch.set_num_threads(1)
    res = {}
    try:
        from easykv_tpu_torch.config import MeshConfig
        from easykv_tpu_torch.parallel import init_distributed, make_mesh

        init_distributed("gloo", "file://" + os.path.join(tmp, "rendezvous"), world, rank,
                         timeout_s=120)
        mc = MeshConfig(data, model)
        mesh = make_mesh(mc, "cpu")
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        for name in inp["cases"]:
            if name == "params":
                res[name] = case_params(inp, mesh, mc)
            elif name == "cache":
                res[name] = case_cache(inp, mesh, mc)
            elif name == "wrappers":
                res[name] = case_wrappers(inp, mesh, mc)
            elif name == "serving":
                res[name] = serve(inp, inp["serving"], tmp, mesh, mc)
            else:
                res[name] = run_case(inp, inp["gen"][name], mesh, mc)
        res["coords"] = (mesh.index(mc.axis_data), mesh.index(mc.axis_model))
    except Exception:  # noqa: BLE001 - reported to the test process
        res["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
