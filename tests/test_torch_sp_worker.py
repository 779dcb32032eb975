"""The rank processes of tests/test_torch_sp.py (no tests here). A rank
imports only the port: it joins a gloo process group on the CPU through a
file:// rendezvous, makes the sequence-parallel mesh over all ranks, runs
every case on its own columns and pickles what it found for the test
process, which holds it against the JAX package.
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
# the prefill case's statics (tests/test_sp_prefill.py's): encoding, roco,
# keep_attention, stride 8, idx 56, a cache of idx + stride + 4 slots
PREFILL_ST = dict(mode="encoding", policy="roco", stride=8, length=104, budget=60, idx=56,
                  r_idx=48, max_new_tokens=4, recent_window=6, temp_length=4,
                  keep_attention=True)
PREFILL_SLOTS = 68


def t(x):
    return torch.from_numpy(np.array(x))


def port_model(inp, kv_quant=False):
    import easykv_tpu_torch
    from easykv_tpu_torch.config import ModelConfig
    from easykv_tpu_torch.models.convert import from_jax_params

    cfg = ModelConfig(**CFG)
    return easykv_tpu_torch.CausalLM(cfg, from_jax_params(inp["params"], device="cpu"),
                                     device="cpu", kv_quant=kv_quant)


def case_ring(inp, mesh):
    """ring_attention (with its scores) on this rank's columns of each
    case's global inputs: (out, Σp, Σp²) of the rank's columns."""
    from easykv_tpu_torch.ops.ring_attention import ring_attention

    n, r = mesh.size, mesh.rank
    res = {}
    for name, (q, k, v, q_pos, k_pos) in inp["ring"].items():
        Tl = q.shape[2] // n
        c = slice(r * Tl, (r + 1) * Tl)
        out, ssum, ssq = ring_attention(t(q)[:, :, c], t(k)[:, :, c], t(v)[:, :, c],
                                        t(q_pos)[:, c], mesh, collect_scores=True,
                                        k_pos=t(k_pos)[:, c])
        res[name] = [x.numpy() for x in (out, ssum, ssq)]
    return res


def run_prefill(inp, kv_quant, sp):
    """The port's _prefill of the prefill case, the statics' sp `sp`:
    (every cache array, the logits) as numpy."""
    from easykv_tpu_torch.cache import KVCache, init_cache
    from easykv_tpu_torch.engine.generate import EngineStatics, _prefill

    model = port_model(inp)
    cfg = model.cfg
    st = EngineStatics(cfg=cfg, kv_quant=kv_quant, sp=sp, **PREFILL_ST)
    ids, plen = inp["prefill"]
    cache = init_cache(cfg.num_hidden_layers, ids.shape[0], cfg.num_key_value_heads,
                       inp.get("slots", PREFILL_SLOTS), cfg.head_dim, torch.float32, "cpu",
                       quantized=kv_quant)
    logits = _prefill(st, model.params, cache, t(ids), t(plen), st.encode_spec(), "encode")
    arrays = [None if x is None else x.numpy()
              for x in (getattr(cache, f) for f in KVCache.__dataclass_fields__)]
    return arrays, logits.numpy()


def run_generate(inp, case, mesh):
    """generate() of `case` under the sp mesh `mesh` (None: none): its
    returned tokens (or ppl), the printed budget-ratio lines and how often
    the ring prefill ran."""
    import easykv_tpu_torch
    from easykv_tpu_torch import flags

    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    model = port_model(inp, case.get("kv_quant", False))
    ring = gen_mod._ring_prefill
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return ring(*a, **k)

    buf = io.StringIO()
    gen_mod._ring_prefill = counted
    flags.set_sp_mesh(mesh)
    try:
        with contextlib.redirect_stdout(buf):
            out = easykv_tpu_torch.generate(model, inp["ids"][case["ids"]], case["gc"],
                                            kv_mode=case["mode"], stride=case["stride"])
    finally:
        gen_mod._ring_prefill = ring
        flags.set_sp_mesh(None)
    lines = [x for x in buf.getvalue().splitlines() if "udget ratio" in x]
    return dict(out=out, printed=lines, ring=len(calls))


def worker(rank, world, tmp):
    """A rank: every case of inputs.pkl, pickled to rank{rank}.pkl."""
    torch.set_num_threads(1)
    res = {}
    try:
        from easykv_tpu_torch.parallel import init_distributed
        from easykv_tpu_torch.parallel.mesh import make_sp_mesh

        init_distributed("gloo", "file://" + os.path.join(tmp, "rendezvous"), world, rank,
                         timeout_s=120)
        mesh = make_sp_mesh("cpu")
        with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        res["ring"] = case_ring(inp, mesh)
        for kvq in inp["prefill_kv"]:
            res["prefill", kvq] = run_prefill(inp, kvq, (mesh, "sp"))
        for name, case in inp["gen"].items():
            res[name] = run_generate(inp, case, mesh)
    except Exception:  # noqa: BLE001 - reported to the test process
        res["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
