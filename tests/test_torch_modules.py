"""easykv_tpu_torch modules against their easykv_tpu counterparts on the CPU:
rope, prefill attention, in-flight decode attention, the nucleus kept set
and greedy sampling, the parameter converter, the package's import
boundary and its device default. Inputs come from numpy with a seed."""
import importlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu.ops import attention as jattn
from easykv_tpu.ops import rope as jrope
from easykv_tpu import sampling as jsampling
from easykv_tpu.config import ModelConfig as JModelConfig

from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.ops import attention as tattn
from easykv_tpu_torch.ops import rope as trope
from easykv_tpu_torch import sampling as tsampling

TOL = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("ntk", [None, 8192])
def test_rope_matches_jax(ntk):
    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              max_position_embeddings=4096)
    if ntk:
        kw.update(rope_scaling_type="dynamic", rope_scaling_factor=2.0, rope_ntk_length=ntk)
    jc, tc = JModelConfig(**kw), ModelConfig(**kw)
    assert trope.rope_base_for(tc) == jrope.rope_base_for(jc)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 9, 16)).astype(np.float32)
    pos = rng.integers(-1, 3000, size=(2, 1, 9)).astype(np.int32)
    jf = jrope.rope_inv_freq(16, jrope.rope_base_for(jc))
    tf = trope.rope_inv_freq(16, trope.rope_base_for(tc), torch.device("cpu"))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), **TOL)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jf)
    out = trope.apply_rope(t(x), t(pos), tf)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _attn_inputs(seed, B, Hq, Hkv, T, S, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    pos = rng.integers(0, 40, size=(B, Hkv, S)).astype(np.int32)
    pos[:, :, ::5] = -1
    return rng, q, k, v, pos


@pytest.mark.parametrize("Hq,Hkv,window", [(4, 4, None), (4, 2, None), (4, 2, 12)])
def test_attend_matches_jax(Hq, Hkv, window):
    rng, q, k, v, pos = _attn_inputs(1, 2, Hq, Hkv, 6, 24, 16)
    q_pos = rng.integers(-1, 45, size=(2, 6)).astype(np.int32)
    jo, jp = jax.jit(jattn.attend, static_argnames="sliding_window")(
        *map(jnp.asarray, (q, k, v, pos, q_pos)), sliding_window=window)
    to, tp = tattn.attend(*map(t, (q, k, v, pos, q_pos)), sliding_window=window)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)


@pytest.mark.parametrize("Hq,Hkv,window", [(4, 4, None), (4, 2, None), (4, 2, 12)])
def test_attend_inflight_matches_jax(Hq, Hkv, window):
    rng, q, k, v, pos = _attn_inputs(2, 2, Hq, Hkv, 1, 24, 16)
    kn = rng.normal(size=(2, Hkv, 1, 16)).astype(np.float32)
    vn = rng.normal(size=(2, Hkv, 1, 16)).astype(np.float32)
    q_pos = np.array([30, -1], np.int32)  # second row dead
    args = (q, kn, vn, k, v, pos, q_pos)
    jres = jax.jit(jattn.attend_inflight, static_argnames="sliding_window")(
        *map(jnp.asarray, args), sliding_window=window)
    tres = tattn.attend_inflight(*map(t, args), sliding_window=window)
    for a, b in zip(tres, jres):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert (tres[1][1] == 0).all() and (tres[2][1] == 0).all()


def test_nucleus_mask_matches_jax():
    jnucleus = jax.jit(jsampling.nucleus_mask)
    rng = np.random.default_rng(3)
    for trial in range(6):
        V = int(rng.integers(8, 300))
        logits = rng.standard_normal((2, V)).astype(np.float32) * 3
        if trial % 3 == 0:  # exact ties, some at the likely boundary
            logits[:, : V // 2] = logits[:, V // 2: V // 2 * 2][:, ::-1]
        prob = np.asarray(jax.jit(jax.nn.softmax)(jnp.asarray(logits)))
        top_p = float(rng.choice([0.01, 0.3, 0.9, 0.95, 0.999, 1.0]))
        ref = np.asarray(jnucleus(jnp.asarray(prob), jnp.float32(top_p)))
        out = tsampling.nucleus_mask(t(prob), top_p).numpy()
        np.testing.assert_array_equal(out, ref)


def test_greedy_sample_topp_is_argmax_lowest_id_on_ties():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(3, 50)).astype(np.float32)
    logits[1, 7] = logits[1, 31] = logits[1].max() + 1.0   # tie: id 7 wins
    ref = np.asarray(jax.jit(jsampling.sample_topp)(
        jax.random.PRNGKey(0), jnp.asarray(logits), jnp.float32(1e-9), jnp.float32(1.0)))
    for seed in range(3):
        gen = torch.Generator().manual_seed(seed)
        out = tsampling.sample_topp(gen, t(logits), 1e-9, 1.0).numpy()
        np.testing.assert_array_equal(out, logits.argmax(-1))
        np.testing.assert_array_equal(out[[0, 2]], ref[[0, 2]])
    assert out[1] == 7


def test_sample_topp_stays_in_nucleus():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.normal(size=(4, 40)).astype(np.float32) * 3)
    prob = torch.softmax(logits / 0.7, dim=-1)
    keep = tsampling.nucleus_mask(prob, 0.5)
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsampling.sample_topp(gen, logits, 0.7, 0.5)
        assert keep[torch.arange(4), tok.long()].all()


def test_converter_prefill_logits_match_jax():
    from easykv_tpu.models import llama as jllama

    from easykv_tpu_torch.models.convert import from_jax_params

    jgen = importlib.import_module("easykv_tpu.engine.generate")
    tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

    kw = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
              max_position_embeddings=512)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(6).integers(1, 120, size=(2, 40)).astype(np.int32)
    plen = np.array([40, 29], np.int32)

    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", policy="full", stride=1,
                             length=40, budget=0)
    jcache = jgen._engine_cache(jst, 2, 128)
    jcache, jlog = jax.jit(lambda c, i, p: jgen._prefill(jst, jparams, c, i, p, None, "zero"))(
        jcache, jnp.asarray(ids), jnp.asarray(plen))

    tst = tgen.EngineStatics(cfg=tcfg, policy="full", length=40, budget=0)
    tcache = tgen._engine_cache(tst, 2, 128, torch.float32, torch.device("cpu"))
    tlog = tgen._prefill(tst, tparams, tcache, t(ids), t(plen))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), **TOL)


def test_package_imports_no_jax():
    code = ("import sys, easykv_tpu_torch, easykv_tpu_torch.models.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'easykv_tpu' or m.startswith('easykv_tpu.')]; "
            "assert not bad, bad; print('ok')")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert res.returncode == 0 and "ok" in res.stdout, res.stderr


def test_entry_points_default_to_cuda(monkeypatch):
    from easykv_tpu_torch import CausalLM
    from easykv_tpu_torch.models.llama import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(vocab_size=32, hidden_size=16, intermediate_size=32,
                      num_hidden_layers=1, num_attention_heads=2)
    params = init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CausalLM(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    assert CausalLM(cfg, params, device="cpu").device.type == "cpu"
