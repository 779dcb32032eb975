"""End to end on the CPU: generate() of the port in the kv_modes encoding,
encoding_decoding, auto and ppl against the JAX package's, on the same
converted weights, at temperature 1e-9. Greedy tokens and the printed
budget ratio must be equal; ppl within 2e-4 relative (the JAX package's own
bound between its two encode paths, tests/test_layer_major.py). The JAX
package runs its default CPU path (XLA); for policies that never read the
counters also its Pallas kernels (interpret mode), whose K6 clamps negative
initial counters to 0. `random` is left out: jax.random and torch draw
different numbers (the module tests inject the same ranks instead)."""
import contextlib
import importlib
import re
from unittest import mock

import jax
import numpy as np
import pytest

import easykv_tpu
import easykv_tpu_torch
from easykv_tpu import flags
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama

from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.convert import from_jax_params

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)
LENGTH, STRIDE = 90, 8
gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return {quant: (easykv_tpu.CausalLM(jcfg, jparams, kv_quant=quant),
                    easykv_tpu_torch.CausalLM(ModelConfig(**CFG), tparams, device="cpu",
                                              kv_quant=quant))
            for quant in (False, True)}


@contextlib.contextmanager
def _caches():
    """Records every KV cache the port's engine allocates."""
    made, make = [], gen_mod._engine_cache

    def record(*args):
        made.append(make(*args))
        return made[-1]
    with mock.patch.object(gen_mod, "_engine_cache", record):
        yield made


def _ratio(text):
    return re.findall(r"(?i)KV cache budget ratio.*", text)


def _gc(policy, budget, **kw):
    return dict({"budget": budget, "kv_policy": policy, "max_new_tokens": 12,
                 "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}, **kw)


def _both(models, capsys, gc, mode, quant=False, seed=0, pallas=False):
    """(port's result, JAX's result), with the printed ratio lines equal."""
    jm, tm = models[quant]
    ids = np.random.default_rng(seed).integers(1, 120, size=(LENGTH,))
    flags.use_pallas(pallas)
    try:
        ref = easykv_tpu.generate(jm, ids, gc, kv_mode=mode, stride=STRIDE)
    finally:
        flags.use_pallas(None)
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode=mode, stride=STRIDE)
    tprint = _ratio(capsys.readouterr().out)
    assert tprint == jprint and len(tprint) == 1
    return out, ref, tm.last_run


@pytest.mark.parametrize("keep", [False, True], ids=["", "keep_attention"])
@pytest.mark.parametrize("policy", ["roco", "h2o_head", "tova", "recency", "full"])
def test_encoding_matches_jax(models, policy, keep, capsys):
    with _caches() as made:
        out, ref, run = _both(models, capsys, _gc(policy, 0.5, keep_attention=keep),
                              "encoding", seed=len(policy))
    assert out == ref and len(out) == 12
    idx, _ = easykv_tpu_torch.stride_align(LENGTH, LENGTH // 2 + STRIDE, STRIDE)
    kept = LENGTH if policy == "full" else idx
    # every (layer, row, head) holds the encode's `kept` slots plus the 12
    # decode writes (encoding never evicts while decoding)
    valid = (made[-1].pos >= 0).sum(dim=-1)
    assert int(valid.min()) == int(valid.max()) == kept + 12 and run.kv_len == kept + 12


@pytest.mark.parametrize("policy,pallas", [("roco", False), ("h2o_head", False),
                                           ("h2o_head", True), ("tova", True)])
def test_encoding_int8_matches_jax(models, policy, pallas, capsys):
    out, ref, _ = _both(models, capsys, _gc(policy, 0.5), "encoding", quant=True,
                        seed=len(policy) + 1, pallas=pallas)
    assert out == ref


@pytest.mark.parametrize("policy,quant", [("roco", False), ("tova", False),
                                          ("recency", False), ("roco", True)])
def test_encoding_decoding_matches_jax(models, policy, quant, capsys):
    out, ref, run = _both(models, capsys, _gc(policy, 40), "encoding_decoding", quant=quant,
                          seed=len(policy) + 2)
    assert out == ref
    idx, _ = easykv_tpu_torch.stride_align_encdec(LENGTH, 40 + STRIDE, STRIDE)
    assert run.kv_len == idx        # one eviction per decode step keeps idx slots


@pytest.mark.parametrize("budget", [200, 40], ids=["decoding", "encoding_decoding"])
def test_auto_matches_jax(models, budget, capsys):
    out, ref, _ = _both(models, capsys, _gc("roco", budget), "auto", seed=5)
    assert out == ref


@pytest.mark.parametrize("budget", [1.0, LENGTH])
def test_full_budget_encoding_matches_jax(models, budget, capsys):
    out, ref, run = _both(models, capsys, _gc("roco", budget), "encoding", seed=6)
    assert out == ref and run.kv_len == LENGTH + 12


def test_default_kv_mode_is_encoding(models, capsys):
    """Without kv_mode both packages run `encoding`."""
    jm, tm = models[False]
    ids = np.random.default_rng(7).integers(1, 120, size=(LENGTH,))
    gc = _gc("roco", 0.5)
    out = easykv_tpu_torch.generate(tm, ids, gc, stride=STRIDE)
    assert out == easykv_tpu_torch.generate(tm, ids, gc, kv_mode="encoding", stride=STRIDE)
    assert out == easykv_tpu.generate(jm, ids, gc, stride=STRIDE)
    assert out != easykv_tpu_torch.generate(tm, ids, dict(gc, budget=8), kv_mode="decoding",
                                            stride=STRIDE)


@pytest.mark.parametrize("policy,budget,quant", [
    ("roco", 0.5, False), ("recency", 0.5, False), ("full", 1.0, False), ("roco", 0.5, True)])
def test_ppl_matches_jax(models, policy, budget, quant, capsys):
    jm, tm = models[quant]
    ids = np.random.default_rng(len(policy) + 3).integers(1, 120, size=(LENGTH,))
    gc = {"budget": budget, "kv_policy": policy, "seed": 9}
    tm = easykv_tpu_torch.enable_fixed_kv(tm, None, "encoding", stride=STRIDE)
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode="ppl", stride=STRIDE)
    jprint = _ratio(capsys.readouterr().out)
    out = tm.easykv_ppl(ids, gc)
    assert isinstance(out, float) and np.isfinite(out)
    assert out == pytest.approx(ref, rel=2e-4)
    assert _ratio(capsys.readouterr().out) == jprint


def test_encoding_batch_rows_match_single_rows(models):
    """B=2 prompts of one length in one call give each row's own tokens."""
    _, tm = models[True]
    ids = np.random.default_rng(8).integers(1, 120, size=(2, LENGTH))
    gc = _gc("roco", 0.5)
    both = easykv_tpu_torch.generate(tm, ids, gc, stride=STRIDE)
    assert both == easykv_tpu_torch.generate(tm, ids[0], gc, stride=STRIDE)
