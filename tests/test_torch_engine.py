"""End to end on the CPU: generate(kv_mode="decoding") of the port against
the JAX package's, on the same converted weights, at temperature 1e-9.
Greedy tokens and the printed budget ratio must be equal. (`random` is held
by the lockstep test: jax.random and torch draw different numbers.)"""
import re

import jax
import numpy as np
import pytest

import easykv_tpu
import easykv_tpu_torch
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama

from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.convert import from_jax_params

CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
           max_position_embeddings=512)


@pytest.fixture(scope="module")
def models():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return (easykv_tpu.CausalLM(jcfg, jparams),
            easykv_tpu_torch.CausalLM(ModelConfig(**CFG), tparams, device="cpu"))


def _ratio(text):
    return re.findall(r"KV cache budget ratio: .*", text)


@pytest.mark.parametrize("policy", ["roco", "h2o_head", "tova", "recency", "full"])
def test_generate_matches_jax(models, policy, capsys):
    jm, tm = models
    ids = np.random.default_rng(sum(map(ord, policy))).integers(1, 120, size=(30,))
    gc = {"budget": 8, "kv_policy": policy, "max_new_tokens": 22,
          "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode="decoding")
    jprint = _ratio(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="decoding")
    tprint = _ratio(capsys.readouterr().out)
    assert out == ref
    assert tprint == jprint and len(tprint) == 1
    if policy != "full":
        assert tm.last_run.kv_len - 30 == 8


def test_generate_eos_stops_and_pads(models):
    """Tokens after EOS are -1 (dropped from the returned list); the JAX
    package stops at the same place."""
    jm, tm = models
    ids = np.random.default_rng(11).integers(1, 120, size=(30,))
    gc = {"budget": 8, "kv_policy": "roco", "max_new_tokens": 40,
          "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    free = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="decoding")
    eos = free[5]
    gc["eos_token_ids"] = [eos]
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode="decoding")
    assert out == free[:free.index(eos) + 1]
    assert out == easykv_tpu.generate(jm, ids, gc, kv_mode="decoding")


@pytest.mark.parametrize("variant", [
    dict(num_key_value_heads=4),   # MHA, LLaMa-2-7B's head layout
    dict(sliding_window=12),       # Mistral-style window: K1's mask and the prefill attend
], ids=["mha", "sliding_window_gqa"])
def test_generate_variant_matches_jax(variant):
    kw = dict(CFG, **variant)
    jcfg = JModelConfig(**kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(12).integers(1, 120, size=(30,))
    gc = {"budget": 8, "kv_policy": "roco", "max_new_tokens": 16,
          "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    ref = easykv_tpu.generate(easykv_tpu.CausalLM(jcfg, jparams), ids, gc, kv_mode="decoding")
    out = easykv_tpu_torch.generate(
        easykv_tpu_torch.CausalLM(ModelConfig(**kw), tparams, device="cpu"), ids, gc,
        kv_mode="decoding")
    assert out == ref
