"""generate() with streaming=True in the kv_modes encoding,
encoding_decoding, auto and ppl, of the port against the JAX package's, on
the CPU, on the same converted weights, at temperature 1e-9: full-budget
encoding and ppl included, stride 1 and 8, f32 and int8 caches. Greedy
tokens and the printed budget-ratio lines must be equal, ppl within 1e-5
relative. Every policy but `random` (jax.random and torch draw different
numbers: tests/test_torch_streaming_encode.py's lockstep injects the ranks
into both packages instead). The JAX package runs its default CPU path,
whose streaming decode carries the age ranks as the port's does."""
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
LENGTH = 90


def _lines(text):
    return re.findall(r"(?i)KV cache budget ratio.*", text)


@pytest.fixture(scope="module")
def lms():
    jcfg = JModelConfig(**CFG)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    return {quant: (easykv_tpu.CausalLM(jcfg, jparams, kv_quant=quant),
                    easykv_tpu_torch.CausalLM(ModelConfig(**CFG), tparams, device="cpu",
                                              kv_quant=quant))
            for quant in (False, True)}


GEN_CASES = [  # mode, policy, budget, stride, quant
    ("encoding", "roco", 0.5, 8, False), ("encoding", "h2o_head", 0.5, 8, False),
    ("encoding", "tova", 0.5, 8, False), ("encoding", "recency", 0.5, 8, False),
    ("encoding", "full", 0.5, 8, False), ("encoding", "roco", 0.5, 8, True),
    ("encoding", "tova", 0.5, 1, False), ("encoding", "roco", 0.5, 1, True),
    ("encoding", "roco", 1.0, 8, False),
    ("encoding_decoding", "roco", 40, 8, False), ("encoding_decoding", "tova", 40, 8, True),
    ("encoding_decoding", "recency", 40, 1, False),
    ("auto", "roco", 40, 8, True), ("auto", "roco", 200, 8, False),
    ("ppl", "roco", 0.5, 8, False), ("ppl", "h2o_head", 0.5, 8, True),
    ("ppl", "recency", 0.5, 1, False), ("ppl", "roco", 1.0, 8, False),
]


@pytest.mark.parametrize("mode,policy,budget,stride,quant", GEN_CASES,
                         ids=[f"{m}-{p}-{b}-s{s}{'-int8' if q else ''}"
                              for m, p, b, s, q in GEN_CASES])
def test_streaming_generate_matches_jax(lms, mode, policy, budget, stride, quant, capsys):
    jm, tm = lms[quant]
    ids = np.random.default_rng(len(policy) + stride).integers(1, 120, size=(LENGTH,))
    gc = {"budget": budget, "kv_policy": policy, "max_new_tokens": 10, "streaming": True,
          "temperature": 1e-9, "top_p": 1.0, "eos_token_ids": [], "seed": 3}
    ref = easykv_tpu.generate(jm, ids, gc, kv_mode=mode, stride=stride)
    jprint = _lines(capsys.readouterr().out)
    out = easykv_tpu_torch.generate(tm, ids, gc, kv_mode=mode, stride=stride)
    tprint = _lines(capsys.readouterr().out)
    assert tprint == jprint and len(tprint) == (0 if mode == "ppl" and budget == 1.0 else 1)
    if mode == "ppl":
        assert isinstance(out, float) and out == pytest.approx(ref, rel=1e-5)
    else:
        assert out == ref and len(out) == 10
