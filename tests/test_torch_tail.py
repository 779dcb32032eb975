"""The port's tail against the JAX package: the auxiliary score math the
reference's main path no longer calls (ops/aux_math.py), the experimental
RoPE variants (ops/rope.py), the merged eviction (cache.evict_slots_merged)
and the sampling routes beside the engine's (sampling.py). No engine path
reaches them, in either package.

Floats within 1e-6, the merged eviction's pos exact and its K / V within
1e-6, logits_adapter's filtered and raw probabilities within 1e-6. The
samplers draw from torch generators, so they are held to the JAX package's
filtered distribution and kept set, not to its draws: every draw of N rows
lies in logits_adapter's kept set, and each token's frequency is within
five standard errors (plus 1e-3) of its filtered probability.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu import cache as jcache
from easykv_tpu import sampling as jsampling
from easykv_tpu.ops import aux_math as jaux
from easykv_tpu.ops import rope as jrope

from easykv_tpu_torch import cache as tcache
from easykv_tpu_torch import sampling as tsampling
from easykv_tpu_torch.ops import aux_math as taux
from easykv_tpu_torch.ops import rope as trope

RNG = np.random.default_rng(11)


def _f(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=1e-6)


def _probs(*shape):
    p = np.abs(_f(*shape)) + 0.01
    return (p / p.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("name", ["relu_normalize", "h2o_head_decay_score",
                                  "h2o_head_prob_score_v1", "h2o_head_prob_score_v2"])
def test_aux_math_matches_jax(name):
    probs = _probs(2, 3, 5, 12)                 # (B, H, R, S)
    if name == "relu_normalize":
        p, q = _probs(4, 16), _probs(4, 16) * 0.5
        _close(taux.relu_normalize(torch.from_numpy(p), torch.from_numpy(q)),
               jaux.relu_normalize(jnp.asarray(p), jnp.asarray(q)))
    elif name == "h2o_head_decay_score":
        _close(taux.h2o_head_decay_score(torch.from_numpy(probs), 0.9),
               jaux.h2o_head_decay_score(jnp.asarray(probs), 0.9))
    else:
        mode = name[-2:]
        rows = RNG.random(5).astype(np.float32)
        got = taux.h2o_head_prob_score(torch.from_numpy(probs), torch.from_numpy(rows), mode)
        want = jaux.h2o_head_prob_score(jnp.asarray(probs), jnp.asarray(rows), mode)
        for a, b in zip(got, want):
            _close(a, b)


@pytest.mark.parametrize("name", ["grouped", "neighbor", "identical"])
def test_rope_variants_match_jax(name):
    x = _f(2, 3, 7, 16)
    pos = RNG.integers(0, 300, size=(2, 1, 7)).astype(np.int32)
    inv = jrope.rope_inv_freq(16, 10000.0)
    tinv = trope.rope_inv_freq(16, 10000.0, torch.device("cpu"))
    _close(tinv, inv)
    tx, tp = torch.from_numpy(x), torch.from_numpy(pos)
    if name == "grouped":
        got = trope.apply_grouped_rope(tx, tp, tinv, 4)
        want = jrope.apply_grouped_rope(jnp.asarray(x), jnp.asarray(pos), inv, 4)
    elif name == "neighbor":
        got = trope.apply_neighbor_rope(tx, tp, tinv, 100)
        want = jrope.apply_neighbor_rope(jnp.asarray(x), jnp.asarray(pos), inv, 100)
    else:
        got = trope.apply_identical_rope(tx, tinv)
        want = jrope.apply_identical_rope(jnp.asarray(x), inv)
    _close(got, want, atol=2e-6)


@pytest.mark.parametrize("gated", [False, True])
def test_evict_slots_merged_matches_jax(gated):
    B, H, S, D, k = 2, 3, 10, 4, 3
    kv = [_f(B, H, S, D) for _ in range(2)]
    pos = np.tile(np.arange(S, dtype=np.int32), (B, H, 1))
    pos[:, :, 8:] = -1
    side = [RNG.random((B, H, S)).astype(np.float32) for _ in range(3)]
    ids = np.stack([np.sort(RNG.choice(8, k, replace=False)) for _ in range(B * H)]
                   ).reshape(B, H, k).astype(np.int32)
    gate = np.array([True, False]) if gated else None
    want = jcache.evict_slots_merged(
        jcache.LayerCache(*map(jnp.asarray, kv + [pos] + side)), jnp.asarray(ids),
        None if gate is None else jnp.asarray(gate))
    got = tcache.KVCache(*(torch.from_numpy(a.copy()) for a in kv + [pos] + side))
    tcache.evict_slots_merged(got, torch.from_numpy(ids),
                              None if gate is None else torch.from_numpy(gate))
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(want.pos))
    _close(got.k, want.k)
    _close(got.v, want.v)
    with pytest.raises(AssertionError, match="float cache"):
        q = tcache.init_cache(1, B, H, S, D, torch.float32, torch.device("cpu"), quantized=True)
        tcache.evict_slots_merged(q.layer(0), torch.from_numpy(ids))


# (logits rows, temperature, top_p): a narrow vocabulary, ties, a flat
# 1024-wide one whose nucleus passes sample_from_logits' top-512 (its full
# sort), and top_p = 1 (its unfiltered draw)
def _sampling_cases():
    narrow = _f(3, 16) * 2.0
    ties = np.repeat(np.array([[2.0, 1.0, 1.0, 1.0, 0.0, -1.0]], np.float32), 2, axis=0)
    wide = _f(1, 1024) * 0.2
    return {"narrow": (narrow, 0.8, 0.9), "ties": (ties, 1.0, 0.5),
            "wide": (wide, 1.0, 0.95), "top_p_1": (narrow[:1], 0.7, 1.0)}


CASES = _sampling_cases()
N = 10000


def _draws(fn, logits, temp, top_p, seed):
    g = torch.Generator().manual_seed(seed)
    rows = torch.from_numpy(np.repeat(logits, N, axis=0))         # N copies of each row
    if fn == "sample_token":
        filtered, _ = tsampling.logits_adapter(rows, temp, top_p)
        return tsampling.sample_token(g, filtered).numpy()
    return getattr(tsampling, fn)(g, rows, temp, top_p).numpy()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("fn", ["logits_adapter", "sample_token", "sample_from_logits",
                                "sample_topp_sorted"])
def test_sampling_matches_jax(fn, case):
    logits, temp, top_p = CASES[case]
    filtered, raw = jsampling.logits_adapter(jnp.asarray(logits), temp, top_p)
    filtered, raw = np.asarray(filtered), np.asarray(raw)
    if fn == "logits_adapter":
        got = tsampling.logits_adapter(torch.from_numpy(logits), temp, top_p)
        _close(got[0], filtered)
        _close(got[1], raw)
        return
    draws = _draws(fn, logits, temp, top_p, seed=len(case)).reshape(len(logits), N)
    for row, p in zip(draws, filtered):
        assert (p[row] > 0).all(), "a draw outside the kept set"
        freq = np.bincount(row, minlength=p.size) / N
        tol = 5 * np.sqrt(p * (1 - p) / N) + 1e-3
        assert (np.abs(freq - p) <= tol).all(), np.abs(freq - p).max()
