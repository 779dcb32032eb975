"""The plain versions of the port's three CUDA kernels against the TPU
kernels they replace, run as the JAX package's own tests run them: Pallas in
interpret mode on the CPU.

  K1 decode attention with the in-flight token  (tolerance 1e-5, f32)
  K2 sidecar pass with the folded eviction      (pos / slot / counter exact,
                                                 scores within 1e-6)
  K3 K/V row write                              (exact)

and K1's launch plan (`split_plan`: the cluster that splits S, the rings
of cache tiles, the shared memory of a block) at the shapes the card runs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu import policies as jpol
from easykv_tpu.ops.pallas.decode_attention import fused_decode_attend_inflight as jk1
from easykv_tpu.ops.pallas.row_write import write_rows as jk3
from easykv_tpu.ops.pallas.sidecar_update import fused_write_update as jk2

from easykv_tpu_torch import policies as tpol
from easykv_tpu_torch.ops.cuda import _build
from easykv_tpu_torch.ops.cuda import decode_attention as da
from easykv_tpu_torch.ops.cuda.decode_attention import fused_decode_attend_inflight as tk1
from easykv_tpu_torch.ops.cuda.row_write import write_rows as tk3
from easykv_tpu_torch.ops.cuda.sidecar_update import fused_write_update as tk2

POLICIES = [None, "h2o_head", "tova", "roco", "recency", "random"]


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("Hq,Hkv,q_pos,window", [
    (4, 4, (30, 35), None),     # MHA
    (8, 2, (30, 35), None),     # GQA
    (4, 2, (30, -1), None),     # dead second row
    (4, 2, (30, 35), 9),        # sliding window
])
def test_k1_plain_matches_pallas(Hq, Hkv, q_pos, window):
    B, S, D = 2, 128, 64
    rng = np.random.default_rng(1)
    q = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    kn = rng.normal(size=(B, Hkv, 1, D)).astype(np.float32)
    vn = rng.normal(size=(B, Hkv, 1, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    pos = rng.integers(0, 40, size=(B, Hkv, S)).astype(np.int32)
    pos[:, :, ::7] = -1
    qp = np.array(q_pos, np.int32)
    args = (q, kn, vn, k, v, pos, qp)
    ref = jax.jit(functools.partial(jk1, sliding_window=window, interpret=True))(
        *map(jnp.asarray, args))
    out = tk1(*map(t, args), sliding_window=window)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _sidecar_state(seed, L=2, B=2, H=2, S=128, n_valid=48, prompt=12):
    rng = np.random.default_rng(seed)
    pos = np.full((L, B, H, S), -1, np.int32)
    pos[..., :n_valid] = np.arange(n_valid)
    # a few evicted (free) generated slots per head, scattered
    for idx in np.ndindex(L, B, H):
        pos[idx][rng.choice(np.arange(prompt, n_valid - 4), 3, replace=False)] = -1
    valid = pos >= 0
    score = np.where(valid, rng.random(pos.shape), 0).astype(np.float32)
    ssq = (score * rng.random(pos.shape)).astype(np.float32)
    counter = np.where(valid, rng.integers(0, 30, pos.shape), 0).astype(np.float32)
    probs = np.where(valid, rng.random(pos.shape) / S, 0).astype(np.float32)
    p_new = rng.random((L, B, H, 1)).astype(np.float32) * 0.1
    return pos, score, ssq, counter, probs, p_new


@pytest.mark.parametrize("gate", ["on", "off", "mixed"])
@pytest.mark.parametrize("policy", POLICIES)
def test_k2_plain_matches_pallas(policy, gate):
    pos, score, ssq, counter, probs, p_new = _sidecar_state(7)
    B = pos.shape[1]
    q_pos = np.array([48, 48], np.int32)
    live = np.array([True, gate != "mixed"])
    upd = live.copy()
    cinit = np.array([3.0, 0.0], np.float32)
    evict_gate = {"on": [True, True], "off": [False, False],
                  "mixed": [True, False]}[gate]
    evict_gate = np.array(evict_gate) & live
    next_pos = q_pos + 1
    prompt_len = np.full((B,), 12, np.int32)
    rand_rank = np.array([5, 17], np.int32)
    budget = 20
    rw = int(budget * 0.3)

    jspec, jkw, tkw = {}, {}, {}
    if policy is not None:
        fk = max(budget - rw, 1)
        jspec = dict(espec=jpol.PolicySpec(policy, jpol.PHASE_DECODE, 1, 4, rw,
                                           feasible_k=fk, protect_prompt=True))
        tkw = dict(espec=tpol.PolicySpec(policy, tpol.PHASE_DECODE, 1, 4, rw, feasible_k=fk,
                                         protect_prompt=True))
        extra = (evict_gate, next_pos, prompt_len, rand_rank)
        for kw, conv in ((jkw, jnp.asarray), (tkw, t)):
            kw.update(zip(("evict_gate", "next_pos", "prompt_len", "rand_rank"),
                          map(conv, extra)))
    args = (pos, score, ssq, counter, probs, p_new, q_pos, live, upd, cinit)
    ref = jax.jit(functools.partial(jk2, policy=policy, interpret=True, **jspec))(
        *map(jnp.asarray, args), **jkw)
    out = tk2(*map(t, args), policy=policy, **tkw)
    names = ("pos", "score", "score_sq", "counter", "slot")
    for name, a, b in zip(names, out, ref):
        if name in ("score", "score_sq"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if policy is not None and gate != "off":
        assert (out[0].numpy() != pos).any()   # something was written / evicted


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_k3_plain_matches_pallas(dtype):
    L, B, H, S, Dh = 2, 2, 2, 128, 128
    rng = np.random.default_rng(2)
    k = jnp.asarray(rng.normal(size=(L, B, H, S, Dh)), dtype)
    v = jnp.asarray(rng.normal(size=(L, B, H, S, Dh)), dtype)
    kn = jnp.asarray(rng.normal(size=(L, B, H, 1, Dh)), dtype)
    vn = jnp.asarray(rng.normal(size=(L, B, H, 1, Dh)), dtype)
    slots = rng.integers(0, S, size=(L, B, H)).astype(np.int32)
    rk, rv = jax.jit(functools.partial(jk3, interpret=True))(k, v, kn, vn, jnp.asarray(slots))

    def tt(x):
        return t(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16 if dtype is jnp.bfloat16 else torch.float32)

    ok, ov = tk3(tt(k), tt(v), tt(kn), tt(vn), t(slots))
    np.testing.assert_array_equal(ok.float().numpy(), np.asarray(rk.astype(jnp.float32)))
    np.testing.assert_array_equal(ov.float().numpy(), np.asarray(rv.astype(jnp.float32)))


# (B, Hkv, rep, S) of K1's launches: the decode at S = 768 (bf16 / int8
# roco, B = 1 and 4), 896 (`full`), the encoding decode (2304) and
# `encoding_decoding` / `ppl` (2176), card tests at 256; B = 16 (c = 1), GQA
# rep 4 (Mistral-7B widths, B = 2 with its 512-slot window), MQA rep 32
K1_SHAPES = [(B, Hkv, rep, S) for S in (768, 896, 2176, 2304, 256)
             for B, Hkv, rep in ((1, 32, 1), (2, 32, 1), (4, 32, 1), (16, 32, 1), (2, 8, 4),
                                 (16, 8, 4), (1, 8, 4))] + [(1, 1, 32, 768), (2, 2, 4, 256)]


@pytest.mark.parametrize("kv,rot", [("bf16", 0), ("int8", 0), ("f32", 0), ("bf16", 1),
                                    ("int8", 1), ("bf16", 2), ("int8", 2), ("f32", 2)])
def test_k1_split_plan_covers_every_slot(kv, rot):
    """K1's plan at every shape the card runs it (phase 2 and 3 of
    chip_smoke.py, the card tests): each slot lies in exactly one block's
    run, every block has one, the cluster is a power of two up to 8 that
    keeps the grid within one block an SM (c = 4 at 32 pairs, 1 from 128),
    the rings hold all of a run's 32-row tiles or as many as fit in half an
    SM's shared memory (two blocks an SM), and a block's shared memory is
    within the card's."""
    for B, Hkv, rep, S in K1_SHAPES:
        p = da.split_plan(B, Hkv, rep, S, 128, kv, rot)
        nt = -(-S // da.TILE)
        assert p.cluster in (1, 2, 4, 8) and p.cluster <= nt
        assert B * Hkv * p.cluster <= da.SMS or p.cluster == 1
        assert 2 * p.cluster > min(8, nt) or B * Hkv * 2 * p.cluster > da.SMS
        if B * Hkv == 32 and S >= 256:
            assert p.cluster == 4
        hits = np.zeros(S, np.int64)
        for r in range(p.cluster):
            s0, s1 = da.block_rows(p, r, S)
            assert s1 > s0 and s0 % da.TILE == 0
            hits[s0:s1] += 1
        assert (hits == 1).all()
        assert 1 <= p.nk == p.nv <= -(-nt // p.cluster)
        assert p.smem == da.split_smem(rep, S, 128, kv, rot, p.cluster, p.nk, p.nv)
        assert p.smem <= _build.SMEM_LIMIT
        if p.smem <= da.TWO_A_SM:                         # two blocks an SM
            assert 2 * (p.smem + 1024) <= da.SM_SMEM
        if p.nk < -(-nt // p.cluster):                    # a ring: as many slots as fit
            assert da.split_smem(rep, S, 128, kv, rot, p.cluster, p.nk + 1, p.nv + 1) > \
                (da.TWO_A_SM if p.smem <= da.TWO_A_SM else _build.SMEM_LIMIT)
    # the main path's decode at S = 768: every tile of a run in flight at
    # once, two blocks' worth of shared memory an SM
    for kv_ in ("bf16", "int8"):
        p = da.split_plan(1, 32, 1, 768, 128, kv_, rot)
        assert p.cluster == 4 and (rot or (p.nk == 6 and p.smem <= da.TWO_A_SM))
    with pytest.raises(ValueError, match="head_dim 24"):
        da.split_plan(1, 32, 1, 768, 24, kv, rot)
