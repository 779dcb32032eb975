"""The plain versions of the port's three CUDA kernels against the TPU
kernels they replace, run as the JAX package's own tests run them: Pallas in
interpret mode on the CPU.

  K1 decode attention with the in-flight token  (tolerance 1e-5, f32)
  K2 sidecar pass with the folded eviction      (pos / slot / counter exact,
                                                 scores within 1e-6)
  K2 and K4 on rows at the selection's edges    (the same; ties, NaN, -0.0)
  K3 K/V row write                              (exact)

and K1's launch plan (`split_plan`: the cluster that splits S, the rings
of cache tiles, the shared memory of a block) and K2's and K4's
(`row_plan`: the warps that own a row, the slots of each lane) at the
shapes the card runs.
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
from easykv_tpu.ops.pallas.sidecar_update import fused_evict as jk4
from easykv_tpu.ops.pallas.sidecar_update import fused_write_update as jk2

from easykv_tpu_torch import policies as tpol
from easykv_tpu_torch.ops.cuda import _build
from easykv_tpu_torch.ops.cuda import decode_attention as da
from easykv_tpu_torch.ops.cuda import kv_compact as kc
from easykv_tpu_torch.ops.cuda import sidecar_update as su
from easykv_tpu_torch.ops.cuda.decode_attention import fused_decode_attend_inflight as tk1
from easykv_tpu_torch.ops.cuda.row_write import write_rows as tk3
from easykv_tpu_torch.ops.cuda.sidecar_update import fused_evict as tk4
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


@pytest.mark.parametrize("S", [16, 256, 768, 777, 2304, 6144, 6145, 8192, 11622])
def test_k2_row_plan_covers_every_slot(S):
    """K2's and K4's launch plan (`row_plan`) at the shapes the card runs
    them (chip_smoke.py's phases 2 and 5, the card tests: S = 16, 777, 768
    at B = 1, 4 and 16, 2304) and at the ends of their range: every row of
    L·B·H falls to exactly one warp or block, every slot of a row to exactly
    one lane of one warp, a lane holds at most 24 slots in registers, and a
    block stays within 256 threads and the card's shared memory; one more
    slot than that memory holds raises, as before."""
    plan = su.row_plan(S)
    assert plan.threads == 32 * plan.warps * plan.rows <= 256
    assert plan.smem <= _build.SMEM_LIMIT
    if plan.chunks:
        assert plan.chunks in su.LANE_CHUNKS and plan.smem == 0
        assert plan.warps == 1 and plan.rows == su.ROWS_A_BLOCK
        assert 128 * plan.chunks >= S
    else:
        assert S > 128 * su.LANE_CHUNKS[-1]
        assert plan.warps == su.WIDE_WARPS and plan.rows == 1 and plan.smem == 20 * S
    hits = np.zeros(S, np.int64)
    for warp in range(plan.warps):
        for lane in range(32):
            slots = su.lane_slots(plan, S, warp, lane)
            assert slots == sorted(slots)
            assert plan.chunks == 0 or len(slots) <= 4 * plan.chunks <= 24
            hits[slots] += 1
    assert (hits == 1).all()
    for B in (1, 4, 16):
        nrows = 32 * B * 32
        owned = [k * plan.rows + w for k in range(-(-nrows // plan.rows))
                 for w in range(plan.rows) if k * plan.rows + w < nrows]
        assert owned == list(range(nrows))
    expect = {16: (1, 2), 768: (1, 6), 777: (8, 0), 2304: (8, 0), 6144: (8, 0)}
    if S in expect:
        assert (plan.warps, plan.chunks) == expect[S]
    with pytest.raises(ValueError, match="shared memory"):
        su._plan_for(_build.SMEM_LIMIT // 20 + 1)


@pytest.mark.parametrize("S", [16, 768, 777, 2304])
def test_k9_shift_plan_covers_every_tail_row(S):
    """K9's row kernel (`shift_plan`, `shift_dealing`) at the shapes the card
    runs it (phase 2: S = 768, 777, 2304; the card tests: S = 16): for
    victims at slot 0, 1, inside, at S - 1, none and negative, every row of
    the tail [max(vs, 0), S) is written by exactly one round of at most the
    plan's rows, each round's rows above every earlier round's (so no round
    reads a row an earlier one wrote), and no row outside the tail. bf16 /
    int8 / f32 rows of D = 128 take the row kernel (16 / 8 / 32 lanes a row,
    64 KB of K and V a round: one round at S = 768 in int8); a row that is
    not a power of two units takes the per-head walk."""
    for D, eb, lanes in ((128, 2, 16), (128, 1, 8), (128, 4, 32), (256, 4, 32), (64, 2, 8)):
        p = kc.shift_plan(D, eb)
        assert p.lanes == lanes and p.lanes * p.units == D * eb // 16
        assert p.threads % 32 == 0 and p.threads <= 512 and p.rows * 2 * D * eb <= kc.SHIFT_TILE
        assert kc.shift_smem(p.rows, D * eb // 16) <= _build.SMEM_LIMIT
        for vs in sorted({0, 1 % S, S // 2, S - 1, S, -1, 5 % S}):
            rounds = kc.shift_dealing(p, S, vs)
            hits = np.zeros(S, np.int64)
            for i, (first, n) in enumerate(rounds):
                assert 1 <= n <= p.rows and (i == 0 or first == sum(rounds[i - 1]))
                hits[first:first + n] += 1
            assert (hits == (np.arange(S) >= max(vs, 0))).all()
    assert len(kc.shift_dealing(kc.shift_plan(128, 1), 768, 512)) == 1
    assert kc.shift_plan(96, 2).lanes == 0 and kc.shift_plan(8, 2).lanes == 0


def _edge_rows(S=128, prompt=6):
    """Sidecars (L=1, B=2, H=5, S; the TPU kernels take S % 128 == 0) whose
    heads hold the selection's edges: h0 tied scores and stds, h1 a NaN
    score, h2 a -0.0 score before a +0.0 one, h3 no candidate (every
    position inside the protected prompt), h4 a full row (positions
    0..S-1); the others positions 0..15 with a hole at slot 9."""
    rng = np.random.default_rng(21)
    L, B, H = 1, 2, 5
    pos = np.full((L, B, H, S), -1, np.int32)
    pos[..., :16] = np.arange(16)
    pos[..., 9] = -1
    pos[:, :, 3] = np.where(np.arange(S) < prompt, np.arange(S), -1)
    pos[:, :, 4] = np.arange(S)
    valid = pos >= 0
    score = np.where(valid, rng.random(pos.shape), 0).astype(np.float32)
    ssq = (score * rng.random(pos.shape)).astype(np.float32)
    counter = np.where(valid, rng.integers(1, 30, pos.shape), 0).astype(np.float32)
    score[:, :, 0], ssq[:, :, 0], counter[:, :, 0] = 0.5, 0.25, 4.0
    score[:, :, 1, 7] = np.nan
    score[:, :, 2, 8], score[:, :, 2, 11] = -0.0, 0.0
    ssq[:, :, 2, 8] = ssq[:, :, 2, 11] = 0.0
    probs = np.where(valid, rng.random(pos.shape) / S, 0).astype(np.float32)
    p_new = (rng.random((L, B, H, 1)) * 0.1).astype(np.float32)
    return pos, score, ssq, counter, probs, p_new


@pytest.mark.parametrize("policy", ["h2o_head", "tova", "roco", "recency", "random"])
@pytest.mark.parametrize("kernel", ["k2", "k2-compact", "k4"])
def test_k2_k4_plain_match_pallas_at_selection_edges(kernel, policy):
    """The plain K2 (with and without `compact`) and K4, which the card
    holds the kernels to bit for bit, against the TPU kernels in interpret
    mode on rows at the selection's edges (_edge_rows): tied keys, a NaN
    minimum, -0.0 against +0.0, no candidate, a full row (write slot 0);
    batch row 1 is dead and its gate off."""
    pos, score, ssq, counter, probs, p_new = _edge_rows()
    budget, rw = 20, 6
    specs = [m.PolicySpec(policy, m.PHASE_DECODE, 1, 4, rw, feasible_k=budget - rw,
                          protect_prompt=True) for m in (jpol, tpol)]
    per_b = dict(evict_gate=np.array([True, False]), next_pos=np.array([129, 129], np.int32),
                 prompt_len=np.array([6, 6], np.int32), rand_rank=np.array([5, 3], np.int32))
    if kernel == "k4":
        args = (pos, score, ssq, counter) + tuple(per_b.values())
        ref = jax.jit(functools.partial(jk4, spec=specs[0], interpret=True))(
            *map(jnp.asarray, args))
        out = tk4(*map(t, args), specs[1])
        names = ("pos", "counter")
    else:
        live = np.array([True, False])
        args = (pos, score, ssq, counter, probs, p_new, np.array([128, 128], np.int32), live,
                live.copy(), np.array([3.0, 0.0], np.float32))
        compact = kernel == "k2-compact"
        ref = jax.jit(functools.partial(jk2, policy=policy, interpret=True, espec=specs[0],
                                        compact=compact))(
            *map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in per_b.items()})
        out = tk2(*map(t, args), policy=policy, espec=specs[1], compact=compact,
                  **{k: t(v) for k, v in per_b.items()})
        names = ("pos", "score", "score_sq", "counter", "slot") + (("victim",) if compact else ())
    assert len(out) == len(ref) == len(names)
    for name, a, b in zip(names, out, ref):
        if name in ("score", "score_sq"):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # the dead, ungated row kept its positions
    np.testing.assert_array_equal(out[0].numpy()[:, 1], pos[:, 1])
    if kernel == "k4" and policy == "h2o_head":
        # a NaN minimum evicts nothing; of -0.0 and +0.0 the first goes
        np.testing.assert_array_equal(out[0].numpy()[0, 0, 1], pos[0, 0, 1])
        assert out[0].numpy()[0, 0, 2, 8] == -1 and out[0].numpy()[0, 0, 2, 11] == 11
