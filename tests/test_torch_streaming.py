"""The ordered StreamingLLM kernels and modules of the port against the JAX
package's, on the CPU. The Pallas kernels run in interpret mode, as
tests/test_rope_streaming.py and tests/test_sidecar_kernel.py run them.

  flags            use_prerot / prerot_enabled: default on, the override,
                   EASYKV_TPU_PREROT
  K4 plain         against Pallas `fused_evict` and the JAX package's
                   evict_cache (its XLA branch); five policies, the gate on
                   in one row and off in the other: pos and counter exact
  K8 plain         against Pallas `fused_compact` and _compact_one's XLA
                   roll + select; f32 and int8: every array exact
  K9 plain         against Pallas `fused_kv_compact`; rotate on and off,
                   f32 and int8, S=128 and S=256 (S=256 takes the TPU
                   kernel's tile-skipped int8 branch): V and v_scale exact,
                   K exact without rotation; rotated f32 K within 1e-6,
                   int8 K within one step, k_scale within 1e-6 relative
                   (cos and sin of the two frameworks may differ in the
                   last bit)
  K9 requant gap   two int8 rows one step apart, both shifted 24 times
                   through the plain K9: the gap grows past one step, and
                   stays within chip_smoke.py's int8_k_gap_limit
  K2 `compact`     plain against Pallas `fused_write_update(compact=True)`,
                   five policies, with and without the int8 scale rows:
                   bit-exact, victim slot included
  K1 `ordered`     plain (rot tables) against Pallas `ordered=True` and
                   against attend_inflight over apply_rope(k, slot); MHA
                   and GQA, f32 and int8: within 1e-5
  _prerotate_cache f32 within 1e-6 of the largest value (cos and sin of
                   angles up to S radians differ in their last bits between
                   the frameworks), int8 within one step (scales 1e-6
                   relative)
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu import policies as jpol
from easykv_tpu.cache import KVCache as JKVCache
from easykv_tpu.cache import init_cache as jinit_cache
from easykv_tpu.cache import quantize_kv as jquantize
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.ops.attention import attend_inflight as jattend_inflight
from easykv_tpu.ops.pallas import sidecar_update as jsu
from easykv_tpu.ops.pallas.decode_attention import fused_decode_attend_inflight as jk1
from easykv_tpu.ops.rope import apply_rope as japply_rope
from easykv_tpu.ops.rope import rope_inv_freq as jinv_freq

from chip_smoke import int8_k_gap_limit
from easykv_tpu_torch import flags as tflags
from easykv_tpu_torch import policies as tpol
from easykv_tpu_torch.cache import KVCache, init_cache, quantize_kv
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.llama import rotation_tables
from easykv_tpu_torch.ops.cuda.decode_attention import fused_decode_attend_inflight as tk1
from easykv_tpu_torch.ops.cuda.kv_compact import fused_compact as tk8
from easykv_tpu_torch.ops.cuda.kv_compact import fused_kv_compact as tk9
from easykv_tpu_torch.ops.cuda.kv_compact import shift_rotation
from easykv_tpu_torch.ops.cuda.sidecar_update import fused_evict as tk4
from easykv_tpu_torch.ops.cuda.sidecar_update import fused_write_update as tk2
from easykv_tpu_torch.ops.rope import rope_inv_freq as tinv_freq

jgen = importlib.import_module("easykv_tpu.engine.generate")
tgen = importlib.import_module("easykv_tpu_torch.engine.generate")

POLICIES = ["h2o_head", "tova", "roco", "recency", "random"]


def t(x):
    return torch.from_numpy(np.array(x))


def test_prerot_flag(monkeypatch):
    monkeypatch.delenv("EASYKV_TPU_PREROT", raising=False)
    assert tflags.prerot_enabled()
    monkeypatch.setenv("EASYKV_TPU_PREROT", "0")
    assert not tflags.prerot_enabled()
    tflags.use_prerot(True)
    try:
        assert tflags.prerot_enabled()
    finally:
        tflags.use_prerot(None)
    assert not tflags.prerot_enabled()


def _spec(policy, budget=20):
    rw = int(budget * 0.3)
    return dict(policy=policy, phase="decode", k=1, sink_length=4, recent_window=rw,
                feasible_k=budget - rw, protect_prompt=True)


def _sidecars(L, B, H, S, n_valid, seed, holes=3):
    """Decode-mode sidecars: slots [0, n_valid) hold positions in order,
    a few generated ones already evicted."""
    rng = np.random.default_rng(seed)
    pos = np.full((L, B, H, S), -1, np.int32)
    pos[..., :n_valid] = np.arange(n_valid)
    for idx in np.ndindex(L, B, H):
        pos[idx][rng.choice(np.arange(12, n_valid - 4), holes, replace=False)] = -1
    valid = pos >= 0
    score = np.where(valid, rng.random(pos.shape), 0).astype(np.float32)
    ssq = (score * rng.random(pos.shape)).astype(np.float32)
    counter = np.where(valid, rng.integers(1, 30, pos.shape), 0).astype(np.float32)
    return pos, score, ssq, counter, rng


# --------------------------------------------------------------------------
# K4
# --------------------------------------------------------------------------

@pytest.mark.parametrize("policy", POLICIES)
def test_k4_plain_matches_pallas_and_xla(policy):
    L, B, H, S = 2, 2, 2, 128
    pos, score, ssq, counter, _ = _sidecars(L, B, H, S, 48, seed=len(policy))
    per_b = dict(evict_gate=np.array([True, False]), next_pos=np.array([48, 48], np.int32),
                 prompt_len=np.array([12, 12], np.int32), rand_rank=np.array([5, 17], np.int32))
    spec_j, spec_t = jpol.PolicySpec(**_spec(policy)), tpol.PolicySpec(**_spec(policy))
    jargs = [jnp.asarray(x) for x in (pos, score, ssq, counter)] + \
        [jnp.asarray(per_b[k]) for k in ("evict_gate", "next_pos", "prompt_len", "rand_rank")]
    ref_p = jax.jit(functools.partial(jsu.fused_evict, spec=spec_j, interpret=True))(*jargs)
    jcache = JKVCache(jnp.zeros((L, B, H, S, 8)), jnp.zeros((L, B, H, S, 8)), *jargs[:4],
                      jnp.zeros((L, B, H, 1)), jnp.zeros((L, B, H, 1)))
    ref_x = jax.jit(lambda c: jpol.evict_cache(c, spec_j, jargs[5], jargs[6], jargs[7],
                                               jargs[4]))(jcache)
    tpos, tcnt = t(pos), t(counter)
    out = tk4(tpos, t(score), t(ssq), tcnt, *(t(per_b[k]) for k in
                                               ("evict_gate", "next_pos", "prompt_len",
                                                "rand_rank")), spec_t)
    assert out[0] is tpos and out[1] is tcnt          # in place
    for a, b, c in ((tpos, ref_p[0], ref_x.pos), (tcnt, ref_p[1], ref_x.counter)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))
    assert ((tpos >= 0).sum(-1)[:, 0] == (pos >= 0).sum(-1)[:, 0] - 1).all()
    assert ((tpos >= 0).sum(-1)[:, 1] == (pos >= 0).sum(-1)[:, 1]).all()
    # evict_cache takes K4 for a decode-phase k=1 spec
    tc = KVCache(None, None, t(pos), t(score), t(ssq), t(counter))
    tpol.evict_cache(tc, spec_t, *(t(per_b[k]) for k in ("next_pos", "prompt_len",
                                                         "rand_rank", "evict_gate")))
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(ref_x.pos))


# --------------------------------------------------------------------------
# K8
# --------------------------------------------------------------------------

def _compact_state(quant, S=128, D=8, seed=9):
    """Post-eviction state: on most heads one random slot of the 40 valid
    went invalid, the other heads did not evict."""
    rng = np.random.default_rng(seed)
    L, B, H = 2, 2, 4
    pos_mid = np.full((L, B, H, S), -1, np.int32)
    pos_mid[..., :40] = np.arange(40)
    pos = pos_mid.copy()
    for idx in np.ndindex(L, B, H):
        if rng.random() < 0.7:
            pos[idx][rng.integers(0, 40)] = -1
    dt = np.int8 if quant else np.float32
    arrays = dict(
        pos=pos, score=rng.normal(size=pos.shape).astype(np.float32),
        score_sq=(rng.normal(size=pos.shape) ** 2).astype(np.float32),
        counter=rng.integers(0, 9, pos.shape).astype(np.float32),
        k=rng.integers(-100, 100, pos.shape + (D,)).astype(dt),
        v=rng.integers(-100, 100, pos.shape + (D,)).astype(dt))
    if quant:
        arrays.update(k_scale=(rng.random(pos.shape) * 0.02).astype(np.float32),
                      v_scale=(rng.random(pos.shape) * 0.02).astype(np.float32))
    return pos_mid, arrays


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_k8_plain_matches_pallas_and_xla(quant):
    pos_mid, a = _compact_state(quant)
    names = ["pos", "score", "score_sq", "counter", "k", "v"] + (
        ["k_scale", "v_scale"] if quant else [])
    ref_p = jax.jit(functools.partial(jsu.fused_compact, interpret=True))(
        jnp.asarray(pos_mid), *(jnp.asarray(a[n]) for n in names))
    L, B, H, S = pos_mid.shape
    jc = jinit_cache(L, B, H, S, a["k"].shape[-1], dtype=jnp.float32, quantized=quant)
    jc = jc._replace(**{n: jnp.asarray(a[n]) for n in names})
    ref_x = jax.jit(jgen._compact_one)(jc, jnp.asarray(pos_mid))       # XLA roll + select
    tens = [t(a[n]) for n in names]
    tk8(t(pos_mid), *tens)
    for name, got, rp in zip(names, tens, ref_p):
        np.testing.assert_array_equal(got.numpy(), np.asarray(rp), err_msg=name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref_x, name)),
                                      err_msg=name)
    fired = ((pos_mid >= 0) & (a["pos"] < 0)).any(-1)
    assert fired.any() and not fired.all()
    assert (tens[0][..., -1] == -1).all()
    # valid slots contiguous from 0 after the shift
    p = tens[0].numpy()
    np.testing.assert_array_equal(p >= 0, np.arange(p.shape[-1]) < (p >= 0).sum(-1)[..., None])


# --------------------------------------------------------------------------
# K9
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("rotate", [True, False], ids=["rotate", "shift"])
def test_k9_plain_matches_pallas(rotate, quant, S):
    L, B, H, D = 2, 2, 4, 32
    inv_freq = np.asarray(jinv_freq(D, 10000.0))
    rng = np.random.default_rng(11 + S + quant)
    if quant:
        k = rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8)
        v = rng.integers(-127, 128, (L, B, H, S, D)).astype(np.int8)
        ksc = (rng.random((L, B, H, S)) * 0.02 + 1e-3).astype(np.float32)
        vsc = (rng.random((L, B, H, S)) * 0.02 + 1e-3).astype(np.float32)
    else:
        k = rng.standard_normal((L, B, H, S, D)).astype(np.float32)
        v = rng.standard_normal((L, B, H, S, D)).astype(np.float32)
        ksc = vsc = None
    # victims in the first, a middle and the last slot, S (none), and random
    v_slot = np.where(rng.random((L, B, H)) < 0.7, rng.integers(0, S, (L, B, H)), S)
    v_slot.flat[:4] = [0, S // 2, S - 1, S]
    v_slot = v_slot.astype(np.int32)
    kw = dict(k_scale=jnp.asarray(ksc), v_scale=jnp.asarray(vsc)) if quant else {}
    ref = jax.jit(functools.partial(jsu.fused_kv_compact, rotate=rotate, interpret=True))(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(v_slot), inv_freq=jnp.asarray(inv_freq),
        **kw)
    tk, tv = t(k), t(v)
    tkw = dict(k_scale=t(ksc), v_scale=t(vsc)) if quant else {}
    out = tk9(tk, tv, t(v_slot), rot=shift_rotation(t(inv_freq)) if rotate else None, **tkw)
    assert out[0] is tk and len(out) == len(ref)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ref[1]))
    if quant:
        np.testing.assert_array_equal(tkw["v_scale"].numpy(), np.asarray(ref[3]))
    if not rotate:
        np.testing.assert_array_equal(tk.numpy(), np.asarray(ref[0]))
        if quant:
            np.testing.assert_array_equal(tkw["k_scale"].numpy(), np.asarray(ref[2]))
    elif quant:
        d = np.abs(tk.numpy().astype(np.int32) - np.asarray(ref[0]).astype(np.int32))
        assert d.max() <= 1
        np.testing.assert_allclose(tkw["k_scale"].numpy(), np.asarray(ref[2]), rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_allclose(tk.numpy(), np.asarray(ref[0]), rtol=0, atol=1e-6)
    # untouched below each victim, moved at and above it
    below = np.arange(S)[None, None, None, :] < v_slot[..., None]
    np.testing.assert_array_equal(tv.numpy()[below], v[below])
    moved = ~below
    moved[..., -1] = False
    np.testing.assert_array_equal(tv.numpy()[moved], np.roll(v, -1, axis=3)[moved])


def test_k9_requant_gap_grows_within_limit():
    """The pre-rotated int8 cache requantizes a K row at every shift. Two
    rows one int8 step apart (one value of each pair of rows), both shifted
    by the plain K9 alone: their dequantized gap grows past one step, as
    the kernel path and the plain path drift apart on the card, and stays
    within the per-row bound chip_smoke.py holds those paths to."""
    N, D = 128, 128
    rng = np.random.default_rng(17)
    q, s = quantize_kv(torch.from_numpy(rng.standard_normal((1, 1, N, 1, D)).astype(np.float32)))
    qb = q.clone()
    j = torch.from_numpy(rng.integers(0, D, N))
    one = qb[0, 0, torch.arange(N), 0, j]
    qb[0, 0, torch.arange(N), 0, j] = torch.where(one < 127, one + 1, one - 1)
    # heads [0, N) hold path A's rows, [N, 2N) path B's; S = 1, so each
    # call moves every row onto its own slot: one shift
    k, ks = torch.cat([q, qb], dim=2), torch.cat([s, s], dim=2)
    v, vs = torch.zeros_like(k), torch.ones_like(ks)
    v_slot = torch.zeros((1, 1, 2 * N), dtype=torch.int32)
    rot = shift_rotation(tinv_freq(D, 10000.0, torch.device("cpu")))
    held = torch.ones((1, 1, N, 1), dtype=torch.bool)
    largest = 0.0
    for n in range(1, 25):
        tk9(k, v, v_slot, ks, vs, rot=rot)
        a, b = k[:, :, :N], k[:, :, N:]
        ok, reading = int8_k_gap_limit(a, ks[:, :, :N], b, ks[:, :, N:],
                                       torch.full((1, 1, N, 1), n), held)
        assert ok, f"after {n} shifts: {reading}"
        sa, sb = ks[:, :, :N], ks[:, :, N:]
        gap = (a.float() * sa[..., None] - b.float() * sb[..., None]).abs().amax(-1)
        largest = max(largest, float((gap / torch.maximum(sa, sb)).max()))
    assert largest >= 2.0          # the growth: more than one step, from K9's math alone


# --------------------------------------------------------------------------
# K2 compact
# --------------------------------------------------------------------------

@pytest.mark.parametrize("scale_rows", [False, True], ids=["float", "int8-scale-rows"])
@pytest.mark.parametrize("policy", POLICIES)
def test_k2_compact_plain_matches_pallas(policy, scale_rows):
    """Row 0's gate fires (sidecars shift at its victim), row 1's does not
    (counters un-bumped, victim slot S)."""
    L, B, H, S = 2, 2, 2, 128
    pos, score, ssq, counter, rng = _sidecars(L, B, H, S, 48, seed=3 + len(policy))
    probs = np.where(pos >= 0, rng.random(pos.shape) / S, 0).astype(np.float32)
    p_new = (rng.random((L, B, H, 1)) * 0.1).astype(np.float32)
    live = np.array([True, True])
    args = (pos, score, ssq, counter, probs, p_new, np.array([48, 48], np.int32), live,
            live.copy(), np.array([3.0, 0.0], np.float32))
    extra = dict(evict_gate=np.array([True, False]), next_pos=np.array([49, 49], np.int32),
                 prompt_len=np.full((B,), 12, np.int32), rand_rank=np.array([5, 17], np.int32))
    names = ("k_sc_new", "v_sc_new", "k_scale", "v_scale")
    scales = (rng.random((L, B, H, 1)).astype(np.float32),
              rng.random((L, B, H, 1)).astype(np.float32),
              rng.random((L, B, H, S)).astype(np.float32),
              rng.random((L, B, H, S)).astype(np.float32)) if scale_rows else ()
    ref = jax.jit(functools.partial(jsu.fused_write_update, policy=policy, interpret=True,
                                    espec=jpol.PolicySpec(**_spec(policy)), compact=True))(
        *map(jnp.asarray, args), **{k: jnp.asarray(v) for k, v in extra.items()},
        **{n: jnp.asarray(x) for n, x in zip(names, scales)})
    out = tk2(*map(t, args), policy=policy, espec=tpol.PolicySpec(**_spec(policy)),
              compact=True, **{k: t(v) for k, v in extra.items()},
              **{n: t(x) for n, x in zip(names, scales)})
    assert len(out) == len(ref) == (8 if scale_rows else 6)
    for i, (a, b) in enumerate(zip(out, ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"output {i}")
    vslot = out[-1].numpy()[..., 0]
    assert (vslot[:, 1] == S).all() and (vslot[:, 0] < S).all()
    np.testing.assert_array_equal(out[3].numpy()[:, 1], counter[:, 1])      # un-bumped
    assert (out[0].numpy()[:, 0, :, -1] == -1).all()


# --------------------------------------------------------------------------
# K1 ordered
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_k1_ordered_plain_matches_pallas_and_rope(Hq, Hkv, quant):
    B, S, D = 2, 130, 64
    rng = np.random.default_rng(31 + Hkv + quant)
    q, kn, vn = (rng.normal(size=(B, h, 1, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    pos = np.full((B, Hkv, S), -1, np.int32)
    pos[:, :, :40] = np.arange(40)
    q_pos = np.array([40, 41], np.int32)
    scales = ()
    if quant:
        (k, ks), (v, vs) = (tuple(np.asarray(x) for x in jquantize(jnp.asarray(a)))
                            for a in (k, v))
        scales = (ks, vs)
    inv_freq = jinv_freq(D, 10000.0)
    jkw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1])) if quant else {}
    ref_p = jax.jit(functools.partial(jk1, ordered=True, interpret=True))(
        *map(jnp.asarray, (q, kn, vn, k, v, pos, q_pos)), inv_freq=inv_freq, **jkw)
    # the JAX package's XLA path: dequantize, rotate by slot, plain attention
    kd = k.astype(np.float32) * (scales[0][..., None] if quant else 1)
    vd = v.astype(np.float32) * (scales[1][..., None] if quant else 1)
    k_rot = japply_rope(jnp.asarray(kd), jnp.arange(S, dtype=jnp.int32), inv_freq)
    ref_x = jattend_inflight(*map(jnp.asarray, (q, kn, vn)), k_rot, jnp.asarray(vd),
                             jnp.asarray(pos), jnp.asarray(q_pos))
    cfg = ModelConfig(vocab_size=8, hidden_size=D * Hq, intermediate_size=8,
                      num_hidden_layers=1, num_attention_heads=Hq, num_key_value_heads=Hkv)
    rot = rotation_tables(S, cfg, "cpu")
    out = tk1(*map(t, (q, kn, vn, k, v, pos, q_pos)), *map(t, scales), rot=rot)
    for a, b, c in zip(out, ref_p, ref_x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-5)


# --------------------------------------------------------------------------
# _prerotate_cache
# --------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_prerotate_cache_matches_jax(quant):
    kw = dict(vocab_size=16, hidden_size=64, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=2, max_position_embeddings=256)
    L, B, H, S, D = 2, 1, 2, 128, 32
    rng = np.random.default_rng(3 + quant)
    base = rng.standard_normal((L, B, H, S, D)).astype(np.float32)
    jc = jinit_cache(L, B, H, S, D, dtype=jnp.float32, quantized=quant)
    if quant:
        kq, ks = jquantize(jnp.asarray(base))
        jc = jc._replace(k=kq, k_scale=ks)
    else:
        jc = jc._replace(k=jnp.asarray(base))
    ref = jax.jit(lambda c: jgen._prerotate_cache(c, JModelConfig(**kw)))(jc)
    tc = init_cache(L, B, H, S, D, torch.float32, torch.device("cpu"), quantized=quant)
    tc.k.copy_(t(np.asarray(jc.k)))
    if quant:
        tc.k_scale.copy_(t(np.asarray(jc.k_scale)))
    tgen._prerotate_cache(tc, ModelConfig(**kw))
    if quant:
        d = np.abs(tc.k.numpy().astype(np.int32) - np.asarray(ref.k).astype(np.int32))
        assert d.max() <= 1
        np.testing.assert_allclose(tc.k_scale.numpy(), np.asarray(ref.k_scale), rtol=1e-6)
    else:
        want = np.asarray(ref.k)
        np.testing.assert_allclose(tc.k.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
