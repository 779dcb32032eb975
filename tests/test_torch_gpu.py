"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors (float and int8 caches), and the
decode path with the kernels against the same path with the plain versions.
Marked `gpu`; on a machine without a CUDA device every test skips (the
fixture decides).

K6 (chunk write + attend) is held bit-exact on every cache array, int8
bytes and scales included, and to K5's limits on out and the statistics.
The ordered StreamingLLM kernels (K4, K8, K9, K2 `compact`) are held
bit-exact on every array they write, K1 `ordered` to K1's limits; the
streaming decode path with the kernels must give the plain path's tokens
and final positions.

Run on a machine with an NVIDIA H100 (tests/conftest.py imports JAX, which
such a machine need not have):  python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import contextlib
import importlib
from unittest import mock

import pytest
import torch

from easykv_tpu_torch.cache import quantize_kv
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.llama import init_params
from easykv_tpu_torch.ops.cuda.chunk_attention import (
    fused_chunk_attend, fused_chunk_attend_plain, fused_chunk_write_attend,
    fused_chunk_write_attend_plain)
from easykv_tpu_torch import flags
from easykv_tpu_torch.ops.cuda import sidecar_update
from easykv_tpu_torch.ops.cuda.decode_attention import (
    fused_decode_attend_inflight, fused_decode_attend_inflight_plain)
from easykv_tpu_torch.ops.cuda.kv_compact import (fused_compact, fused_compact_plain,
                                                  fused_kv_compact, fused_kv_compact_plain,
                                                  shift_rotation)
from easykv_tpu_torch.ops.cuda.row_write import write_rows, write_rows_plain
from easykv_tpu_torch.ops.cuda.sidecar_update import (fused_evict, fused_evict_plain,
                                                      fused_write_update,
                                                      fused_write_update_plain)
from easykv_tpu_torch.ops.rope import rope_cos_sin, rope_inv_freq
from easykv_tpu_torch.policies import PHASE_DECODE, PolicySpec

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _out_ok(got, ref):
    """bf16: the two sides' fp32 results round to the same or adjacent bf16
    values, one bf16 ulp of the reference value plus 1e-3; f32: 1e-5."""
    err = (got.float() - ref.float()).abs()
    if ref.dtype == torch.bfloat16:
        return bool((err <= (1e-3 + 2**-7 * ref.float().abs()).clamp(max=1e-2)).all())
    return err.max().item() <= 1e-5


def _positions(B, H, S, n_valid, gen):
    pos = torch.full((B, H, S), -1, dtype=torch.int32)
    pos[..., :n_valid] = torch.randperm(n_valid + 40, generator=gen)[:n_valid].sort().values
    pos[..., ::9] = -1
    return pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,q_pos,window", [
    (8, 8, (200, 230), None), (8, 2, (200, 230), None), (8, 4, (200, -1), None),
    (8, 2, (200, 230), 50)])
def test_k1_kernel_matches_plain(cuda, dtype, Hq, Hkv, q_pos, window):
    B, S, D = 2, 256, 128
    g = torch.Generator(device=cuda).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa: E731
    args = (rnd(B, Hq, 1, D), rnd(B, Hkv, 1, D), rnd(B, Hkv, 1, D), rnd(B, Hkv, S, D),
            rnd(B, Hkv, S, D), _positions(B, Hkv, S, 220, torch.Generator().manual_seed(0))
            .to(cuda), torch.tensor(q_pos, dtype=torch.int32, device=cuda))
    before = fused_decode_attend_inflight.launches
    got = fused_decode_attend_inflight(*args, sliding_window=window)
    ref = fused_decode_attend_inflight_plain(*args, sliding_window=window)
    assert fused_decode_attend_inflight.launches == before + 1
    # bf16: the plain version rounds p to bf16 before PV, the kernel keeps it
    # in fp32; the results agree to one bf16 ulp of the reference value
    err = (got[0].float() - ref[0].float()).abs()
    if dtype == torch.bfloat16:
        assert (err <= (1e-3 + 2**-7 * ref[0].float().abs()).clamp(max=1e-2)).all()
    else:
        assert err.max().item() <= 1e-5
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Hq,Hkv,q_pos,window", [
    (8, 8, (200, 230), None), (8, 2, (200, 230), None), (8, 4, (200, -1), None),
    (8, 2, (200, 230), 50)])
def test_k1_int8_kernel_matches_plain(cuda, dtype, Hq, Hkv, q_pos, window):
    B, S, D = 2, 256, 128
    g = torch.Generator(device=cuda).manual_seed(3)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    (k, ks), (v, vs) = quantize_kv(rnd(B, Hkv, S, D)), quantize_kv(rnd(B, Hkv, S, D))
    args = (rnd(B, Hq, 1, D).to(dtype), rnd(B, Hkv, 1, D).to(dtype), rnd(B, Hkv, 1, D).to(dtype),
            k, v, _positions(B, Hkv, S, 220, torch.Generator().manual_seed(3)).to(cuda),
            torch.tensor(q_pos, dtype=torch.int32, device=cuda), ks, vs)
    before = fused_decode_attend_inflight.launches
    got = fused_decode_attend_inflight(*args, sliding_window=window)
    ref = fused_decode_attend_inflight_plain(*args, sliding_window=window)
    assert fused_decode_attend_inflight.launches == before + 1
    assert _out_ok(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-5)
    if q_pos[-1] < 0:
        assert (got[0][1] == 0).all() and (got[1][1] == 0).all()


def _k5_args(cuda, B, Hq, Hkv, S, n_valid, dtype, quant, pad, seed, C=128, D=128):
    """The prefill's chunk at n_valid: slots [0, n_valid) hold positions
    0..n_valid-1, the queries sit at n_valid-C .. n_valid-1."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    pos = torch.full((B, Hkv, S), -1, dtype=torch.int32, device=cuda)
    pos[..., :n_valid] = torch.arange(n_valid, dtype=torch.int32, device=cuda)
    pos[..., 5:n_valid - C:11] = -1                      # evicted slots
    q_pos = torch.arange(n_valid - C, n_valid, dtype=torch.int32, device=cuda).repeat(B, 1)
    if pad:
        q_pos[-1, C - 9:] = -1
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    q = rnd(B, Hq, C, D).to(dtype)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return q, k, v, pos, q_pos, ks, vs
    return q, k.to(dtype), v.to(dtype), pos, q_pos


@pytest.mark.parametrize("S", [256, 768])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
@pytest.mark.parametrize("scores,Hkv,pad,window", [
    (False, 8, False, None), (True, 8, False, None), (True, 2, True, None),
    (True, 8, False, 100)], ids=["prefill", "scores", "gqa-padding", "window"])
def test_k5_kernel_matches_plain(cuda, S, kv, scores, Hkv, pad, window):
    args = _k5_args(cuda, 2, 8, Hkv, S, S * 2 // 3, torch.bfloat16, kv == "int8", pad, S)
    before = fused_chunk_attend.launches
    got = fused_chunk_attend(*args, need_scores=scores, sliding_window=window)
    ref = fused_chunk_attend_plain(*args, need_scores=scores, sliding_window=window)
    assert fused_chunk_attend.launches == before + 1
    assert _out_ok(got[0], ref[0])
    if pad:
        assert (got[0][-1, :, -9:] == 0).all()
    if scores:
        for a, b in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    else:
        assert got[1:] == (None, None, None)


@pytest.mark.parametrize("kv", ["int8", "f32"])
def test_k5_f32_kernel_matches_plain(cuda, kv):
    args = _k5_args(cuda, 1, 8, 4, 512, 400, torch.float32, kv == "int8", True, 5)
    got = fused_chunk_attend(*args)
    ref = fused_chunk_attend_plain(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def k6_args(dev, B, Hq, Hkv, S, n_valid, dtype, quant, scattered, negative, seed, C=96,
            D=128):
    """K6's arguments for one strided chunk: the cache holds positions
    0..n_valid-1 in slots [0, n_valid); contiguous ids write slots
    [n_valid, n_valid + C), scattered ones the C slots (sorted) that an
    eviction just freed. The chunk's tokens sit at n_valid + 1000 + c;
    negative initial counters are the engine's -((pos - idx) % stride)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    pos = torch.full((B, Hkv, S), -1, dtype=torch.int32)
    pos[..., :n_valid] = torch.arange(n_valid, dtype=torch.int32)
    cpu = torch.Generator().manual_seed(seed)
    if scattered:
        ids = torch.stack([torch.randperm(n_valid, generator=cpu)[:C].sort().values
                           for _ in range(B * Hkv)]).reshape(B, Hkv, C).to(torch.int32)
        pos.scatter_(-1, ids.long(), -1)
    else:
        ids = (n_valid + torch.arange(C, dtype=torch.int32)).expand(B, Hkv, C).contiguous()
    q_pos = (n_valid + 1000 + torch.arange(C, dtype=torch.int32)).repeat(B, 1)
    if negative:
        cinit = -((torch.arange(C) + 5) % 8).to(torch.float32).repeat(B, 1)
    else:
        cinit = (torch.rand((B, C), generator=cpu) * 30).floor()
    u = lambda: torch.rand((B, Hkv, S), generator=g, device=dev)  # noqa: E731
    sidecars = (pos.to(dev), u(), u() * 0.1, (u() * 50).floor())
    k, v = rnd(B, Hkv, S, D), rnd(B, Hkv, S, D)
    if quant:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    else:
        k, v, scales = k.to(dtype), v.to(dtype), ()
    return (rnd(B, Hq, C, D).to(dtype), rnd(B, Hkv, C, D).to(dtype),
            rnd(B, Hkv, C, D).to(dtype), ids.to(dev), q_pos.to(dev), cinit.to(dev),
            k, v) + sidecars + scales


K6_CACHE = ("k", "v", "pos", "score", "score_sq", "counter", "k_scale", "v_scale")


def k6_compare(args, need_scores, window):
    """(results, cache arrays) of K6 and of its plain version on copies."""
    ka = [a.clone() for a in args]
    kb = [a.clone() for a in args]
    before = fused_chunk_write_attend.launches
    got = fused_chunk_write_attend(*ka, need_scores=need_scores, sliding_window=window)
    assert fused_chunk_write_attend.launches == before + 1
    ref = fused_chunk_write_attend_plain(*kb, need_scores=need_scores, sliding_window=window)
    return got, ref, ka[6:], kb[6:]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["int8", "float"])
@pytest.mark.parametrize("scattered,scores,Hq,Hkv,window,negative", [
    (False, True, 8, 8, None, True), (True, True, 8, 8, None, False),
    (True, False, 8, 8, None, True), (True, True, 8, 2, None, True),
    (True, True, 8, 8, 150, True)],
    ids=["contiguous-scores", "scattered-scores", "scattered-noscores", "gqa4", "window"])
def test_k6_kernel_matches_plain(cuda, dtype, kv, scattered, scores, Hq, Hkv, window,
                                 negative):
    args = k6_args(cuda, 2, Hq, Hkv, 512, 384, dtype, kv == "int8", scattered, negative, 6)
    got, ref, ca, cb = k6_compare(args, scores, window)
    for name, a, b in zip(K6_CACHE, ca, cb):
        assert torch.equal(a, b), name          # int8 bytes and scales included
    if negative:
        assert (ca[5].gather(-1, args[3].long()) < 0).any()
    assert _out_ok(got[0], ref[0])
    if scores:
        for a, b in zip(got[1:], ref[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    else:
        assert got[1:] == (None, None, None)


@pytest.mark.parametrize("scale_rows", [False, True], ids=["float-cache", "int8-scale-rows"])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("policy", [None, "h2o_head", "tova", "roco", "recency", "random"])
def test_k2_kernel_bit_exact(cuda, policy, gate, scale_rows):
    L, B, H, S = 2, 2, 4, 256
    gen = torch.Generator(device=cuda).manual_seed(1)
    pos = torch.stack([_positions(B, H, S, 200, torch.Generator().manual_seed(l))
                       for l in range(L)]).to(cuda)
    pos[..., :40] = torch.arange(40, dtype=torch.int32, device=cuda)
    valid = pos >= 0
    u = lambda: torch.rand((L, B, H, S), generator=gen, device=cuda)  # noqa: E731
    score = torch.where(valid, u(), 0.0)
    state = (pos, score, score * u(), torch.where(valid, (u() * 50).floor(), 0.0),
             torch.where(valid, u() / S, 0.0), torch.rand((L, B, H, 1), generator=gen,
                                                          device=cuda) * 0.1)
    per_b = (torch.tensor([241, 241], dtype=torch.int32, device=cuda),
             torch.tensor([True, True], device=cuda), torch.tensor([True, False], device=cuda),
             torch.tensor([2.0, 0.0], device=cuda))
    kw = {}
    if policy is not None:
        kw = dict(espec=PolicySpec(policy, PHASE_DECODE, 1, 4, 6, feasible_k=14,
                                   protect_prompt=True),
                  evict_gate=torch.tensor([gate, True], device=cuda),
                  next_pos=torch.tensor([242, 242], dtype=torch.int32, device=cuda),
                  prompt_len=torch.tensor([40, 40], dtype=torch.int32, device=cuda),
                  rand_rank=torch.tensor([3, 11], dtype=torch.int32, device=cuda))
    scales = ()
    if scale_rows:
        scales = (torch.rand((L, B, H, 1), generator=gen, device=cuda),
                  torch.rand((L, B, H, 1), generator=gen, device=cuda), u(), u())
    names = ("k_sc_new", "v_sc_new", "k_scale", "v_scale")
    got = fused_write_update(*[x.clone() for x in state], *per_b, policy, **kw,
                             **{n: x.clone() for n, x in zip(names, scales)})
    ref = fused_write_update_plain(*[x.clone() for x in state], *per_b, policy, **kw,
                                   **{n: x.clone() for n, x in zip(names, scales)})
    assert len(got) == len(ref) == (7 if scale_rows else 5)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Dh", [64, 128])
def test_k3_kernel_exact(cuda, Dh):
    L, B, H, S = 2, 2, 4, 128
    g = torch.Generator(device=cuda).manual_seed(2)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(torch.bfloat16)  # noqa: E731
    k, v, kn, vn = rnd(L, B, H, S, Dh), rnd(L, B, H, S, Dh), rnd(L, B, H, 1, Dh), \
        rnd(L, B, H, 1, Dh)
    slots = torch.randint(0, S, (L, B, H), generator=g, device=cuda, dtype=torch.int32)
    ka, va = write_rows(k.clone(), v.clone(), kn, vn, slots)
    kb, vb = write_rows_plain(k.clone(), v.clone(), kn, vn, slots)
    assert torch.equal(ka, kb) and torch.equal(va, vb)


@pytest.mark.parametrize("Dh", [64, 128])
def test_k3_int8_kernel_exact(cuda, Dh):
    L, B, H, S = 2, 2, 4, 128
    g = torch.Generator(device=cuda).manual_seed(4)
    rnd = lambda *s: torch.randint(-127, 128, s, generator=g, device=cuda,  # noqa: E731
                                   dtype=torch.int8)
    k, v, kn, vn = rnd(L, B, H, S, Dh), rnd(L, B, H, S, Dh), rnd(L, B, H, 1, Dh), \
        rnd(L, B, H, 1, Dh)
    slots = torch.randint(0, S, (L, B, H), generator=g, device=cuda, dtype=torch.int32)
    ka, va = write_rows(k.clone(), v.clone(), kn, vn, slots)
    kb, vb = write_rows_plain(k.clone(), v.clone(), kn, vn, slots)
    assert torch.equal(ka, kb) and torch.equal(va, vb)


def _decode_paths(cuda, policy, kv_quant):
    """(out_ids, final pos, kv_len) of a small decode run with the kernels
    and with every kernel swapped for its plain version."""
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    llama_mod = importlib.import_module("easykv_tpu_torch.models.llama")
    plain_kernels = mock.patch.multiple(
        llama_mod, fused_decode_attend_inflight=fused_decode_attend_inflight_plain,
        fused_write_update=fused_write_update_plain, write_rows=write_rows_plain,
        fused_chunk_attend=fused_chunk_attend_plain,
        fused_chunk_write_attend=fused_chunk_write_attend_plain)
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    st = gen_mod.EngineStatics(cfg=cfg, policy=policy, length=64, budget=8,
                               max_new_tokens=24, recent_window_dec=2, kv_quant=kv_quant)
    ids = torch.randint(1, 512, (1, 64), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(cuda)
    plen = torch.tensor([50], dtype=torch.int32, device=cuda)
    outs = []
    for plain in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(0)
        with plain_kernels if plain else contextlib.nullcontext():
            res, cache, _, _ = gen_mod._run_decoding(st, params, ids, plen, 1e-9, 1.0, gen,
                                                     torch.float32)
        outs.append((res.out_ids, cache.pos, res.kv_len))
    return outs


@pytest.mark.parametrize("policy", ["roco", "tova", "full"])
def test_decode_kernel_path_matches_plain_path(cuda, policy):
    outs = _decode_paths(cuda, policy, False)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    if policy != "full":
        assert int(outs[0][2][0]) - 50 == 8


@pytest.mark.parametrize("policy", ["roco", "full"])
def test_int8_decode_kernel_path_matches_plain_path(cuda, policy):
    before = fused_chunk_attend.launches
    outs = _decode_paths(cuda, policy, True)
    assert fused_chunk_attend.launches == before + 2      # one prefill chunk per layer
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    if policy != "full":
        assert int(outs[0][2][0]) - 50 == 8


# --------------------------------------------------------------------------
# ordered StreamingLLM decoding: K4, K8, K9, K2 compact, K1 ordered
# --------------------------------------------------------------------------

SHAPES = {"small": (2, 2, 4, 256, 128), "7b": (32, 1, 32, 768, 128)}


def _ordered_sidecars(cuda, L, B, H, S, n_valid, seed):
    """An age-ordered cache: slots [0, n_valid) hold increasing positions
    (prompt 0..n_valid/2, then generated tokens with gaps), the rest free."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    cpu = torch.Generator().manual_seed(seed)
    plen = n_valid // 2
    pos = torch.full((L, B, H, S), -1, dtype=torch.int32)
    gen_pos = torch.stack([plen + torch.randperm(2 * n_valid, generator=cpu)[:n_valid - plen]
                           .sort().values for _ in range(L * B * H)])
    pos[..., :plen] = torch.arange(plen, dtype=torch.int32)
    pos[..., plen:n_valid] = gen_pos.reshape(L, B, H, -1).to(torch.int32)
    pos = pos.to(cuda)
    valid = pos >= 0
    u = lambda: torch.rand((L, B, H, S), generator=gen, device=cuda)  # noqa: E731
    score = torch.where(valid, u(), 0.0)
    return pos, score, score * u(), torch.where(valid, (u() * 50).floor(), 0.0), plen


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("policy", ["h2o_head", "tova", "roco", "recency", "random"])
def test_k4_kernel_bit_exact(cuda, policy, shape):
    L, B, H, S, _ = SHAPES[shape]
    n_valid = S * 3 // 4
    pos, score, ssq, counter, plen = _ordered_sidecars(cuda, L, B, H, S, n_valid, 5)
    B2 = max(B, 2)
    if B2 != B:
        pos, score, ssq, counter = (torch.cat([x, x.flip(2)], dim=1) for x in
                                    (pos, score, ssq, counter))
    spec = PolicySpec(policy, PHASE_DECODE, 1, 4, 12, feasible_k=30, protect_prompt=True)
    per_b = (torch.tensor([True, False] + [True] * (B2 - 2), device=cuda),
             torch.full((B2,), 3 * S, dtype=torch.int32, device=cuda),
             torch.full((B2,), plen, dtype=torch.int32, device=cuda),
             torch.arange(B2, dtype=torch.int32, device=cuda) * 7 + 3)
    a = [x.clone() for x in (pos, score, ssq, counter)]
    b = [x.clone() for x in (pos, score, ssq, counter)]
    before = fused_evict.launches
    fused_evict(*a, *per_b, spec)
    assert fused_evict.launches == before + 1
    fused_evict_plain(*b, *per_b, spec)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    drop = (pos >= 0).sum(-1) - (a[0] >= 0).sum(-1)
    assert (drop[:, 0] == 1).all() and (drop[:, 1] == 0).all()


def _kv(cuda, L, B, H, S, D, kind, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    k = torch.randn((L, B, H, S, D), generator=g, device=cuda)
    v = torch.randn((L, B, H, S, D), generator=g, device=cuda)
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        return k, v, ks, vs
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    return k.to(dtype), v.to(dtype), None, None


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("rotate", [True, False], ids=["rotate", "shift"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_k9_kernel_bit_exact(cuda, kind, rotate, shape):
    L, B, H, S, D = SHAPES[shape]
    k, v, ks, vs = _kv(cuda, L, B, H, S, D, kind, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    v_slot = torch.randint(S // 2, S * 3 // 4, (L, B, H), generator=g, device=cuda,
                           dtype=torch.int32)
    flat = v_slot.view(-1)
    flat[:5] = torch.tensor([0, 31, 32, S - 1, S], dtype=torch.int32)   # tile edges, none
    rot = shift_rotation(rope_inv_freq(D, 10000.0, cuda)) if rotate else None
    arrs = [x for x in (k, v, ks, vs) if x is not None]
    a = [x.clone() for x in arrs]
    b = [x.clone() for x in arrs]
    kw = lambda xs: dict(k_scale=xs[2], v_scale=xs[3]) if ks is not None else {}  # noqa: E731
    before = fused_kv_compact.launches
    fused_kv_compact(a[0], a[1], v_slot, rot=rot, **kw(a))
    assert fused_kv_compact.launches == before + 1
    fused_kv_compact_plain(b[0], b[1], v_slot, rot=rot, **kw(b))
    for name, x, y in zip(("k", "v", "k_scale", "v_scale"), a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_k8_kernel_bit_exact(cuda, kind, shape):
    L, B, H, S, D = SHAPES[shape]
    pos, score, ssq, counter, plen = _ordered_sidecars(cuda, L, B, H, S, S * 3 // 4, 9)
    k, v, ks, vs = _kv(cuda, L, B, H, S, D, kind, 10)
    g = torch.Generator(device=cuda).manual_seed(11)
    victim = torch.randint(plen, S * 3 // 4, (L, B, H, 1), generator=g, device=cuda)
    fires = torch.rand((L, B, H, 1), generator=g, device=cuda) < 0.8
    post = pos.clone()
    post.scatter_(-1, victim, torch.where(fires, -1, post.gather(-1, victim)))
    arrs = [x for x in (post, score, ssq, counter, k, v, ks, vs) if x is not None]
    a = [x.clone() for x in arrs]
    b = [x.clone() for x in arrs]
    before = fused_compact.launches
    fused_compact(pos, *a)
    assert fused_compact.launches == before + 1
    fused_compact_plain(pos, *b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    n = (a[0] >= 0).sum(-1)
    assert torch.equal(a[0] >= 0, torch.arange(S, device=cuda) < n[..., None])


@pytest.mark.parametrize("scale_rows", [False, True], ids=["float-cache", "int8-scale-rows"])
@pytest.mark.parametrize("policy", ["h2o_head", "tova", "roco", "recency", "random"])
def test_k2_compact_kernel_bit_exact(cuda, policy, scale_rows):
    for shape in SHAPES:
        L, B, H, S, _ = SHAPES[shape]
        B = max(B, 2)
        pos, score, ssq, counter, plen = _ordered_sidecars(cuda, L, B, H, S, S * 3 // 4, 12)
        gen = torch.Generator(device=cuda).manual_seed(13)
        state = (pos, score, ssq, counter,
                 torch.where(pos >= 0, torch.rand(pos.shape, generator=gen, device=cuda) / S,
                             0.0),
                 torch.rand((L, B, H, 1), generator=gen, device=cuda) * 0.1)
        per_b = (torch.full((B,), 3 * S, dtype=torch.int32, device=cuda),
                 torch.ones(B, dtype=torch.bool, device=cuda),
                 torch.ones(B, dtype=torch.bool, device=cuda),
                 torch.zeros(B, device=cuda))
        kw = dict(espec=PolicySpec(policy, PHASE_DECODE, 1, 4, 12, feasible_k=30,
                                   protect_prompt=True),
                  evict_gate=torch.tensor([True, False], device=cuda),
                  next_pos=torch.full((B,), 3 * S + 1, dtype=torch.int32, device=cuda),
                  prompt_len=torch.full((B,), plen, dtype=torch.int32, device=cuda),
                  rand_rank=torch.tensor([3, 11], dtype=torch.int32, device=cuda),
                  compact=True)
        scales = ()
        if scale_rows:
            scales = (torch.rand((L, B, H, 1), generator=gen, device=cuda),
                      torch.rand((L, B, H, 1), generator=gen, device=cuda),
                      torch.rand(pos.shape, generator=gen, device=cuda),
                      torch.rand(pos.shape, generator=gen, device=cuda))
        names = ("k_sc_new", "v_sc_new", "k_scale", "v_scale")
        got = fused_write_update(*[x.clone() for x in state], *per_b, policy, **kw,
                                 **{n: x.clone() for n, x in zip(names, scales)})
        ref = fused_write_update_plain(*[x.clone() for x in state], *per_b, policy, **kw,
                                       **{n: x.clone() for n, x in zip(names, scales)})
        assert len(got) == len(ref) == (8 if scale_rows else 6)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), shape
        assert (got[-1][:, 1] == S).all() and (got[-1][:, 0] < S).all()


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("Hq,Hkv,B", [(32, 32, 1), (32, 8, 2), (8, 8, 2)],
                         ids=["mha-7b", "gqa-b2", "small"])
def test_k1_ordered_kernel_matches_plain(cuda, kind, Hq, Hkv, B):
    S, D = 768, 128
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(14)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    k, v, ks, vs = _kv(cuda, 1, B, Hkv, S, D, kind, 15)
    k, v = k[0], v[0]
    scales = () if ks is None else (ks[0], vs[0])
    pos = torch.full((B, Hkv, S), -1, dtype=torch.int32, device=cuda)
    pos[..., :712] = torch.arange(712, dtype=torch.int32, device=cuda)
    q_pos = torch.full((B,), 800, dtype=torch.int32, device=cuda)
    rot = tuple(x.contiguous() for x in rope_cos_sin(
        torch.arange(S, dtype=torch.int32, device=cuda), rope_inv_freq(D, 10000.0, cuda)))
    args = (rnd(B, Hq, 1, D).to(dtype), rnd(B, Hkv, 1, D).to(dtype), rnd(B, Hkv, 1, D).to(dtype),
            k, v, pos, q_pos) + scales
    before = fused_decode_attend_inflight.launches
    got = fused_decode_attend_inflight(*args, rot=rot)
    assert fused_decode_attend_inflight.launches == before + 1
    ref = fused_decode_attend_inflight_plain(*args, rot=rot)
    assert _out_ok(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-5)
    unrot = fused_decode_attend_inflight_plain(*args)
    assert (unrot[1] - ref[1]).abs().max() > 1e-4      # the rotation is not a no-op


def _streaming_paths(cuda, kv_quant, prerot):
    """(out_ids, final pos, kv_len) of a small streaming decode with the
    kernels and with every kernel swapped for its plain version."""
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    llama_mod = importlib.import_module("easykv_tpu_torch.models.llama")
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=64, budget=8,
                               max_new_tokens=24, recent_window_dec=2, kv_quant=kv_quant,
                               streaming=True)
    ids = torch.randint(1, 512, (1, 64), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(cuda)
    plen = torch.tensor([50], dtype=torch.int32, device=cuda)
    outs = []
    flags.use_prerot(prerot)
    try:
        for plain in (False, True):
            patches = contextlib.ExitStack()
            if plain:
                patches.enter_context(mock.patch.multiple(
                    llama_mod, fused_decode_attend_inflight=fused_decode_attend_inflight_plain,
                    fused_write_update=fused_write_update_plain, write_rows=write_rows_plain,
                    fused_chunk_attend=fused_chunk_attend_plain,
                    fused_kv_compact=fused_kv_compact_plain))
                patches.enter_context(mock.patch.object(gen_mod, "fused_compact",
                                                        fused_compact_plain))
                patches.enter_context(mock.patch.object(sidecar_update, "fused_evict",
                                                        fused_evict_plain))
            gen = torch.Generator(device=cuda).manual_seed(0)
            counts = (fused_evict.launches, fused_compact.launches, fused_kv_compact.launches)
            with patches:
                res, cache, _, _ = gen_mod._run_decoding(st, params, ids, plen, 1e-9, 1.0, gen,
                                                         torch.float32)
            launched = tuple(f.launches - c for f, c in zip(
                (fused_evict, fused_compact, fused_kv_compact), counts))
            outs.append((res.out_ids, cache.pos, res.kv_len, launched))
    finally:
        flags.use_prerot(None)
    return outs


@pytest.mark.parametrize("prerot", [True, False], ids=["prerot", "rotate-at-read"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_streaming_kernel_path_matches_plain_path(cuda, kv_quant, prerot):
    outs = _streaming_paths(cuda, kv_quant, prerot)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1][0], outs[1][1][0])        # layer 0 exact
    if not kv_quant:
        assert torch.equal(outs[0][1], outs[1][1])
    assert int(outs[0][2][0]) - 50 == 8
    assert outs[0][3] == ((0, 0, 24) if prerot else (24, 24, 0))
    assert outs[1][3] == (0, 0, 0)
