"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version on the same CUDA tensors (float and int8 caches), and the
decode path with the kernels against the same path with the plain versions.
Marked `gpu`; on a machine without a CUDA device every test skips (the
fixture decides).

K6 (chunk write + attend) is held bit-exact on every cache array, int8
bytes and scales included, and to K5's limits on out and the statistics.
The ordered StreamingLLM kernels (K4, K8, K9, K2 `compact`) are held
bit-exact on every array they write, K1 `ordered` to K1's limits; K2 (every
policy, with and without scale rows and `compact`) and K4 also at the edges
of their launch plan (a row of 16 slots, B = 16, and the wide path at
S = 777 with a scalar tail, 2304 and 8192) with tied,
NaN and signed-zero scores, a row without a candidate and a dead row, and
give the same bits on two launches and on two streams at once; the
streaming decode path with the kernels must give the plain path's tokens
and final positions. The quantized-weight kernels K10-K13 are held to
their plain versions at LLaMa-2-7B widths and a ragged N (1e-5 of max|ref|
in f32, one bf16 ulp more in bf16; K11 at M from 2 to 512, both of its tile
configurations and its group split), raise on what they do not take, and
the decode path over int8 / int4 trees gives the plain path's tokens. K5
(its split attention runs and its statistics), K11 (its split groups) and
K12 (its cluster partials, also on two streams at once) give the same bits
in every run; K12 is held at M = 1..8, groups of 64 and 128, ragged widths
and x at 2- and 16-byte offsets. The
one-kernel decode step K14 is held to its plain version at small and
LLaMa-2-7B widths (each output within 1e-3 of its largest |value|, one bf16
ulp more in bf16), launches once a decode step only where the JAX package
would, and raises when its cooperative grid cannot be co-resident; its
batched twin K15 likewise, at 1 < B <= 16 (8 for GQA), MHA and GQA, with
bf16, int8 and f32 caches and a dead row. The chunk step K7 is held to its
plain version (out to K6's limit, the written rows exact, scores within
1e-5) and, bit for bit on every array and the next mask, to K6 followed by
the plain update and selection on K6's own statistics; it raises on what it
does not take; the strided encode with it gives the K6 path's tokens and
final cache. K1 (every variant and `fused_decode_attend`), whose slots
split over a thread-block cluster, is held to its plain version at the
split's edges (runs with no visible slot, a dead row, S not a multiple of
the tiles or the cluster, one block a head at B = 16, GQA rep 4 with a
window, MQA rep 32) and, with K10 on the M = 1 weight stream, gives the same
bits on two launches and on two streams; the shared memory each lays out is
the one its Python plan computes.

Run on a machine with an NVIDIA H100 (tests/conftest.py imports JAX, which
such a machine need not have):  python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import contextlib
import functools
import importlib
from unittest import mock

import pytest
import torch

from easykv_tpu_torch.cache import quantize_kv
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.llama import age_ranks_all, init_params
from easykv_tpu_torch.cache import KVCache
from easykv_tpu_torch.ops.cuda.chunk_attention import (
    chunk_step_evict_plain, fused_chunk_attend, fused_chunk_attend_plain, fused_chunk_step,
    fused_chunk_step_plain, fused_chunk_write_attend, fused_chunk_write_attend_plain)
from easykv_tpu_torch import flags
from easykv_tpu_torch.ops.cuda import sidecar_update
from easykv_tpu_torch.ops.cuda.decode_attention import (
    fused_decode_attend, fused_decode_attend_inflight, fused_decode_attend_inflight_plain,
    fused_decode_attend_plain)
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


# (B, Hq, Hkv, S, n_valid, C, D): the strided encode's chunk (C=96 of 2176
# visible slots of 2304), the same with GQA rep 4 at B=2, head_dim 64
K5_WIDE = {"encode-mha": (1, 8, 8, 2304, 2176, 96, 128),
           "encode-gqa4-b2": (2, 8, 2, 2304, 2176, 96, 128),
           "d64": (2, 8, 4, 768, 512, 128, 64)}


@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("shape", list(K5_WIDE))
def test_k5_kernel_matches_plain_at_encode_shapes(cuda, shape, kv):
    B, Hq, Hkv, S, n_valid, C, D = K5_WIDE[shape]
    dtype = torch.float32 if kv == "f32" else torch.bfloat16
    args = _k5_args(cuda, B, Hq, Hkv, S, n_valid, dtype, kv == "int8", True, 9, C=C, D=D)
    got = fused_chunk_attend(*args)
    ref = fused_chunk_attend_plain(*args)
    assert _out_ok(got[0], ref[0])
    assert (got[0][-1, :, -9:] == 0).all()
    for a, b in zip(got[1:], ref[1:]):
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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kv", ["int8", "float"])
@pytest.mark.parametrize("S,n_valid,Hkv,D", [(2304, 2080, 8, 128), (2304, 2080, 2, 128),
                                             (512, 384, 8, 64)],
                         ids=["encode-mha", "encode-gqa4", "d64"])
def test_k6_kernel_matches_plain_at_encode_shapes(cuda, dtype, kv, S, n_valid, Hkv, D):
    """A triggered strided chunk at the encode's S = 2304 (C = 96 written
    among 2080 + 96 valid slots), and head_dim 64."""
    args = k6_args(cuda, 1 if Hkv == 8 else 2, 8, Hkv, S, n_valid, dtype, kv == "int8", True,
                   True, 16, D=D)
    got, ref, ca, cb = k6_compare(args, True, None)
    for name, a, b in zip(K6_CACHE, ca, cb):
        assert torch.equal(a, b), name
    assert _out_ok(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_k5_and_k11_give_the_same_bits_every_run(cuda):
    """Two calls on the same inputs give bit-identical results: K5 with its
    attention split into runs and its statistics, K11 with its groups split
    over blocks (M = 4 and 128) and without (M = 512)."""
    from easykv_tpu_torch.ops.cuda import chunk_attention, w4_stream
    from easykv_tpu_torch.ops import quant
    args = _k5_args(cuda, 2, 8, 2, 2304, 2176, torch.bfloat16, True, False, 12, C=96)
    assert chunk_attention.attend_splits(2, 2, 4, 96, 2304) > 1
    a, b = fused_chunk_attend(*args), fused_chunk_attend(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    _, w = _qweights(cuda, "wo", 13)
    ql = quant.quantize_linear_int4(w, 128, "arith")
    for M in (4, 128, 512):
        assert (w4_stream.gemm_plan(M, 4096, 4096)[2] > 1) == (M < 512)
        x = _qx(cuda, M, 4096, torch.bfloat16, 14)
        y0 = w4_stream.w4a16_gemm_arith(x, ql["q4a"], ql["gs"])
        y1 = w4_stream.w4a16_gemm_arith(x, ql["q4a"], ql["gs"])
        assert torch.equal(y0, y1), M


# K2's and K4's launch-plan edges (sidecar_update.row_plan): (L, B, H, S)
K2_EDGES = {"S=16": (2, 2, 8, 16), "S=777": (2, 2, 8, 777), "S=2304": (2, 2, 8, 2304),
            "B=16": (2, 16, 8, 768), "S=8192": (1, 2, 8, 8192)}


def _same_bits(a, b):
    """The same bits (NaN payloads and signed zeros included)."""
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _k2_edge(cuda, L, B, H, S, seed, gate=True):
    """K2's and K4's inputs at a plan edge: an age-ordered cache (slots
    [0, 3S/4) valid) whose layer 0, batch row 0 has odd heads: 0 every
    score, score_sq and counter tied; 1 a NaN score (victim S among the
    scores); 2 a -0.0 score before a +0.0 one; 3 no candidate (every
    position in the prompt); 4 a NaN score_sq. The last batch row is dead
    (at B > 1).
    Row 0's eviction gate is `gate`, the others' alternate. Returns (state,
    per_b, ev, scales, spec)."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    cpu = torch.Generator().manual_seed(seed)
    n_valid = S * 3 // 4
    plen = n_valid // 2
    pos = torch.full((L, B, H, S), -1, dtype=torch.int32)
    pos[..., :plen] = torch.arange(plen, dtype=torch.int32)
    gen_pos = torch.stack([plen + torch.randperm(2 * n_valid, generator=cpu)[:n_valid - plen]
                           .sort().values for _ in range(L * B * H)])
    pos[..., plen:n_valid] = gen_pos.view(L, B, H, -1).to(torch.int32)
    pos[0, 0, 3, plen:] = -1
    if B > 1:
        pos[:, -1] = -1
    pos = pos.to(cuda)
    valid = pos >= 0
    u = lambda: torch.rand((L, B, H, S), generator=g, device=cuda)  # noqa: E731
    score = torch.where(valid, u() * 4, 0.0)
    ssq = score * u() * 0.1
    counter = torch.where(valid, (u() * 50).floor() + 1, 0.0)
    probs = torch.where(valid, u() / S, 0.0)
    score[0, 0, 0], ssq[0, 0, 0], counter[0, 0, 0], probs[0, 0, 0] = 0.5, 0.125, 8.0, 1.0 / S
    score[0, 0, 1, plen + 1], probs[0, 0, 1, plen + 1] = float("nan"), float("nan")
    score[0, 0, 2, plen + 2], probs[0, 0, 2, plen + 2] = -0.0, -0.0
    score[0, 0, 2, plen + 3], probs[0, 0, 2, plen + 3] = 0.0, 0.0
    ssq[0, 0, 4, plen + 1] = float("nan")
    b = torch.arange(B, device=cuda)
    nxt = 3 * S + 1
    per_b = (torch.full((B,), nxt - 1, dtype=torch.int32, device=cuda), (b != B - 1) | (B == 1),
             b % 3 != 1, (b % 2).float())
    ev = dict(next_pos=torch.full((B,), nxt, dtype=torch.int32, device=cuda),
              prompt_len=torch.full((B,), plen, dtype=torch.int32, device=cuda),
              rand_rank=(3 + 7 * b).to(torch.int32) % max(n_valid - plen, 1),
              evict_gate=torch.where(b == 0, gate, (b % 2 == 0) | (b == B - 1)))
    scales = (torch.rand((L, B, H, 1), generator=g, device=cuda),
              torch.rand((L, B, H, 1), generator=g, device=cuda), u(), u())
    spec = lambda policy: PolicySpec(policy, PHASE_DECODE, 1, 4, max(S // 8, 1),  # noqa: E731
                                     feasible_k=max(S // 4, 1), protect_prompt=True)
    state = (pos, score, ssq, counter, probs,
             torch.rand((L, B, H, 1), generator=g, device=cuda) * 0.1)
    return state, per_b, ev, scales, spec


def _k2_edge_calls(cuda, policy, gate, scale_rows, compact, seed):
    """K2 and its plain version on copies of each K2_EDGES case: yields
    (case, the kernel's outputs, the plain version's)."""
    names = ("k_sc_new", "v_sc_new", "k_scale", "v_scale")
    for i, (case, shape) in enumerate(K2_EDGES.items()):
        state, per_b, ev, scales, spec = _k2_edge(cuda, *shape, seed + i, gate)
        kw = {} if policy is None else dict(ev, espec=spec(policy), compact=compact)
        if scale_rows:
            kw.update(zip(names, scales))
        res = [fn(*[x.clone() for x in state], *per_b, policy,
                  **{n: x.clone() if torch.is_tensor(x) and x.dim() == 4 else x
                     for n, x in kw.items()})
               for fn in (fused_write_update, fused_write_update_plain)]
        yield case, *res


@pytest.mark.parametrize("scale_rows", [False, True], ids=["float-cache", "int8-scale-rows"])
@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("policy", [None, "h2o_head", "tova", "roco", "recency", "random"])
def test_k2_kernel_bit_exact(cuda, policy, gate, scale_rows):
    """At L=2, B=2, H=4, S=256, then at each of K2_EDGES (_k2_edge)."""
    for case, got, ref in _k2_edge_calls(cuda, policy, gate, scale_rows, False, 70):
        assert len(got) == len(ref) == (7 if scale_rows else 5), case
        assert all(_same_bits(a, b) for a, b in zip(got, ref)), case
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


def _k3_fold_matches(cuda, k, v, kn, vn):
    """K2 given the rows writes them where K3 writes them at K2's slots."""
    L, B, H, S, _ = k.shape
    g = torch.Generator(device=cuda).manual_seed(5)
    pos = torch.where(torch.rand((L, B, H, S), generator=g, device=cuda) < 0.8, 7, -1).int()
    z = torch.zeros((L, B, H, S), device=cuda)
    on = torch.ones(B, dtype=torch.bool, device=cuda)

    def state():
        return (pos.clone(), z.clone(), z.clone(), z.clone(), z.clone(),
                torch.zeros((L, B, H, 1), device=cuda), torch.full((B,), S, dtype=torch.int32,
                                                                   device=cuda),
                on, on, torch.zeros(B, device=cuda), None)
    ka, va, kb, vb = k.clone(), v.clone(), k.clone(), v.clone()
    fused_write_update(*state(), k=ka, v=va, kn=kn, vn=vn)
    slot = fused_write_update(*state())[4]
    write_rows(kb, vb, kn, vn, slot[..., 0].contiguous())
    assert torch.equal(ka, kb) and torch.equal(va, vb)


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
    _k3_fold_matches(cuda, k, v, kn, vn)


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
    _k3_fold_matches(cuda, k, v, kn, vn)


def _decode_paths(cuda, policy, kv_quant):
    """(out_ids, final pos, kv_len) of a small decode run with the kernels
    and with every kernel swapped for its plain version."""
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    llama_mod = importlib.import_module("easykv_tpu_torch.models.llama")
    plain_kernels = mock.patch.multiple(
        llama_mod, fused_decode_attend_inflight=fused_decode_attend_inflight_plain,
        fused_write_update=fused_write_update_plain,
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
    """At SHAPES' two shapes; with the small one also at each of K2_EDGES
    (_k2_edge)."""
    for i, (case, edge) in enumerate(K2_EDGES.items() if shape == "small" else ()):
        state, _, ev, _, spec = _k2_edge(cuda, *edge, 90 + i)
        args = (ev["evict_gate"], ev["next_pos"], ev["prompt_len"], ev["rand_rank"], spec(policy))
        a = [x.clone() for x in state[:4]]
        b = [x.clone() for x in state[:4]]
        fused_evict(*a, *args)
        fused_evict_plain(*b, *args)
        assert all(_same_bits(x, y) for x, y in zip(a, b)), case
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


@pytest.mark.parametrize("L,B,H,S", [(2, 1, 4, 16), (2, 1, 8, 777), (2, 1, 8, 2304),
                                     (2, 4, 8, 768)], ids=["S16", "S777", "S2304", "B4"])
@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
def test_k9_row_split_edges_bit_exact(cuda, kind, L, B, H, S):
    """K9's row kernel at the edges of its dealing (kv_compact.shift_dealing):
    a tail shorter than a block's rows (S = 16), S = 777, tails of several
    rounds of the cluster (S = 2304, victim 0 and -1: the wraparound row
    loaded before the first round), B = 4; victims at 0, 5, S/2, S - 33,
    S - 1, none, -1 and among the rest; rotate and shift: bit-exact."""
    D = 128
    k, v, ks, vs = _kv(cuda, L, B, H, S, D, kind, 30 + S)
    g = torch.Generator(device=cuda).manual_seed(31 + S)
    v_slot = torch.randint(0, S, (L, B, H), generator=g, device=cuda, dtype=torch.int32)
    edges = [0, 5 % S, S // 2, max(S - 33, 0), S - 1, S, -1]
    v_slot.view(-1)[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
    for rotate in (True, False):
        rot = shift_rotation(rope_inv_freq(D, 10000.0, cuda)) if rotate else None
        arrs = [x for x in (k, v, ks, vs) if x is not None]
        a = [x.clone() for x in arrs]
        b = [x.clone() for x in arrs]
        kw = lambda xs: dict(k_scale=xs[2], v_scale=xs[3]) if ks is not None else {}  # noqa: E731
        fused_kv_compact(a[0], a[1], v_slot, rot=rot, **kw(a))
        fused_kv_compact_plain(b[0], b[1], v_slot, rot=rot, **kw(b))
        for name, x, y in zip(("k", "v", "k_scale", "v_scale"), a, b):
            assert torch.equal(x, y), (name, rotate)


def test_k9_layout_matches_its_python_mirror(cuda):
    """The shared memory the C side of K9's row kernel lays out is the one
    kv_compact.shift_smem computes (which the CPU tests hold to the card's
    232,448 bytes)."""
    from easykv_tpu_torch.ops.cuda import _build, kv_compact as kc
    lib = _build.load("kv_compact", kc.SIGNATURES)
    for D, dtype, eb in ((128, 1, 2), (128, 2, 1), (128, 0, 4), (256, 0, 4), (64, 1, 2)):
        p = kc.shift_plan(D, eb)
        assert lib.kv_shift_smem(p.rows, D, dtype) == kc.shift_smem(p.rows, D * eb // 16)


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
    """At SHAPES' two shapes, then at each of K2_EDGES (_k2_edge), where
    a NaN score leaves h2o_head and tova without a victim (S)."""
    victims = set()
    for case, got, ref in _k2_edge_calls(cuda, policy, True, scale_rows, True, 110):
        assert len(got) == len(ref) == (8 if scale_rows else 6), case
        assert all(_same_bits(a, b) for a, b in zip(got, ref)), case
        victims.add(int(got[-1][0, 0, 1, 0]) == got[0].shape[-1])
    assert victims == {policy in ("h2o_head", "tova")}
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


def test_k2_k4_give_the_same_bits_every_run(cuda):
    """K2 (roco, `compact`, scale rows) and K4 (roco) keep no state between
    launches and their blocks share nothing: the same bits on two launches,
    and on two streams at once, with a warp a row (S = 768, L = 32, B = 1)
    and a block a row (S = 2304 and 8192)."""
    for shape in ((32, 1, 32, 768), (2, 2, 8, 2304), (1, 2, 8, 8192)):
        state, per_b, ev, scales, spec = _k2_edge(cuda, *shape, 130)
        kw = dict(ev, espec=spec("roco"), compact=True)

        def k2():
            return fused_write_update(*[x.clone() for x in state], *per_b, "roco", **kw,
                                      k_sc_new=scales[0], v_sc_new=scales[1],
                                      k_scale=scales[2].clone(), v_scale=scales[3].clone())

        def k4():
            a = [x.clone() for x in state[:4]]
            return fused_evict(*a, ev["evict_gate"], ev["next_pos"], ev["prompt_len"],
                               ev["rand_rank"], spec("roco"))
        for fn in (k2, k4):
            first, again = fn(), fn()
            assert all(_same_bits(a, b) for a, b in zip(first, again)), shape
            streams = [torch.cuda.Stream() for _ in range(2)]
            torch.cuda.synchronize()
            outs = []
            for _ in range(4):
                for st in streams:
                    with torch.cuda.stream(st):
                        outs.append(fn())
            torch.cuda.synchronize()
            assert all(_same_bits(a, b) for o in outs for a, b in zip(o, first)), shape


def test_k2_k4_take_their_python_plan(cuda, monkeypatch):
    """The kernels take row_plan's plan: at S = 16 and 768 (a warp a row),
    777, 2304 and 8192 (the wide path) they lay out the shared memory the
    plan computes; both refuse a team of warps a row (their register path
    is a warp's) and a plan whose lanes miss a slot."""
    lib = sidecar_update._build.load("sidecar_update", sidecar_update.SIGNATURES)
    for S in (16, 768, 777, 2304, 8192):
        p = sidecar_update.row_plan(S)
        assert lib.sidecar_smem(S, p.chunks) == p.smem
    state, per_b, ev, _, spec = _k2_edge(cuda, 2, 2, 8, 777, 140)
    for bad in (sidecar_update.RowPlan(2, 4, 1, 64, 0), sidecar_update.RowPlan(1, 6, 4, 128, 0)):
        monkeypatch.setattr(sidecar_update, "row_plan", lambda S, bad=bad: bad)
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_write_update(*[x.clone() for x in state], *per_b, "roco", **ev,
                               espec=spec("roco"))
        with pytest.raises(RuntimeError, match="launch failed"):
            fused_evict(*[x.clone() for x in state[:4]], ev["evict_gate"], ev["next_pos"],
                        ev["prompt_len"], ev["rand_rank"], spec("roco"))


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
                    fused_write_update=fused_write_update_plain,
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


# --------------------------------------------------------------------------
# StreamingLLM in the encoding family: K1 `rank`, fused_decode_attend
# --------------------------------------------------------------------------

def _unordered(cuda, B, H, S, n_valid, seed, dead_row=False):
    """Positions of the encoding family's unordered cache (n_valid distinct
    positions at random slots of each head, holes elsewhere) and their age
    ranks."""
    gen = torch.Generator().manual_seed(seed)
    pos = torch.full((B * H, S), -1, dtype=torch.int32)
    for r in range(B * H):
        pos[r, torch.randperm(S, generator=gen)[:n_valid]] = (
            torch.randperm(2 * S, generator=gen)[:n_valid].sort().values.to(torch.int32))
    pos = pos.view(B, H, S)
    if dead_row:
        pos[-1] = -1
    pos = pos.to(cuda)
    return pos, age_ranks_all(pos[None])[0]


RANK_SHAPES = {  # Hq, Hkv, B, S, dead row
    "mha-7b": (32, 32, 1, 2304, False), "gqa-rep4-dead-row": (32, 8, 2, 2304, True),
    "small": (8, 8, 2, 256, False)}


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", list(RANK_SHAPES))
def test_k1_rank_kernel_matches_plain(cuda, kind, shape):
    Hq, Hkv, B, S, dead = RANK_SHAPES[shape]
    D = 128
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(21)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)  # noqa: E731
    k, v, ks, vs = _kv(cuda, 1, B, Hkv, S, D, kind, 22)
    scales = () if ks is None else (ks[0], vs[0])
    pos, ranks = _unordered(cuda, B, Hkv, S, S * 7 // 8, 23, dead)
    q_pos = torch.full((B,), 2 * S, dtype=torch.int32, device=cuda)
    if dead:
        q_pos[-1] = -1
    rot = tuple(x.contiguous() for x in rope_cos_sin(
        torch.arange(S, dtype=torch.int32, device=cuda), rope_inv_freq(D, 10000.0, cuda)))
    args = (rnd(B, Hq, 1, D).to(dtype), rnd(B, Hkv, 1, D).to(dtype), rnd(B, Hkv, 1, D).to(dtype),
            k[0], v[0], pos, q_pos) + scales
    before = (fused_decode_attend_inflight.launches, fused_decode_attend_inflight.rank_launches)
    got = fused_decode_attend_inflight(*args, rot=rot, rank=ranks)
    assert (fused_decode_attend_inflight.launches,
            fused_decode_attend_inflight.rank_launches) == (before[0] + 1, before[1] + 1)
    ref = fused_decode_attend_inflight_plain(*args, rot=rot, rank=ranks)
    assert _out_ok(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=0, atol=1e-5)
    if dead:
        assert (got[0][-1] == 0).all() and (got[1][-1] == 0).all()
    by_slot = fused_decode_attend_inflight_plain(*args, rot=rot)
    assert (by_slot[1] - ref[1]).abs().max() > 1e-4     # ranks are not slots here


def test_k1_rank_needs_the_tables(cuda):
    args = (torch.zeros((1, 8, 1, 128), device=cuda),) * 3 + (
        torch.zeros((1, 8, 256, 128), device=cuda),) * 2 + (
        torch.zeros((1, 8, 256), dtype=torch.int32, device=cuda),
        torch.zeros((1,), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="rot"):
        fused_decode_attend_inflight(*args, rank=args[5])


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape,window", [("mha-7b", None), ("mha-7b", 512),
                                          ("gqa-rep4-dead-row", None), ("small", 40)])
def test_decode_attend_kernel_matches_plain(cuda, kind, shape, window):
    Hq, Hkv, B, S, dead = RANK_SHAPES[shape]
    D = 128
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(24)
    k, v, ks, vs = _kv(cuda, 1, B, Hkv, S, D, kind, 25)
    scales = () if ks is None else (ks[0], vs[0])
    pos, _ = _unordered(cuda, B, Hkv, S, S * 7 // 8, 26, dead)
    q_pos = pos.amax(dim=(1, 2)).to(torch.int32)          # the newest row is the query's own
    args = (torch.randn((B, Hq, 1, D), generator=g, device=cuda).to(dtype), k[0], v[0], pos,
            q_pos) + scales
    before = fused_decode_attend.launches
    got = fused_decode_attend(*args, sliding_window=window)
    assert fused_decode_attend.launches == before + 1
    ref = fused_decode_attend_plain(*args, sliding_window=window)
    assert _out_ok(got[0], ref[0])
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)
    if dead:
        assert (got[0][-1] == 0).all() and (got[1][-1] == 0).all()


# K1's split edges: (B, Hq, Hkv, S, window, cluster of the plan)
K1_EDGES = {
    "masked-runs": (1, 32, 32, 768, None, 4),      # slots 300.. free: blocks 2 and 3 see none
    "dead-row": (2, 32, 32, 768, None, 2),         # q_pos -1 in row 1
    "ragged-S": (1, 32, 32, 777, None, 4),         # 25 tiles, the last of 9 rows
    "b16-c1": (16, 32, 32, 768, None, 1),          # 512 pairs: one block a head
    "gqa-rep4-window": (2, 32, 8, 768, 512, 8),    # Mistral-7B's heads, a 512-slot window
    "mqa-rep32": (1, 32, 1, 768, None, 8),         # 32 rep rows: PV in several passes
}
K1_VARIANTS = ("plain", "ordered", "rank", "decode_attend")


def _k1_edge(cuda, case, kind, variant, seed=60):
    """The variant's kernel and plain results at one of K1's split edges."""
    from easykv_tpu_torch.ops.cuda.decode_attention import split_plan
    B, Hq, Hkv, S, window, cluster = K1_EDGES[case]
    D = 128
    dtype = torch.float32 if kind == "f32" else torch.bfloat16
    g = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda).to(dtype)  # noqa: E731
    k, v, ks, vs = _kv(cuda, 1, B, Hkv, S, D, kind, seed + 1)
    scales = () if ks is None else (ks[0], vs[0])
    if case == "masked-runs":
        pos = torch.full((B, Hkv, S), -1, dtype=torch.int32, device=cuda)
        pos[..., :300] = torch.randperm(300, generator=torch.Generator().manual_seed(seed)).to(
            device=cuda, dtype=torch.int32)
        ranks = age_ranks_all(pos[None])[0]
    else:
        pos, ranks = _unordered(cuda, B, Hkv, S, S * 7 // 8, seed + 2, dead_row=case == "dead-row")
    q_pos = torch.full((B,), 2 * S, dtype=torch.int32, device=cuda)
    if case == "dead-row":
        q_pos[-1] = -1
    rot = tuple(x.contiguous() for x in rope_cos_sin(
        torch.arange(S, dtype=torch.int32, device=cuda), rope_inv_freq(D, 10000.0, cuda)))
    kv = "int8" if kind == "int8" else kind
    rid = {"plain": 0, "ordered": 1, "rank": 2, "decode_attend": 0}[variant]
    assert split_plan(B, Hkv, Hq // Hkv, S, D, kv, rid).cluster == cluster
    q = rnd(B, Hq, 1, D)
    if variant == "decode_attend":
        args = (q, k[0], v[0], pos, q_pos) + scales
        return (fused_decode_attend(*args, sliding_window=window),
                fused_decode_attend_plain(*args, sliding_window=window))
    kw = dict(sliding_window=window)
    if variant != "plain":
        kw["rot"] = rot
    if variant == "rank":
        kw["rank"] = ranks
    args = (q, rnd(B, Hkv, 1, D), rnd(B, Hkv, 1, D), k[0], v[0], pos, q_pos) + scales
    return (fused_decode_attend_inflight(*args, **kw),
            fused_decode_attend_inflight_plain(*args, **kw))


@pytest.mark.parametrize("kind", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("case", list(K1_EDGES))
@pytest.mark.parametrize("variant", K1_VARIANTS)
def test_k1_split_edges_match_plain(cuda, variant, case, kind):
    """K1 (plain, `ordered`, `rank`) and `fused_decode_attend`, their slots
    split over a cluster, against their plain versions where the split has
    edges: runs with no visible slot (their local max -inf, e = 0), a dead
    row, S not a multiple of the 32-row tiles or of the cluster, one block a
    (batch, kv head) at B = 16, GQA rep 4 with a 512-slot window, MQA rep 32;
    out to K1's limit, probs (and p_new) within 1e-5, a dead row all zero."""
    got, ref = _k1_edge(cuda, case, kind, variant)
    torch.cuda.synchronize()
    assert _out_ok(got[0], ref[0])
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    if case == "dead-row":
        assert (got[0][-1] == 0).all() and (got[1][-1] == 0).all()
    if case == "masked-runs":
        assert (got[1][..., 300:] == 0).all()


def test_k1_gives_the_same_bits_every_run(cuda):
    """K1's blocks share nothing but their cluster's distributed shared
    memory, added in rank order, and keep no state between launches: every
    variant gives the same bits on two launches, and on two streams at
    once."""
    for variant in K1_VARIANTS:
        for kind in ("bf16", "int8"):
            first, _ = _k1_edge(cuda, "ragged-S", kind, variant, seed=61)
            again, _ = _k1_edge(cuda, "ragged-S", kind, variant, seed=61)
            assert all(torch.equal(a, b) for a, b in zip(first, again)), (variant, kind)
            streams = [torch.cuda.Stream() for _ in range(2)]
            torch.cuda.synchronize()
            outs = []
            for _ in range(8):
                for st in streams:
                    with torch.cuda.stream(st):
                        outs.append(_k1_edge(cuda, "ragged-S", kind, variant, seed=61)[0])
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for o in outs for a, b in zip(o, first)), (variant, kind)


@pytest.mark.parametrize("stride", [8, 1])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_streaming_encode_kernel_path_matches_plain_path(cuda, kv_quant, stride):
    """generate(streaming=True) in `encoding` and `ppl` on a small model,
    with the kernels and with every kernel swapped for its plain version:
    equal tokens and final positions (int8: layer 0's), ppl within 1e-5
    relative; the kernel path runs K1's rank variant on every decode step
    (and every stride-1 chunk)."""
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    llama_mod = importlib.import_module("easykv_tpu_torch.models.llama")
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    n, new = 96, 12
    ids = torch.randint(1, 512, (1, n), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(cuda)
    b = n // 2 + stride
    idx, r_idx = gen_mod.stride_align(n, b, stride)
    common = dict(cfg=cfg, policy="roco", length=n, budget=b, idx=idx, r_idx=r_idx,
                  stride=stride, max_new_tokens=new, recent_window=b // 10,
                  recent_window_dec=int(b * 0.3), kv_quant=kv_quant, streaming=True)
    outs = []
    for plain in (False, True):
        patches = contextlib.ExitStack()
        if plain:
            patches.enter_context(mock.patch.multiple(
                llama_mod, fused_decode_attend_inflight=fused_decode_attend_inflight_plain,
                fused_write_update=fused_write_update_plain,
                fused_chunk_attend=fused_chunk_attend_plain))
        ranked = fused_decode_attend_inflight.rank_launches
        with patches:
            st = gen_mod.EngineStatics(mode="encoding", **common)
            res, _, cache, _ = gen_mod._run_encoding(
                st, params, ids, 1e-9, 1.0, torch.Generator(device=cuda).manual_seed(0),
                torch.float32)
            st = gen_mod.EngineStatics(mode="ppl", **common)
            loss, _, _ = gen_mod._run_ppl(st, params, ids, torch.Generator(device=cuda)
                                          .manual_seed(0), torch.float32)
        outs.append((res.out_ids, cache.pos, float(loss[0]),
                     fused_decode_attend_inflight.rank_launches - ranked))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1][0], outs[1][1][0])        # layer 0 exact
    if not kv_quant:
        assert torch.equal(outs[0][1], outs[1][1])
    assert outs[0][2] == pytest.approx(outs[1][2], rel=1e-5)
    steps = new + (2 * (n - r_idx) if stride == 1 else 0)  # encoding's and ppl's chunks
    assert outs[0][3] == cfg.num_hidden_layers * steps and outs[1][3] == 0


# --------------------------------------------------------------------------
# quantized weights: K10-K13 against their plain versions
# --------------------------------------------------------------------------

# (K, N) at LLaMa-2-7B width: the fused tree, the split tree's extra widths,
# the LM head (N = 32000 is not a multiple of 512) and a ragged N whose rows
# are not a whole number of 16-byte loads
W7B = {"wqkv": (4096, 12288), "wo": (4096, 4096), "wgu": (4096, 22016), "wd": (11008, 4096),
       "wg": (4096, 11008), "head": (4096, 32000), "n300": (4096, 300)}


def _quant_close(got, ref):
    """f32: within 1e-5 of max|ref| (the order of the f32 sums); bf16: the
    two f32 sums round to the same or adjacent bf16 values, so one bf16 ulp
    of the reference value plus that."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    tol = 1e-5 * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        tol = tol + 2**-7 * ref.float().abs()
    return bool((err <= tol).all())


def _qweights(cuda, name, seed):
    from easykv_tpu_torch.ops import quant
    K, N = W7B[name]
    g = torch.Generator(device=cuda).manual_seed(seed)
    return quant, torch.randn((K, N), generator=g, device=cuda) * 0.02


def _qx(cuda, M, K, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return torch.randn((M, K), generator=g, device=cuda).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["wqkv", "wo", "wgu", "wd", "wg", "head", "n300"])
def test_k10_kernel_matches_plain(cuda, name, dtype):
    from easykv_tpu_torch.ops.cuda.w4_stream import w4a16_gemv_arith, w4a16_gemv_arith_plain
    quant, w = _qweights(cuda, name, 1)
    ql = quant.quantize_linear_int4(w, 128, "arith")
    x = _qx(cuda, 1, w.shape[0], dtype, 2)
    before = w4a16_gemv_arith.launches
    got = w4a16_gemv_arith(x, ql["q4a"], ql["gs3"])
    ref = w4a16_gemv_arith_plain(x, ql["q4a"], ql["gs3"])
    torch.cuda.synchronize()
    assert w4a16_gemv_arith.launches == before + 1
    assert _quant_close(got, ref)


@pytest.mark.parametrize("group,K", [(64, 4096), (8, 4096), (24, 3072), (136, 2176),
                                     (256, 4096)])
def test_k10_kernel_matches_plain_at_other_groups(cuda, group, K):
    """K10 with groups other than the main path's 128 carrier rows: several
    groups a stage (64, 8, 24), a group straddling stages (136) and a group
    spanning two (256), x in bf16 and f32, N = 4096 and a ragged 264."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.w4_stream import w4a16_gemv_arith, w4a16_gemv_arith_plain
    for N in (4096, 264):
        g = torch.Generator(device=cuda).manual_seed(group + N)
        ql = quant.quantize_linear_int4(torch.randn((K, N), generator=g, device=cuda) * 0.02,
                                        group, "arith")
        assert ql["gs3"].shape[0] == K // group
        for dtype in (torch.bfloat16, torch.float32):
            x = _qx(cuda, 1, K, dtype, 50 + group)
            got = w4a16_gemv_arith(x, ql["q4a"], ql["gs3"])
            ref = w4a16_gemv_arith_plain(x, ql["q4a"], ql["gs3"])
            torch.cuda.synchronize()
            assert _quant_close(got, ref), (group, N, dtype)


@pytest.mark.parametrize("N", [40, 264, 4112])
@pytest.mark.parametrize("x_offset", [0, 2, 16], ids=["x-aligned", "x+2B", "x+16B"])
def test_k10_ragged_widths_and_offsets(cuda, N, x_offset):
    """K10 at widths that are not a multiple of 16 (40, 264: the producer's
    own loads of carrier and scales) or of its 256-column slab (4112: a
    partial slab by the tensor map and bulk copies), x at a 2- and a 16-byte
    offset (an f32 x at 4 bytes for 2), bf16 and f32 x."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.w4_stream import w4a16_gemv_arith, w4a16_gemv_arith_plain
    g = torch.Generator(device=cuda).manual_seed(N)
    ql = quant.quantize_linear_int4(torch.randn((2048, N), generator=g, device=cuda) * 0.02,
                                    128, "arith")
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.tensor([], dtype=dtype).element_size()
        off = -(-x_offset // size)
        base = torch.randn((2048 + 16,), generator=g, device=cuda).to(dtype)
        x = base[off:off + 2048].view(1, 2048)
        assert (x.data_ptr() - base.data_ptr()) == off * size
        got = w4a16_gemv_arith(x, ql["q4a"], ql["gs3"])
        ref = w4a16_gemv_arith_plain(x, ql["q4a"], ql["gs3"])
        torch.cuda.synchronize()
        assert _quant_close(got, ref)


def test_k10_gives_the_same_bits_every_run(cuda):
    """K10's cluster partials add in rank order and it keeps no state
    between launches (no workspace, no ticket): two launches give the same
    bits, and so do launches in flight on two streams at once (wq, wd:
    clusters of 8)."""
    from easykv_tpu_torch.ops.cuda import _wstream
    from easykv_tpu_torch.ops.cuda.quant_matmul import gemv_plan
    from easykv_tpu_torch.ops.cuda.w4_stream import w4a16_gemv_arith, w4a16_gemv_arith_plain
    rows_before = dict(_wstream._rows)
    for name in ("wo", "wd"):
        quant, w = _qweights(cuda, name, 74)
        ql = quant.quantize_linear_int4(w, 128, "arith")
        assert gemv_plan(w.shape[0] // 2, w.shape[1], 128).cluster > 1
        xs = [_qx(cuda, 1, w.shape[0], torch.bfloat16, 75 + i) for i in range(2)]
        first = [w4a16_gemv_arith(x, ql["q4a"], ql["gs3"]) for x in xs]
        assert all(torch.equal(a, w4a16_gemv_arith(x, ql["q4a"], ql["gs3"]))
                   for a, x in zip(first, xs))
        streams = [torch.cuda.Stream() for _ in range(2)]
        torch.cuda.synchronize()
        outs = []
        for _ in range(32):
            for i, (st, x) in enumerate(zip(streams, xs)):
                with torch.cuda.stream(st):
                    outs.append((i, w4a16_gemv_arith(x, ql["q4a"], ql["gs3"])))
        torch.cuda.synchronize()
        assert all(torch.equal(y, first[i]) for i, y in outs)
        assert all(_quant_close(a, w4a16_gemv_arith_plain(x, ql["q4a"], ql["gs3"]))
                   for a, x in zip(first, xs))
    assert dict(_wstream._rows) == rows_before          # no ticket row taken


@pytest.mark.parametrize("M", [2, 4, 16, 96, 128, 511, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["wqkv", "wo", "wgu", "wd", "n300"])
def test_k11_kernel_matches_plain(cuda, name, dtype, M):
    from easykv_tpu_torch.ops.cuda.w4_stream import w4a16_gemm_arith, w4a16_gemm_arith_plain
    quant, w = _qweights(cuda, name, 3)
    ql = quant.quantize_linear_int4(w, 128, "arith")
    x = _qx(cuda, M, w.shape[0], dtype, 4)
    before = w4a16_gemm_arith.launches
    got = w4a16_gemm_arith(x, ql["q4a"], ql["gs"])
    ref = w4a16_gemm_arith_plain(x, ql["q4a"], ql["gs"])
    torch.cuda.synchronize()
    assert w4a16_gemm_arith.launches == before + 1
    assert _quant_close(got, ref)


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["wo", "wg", "wd", "head", "n300"])
def test_k12_kernel_matches_plain(cuda, name, dtype, M):
    from easykv_tpu_torch.ops.cuda.w4_matmul import w4a16_gemv, w4a16_gemv_plain
    quant, w = _qweights(cuda, name, 5)
    ql = quant.quantize_linear_int4(w, 128, "halves")
    x = _qx(cuda, M, w.shape[0], dtype, 6)
    got = w4a16_gemv(x, ql["q4p"], ql["gs"])
    ref = w4a16_gemv_plain(x, ql["q4p"], ql["gs"])
    torch.cuda.synchronize()
    assert _quant_close(got, ref)


@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("name", ["wo", "wg", "wd", "head"])
def test_k12_kernel_matches_plain_at_every_row_count(cuda, name, group, M):
    """K12 at every LLaMa-2-7B product width mm sends it (wq = wk = wv = wo,
    wg = wu, wd, the head), M = 1..8, groups of 64 and 128, x in bf16 and
    f32: within the quantized kernels' limit, one launch a call."""
    from easykv_tpu_torch.ops.cuda.w4_matmul import w4a16_gemv, w4a16_gemv_plain
    quant, w = _qweights(cuda, name, 30 + group)
    ql = quant.quantize_linear_int4(w, group, "halves")
    for dtype in (torch.bfloat16, torch.float32):
        x = _qx(cuda, M, w.shape[0], dtype, 31 + M)
        before = w4a16_gemv.launches
        got = w4a16_gemv(x, ql["q4p"], ql["gs"])
        ref = w4a16_gemv_plain(x, ql["q4p"], ql["gs"])
        torch.cuda.synchronize()
        assert w4a16_gemv.launches == before + 1
        assert got.dtype == dtype and _quant_close(got, ref)


@pytest.mark.parametrize("N", [40, 264, 4112])
@pytest.mark.parametrize("x_offset", [0, 2, 16], ids=["x-aligned", "x+2B", "x+16B"])
def test_k12_ragged_widths_and_offsets(cuda, N, x_offset):
    """K12 at widths that are not a multiple of 16 (40, 264: the masked
    copies) or of its 256-column slab (4112: a partial slab by bulk copy),
    with x at a 2-byte offset (the masked copies) and at a 16-byte offset
    (bulk copies), M = 1, 3, 8, bf16 x."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.w4_matmul import w4a16_gemv, w4a16_gemv_plain
    g = torch.Generator(device=cuda).manual_seed(N)
    ql = quant.quantize_linear_int4(torch.randn((2048, N), generator=g, device=cuda) * 0.02,
                                    128, "halves")
    for M in (1, 3, 8):
        base = torch.randn((M * 2048 + 8,), generator=g, device=cuda).to(torch.bfloat16)
        x = base[x_offset // 2:x_offset // 2 + M * 2048].view(M, 2048)
        assert (x.data_ptr() - base.data_ptr()) == x_offset
        got = w4a16_gemv(x, ql["q4p"], ql["gs"])
        ref = w4a16_gemv_plain(x, ql["q4p"], ql["gs"])
        torch.cuda.synchronize()
        assert _quant_close(got, ref)


def test_k12_gives_the_same_bits_every_run(cuda):
    """K12's cluster partials add in rank order and nothing is shared between
    launches: two launches give the same bits, and so do launches in flight
    on two streams at once (wd: clusters of 6; wg: of 5)."""
    from easykv_tpu_torch.ops.cuda.w4_matmul import plan, w4a16_gemv, w4a16_gemv_plain
    for name, cluster in (("wd", 6), ("wg", 5)):
        quant, w = _qweights(cuda, name, 40)
        ql = quant.quantize_linear_int4(w, 128, "halves")
        assert plan(1, w.shape[0] // 2, w.shape[1], 128).cluster == cluster
        xs = [_qx(cuda, M, w.shape[0], torch.bfloat16, 41 + M) for M in (1, 4)]
        first = [w4a16_gemv(x, ql["q4p"], ql["gs"]) for x in xs]
        assert all(torch.equal(a, w4a16_gemv(x, ql["q4p"], ql["gs"])) for a, x in zip(first, xs))
        streams = [torch.cuda.Stream() for _ in range(2)]
        torch.cuda.synchronize()
        outs = []
        for _ in range(32):
            for i, (st, x) in enumerate(zip(streams, xs)):
                with torch.cuda.stream(st):
                    outs.append((i, w4a16_gemv(x, ql["q4p"], ql["gs"])))
        torch.cuda.synchronize()
        assert all(torch.equal(y, first[i]) for i, y in outs)
        assert all(_quant_close(a, w4a16_gemv_plain(x, ql["q4p"], ql["gs"]))
                   for a, x in zip(first, xs))


@pytest.mark.parametrize("out_f32", [False, True], ids=["x-dtype", "f32-out"])
@pytest.mark.parametrize("M", [1, 4, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["wqkv", "wo", "wd", "head", "n300"])
def test_k13_kernel_matches_plain(cuda, name, dtype, M, out_f32):
    from easykv_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    quant, w = _qweights(cuda, name, 7)
    ql = quant.quantize_linear(w)
    x = _qx(cuda, M, w.shape[0], dtype, 8)
    got = quant_matmul(x, ql["q"], ql["s"], out_f32=out_f32)
    ref = quant_matmul_plain(x, ql["q"], ql["s"], out_f32=out_f32)
    torch.cuda.synchronize()
    assert _quant_close(got, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["wqkv", "wo", "wgu", "wd", "head"])
def test_k13_m1_kernel_matches_plain_at_every_width(cuda, name, dtype):
    """K13's M = 1 kernel (csrc/quant_gemv.cu) at the fused tree's four
    products and the LM head, x in f32 and bf16, out in x's dtype and in
    f32, within quant_limit's bar of its plain version; one launch each."""
    from easykv_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    quant, w = _qweights(cuda, name, 70)
    ql = quant.quantize_linear(w)
    x = _qx(cuda, 1, w.shape[0], dtype, 71)
    for out_f32 in (False, True):
        before = quant_matmul.launches
        got = quant_matmul(x, ql["q"], ql["s"], out_f32=out_f32)
        ref = quant_matmul_plain(x, ql["q"], ql["s"], out_f32=out_f32)
        torch.cuda.synchronize()
        assert quant_matmul.launches == before + 1
        assert _quant_close(got, ref) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("N", [40, 264, 4112])
@pytest.mark.parametrize("x_offset", [0, 2, 16], ids=["x-aligned", "x+2B", "x+16B"])
def test_k13_m1_ragged_widths_and_offsets(cuda, N, x_offset):
    """K13 at M = 1 at widths that are not a multiple of 16 (40, 264: the
    producer's own loads) or of its 256-column slab (4112: a partial slab by
    the tensor map), x at a 2- and a 16-byte offset (an f32 x at 4 bytes for
    2), bf16 and f32 x."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    g = torch.Generator(device=cuda).manual_seed(N)
    ql = quant.quantize_linear(torch.randn((2048, N), generator=g, device=cuda) * 0.02)
    for dtype in (torch.bfloat16, torch.float32):
        size = torch.tensor([], dtype=dtype).element_size()
        off = -(-x_offset // size)
        base = torch.randn((2048 + 16,), generator=g, device=cuda).to(dtype)
        x = base[off:off + 2048].view(1, 2048)
        assert (x.data_ptr() - base.data_ptr()) == off * size
        got = quant_matmul(x, ql["q"], ql["s"])
        ref = quant_matmul_plain(x, ql["q"], ql["s"])
        torch.cuda.synchronize()
        assert _quant_close(got, ref)


def test_k13_m1_gives_the_same_bits_every_run(cuda):
    """K13's M = 1 cluster partials add in rank order and it keeps no state
    between launches (no workspace, no ticket): two launches give the same
    bits, and so do launches in flight on two streams at once."""
    from easykv_tpu_torch.ops.cuda.quant_matmul import (gemv_plan, quant_matmul,
                                                        quant_matmul_plain)
    for name in ("wo", "wd"):
        quant, w = _qweights(cuda, name, 72)
        ql = quant.quantize_linear(w)
        assert gemv_plan(*w.shape).cluster > 1
        xs = [_qx(cuda, 1, w.shape[0], torch.bfloat16, 73 + i) for i in range(2)]
        first = [quant_matmul(x, ql["q"], ql["s"]) for x in xs]
        assert all(torch.equal(a, quant_matmul(x, ql["q"], ql["s"])) for a, x in zip(first, xs))
        streams = [torch.cuda.Stream() for _ in range(2)]
        torch.cuda.synchronize()
        outs = []
        for _ in range(32):
            for i, (st, x) in enumerate(zip(streams, xs)):
                with torch.cuda.stream(st):
                    outs.append((i, quant_matmul(x, ql["q"], ql["s"])))
        torch.cuda.synchronize()
        assert all(torch.equal(y, first[i]) for i, y in outs)
        assert all(_quant_close(a, quant_matmul_plain(x, ql["q"], ql["s"]))
                   for a, x in zip(first, xs))


K13_EDGES = (2, 3, 4, 5, 16, 17, 128, 255, 256)


@pytest.mark.parametrize("M", K13_EDGES)
def test_k13_tensor_core_kernel_at_its_edges(cuda, M):
    """K13 at 1 < M <= 256 (csrc/quant_matmul.cu) at the edges of its tile
    configurations (x rows on the MMA's 8-wide side up to 8 and 16, 64-,
    128- and 256-row tiles) over the fused tree's four products and the LM
    head (f32 out), x in bf16 and f32: within the plain version's limit, one
    launch a call, and the same bits from a second launch."""
    from easykv_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    for name in ("wqkv", "wo", "wgu", "wd", "head"):
        quant, w = _qweights(cuda, name, 90)
        ql = quant.quantize_linear(w)
        del w
        for dtype in (torch.bfloat16, torch.float32):
            x = _qx(cuda, M, ql["q"].shape[0], dtype, 91 + M)
            kw = dict(out_f32=name == "head")
            before = quant_matmul.launches
            got = quant_matmul(x, ql["q"], ql["s"], **kw)
            again = quant_matmul(x, ql["q"], ql["s"], **kw)
            assert quant_matmul.launches == before + 2
            ref = quant_matmul_plain(x, ql["q"], ql["s"], **kw)
            torch.cuda.synchronize()
            assert _quant_close(got, ref), (name, dtype)
            assert torch.equal(got, again), (name, dtype)


@pytest.mark.parametrize("N", [40, 264, 4112])
@pytest.mark.parametrize("x_offset", [0, 2, 16], ids=["x-aligned", "x+2B", "x+16B"])
def test_k13_ragged_widths_and_offsets(cuda, N, x_offset):
    """K13 at M = 3, 16 and 100 (small tiles, large tiles) at widths that are
    not a multiple of 16 (40, 264: element copies of the weight) or of a
    column tile (4112), x at a 2- and a 16-byte offset (element copies of x
    at 2), and K = 2056 (not a multiple of a stage's rows: the last stage
    zero-filled); bf16 and f32 x."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.quant_matmul import quant_matmul, quant_matmul_plain
    g = torch.Generator(device=cuda).manual_seed(N)
    K = 2056
    ql = quant.quantize_linear(torch.randn((K, N), generator=g, device=cuda) * 0.02)
    for M in (3, 16, 100):
        for dtype in (torch.bfloat16, torch.float32):
            size = torch.tensor([], dtype=dtype).element_size()
            off = -(-x_offset // size)
            base = torch.randn((M * K + 16,), generator=g, device=cuda).to(dtype)
            x = base[off:off + M * K].view(M, K)
            got = quant_matmul(x, ql["q"], ql["s"])
            ref = quant_matmul_plain(x, ql["q"], ql["s"])
            torch.cuda.synchronize()
            assert _quant_close(got, ref), (M, dtype)


def test_k13_takes_its_python_plan(cuda, monkeypatch):
    """The shared memory the C side of K13 at M > 1 lays out is the one
    matmul_smem computes (which the CPU tests hold to the card's 232,448
    bytes), and the kernel gives the same results under other stage rows,
    stages and clusters than the plan's (the row split adds in rank
    order: the sums differ only in their order)."""
    from easykv_tpu_torch.ops.cuda import _build, quant_matmul as qm
    lib = _build.load("quant_matmul", qm.SIGNATURES)
    for K, N in W7B.values():
        for M in K13_EDGES:
            for x_f32 in (False, True):
                p = qm.matmul_plan(M, K, N, x_f32)
                assert lib.quant_matmul_smem(int(p.small), p.rows, p.rs, p.stages,
                                             4 if x_f32 else 2) == qm.matmul_smem(p, x_f32)
    quant, w = _qweights(cuda, "wo", 95)
    ql = quant.quantize_linear(w)
    plan = qm.matmul_plan
    for M in (4, 128):
        x = _qx(cuda, M, 4096, torch.bfloat16, 96)
        ref = qm.quant_matmul_plain(x, ql["q"], ql["s"])
        for rs, stages, cluster in ((64, 2, 1), (128, 2, 8), (64, 6, 2)):
            alt = plan(M, 4096, 4096, False)._replace(rs=rs, stages=stages, cluster=cluster)
            monkeypatch.setattr(qm, "matmul_plan", lambda *a, alt=alt: alt)
            got = qm.quant_matmul(x, ql["q"], ql["s"])
            torch.cuda.synchronize()
            assert _quant_close(got, ref), (M, rs, stages, cluster)
        monkeypatch.setattr(qm, "matmul_plan", plan)


def test_k1_and_k10_layouts_match_their_python_mirrors(cuda):
    """The shared memory the C side of K1 and of K10 lays out is the one
    their Python plans compute (decode_attention.split_smem,
    quant_matmul.gemv_smem with the group), which the CPU tests hold to the
    card's 232,448 bytes."""
    from easykv_tpu_torch.ops.cuda import _build, decode_attention as da, quant_matmul
    lib1 = _build.load("decode_attention", da.SIGNATURES)
    for B, Hkv, rep, S in ((1, 32, 1, 768), (1, 32, 1, 2304), (16, 32, 1, 768), (2, 8, 4, 2304),
                           (1, 1, 32, 768), (4, 32, 1, 777)):
        for kv, dtype, kv_int8 in (("bf16", 1, 0), ("int8", 1, 1), ("f32", 0, 0)):
            for rot in (0, 1, 2):
                p = da.split_plan(B, Hkv, rep, S, 128, kv, rot)
                got = lib1.decode_attend_inflight_smem(rep, S, 128, dtype, kv_int8, rot, *p[:3])
                assert got == p.smem, (B, Hkv, rep, S, kv, rot)
    lib10 = _build.load("quant_gemv", quant_matmul.GEMV_SIGNATURES)
    for K, N in W7B.values():
        for G in (128, 64, 24, 136):
            if (K // 2) % G:
                continue
            p = quant_matmul.gemv_plan(K // 2, N, G)
            assert (lib10.w4a16_gemv_arith_smem(K, G, p.rs, p.stages, p.cluster)
                    == quant_matmul.gemv_smem(K // 2, p, G))


def test_k13_and_k14_layouts_match_their_python_mirrors(cuda):
    """The shared memory the C side of K13 (M = 1) and K14 lays out is the
    one their Python mirrors compute (quant_matmul.gemv_smem,
    fused_decode.slot_layout), which the CPU tests hold to the card's
    232,448 bytes."""
    from easykv_tpu_torch.ops.cuda import _build, fused_decode, quant_matmul
    lib13 = _build.load("quant_gemv", quant_matmul.GEMV_SIGNATURES)
    for K, N in W7B.values():
        p = quant_matmul.gemv_plan(K, N)
        assert lib13.quant_gemv_smem(K, p.rs, p.stages, p.cluster) == quant_matmul.gemv_smem(K, p)
    lib14 = _build.load("fused_decode", fused_decode.SIGNATURES)
    for D, F, Hq, Hkv, L, S, group in {**K14_SHAPES, **K14_RAGGED}.values():
        Dh = D // Hq
        groups = (D // 2 // group, Hq * Dh // 2 // group, D // 2 // group, F // 2 // group)
        prods = fused_decode.products(D, F, Hq, Hkv, Dh, groups)
        for dtype, kv_int8, kv_bytes in ((1, 0, 2), (0, 0, 4), (1, 1, 1)):
            if Dh % (16 // kv_bytes):
                continue
            slot, slots, total = fused_decode.slot_layout(prods, Hq, Hkv, Dh, S, kv_bytes)
            args = (D, F, Hq, Hkv, Dh, S, *groups, dtype, kv_int8)
            assert lib14.fused_decode_step_smem(*args) == total
            assert lib14.fused_decode_step_slots(*args) == slots


def test_quant_kernels_raise_on_what_they_do_not_take(cuda):
    """A CUDA tensor of a type, shape or layout a kernel does not take
    raises, and nothing runs: neither the kernel nor its plain version."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda import quant_matmul as k13, w4_matmul as k12, w4_stream
    w = torch.randn((512, 256), device=cuda) * 0.02
    q8, q4a, q4p = (quant.quantize_linear(w), quant.quantize_linear_int4(w, 128, "arith"),
                    quant.quantize_linear_int4(w, 128, "halves"))
    q4a64 = quant.quantize_linear_int4(w, 64, "arith")
    x1 = torch.randn((1, 512), device=cuda)
    cases = [
        (TypeError, lambda: k13.quant_matmul(x1.half(), q8["q"], q8["s"])),
        (ValueError, lambda: k13.quant_matmul(torch.randn((257, 512), device=cuda), q8["q"],
                                              q8["s"])),
        (ValueError, lambda: k13.quant_matmul(x1, q8["q"].t().contiguous().t(), q8["s"])),
        (ValueError, lambda: k13.quant_matmul(x1, q8["q"].float(), q8["s"])),
        (TypeError, lambda: k12.w4a16_gemv(x1.double(), q4p["q4p"], q4p["gs"])),
        (ValueError, lambda: k12.w4a16_gemv(torch.randn((9, 512), device=cuda), q4p["q4p"],
                                            q4p["gs"])),
        (ValueError, lambda: w4_stream.w4a16_gemv_arith(torch.randn((2, 512), device=cuda),
                                                        q4a["q4a"], q4a["gs3"])),
        (ValueError, lambda: w4_stream.w4a16_gemv_arith(x1, q4a["q4a"], q4a["gs"])),
        (ValueError, lambda: w4_stream.w4a16_gemm_arith(torch.randn((4, 512), device=cuda),
                                                        q4a64["q4a"], q4a64["gs"])),
        (ValueError, lambda: w4_stream.w4a16_gemm_arith(
            torch.randn((512, 4), device=cuda).t(), q4a["q4a"], q4a["gs"])),
    ]
    fns = (k13.quant_matmul, k12.w4a16_gemv, w4_stream.w4a16_gemv_arith,
           w4_stream.w4a16_gemm_arith)
    before = [f.launches for f in fns]
    plains = {n: mock.Mock(side_effect=AssertionError("plain version ran"))
              for n in ("quant_matmul_plain", "w4a16_gemv_plain")}
    with mock.patch.multiple(k13, quant_matmul_plain=plains["quant_matmul_plain"]), \
            mock.patch.multiple(k12, w4a16_gemv_plain=plains["w4a16_gemv_plain"]), \
            mock.patch.object(w4_stream, "grouped_int4",
                              mock.Mock(side_effect=AssertionError("plain version ran"))):
        for exc, call in cases:
            with pytest.raises(exc):
                call()
    assert [f.launches for f in fns] == before


def test_quant_kernels_reject_groups_of_other_than_8_rows(cuda):
    """An int4 group of 86 rows (in-dim 1376) is not a whole number of the
    kernels' row chunks: K10 and K12 raise for it, and mm sends it to the
    grouped product, which gives the CPU's result without a launch."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda import w4_matmul, w4_stream
    w = torch.randn((1376, 512), device=cuda) * 0.02
    x = torch.randn((1, 1376), device=cuda)
    G = quant._fit_group(1376, 128)
    assert G == 86
    fns = (w4_stream.w4a16_gemv_arith, w4_matmul.w4a16_gemv)
    before = [f.launches for f in fns]
    for layout, fn, keys in (("arith", fns[0], ("q4a", "gs3")), ("halves", fns[1], ("q4p", "gs"))):
        ql = quant.quantize_linear_int4(w, G, layout)
        with pytest.raises(ValueError, match="group of 86"):
            fn(x, *(ql[k] for k in keys))
        got = quant.mm(x, ql)
        ref = quant.mm(x.cpu(), quant.QuantLinear(**{k: ql[k].cpu() for k in ql.keys()}))
        assert _quant_close(got.cpu(), ref)
    assert [f.launches for f in fns] == before


def test_split_products_on_two_streams(cuda):
    """Split-row products in flight on two streams at once: K11 at M = 4 (a
    B = 4 decode row), whose groups split over blocks, takes its tickets
    from separate rows; K13 at M = 4, whose rows split over a cluster (no
    ticket), gives the same bits on both streams; every result matches its
    plain version."""
    from easykv_tpu_torch.ops.cuda import _wstream
    from easykv_tpu_torch.ops.cuda.quant_matmul import (matmul_plan, quant_matmul,
                                                        quant_matmul_plain)
    from easykv_tpu_torch.ops.cuda.w4_stream import (gemm_plan, w4a16_gemm_arith,
                                                     w4a16_gemm_arith_plain)
    quant, w = _qweights(cuda, "wo", 11)
    q8, q4 = quant.quantize_linear(w), quant.quantize_linear_int4(w, 128, "arith")
    assert matmul_plan(4, 4096, 4096, False).cluster > 1
    assert gemm_plan(4, 4096, 4096)[2] > 1
    streams = [torch.cuda.Stream() for _ in range(2)]
    xs = [_qx(cuda, 4, 4096, torch.bfloat16, 20 + i) for i in range(2)]
    torch.cuda.synchronize()
    outs = []
    for _ in range(64):
        for i, (s, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(s):
                outs.append((i, quant_matmul(x, q8["q"], q8["s"]),
                             w4a16_gemm_arith(x, q4["q4a"], q4["gs"])))
    torch.cuda.synchronize()
    rows = {_wstream._rows[(xs[0].device, s.cuda_stream)].data_ptr() for s in streams}
    assert len(rows) == 2
    refs = [(quant_matmul_plain(x, q8["q"], q8["s"]),
             w4a16_gemm_arith_plain(x, q4["q4a"], q4["gs"])) for x in xs]
    for i, y8, y4 in outs:
        assert torch.equal(y8, outs[i][1]) and torch.equal(y4, outs[i][2])   # run to run
        assert _quant_close(y8, refs[i][0]) and _quant_close(y4, refs[i][1])


def _quant_decode_paths(cuda, tree, B):
    """(out_ids, final pos) of a small decode run on a quantized tree with
    the kernels, and with K10-K13 swapped for their plain versions."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.quant_matmul import quant_matmul_plain
    from easykv_tpu_torch.ops.cuda.w4_matmul import w4a16_gemv_plain
    from easykv_tpu_torch.ops.cuda.w4_stream import (w4a16_gemm_arith_plain,
                                                     w4a16_gemv_arith_plain)
    from easykv_tpu_torch.ops.cuda.fused_decode import fused_decode_step_plain
    from easykv_tpu_torch.ops.cuda.fused_decode_batch import fused_decode_step_batch_plain
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    llama_mod = importlib.import_module("easykv_tpu_torch.models.llama")
    plain = contextlib.ExitStack()
    plain.enter_context(mock.patch.multiple(quant, quant_matmul=quant_matmul_plain,
                                            w4a16_gemv=w4a16_gemv_plain,
                                            w4a16_gemv_arith=w4a16_gemv_arith_plain,
                                            w4a16_gemm_arith=w4a16_gemm_arith_plain))
    plain.enter_context(mock.patch.multiple(
        llama_mod, fused_decode_step=fused_decode_step_plain,
        fused_decode_step_batch=fused_decode_step_batch_plain))
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=768,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    params = {"int8": lambda p: quant.fuse_gemv_params(quant.quantize_params(p)),
              "int4 arith fused": lambda p: quant.fuse_gemv_params(
                  quant.quantize_params_int4(p, layout="arith")),
              "int4 arith split": lambda p: quant.quantize_params_int4(p, layout="arith"),
              "int4 halves split": quant.quantize_params_int4}[tree](params)
    st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=64, budget=8,
                               max_new_tokens=24, recent_window_dec=2)
    ids = torch.randint(1, 512, (B, 64), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(cuda)
    plen = torch.full((B,), 50, dtype=torch.int32, device=cuda)
    outs = []
    for use_plain in (False, True):
        gen = torch.Generator(device=cuda).manual_seed(0)
        with plain if use_plain else contextlib.nullcontext():
            res, cache, _, _ = gen_mod._run_decoding(st, params, ids, plen, 1e-9, 1.0, gen,
                                                     torch.float32)
        outs.append((res.out_ids, cache.pos))
    return outs


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("tree", ["int8", "int4 arith split", "int4 arith fused",
                                  "int4 halves split"])
def test_quant_decode_kernel_path_matches_plain_path(cuda, tree, B):
    outs = _quant_decode_paths(cuda, tree, B)
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# K14: the one-kernel decode step
# ---------------------------------------------------------------------------

K14_SHAPES = {  # D, F, Hq, Hkv, L, S, group
    "small": (256, 512, 4, 2, 2, 256, 64),
    "7b": (4096, 11008, 32, 32, 2, 768, 128),
}
# wqkv 216, wo and wd 72 columns: not multiples of 16 (9 heads of 8, groups of 12)
K14_RAGGED = {"small-ragged": (72, 192, 9, 9, 2, 256, 12)}


def _k14_close(got, ref):
    """Within 1e-3 of the output's largest |value| (the two-plane feed
    rounds, so one-ulp differences before it move a product by a step of
    the feed; the JAX package holds this feed to its scan at 1e-3), plus
    one bf16 ulp of the value in bf16."""
    assert got.dtype == ref.dtype and got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    tol = 1e-3 * ref.float().abs().max()
    if ref.dtype == torch.bfloat16:
        tol = tol + 2**-7 * ref.float().abs()
    return bool((err <= tol).all()) and bool(torch.isfinite(got.float()).all())


@functools.lru_cache(maxsize=None)
def _fused_tree(D, F, Hq, Hkv, L, group, window, dtype):
    """(config, the fused arithmetic-int4 tree) of L layers at these widths,
    quantized on the card from `dtype` weights drawn from seed 3."""
    from easykv_tpu_torch.ops import quant
    cfg = ModelConfig(vocab_size=256, hidden_size=D, intermediate_size=F, num_hidden_layers=L,
                      num_attention_heads=Hq, num_key_value_heads=Hkv,
                      max_position_embeddings=4096, sliding_window=window)
    params = init_params(cfg, seed=3, dtype=dtype, device=torch.device("cuda"))
    return cfg, quant.fuse_gemv_params(quant.quantize_params_int4(params, group, layout="arith"))


def _k14_args(cuda, shape, kv, rope, seed):
    dtype = torch.float32 if kv == "f32" else torch.bfloat16
    D, F, Hq, Hkv, L, S, group = {**K14_SHAPES, **K14_RAGGED}[shape]
    cfg, tree = _fused_tree(D, F, Hq, Hkv, L, group, None, dtype)
    Dh = D // Hq
    g = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(dtype)  # noqa: E731
    k, v = rnd(L, 1, Hkv, S, Dh), rnd(L, 1, Hkv, S, Dh)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).expand(L, 1, Hkv, S).clone()
    pos[..., S - S // 8:] = -1
    pos[torch.rand(pos.shape, generator=g, device=cuda) < 0.2] = -1     # dead slots
    scales = ()
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    q_pos = torch.tensor([S - S // 8], dtype=torch.int32, device=cuda)
    rope_pos = torch.tensor([S // 2], dtype=torch.int32, device=cuda) if rope else None
    return cfg, tree, (k, v, pos, rnd(1, D), q_pos, *scales), rope_pos


@pytest.mark.parametrize("rope", [False, True], ids=["q_pos", "rope_pos"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", list(K14_SHAPES))
def test_k14_kernel_matches_plain(cuda, shape, kv, rope):
    from easykv_tpu_torch.ops.cuda.fused_decode import fused_decode_step, fused_decode_step_plain
    cfg, tree, args, rope_pos = _k14_args(cuda, shape, kv, rope, 5)
    before = fused_decode_step.launches
    got = fused_decode_step(tree.layers, cfg, *args, rope_pos=rope_pos)
    ref = fused_decode_step_plain(tree.layers, cfg, *args, rope_pos=rope_pos)
    torch.cuda.synchronize()
    assert fused_decode_step.launches == before + 1
    for a, b in zip(got, ref):
        assert _k14_close(a, b)
    again = fused_decode_step(tree.layers, cfg, *args, rope_pos=rope_pos)
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # the same in every run


@pytest.mark.parametrize("rope", [False, True], ids=["q_pos", "rope_pos"])
@pytest.mark.parametrize("kv", ["bf16", "f32"])
def test_k14_ragged_widths_match_plain(cuda, kv, rope):
    """K14 where three of the four products have a width that is not a
    multiple of 16 (K14_RAGGED), so no tensor map takes their carriers and
    the warps copy their items themselves, held as
    test_k14_kernel_matches_plain holds the other shapes (a head of 8 is
    half a 16-byte load of an int8 cache row: bf16 and f32 caches)."""
    from easykv_tpu_torch.ops.cuda.fused_decode import fused_decode_step, fused_decode_step_plain
    cfg, tree, args, rope_pos = _k14_args(cuda, "small-ragged", kv, rope, 8)
    got = fused_decode_step(tree.layers, cfg, *args, rope_pos=rope_pos)
    ref = fused_decode_step_plain(tree.layers, cfg, *args, rope_pos=rope_pos)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert _k14_close(a, b)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_k14_gives_the_same_bits_every_run(cuda, kv):
    """K14 adds its partials in a fixed order and keeps no state between
    launches: three launches on one input at 7B width give the same bits."""
    from easykv_tpu_torch.ops.cuda.fused_decode import fused_decode_step
    cfg, tree, args, _ = _k14_args(cuda, "7b", kv, False, 9)
    outs = [fused_decode_step(tree.layers, cfg, *args) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for o in outs[1:] for a, b in zip(outs[0], o))


def test_k14_dead_row(cuda):
    """q_pos = -1: every probability is 0 on both sides."""
    from easykv_tpu_torch.ops.cuda.fused_decode import fused_decode_step, fused_decode_step_plain
    cfg, tree, args, _ = _k14_args(cuda, "small", "bf16", False, 6)
    args = args[:4] + (torch.tensor([-1], dtype=torch.int32, device=cuda),) + args[5:]
    got = fused_decode_step(tree.layers, cfg, *args)
    ref = fused_decode_step_plain(tree.layers, cfg, *args)
    torch.cuda.synchronize()
    assert not got[3].any() and not got[4].any()
    for a, b in zip(got, ref):
        assert _k14_close(a, b)


def test_k14_too_large_grid_raises(cuda):
    """A cooperative grid the card cannot hold at once is refused: the
    wrapper raises, counts no launch and runs nothing else; the next
    launch runs."""
    from easykv_tpu_torch.ops.cuda import fused_decode as k14
    cfg, tree, args, _ = _k14_args(cuda, "small", "bf16", False, 7)
    before = k14.fused_decode_step.launches
    with mock.patch.object(k14, "fused_decode_step_plain",
                           mock.Mock(side_effect=AssertionError("plain version ran"))), \
            mock.patch.object(k14, "_GRID", 1 << 20):
        with pytest.raises(RuntimeError, match="fused_decode_step launch failed"):
            k14.fused_decode_step(tree.layers, cfg, *args)
    assert k14.fused_decode_step.launches == before
    ref = k14.fused_decode_step_plain(tree.layers, cfg, *args)
    got = k14.fused_decode_step(tree.layers, cfg, *args)
    torch.cuda.synchronize()
    assert all(_k14_close(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("case", ["fused-B1", "fused-B2", "split-B1", "mega-off-B1",
                                  "fused-B1-streaming"])
def test_k14_launch_gating(cuda, case):
    """K14 launches once a decode step for the fused arithmetic tree at
    B = 1 (streaming over the pre-rotated cache too), and K10 never in the
    decode loop there; it never launches at B = 2, for the split tree or
    with the mega flag off."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.fused_decode import fused_decode_step
    from easykv_tpu_torch.ops.cuda.w4_stream import w4a16_gemv_arith
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=768,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    tree = quant.quantize_params_int4(params, layout="arith")
    if case != "split-B1":
        tree = quant.fuse_gemv_params(tree)
    B = 2 if case == "fused-B2" else 1
    n = 12
    st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=64, budget=4, max_new_tokens=n,
                               recent_window_dec=1, streaming=case.endswith("streaming"))
    ids = torch.randint(1, 512, (B, 64), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(cuda)
    plen = torch.full((B,), 64, dtype=torch.int32, device=cuda)
    flags.use_mega(False if case == "mega-off-B1" else None)
    try:
        k14_0, k10_0 = fused_decode_step.launches, w4a16_gemv_arith.launches
        gen_mod._run_decoding(st, tree, ids, plen, 1e-9, 1.0,
                              torch.Generator(device=cuda).manual_seed(0), torch.float32)
        torch.cuda.synchronize()
    finally:
        flags.use_mega(None)
    k14_n = fused_decode_step.launches - k14_0
    k10_n = w4a16_gemv_arith.launches - k10_0
    if case.startswith("fused-B1"):
        assert k14_n == n and k10_n == 0
    else:
        assert k14_n == 0
        assert k10_n == (4 if case != "split-B1" else 7) * 2 * n * (B == 1)


# ---------------------------------------------------------------------------
# K15: the batched one-kernel decode step
# ---------------------------------------------------------------------------

K15_SHAPES = {  # D, F, Hq, Hkv, L, S, group, B, sliding window
    "small-mha-B5": (256, 512, 4, 4, 2, 256, 64, 5, None),
    "small-gqa-B8-window": (256, 512, 4, 2, 2, 256, 64, 8, 100),
    "small-mha-B16": (256, 512, 4, 4, 2, 256, 64, 16, None),
    "7b-B2": (4096, 11008, 32, 32, 2, 768, 128, 2, None),
    "7b-B3": (4096, 11008, 32, 32, 2, 768, 128, 3, None),
    "7b-B4": (4096, 11008, 32, 32, 2, 768, 128, 4, None),
    "7b-B5": (4096, 11008, 32, 32, 2, 768, 128, 5, None),
    "7b-B9": (4096, 11008, 32, 32, 2, 768, 128, 9, None),
    "7b-B16": (4096, 11008, 32, 32, 2, 768, 128, 16, None),
    "mistral-B8-window": (4096, 14336, 32, 8, 2, 768, 128, 8, 512),
}
# wqkv 216, wo and wd 72 columns: not multiples of 16 (9 heads of 8, groups of 12)
K15_RAGGED = {"small-ragged-B5": (72, 192, 9, 9, 2, 256, 12, 5, None)}


def _k15_args(cuda, shape, kv, rope, seed):
    """K15's arguments: 7/8 of the slots visible with a fifth of them dead,
    row 1 dead (q_pos -1), the other rows at scattered positions."""
    dtype = torch.float32 if kv == "f32" else torch.bfloat16
    D, F, Hq, Hkv, L, S, group, B, window = {**K15_SHAPES, **K15_RAGGED}[shape]
    cfg, tree = _fused_tree(D, F, Hq, Hkv, L, group, window, dtype)
    Dh = D // Hq
    g = torch.Generator(device=cuda).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=cuda).to(dtype)  # noqa: E731
    k, v = rnd(L, B, Hkv, S, Dh), rnd(L, B, Hkv, S, Dh)
    pos = torch.arange(S, dtype=torch.int32, device=cuda).expand(L, B, Hkv, S).clone()
    pos[..., S - S // 8:] = -1
    pos[torch.rand(pos.shape, generator=g, device=cuda) < 0.2] = -1     # dead slots
    scales = ()
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
        scales = (ks, vs)
    q_pos = torch.randint(S // 2, S - S // 8 + 1, (B,), generator=g, device=cuda,
                          dtype=torch.int32)
    q_pos[1] = -1
    rope_pos = (q_pos.clamp(min=0) * 3 // 4).to(torch.int32) if rope else None
    return cfg, tree, (k, v, pos, rnd(B, D), q_pos, *scales), rope_pos


@pytest.mark.parametrize("rope", [False, True], ids=["q_pos", "rope_pos"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("shape", list(K15_SHAPES))
def test_k15_kernel_matches_plain(cuda, shape, kv, rope):
    _k15_matches_plain(cuda, shape, kv, rope)


@pytest.mark.parametrize("rope", [False, True], ids=["q_pos", "rope_pos"])
@pytest.mark.parametrize("kv", ["bf16", "f32"])
def test_k15_ragged_widths_match_plain(cuda, kv, rope):
    """K15 where three of the four products have a width that is not a
    multiple of 16 (K15_RAGGED), so their carrier and scale rows are not
    16-byte aligned and the ring's stages take the lanes' own loads, held
    as test_k15_kernel_matches_plain holds the other shapes. A head of 8
    is half a 16-byte load of an int8 cache row, which the attention does
    not take: bf16 and f32 caches."""
    _k15_matches_plain(cuda, "small-ragged-B5", kv, rope)


def _k15_matches_plain(cuda, shape, kv, rope):
    """Every output within the larger of _k14_close's limit and twice the
    plain K15's reorder spread (step_bars.k15_spread: the bf16 feed makes
    the function move by more than 1e-3 of its largest value when only the
    order of its sums and the last ulps of its steps change; with f32
    activations nothing rounds and the spread is f32 rounding); row 1 is
    dead (no probability anywhere); with bf16 activations the feed is
    rounded as the plain version rounds it (step_bars.k15_feed_share:
    layer 0's K and V rows bit-equal to the plain version's with K15's
    order of the first norm's sums, which an f32 feed misses); the same
    bits in every run (partials added in a fixed order)."""
    from easykv_tpu_torch.ops.cuda.step_bars import k15_feed_share, k15_spread, step_shares
    from easykv_tpu_torch.ops.cuda.fused_decode_batch import (fused_decode_step_batch,
                                                              fused_decode_step_batch_plain)
    cfg, tree, args, rope_pos = _k15_args(cuda, shape, kv, rope, 5)
    before = fused_decode_step_batch.launches
    got = fused_decode_step_batch(tree.layers, cfg, *args, rope_pos=rope_pos)
    ref = fused_decode_step_batch_plain(tree.layers, cfg, *args, rope_pos=rope_pos)
    torch.cuda.synchronize()
    assert fused_decode_step_batch.launches == before + 1
    assert all(a.dtype == b.dtype and a.shape == b.shape and bool(torch.isfinite(a.float()).all())
               for a, b in zip(got, ref))
    draws = 32 if shape.startswith("small") else 8      # few flips a draw at small widths
    worst, _, line = step_shares(got, ref, k15_spread(tree.layers, cfg, args, rope_pos, draws),
                                 "reorder spread")
    assert worst <= 1, line
    assert not got[3][:, 1].any() and not got[4][:, 1].any()
    if kv != "f32":      # bf16 activations: layer 0's rows come from one rounded product
        assert min(k15_feed_share(tree.layers, cfg, args, rope_pos)) >= 0.999
        assert max(k15_feed_share(tree.layers, cfg, args, rope_pos, torch.float32)) < 0.9
    again = fused_decode_step_batch(tree.layers, cfg, *args, rope_pos=rope_pos)
    assert all(torch.equal(a, b) for a, b in zip(got, again))      # the same in every run


def test_k15_too_large_grid_raises(cuda):
    """A cooperative grid the card cannot hold at once is refused: the
    wrapper raises, counts no launch and runs nothing else; the next launch
    runs."""
    from easykv_tpu_torch.ops.cuda import fused_decode_batch as k15
    cfg, tree, args, _ = _k15_args(cuda, "small-mha-B5", "bf16", False, 7)
    before = k15.fused_decode_step_batch.launches
    with mock.patch.object(k15, "fused_decode_step_batch_plain",
                           mock.Mock(side_effect=AssertionError("plain version ran"))), \
            mock.patch.object(k15, "_GRID", 1 << 20):
        with pytest.raises(RuntimeError, match="fused_decode_step_batch launch failed"):
            k15.fused_decode_step_batch(tree.layers, cfg, *args)
    assert k15.fused_decode_step_batch.launches == before
    ref = k15.fused_decode_step_batch_plain(tree.layers, cfg, *args)
    got = k15.fused_decode_step_batch(tree.layers, cfg, *args)
    torch.cuda.synchronize()
    assert all(_k14_close(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("case", ["fused-B4", "fused-B8", "fused-B9", "fused-B1", "split-B4",
                                  "mega-off-B4", "mega-batch-off-B4", "fused-B4-streaming"])
def test_k15_launch_gating(cuda, case):
    """K15 launches once a decode step for the fused arithmetic tree at
    1 < B <= 8 (a GQA model; streaming over the pre-rotated cache too), and
    K11 never in the decode loop there; never at B = 9 or B = 1, for the
    split tree, or with either mega flag off."""
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.fused_decode_batch import fused_decode_step_batch
    from easykv_tpu_torch.ops.cuda.w4_stream import w4a16_gemm_arith
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=768,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    tree = quant.quantize_params_int4(params, layout="arith")
    if not case.startswith("split"):
        tree = quant.fuse_gemv_params(tree)
    B = int(case.split("-B")[1].split("-")[0])
    n = 12
    st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=64, budget=4, max_new_tokens=n,
                               recent_window_dec=1, streaming=case.endswith("streaming"))
    ids = torch.randint(1, 512, (B, 64), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(cuda)
    plen = torch.full((B,), 64, dtype=torch.int32, device=cuda)
    flags.use_mega(False if case.startswith("mega-off") else None)
    flags.use_mega_batch(False if case.startswith("mega-batch-off") else None)
    try:
        k15_0, k11_0 = fused_decode_step_batch.launches, w4a16_gemm_arith.launches
        gen_mod._run_decoding(st, tree, ids, plen, 1e-9, 1.0,
                              torch.Generator(device=cuda).manual_seed(0), torch.float32)
        torch.cuda.synchronize()
    finally:
        flags.use_mega(None)
        flags.use_mega_batch(None)
    k15_n = fused_decode_step_batch.launches - k15_0
    k11_n = w4a16_gemm_arith.launches - k11_0
    if case in ("fused-B4", "fused-B8", "fused-B4-streaming"):
        assert k15_n == n and k11_n == 4 * 2      # K11 in the prefill (M = 64 B) only
    else:
        assert k15_n == 0


# --------------------------------------------------------------------------
# K7: the strided encode's chunk step
# --------------------------------------------------------------------------

K7_STATICS = dict(feasible_k=200, sink=4, recent_window=40)


def k7_args(dev, B, Hq, Hkv, S, n_valid, dtype, quant, seed, gates):
    """K7's arguments for a triggered chunk (k6_args' scattered slots, as a
    write mask; negative initial counters): gates (update, evict) per row,
    next_pos after the chunk, the next contiguous window at n_valid."""
    a = k6_args(dev, B, Hq, Hkv, S, n_valid, dtype, quant, True, True, seed)
    q, k_c, v_c, ids, q_pos, cinit = a[:6]
    wm = torch.zeros((B, Hkv, S), dtype=torch.int32, device=dev).scatter_(-1, ids.long(), 1)
    ug = torch.tensor([g[0] for g in gates], device=dev)
    eg = torch.tensor([g[1] for g in gates], device=dev)
    return (q, k_c, v_c, wm, q_pos, cinit, ug, eg, (q_pos[:, -1] + 1).contiguous(),
            torch.full((B,), n_valid, dtype=torch.int32, device=dev)) + a[6:]


def k7_bar(args, policy, window):
    """K6 on the card, then the plain update and selection on K6's own
    statistics: (out, cache arrays, next mask)."""
    b = [x.clone() for x in args]
    q, k_c, v_c, wm, q_pos, cinit, ug, eg, npos, nstart = b[:10]
    S = wm.shape[-1]
    iota = torch.arange(S, dtype=torch.int32, device=wm.device)
    ids = torch.where(wm != 0, iota, S + iota).sort(dim=-1).values[..., :q.shape[2]]
    out, ssum, ssq, _ = fused_chunk_write_attend(q, k_c, v_c, ids.contiguous(), q_pos, cinit,
                                                 *b[10:], sliding_window=window)
    cache = KVCache(*b[10:16], *(b[16:] or (None, None)))
    nxt = chunk_step_evict_plain(cache, ssum, ssq, ug, eg, npos, nstart, policy=policy,
                                 C=q.shape[2], **K7_STATICS)
    return out, b[10:], nxt


K7_GATES = {"on-on": [(True, True)] * 2, "on-off": [(True, False)] * 2,
            "off-on": [(False, True)] * 2, "mixed": [(True, False), (False, True)]}


@pytest.mark.parametrize("gates", list(K7_GATES))
@pytest.mark.parametrize("kv", ["int8", "bf16", "f32"])
@pytest.mark.parametrize("policy", ["roco", "h2o_head"])
@pytest.mark.parametrize("Hq,Hkv,window", [(8, 8, None), (8, 2, 150)], ids=["mha", "gqa4-window"])
def test_k7_kernel_matches_plain_and_k6(cuda, policy, kv, gates, Hq, Hkv, window):
    dtype = torch.float32 if kv == "f32" else torch.bfloat16
    args = k7_args(cuda, 2, Hq, Hkv, 512, 384, dtype, kv == "int8", 7, K7_GATES[gates])
    ka, kb = [x.clone() for x in args], [x.clone() for x in args]
    before = fused_chunk_step.launches
    out, arrs, nxt = fused_chunk_step(*ka, policy=policy, sliding_window=window, **K7_STATICS)
    assert fused_chunk_step.launches == before + 1
    ref = fused_chunk_step_plain(*kb, policy=policy, sliding_window=window, **K7_STATICS)
    torch.cuda.synchronize()
    assert _out_ok(out, ref[0])
    for name, a, b in zip(K6_CACHE, arrs, ref[1]):
        if name in ("score", "score_sq"):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
        elif name in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(a, b), name
    bar = k7_bar(args, policy, window)
    assert torch.equal(out, bar[0])
    for name, a, b in zip(K6_CACHE, arrs, bar[1]):
        assert torch.equal(a, b), name
    assert torch.equal(nxt, bar[2])
    eg = args[7]
    assert (nxt.sum(-1) == args[0].shape[2]).all()
    assert (arrs[2][nxt.bool() & eg[:, None, None]] == -1).all()


def test_k7_raises_on_what_it_does_not_take(cuda):
    args = k7_args(cuda, 1, 2, 2, 256, 128, torch.bfloat16, False, 8, [(True, True)])
    with pytest.raises(ValueError, match="policies"):
        fused_chunk_step(*args, policy="tova", **K7_STATICS)
    big = list(k7_args(cuda, 1, 2, 2, 32768, 128, torch.bfloat16, False, 8, [(True, True)]))
    before = fused_chunk_step.launches
    with pytest.raises(ValueError, match="shared memory"):
        fused_chunk_step(*big, policy="roco", **K7_STATICS)
    bad = list(args)
    bad[6] = bad[6].to(torch.int32)                          # gates are bool
    with pytest.raises(ValueError, match="update_gate"):
        fused_chunk_step(*bad, policy="roco", **K7_STATICS)
    assert fused_chunk_step.launches == before


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("policy", ["roco", "h2o_head"])
def test_strided_encode_step_kernel_matches_k6_path(cuda, policy, kv_quant):
    """generate's `encoding` on a small model with the step kernel on and
    off (the chunk kernels on for the float cache too): equal tokens, every
    final cache array equal, K7 once a chunk-layer and no K6."""
    gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    params = init_params(cfg, seed=0, dtype=torch.float32, device=cuda)
    n, new, stride = 320, 12, 32
    ids = torch.randint(1, 512, (1, n), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(cuda)
    b = n // 2 + stride
    idx, r_idx = gen_mod.stride_align(n, b, stride)
    st = gen_mod.EngineStatics(cfg=cfg, policy=policy, mode="encoding", length=n, budget=b,
                               idx=idx, r_idx=r_idx, stride=stride, max_new_tokens=new,
                               recent_window=b // 10, recent_window_dec=int(b * 0.3),
                               kv_quant=kv_quant, keep_attention=policy == "h2o_head")
    outs = []
    try:
        flags.use_chunk_kernel(True)
        for step in (True, False):
            flags.use_step_kernel(step)
            k7, k6 = fused_chunk_step.launches, fused_chunk_write_attend.launches
            res, _, cache, _ = gen_mod._run_encoding(
                st, params, ids, 1e-9, 1.0, torch.Generator(device=cuda).manual_seed(0),
                torch.float32)
            outs.append((res.out_ids, cache, fused_chunk_step.launches - k7,
                         fused_chunk_write_attend.launches - k6))
    finally:
        flags.use_chunk_kernel(None)
        flags.use_step_kernel(None)
    chunks = cfg.num_hidden_layers * ((n - r_idx) // stride)
    assert outs[0][2:] == (chunks, 0) and outs[1][2:] == (0, chunks)
    assert torch.equal(outs[0][0], outs[1][0])
    for name in K6_CACHE:
        a, b_ = getattr(outs[0][1], name), getattr(outs[1][1], name)
        assert (a is None and b_ is None) or torch.equal(a, b_), name


# --------------------------------------------------------------------------
# the decode loop as a replayed CUDA graph of its step; K3 inside K2's launch
# --------------------------------------------------------------------------

def _smoke():
    """chip_smoke.py's cases and helpers (imported on the card only)."""
    return importlib.import_module("chip_smoke")


def test_decode_graph_matches_eager_loop(cuda):
    """chip_smoke.GRAPH_CASES at LLaMa-2-7B width, L = 2: bf16 and int8 KV
    roco at B = 1 and 4, `full`, `random`, StreamingLLM pre-rotated,
    rotate-at-read and rank, the split int4 tree at B = 4 (K11's split
    tickets), K14 at B = 1, K15 at B = 4 and a sampled run at temperature
    0.7: the decode replayed as a CUDA graph and the eager loop give the same
    tokens of every row, kv_len, bits of every final cache array and carried
    ranks, and the same launch counts."""
    bad = {name: (nodes, diff) for name, nodes, diff, _ in _smoke().graph_twin_results(cuda)
           if diff or nodes[0] == 0 or nodes[1] != 0}
    assert not bad


@pytest.mark.parametrize("case", ["S=777", "S=2304", "S=16", "B=16"])
def test_k2_with_rows_matches_k2_then_k3(cuda, case):
    """K2 given the step's K / V rows against K2 without them then K3, at
    phase 2's K2_EDGES (every policy, `compact`, bf16 rows and int8 rows
    with the scale rows): every output, k and v bit for bit."""
    smoke = _smoke()
    L, B, H, S = smoke.K2_EDGES[case]
    before = fused_write_update.rows_launches
    results = list(smoke.k2_rows_results(L, B, H, S, cuda, 640))
    bad = [label for label, got, ref in results
           if len(got) != len(ref) or not all(smoke.same_bits(a, b) for a, b in zip(got, ref))]
    assert not bad
    assert fused_write_update.rows_launches == before + len(results)


def test_two_graphs_replayed_at_once_keep_their_own_tickets(cuda):
    """Split tickets belong to the capture, not the stream: two CUDA graphs
    of the split int4 decode step at B = 4 (K11 with its groups split over
    blocks), captured one after the other on one stream and replayed at
    once on two streams, leave their logits and caches bit-identical to the
    eager step's. With a ticket row per stream, as before, both graphs
    would count on the capture stream's row."""
    from easykv_tpu_torch.cache import init_cache
    from easykv_tpu_torch.models.llama import StepCtx, _decode_forward
    from easykv_tpu_torch.ops import quant
    from easykv_tpu_torch.ops.cuda.w4_stream import gemm_plan
    cfg = ModelConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=32)
    params = quant.quantize_params_int4(init_params(cfg, seed=3, dtype=torch.bfloat16,
                                                    device=cuda), layout="arith")
    B, S, P, steps = 4, 256, 100, 12
    assert gemm_plan(B, 4096, 4096)[2] > 1          # the groups split: tickets in use
    g = torch.Generator(device=cuda).manual_seed(3)
    base = init_cache(2, B, 32, S, 128, dtype=torch.bfloat16, device=cuda)
    base.pos[..., :P] = torch.arange(P, dtype=torch.int32, device=cuda)
    base.k.copy_(torch.randn(base.k.shape, generator=g, device=cuda))
    base.v.copy_(torch.randn(base.v.shape, generator=g, device=cuda))
    copy = lambda: KVCache(*(None if t is None else t.clone()  # noqa: E731
                             for t in (base.k, base.v, base.pos, base.score, base.score_sq,
                                       base.counter)))
    tok = torch.randint(1, 32000, (B, 1), generator=g, device=cuda, dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.bool, device=cuda)
    ctx = StepCtx(q_pos=torch.full((B, 1), P, dtype=torch.int32, device=cuda),
                  token_valid=ones[:, None], counter_init=torch.zeros((B, 1), device=cuda),
                  next_pos=torch.full((B,), P + 1, dtype=torch.int32, device=cuda),
                  prompt_len=torch.full((B,), P, dtype=torch.int32, device=cuda),
                  evict_gate=~ones, update_gate=ones,
                  rand_rank=torch.zeros(B, dtype=torch.int32, device=cuda))
    eager = copy()
    for _ in range(steps):
        ref = _decode_forward(params, cfg, eager, tok, ctx, None)
    caches, graphs, outs = [copy(), copy()], [], []
    stream = torch.cuda.Stream()
    for c in caches:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs.append(_decode_forward(params, cfg, c, tok, ctx, None))
        graphs.append(graph)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    for _ in range(steps):
        with torch.cuda.stream(s1):
            graphs[0].replay()
        with torch.cuda.stream(s2):
            graphs[1].replay()
    torch.cuda.synchronize()
    for c, out in zip(caches, outs):
        assert torch.equal(out, ref)
        for name in ("k", "v", "pos", "score", "score_sq", "counter"):
            assert torch.equal(getattr(c, name), getattr(eager, name)), name


# ---------------------------------------------------------------------------
# serving: the decode tick replayed as a CUDA graph, dead rows, snapshot / resume
# ---------------------------------------------------------------------------

def _serving_model(cuda, kv_quant, tree=None, seed=6):
    """LLaMa-2-7B width, L = 2, bf16 weights drawn on the card (tree "fused":
    the int4 arithmetic fused tree of them), with a bf16 or int8 KV cache."""
    import dataclasses

    import easykv_tpu_torch
    from easykv_tpu_torch.ops import quant
    cfg = dataclasses.replace(_smoke().LLAMA2_7B, num_hidden_layers=2)
    params = init_params(cfg, seed=seed, dtype=torch.bfloat16, device=cuda)
    if tree == "fused":
        params = quant.fuse_gemv_params(quant.quantize_params_int4(params, layout="arith"))
    return easykv_tpu_torch.CausalLM(cfg, params, device=cuda, kv_quant=kv_quant)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_serving_decode_tick_replay_matches_eager(cuda, kv_quant):
    """ContinuousBatchEngine (4 slots, 6 requests of 128-512 tokens, 40 new,
    roco at budget 16, greedy) with its decode tick replayed as a CUDA graph
    and eager (flags.eager_decode_loop): the same tokens and the bits of
    every final cache array."""
    smoke = _smoke()
    model = _serving_model(cuda, kv_quant)
    prompts = smoke.serving_prompts(6, model.cfg.vocab_size, 2)
    kw = dict(batch_slots=4, max_prompt=512, budget=16, kv_policy="roco", temperature=1e-9,
              top_p=1.0, prefill_chunk=128)
    (out_g, cache_g, nodes_g) = smoke.continuous_run(model, prompts, 40, **kw)
    with flags.eager_decode_loop():
        (out_e, cache_e, nodes_e) = smoke.continuous_run(model, prompts, 40, **kw)
    assert nodes_g > 0 and nodes_e == 0
    assert out_g == out_e
    for name, a in vars(cache_g).items():
        if a is not None:
            assert smoke.same_bits(a, getattr(cache_e, name)), name


@pytest.mark.parametrize("tree,kv_quant", [(None, False), (None, True), ("fused", True)],
                         ids=["bf16-K1", "int8-K1", "int8-K15"])
def test_serving_dead_rows_untouched(cuda, tree, kv_quant):
    """Three rows prefilled through _prefill_chunk one row at a time (an
    int8 cache: K5 at one valid row of three; the other rows' arrays keep
    their bits), then decode steps with row 1 inactive (K1 per layer and K2,
    or K15 over the fused int4 tree, and K2): every array of row 1 keeps its
    bits, its valid slots and the dead slots where K2 would have written."""
    from easykv_tpu_torch.ops.cuda.chunk_attention import fused_chunk_attend as k5
    from easykv_tpu_torch.ops.cuda.fused_decode_batch import fused_decode_step_batch as k15
    from easykv_tpu_torch.serving import engine as serving
    model = _serving_model(cuda, kv_quant, tree)
    B, L, pc = 3, model.cfg.num_hidden_layers, 128
    cache = serving.serving_cache(model, B, 256, 16)
    g = torch.Generator().manual_seed(7)
    lens = (150, 100, 90)

    def snap():
        return {n: a.clone() for n, a in vars(cache).items() if a is not None}
    for row, T in enumerate(lens):
        ids = torch.randint(1, 32000, (2 * pc,), generator=g, dtype=torch.int32).to(cuda)
        for c in range(0, T, pc):
            before, k5_before = snap(), k5.launches
            serving._prefill_chunk(model.cfg, pc, model.params, cache, ids[c:c + pc], c, T, row)
            assert k5.launches == k5_before + (L if kv_quant else 0)
            for r in set(range(B)) - {row}:
                for n, a in before.items():
                    assert smoke_equal(getattr(cache, n)[:, r], a[:, r]), (row, r, n)
    spec = serving.serving_spec("roco", 16)
    gen = torch.Generator(device=cuda).manual_seed(0)
    active = torch.tensor([True, False, True], device=cuda)
    plen = torch.tensor(lens, dtype=torch.int32, device=cuda)
    tokens = torch.tensor([5, 6, 7], dtype=torch.int32, device=cuda)
    before = snap()
    counts = (fused_decode_attend_inflight.launches, fused_write_update.launches, k15.launches)
    for step in range(20):                   # past the budget: rows 0 and 2 evict
        gcount = torch.tensor([step, 0, step], dtype=torch.int32, device=cuda)
        logits = serving._decode_step(model.cfg, spec, 16, model.params, cache, tokens, active,
                                      plen, gcount, gen)
        tokens = logits.argmax(-1).to(torch.int32)
    k15_on = tree == "fused"
    assert fused_decode_attend_inflight.launches - counts[0] == (0 if k15_on else 20 * L)
    assert fused_write_update.launches - counts[1] == 20
    assert k15.launches - counts[2] == (20 if k15_on else 0)
    for n, a in before.items():
        assert smoke_equal(getattr(cache, n)[:, 1], a[:, 1]), n
    assert not torch.equal(cache.pos[:, 0], before["pos"][:, 0])


def smoke_equal(a, b):
    return _smoke().same_bits(a.contiguous(), b.contiguous())


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16", "int8"])
def test_sampled_scheduled_snapshot_resume(cuda, kv_quant, tmp_path):
    """A sampled (T = 1.0, top_p 0.95) ScheduledBatchEngine (4 slots, 8
    requests of 128-512 tokens, 32 new, roco at budget 8) snapshotted after
    24 ticks, when its decode tick has already replayed its graph, and
    resumed into a fresh engine gives the uninterrupted run's outputs: the
    generator's state, advanced by the replays, travels with the snapshot."""
    smoke = _smoke()
    model = _serving_model(cuda, kv_quant)
    prompts = smoke.serving_prompts(8, model.cfg.vocab_size, 3)
    kw = dict(batch_slots=4, max_prompt=512, budget=8, kv_policy="roco", temperature=1.0,
              top_p=0.95, prefill_chunk=128, seed=11)
    whole = smoke.scheduled_outputs(model, prompts, 32, **kw)
    resumed, replays = smoke.scheduled_outputs(model, prompts, 32, 24,
                                               str(tmp_path / "engine.snap"), **kw)
    assert replays > 0
    assert resumed == whole


# ---------------------------------------------------------------------------
# loading, checkpoints, utils and testing on the card
# ---------------------------------------------------------------------------

def _hf_dir(path, cfg, params, shards=1):
    """Writes `params` (a plain split tree) as an HF checkpoint: HF names,
    (out, in), config.json with HF keys."""
    import json

    from easykv_tpu_torch.models.hf import hf_state_dict
    from easykv_tpu_torch.native import save_safetensors
    sd = hf_state_dict(params)
    names = sorted(sd)
    for s in range(shards):
        save_safetensors(str(path / f"model-{s:05d}.safetensors"),
                         {k: sd[k] for k in names[s::shards]})
    hf = {"model_type": "llama", "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
          "intermediate_size": cfg.intermediate_size,
          "num_hidden_layers": cfg.num_hidden_layers,
          "num_attention_heads": cfg.num_attention_heads,
          "num_key_value_heads": cfg.num_key_value_heads,
          "max_position_embeddings": cfg.max_position_embeddings,
          "rms_norm_eps": cfg.rms_norm_eps, "tie_word_embeddings": cfg.tie_word_embeddings}
    (path / "config.json").write_text(json.dumps(hf))


def test_reader_and_loader_into_cuda_tensors(cuda, tmp_path):
    """The mmap reader's views copied to the card equal the written tensors,
    and load_hf_checkpoint on the card gives the CPU load's tree bit for
    bit; quantized on the card, the in-memory quantized tree of the card's
    bf16 load (CUDA's division by a scalar multiplies by its reciprocal, so
    the card's int8 scales may differ from the CPU's by an ulp)."""
    from easykv_tpu_torch.models.checkpoint import _flat
    from easykv_tpu_torch.models.hf import load_hf_checkpoint
    from easykv_tpu_torch.native import SafetensorsFile, save_safetensors
    g = torch.Generator().manual_seed(0)
    tensors = {"a": torch.randn(33, 7, generator=g), "b": torch.arange(3, dtype=torch.int8),
               "c": torch.randn(5, generator=g).to(torch.bfloat16)}
    save_safetensors(str(tmp_path / "t.safetensors"), tensors)
    with SafetensorsFile(str(tmp_path / "t.safetensors")) as f:
        for k, t in tensors.items():
            assert torch.equal(f.tensor(k).to(cuda).cpu(), t), k
    cfg = ModelConfig(vocab_size=256, hidden_size=256, intermediate_size=512,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    _hf_dir(tmp_path, cfg, init_params(cfg, seed=1, device="cpu"), shards=2)
    from easykv_tpu_torch.ops import quant
    _, plain = load_hf_checkpoint(str(tmp_path), device=cuda)
    _, on_cpu = load_hf_checkpoint(str(tmp_path), device="cpu")
    twins = {None: (plain, on_cpu),
             "int4": (load_hf_checkpoint(str(tmp_path), quantize="int4", device=cuda)[1],
                      quant.quantize_params_int4(plain, layout="arith")),
             "int8": (load_hf_checkpoint(str(tmp_path), quantize="int8", device=cuda)[1],
                      quant.quantize_params(plain))}
    for quantize, (got, want) in twins.items():
        a, b = _flat(got), _flat(want)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].is_cuda and smoke_equal(a[k].cpu(), b[k].cpu()), (quantize, k)


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_streamed_load_peak_at_7b_width(cuda, tmp_path, quantize):
    """One LLaMa-2-7B-width layer (and its embedding and head) loaded a layer
    at a time: the peak device memory over the returned tree is at most one
    layer's raw bf16 weights and one weight's transposed copy (0.49 GB), and
    within 3 GB with int4 (the quantizer's f32 temporaries)."""
    import dataclasses

    from easykv_tpu_torch.models.hf import load_hf_checkpoint
    cfg = ModelConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=1, num_attention_heads=32, num_key_value_heads=32)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=cuda)
    _hf_dir(tmp_path, cfg, params)
    del params
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    got_cfg, tree = load_hf_checkpoint(str(tmp_path), quantize=quantize, device=cuda)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(cuda) - base
    over = torch.cuda.max_memory_allocated(cuda) - base - held
    assert dataclasses.replace(got_cfg, max_position_embeddings=4096) == cfg
    layer_raw = 2 * (4 * 4096 * 4096 + 3 * 4096 * 11008 + 2 * 4096)
    limit = layer_raw + 2 * 4096 * 11008 + 2**20 if quantize is None else 3e9
    assert 0 < over <= limit, (over, limit)


def test_check_graph_eager_parity_on_a_decode_step(cuda):
    """testing.check_graph_eager_parity on a bf16 decode step at LLaMa-2-7B
    width (L = 2, roco's scores and the step's cache writes in place): the
    replayed graph gives the eager step's logits; a step that reads a host
    value at capture time is caught."""
    from easykv_tpu_torch.cache import init_cache
    from easykv_tpu_torch.models.llama import StepCtx, _decode_forward
    from easykv_tpu_torch.testing import check_graph_eager_parity
    cfg = ModelConfig(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=2, num_attention_heads=32, num_key_value_heads=32)
    params = init_params(cfg, seed=4, dtype=torch.bfloat16, device=cuda)
    B, S, P = 1, 256, 100
    g = torch.Generator(device=cuda).manual_seed(4)
    cache = init_cache(2, B, 32, S, 128, dtype=torch.bfloat16, device=cuda)
    cache.pos[..., :P] = torch.arange(P, dtype=torch.int32, device=cuda)
    cache.k.copy_(torch.randn(cache.k.shape, generator=g, device=cuda))
    cache.v.copy_(torch.randn(cache.v.shape, generator=g, device=cuda))
    tok = torch.randint(1, 32000, (B, 1), generator=g, device=cuda, dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.bool, device=cuda)
    ctx = StepCtx(q_pos=torch.full((B, 1), P, dtype=torch.int32, device=cuda),
                  token_valid=ones[:, None], counter_init=torch.zeros((B, 1), device=cuda),
                  next_pos=torch.full((B,), P + 1, dtype=torch.int32, device=cuda),
                  prompt_len=torch.full((B,), P, dtype=torch.int32, device=cuda),
                  evict_gate=~ones, update_gate=ones,
                  rand_rank=torch.zeros(B, dtype=torch.int32, device=cuda))
    spec = PolicySpec("roco", PHASE_DECODE, 1, 4, 1, feasible_k=8, protect_prompt=True)
    pos0 = cache.pos.clone()
    check_graph_eager_parity(
        lambda c, t: _decode_forward(params, cfg, c, t, ctx, spec), cache, tok, atol=0, rtol=0)
    assert not torch.equal(cache.pos, pos0)   # the replay wrote the step in place
    calls = []

    def stale(t):   # a host value frozen into the graph at capture
        calls.append(1)
        return t.float() * len(calls)
    with pytest.raises(AssertionError):
        check_graph_eager_parity(stale, torch.ones(4, device=cuda))


def test_device_memory_stats_on_the_card(cuda):
    from easykv_tpu_torch.utils import device_memory_stats, print_device_stats
    torch.cuda.synchronize()
    before = device_memory_stats()
    x = torch.empty(2**30, dtype=torch.uint8, device=cuda)
    after = device_memory_stats(cuda)
    assert set(after) == {"current_gb", "peak_gb", "limit_gb"}
    assert abs(after["current_gb"] - before["current_gb"] - 1.0) < 0.01
    assert after["peak_gb"] >= after["current_gb"] and 70 < after["limit_gb"] < 200
    del x
    print_device_stats()
