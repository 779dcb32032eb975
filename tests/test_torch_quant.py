"""The port's weight formats (easykv_tpu_torch/ops/quant.py) against the
JAX package's (easykv_tpu/ops/quant.py), on the CPU.

- The quantizers, packers and tree transforms are bit-exact.
- The plain versions of K10-K13 against the Pallas kernels in interpret
  mode (run as tests/test_quant.py runs them), f32 inputs: within 1e-5 of
  max|ref|, since only the order of the f32 sums differs.
- `mm` against the JAX `mm` (its default CPU path) for every leaf kind and
  the widths where its branches change, within the same 1e-5 of max|ref|.
- Converted quantized trees (split and fused, MHA and GQA, biased) give the
  JAX prefill's logits within 1e-4 (a forward of two layers adds the f32
  differences of every product).
"""
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import llama as jllama
from easykv_tpu.ops import quant as jq
from easykv_tpu.ops.pallas.quant_matmul import quant_matmul as pallas_k13
from easykv_tpu.ops.pallas.w4_matmul import w4a16_gemv as pallas_k12
from easykv_tpu.ops.pallas.w4_stream import (arith_scale_pair as j_pair,
                                             w4a16_gemm_arith as pallas_k11,
                                             w4a16_gemv_arith as pallas_k10)

from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.ops import quant as tq
from easykv_tpu_torch.ops.cuda import _wstream, quant_matmul, w4_matmul, w4_stream
from easykv_tpu_torch.ops.cuda.quant_matmul import quant_matmul_plain
from easykv_tpu_torch.ops.cuda.w4_matmul import w4a16_gemv_plain
from easykv_tpu_torch.ops.cuda.w4_stream import (w4a16_gemm_arith_plain,
                                                 w4a16_gemv_arith_plain)

REL = 1e-5
CFG = dict(vocab_size=512, hidden_size=256, intermediate_size=768, num_hidden_layers=2,
           num_attention_heads=4, max_position_embeddings=512)


def t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rel=REL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


def _same_leaf(tl, jl):
    """A QuantLinear (or tensor) and a JAX leaf dict (or array): same keys,
    every array bit-identical."""
    if isinstance(jl, dict):
        assert sorted(k for k in tl.keys() if k != "gs3") == sorted(jl)
        for k in jl:
            assert tl[k].dtype == t(jl[k]).dtype, k
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)
    else:
        np.testing.assert_array_equal(tl.detach().numpy(), np.asarray(jl))


def _weights(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.05).astype(np.float32)


@pytest.mark.parametrize("shape", [(256, 384), (512, 300), (768, 256), (3, 64, 40)])
def test_quantize_linear_bit_exact(shape):
    w = _weights(1, shape)
    _same_leaf(tq.QuantLinear(**tq._quantize_int8(t(w))), jq.quantize_linear(jnp.asarray(w)))


@pytest.mark.parametrize("layout", ["halves", "arith"])
@pytest.mark.parametrize("shape,group", [((256, 384), 128), ((512, 300), 128),
                                         ((768, 256), 64), ((96, 40), 16)])
def test_quantize_linear_int4_bit_exact(layout, shape, group):
    w = _weights(2, shape)
    got = tq.quantize_linear_int4(t(w), group, layout)
    ref = jq.quantize_linear_int4(jnp.asarray(w), group, layout)
    _same_leaf(got, ref)
    if layout == "arith":   # the bf16 epilogue pair of w4_stream.arith_scale_pair
        np.testing.assert_array_equal(got["gs3"].view(torch.int16).numpy(),
                                      np.asarray(j_pair(ref["gs"])).view(np.int16))
        gch = got["gs"].shape[0] // 2
        assert torch.equal(got["gs3"].float() * 16,
                           torch.cat([got["gs"][gch:], got["gs"][:gch]]))


def test_pack_unpack_round_trips():
    rng = np.random.default_rng(3)
    q8 = rng.integers(-8, 8, size=(2, 64, 40)).astype(np.int8)
    p = tq.pack_int4(t(q8))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jq.pack_int4(jnp.asarray(q8))))
    lo, hi = tq.unpack_int4(p)
    jlo, jhi = jq.unpack_int4(jnp.asarray(p.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(torch.cat([lo, hi], dim=-2).numpy(), q8)
    q7 = rng.integers(-7, 8, size=(2, 64, 40)).astype(np.int8)
    pa = tq.pack_int4_arith(t(q7))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(jq.pack_int4_arith(jnp.asarray(q7))))
    lo, hi = tq.unpack_int4_arith(pa)
    jlo, jhi = jq.unpack_int4_arith(jnp.asarray(pa.numpy()))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tq._arith_to_rows(pa).numpy(), q7)
    np.testing.assert_array_equal(tq._arith_to_rows(pa).numpy(),
                                  np.asarray(jq._arith_to_rows(jnp.asarray(pa.numpy()))))


def test_fit_group():
    for K in list(range(2, 300)) + [1376, 4096, 11008]:
        for g in (16, 64, 128):
            assert tq._fit_group(K, g) == jq._fit_group(K, g), (K, g)


def _dequant_close(got, ref):
    np.testing.assert_array_equal(tq.dequantize(got).numpy(), np.asarray(jq.dequantize(ref)))


def test_dequantize_bit_exact():
    w = _weights(4, (256, 96))
    for jl in (jq.quantize_linear(jnp.asarray(w)),
               jq.quantize_linear_int4(jnp.asarray(w), 64, "halves"),
               jq.quantize_linear_int4(jnp.asarray(w), 64, "arith")):
        _dequant_close(tq.QuantLinear(**{k: t(v) for k, v in jl.items()}), jl)


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _trees(bias=False, Hkv=4):
    cfg = dict(CFG, num_key_value_heads=Hkv, attention_bias=bias)
    jparams = jllama.init_params(JModelConfig(**cfg), jax.random.PRNGKey(0))
    return cfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")


def _same_tree(tparams, jparams):
    jl = jparams["layers"]
    for l, p in enumerate(tparams.layers):
        names = {n for n, _ in p.named_parameters(recurse=False)} | {n for n, _ in p.named_children()}
        assert names == set(jl)
        for name in jl:
            leaf = jax.tree.map(lambda a: np.asarray(a)[l], jl[name])
            _same_leaf(getattr(p, name), leaf)
    if "lm_head" in jparams:
        _same_leaf(tparams.lm_head, jparams["lm_head"])


QUANTIZERS = {
    "int8": (tq.quantize_params, jq.quantize_params),
    "int4 halves": (tq.quantize_params_int4, jq.quantize_params_int4),
    "int4 arith": (lambda p: tq.quantize_params_int4(p, layout="arith"),
                   lambda p: jq.quantize_params_int4(p, layout="arith")),
    "int4 arith dual, int4 head": (
        lambda p: tq.quantize_params_int4(p, layout="arith", dual_int8=True, lm_head_int8=False),
        lambda p: jq.quantize_params_int4(p, layout="arith", dual_int8=True, lm_head_int8=False)),
    "int4 halves dual, group 64": (
        lambda p: tq.quantize_params_int4(p, group_size=64, dual_int8=True),
        lambda p: jq.quantize_params_int4(p, group_size=64, dual_int8=True)),
}


@pytest.mark.parametrize("fuse", [False, True], ids=["split", "fused"])
@pytest.mark.parametrize("kind", list(QUANTIZERS))
def test_quantize_params_and_fuse_bit_exact(kind, fuse):
    _, jparams, tparams = _trees(bias=True, Hkv=2)
    tquant, jquant = QUANTIZERS[kind]
    got, ref = tquant(tparams), jquant(jparams)
    if fuse:
        got, ref = tq.fuse_gemv_params(got), jq.fuse_gemv_params(ref)
    _same_tree(got, ref)


def test_fuse_plain_tree_and_concat_linears():
    _, jparams, tparams = _trees(bias=True)
    _same_tree(tq.fuse_gemv_params(tparams), jq.fuse_gemv_params(jparams))
    w = [_weights(5 + i, (256, n)) for i, n in enumerate((64, 96))]
    for layout in ("halves", "arith"):
        got = tq.concat_linears([tq.quantize_linear_int4(t(a), 128, layout) for a in w])
        ref = jq.concat_linears([jq.quantize_linear_int4(jnp.asarray(a), 128, layout) for a in w])
        _same_leaf(got, ref)


# ---------------------------------------------------------------------------
# plain K10-K13 against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _xw(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, K)).astype(np.float32),
            rng.normal(size=(K, N)).astype(np.float32))


@pytest.mark.parametrize("M", [1, 4, 8, 200, 256])
@pytest.mark.parametrize("K,N", [(256, 384), (512, 300)])
def test_plain_k13_matches_pallas(M, K, N):
    x, w = _xw(M + N, M, K, N)
    q = jq.quantize_linear(jnp.asarray(w))
    ref = pallas_k13(jnp.asarray(x), q["q"], q["s"], interpret=True)
    got = quant_matmul_plain(t(x), t(q["q"]), t(q["s"]))
    _close(got, ref)
    assert got.dtype == torch.float32
    # the LM head's f32 result from bf16 activations
    xb = t(x).to(torch.bfloat16)
    head = quant_matmul_plain(xb, t(q["q"]), t(q["s"]), out_f32=True)
    assert head.dtype == torch.float32
    _close(head, (xb.float() @ t(q["q"]).float()) * t(q["s"]))


@pytest.mark.parametrize("K,N,G", [(256, 384, 64), (512, 300, 128), (256, 1024, 128)])
@pytest.mark.parametrize("M", [1, 4, 8])
def test_plain_k12_matches_pallas(M, K, N, G):
    """The Pallas wrapper runs its kernel at M = 1 and `_mm_int4` above (the
    same function, w4_matmul.py:69-73)."""
    x, w = _xw(7 * M + N, M, K, N)
    q = jq.quantize_linear_int4(jnp.asarray(w), group_size=G)
    ref = pallas_k12(jnp.asarray(x), q["q4p"], q["gs"], interpret=True)
    _close(w4a16_gemv_plain(t(x), t(q["q4p"]), t(q["gs"])), ref)


@pytest.mark.parametrize("K,N,G", [(256, 384, 64), (512, 300, 128), (256, 1024, 128)])
def test_plain_k10_matches_pallas(K, N, G):
    x, w = _xw(N + G, 1, K, N)
    q = jq.quantize_linear_int4(jnp.asarray(w), group_size=G, layout="arith")
    ref = pallas_k10(jnp.asarray(x), q["q4a"], q["gs"], interpret=True)
    _close(w4a16_gemv_arith_plain(t(x), t(q["q4a"]), tq.arith_scale_pair(t(q["gs"]))), ref)


@pytest.mark.parametrize("M", [4, 8, 200, 512])
@pytest.mark.parametrize("K,N", [(256, 384), (512, 300)])
def test_plain_k11_matches_pallas(M, K, N):
    x, w = _xw(3 * M + N, M, K, N)
    q = jq.quantize_linear_int4(jnp.asarray(w), group_size=128, layout="arith")
    ref = pallas_k11(jnp.asarray(x), q["q4a"], q["gs"], interpret=True)
    _close(w4a16_gemm_arith_plain(t(x), t(q["q4a"]), t(q["gs"])), ref)


# ---------------------------------------------------------------------------
# mm against the JAX mm, every leaf kind, the widths where branches change
# ---------------------------------------------------------------------------

LEAVES = {
    "int8": lambda w: jq.quantize_linear(w),
    "int4 halves": lambda w: jq.quantize_linear_int4(w, 128),
    "int4 arith": lambda w: jq.quantize_linear_int4(w, 128, "arith"),
    "int4 arith dual": lambda w: {**jq.quantize_linear_int4(w, 128, "arith"),
                                  **{k + "8": v for k, v in jq.quantize_linear(w).items()}},
    "int4 halves dual": lambda w: {**jq.quantize_linear_int4(w, 128),
                                   **{k + "8": v for k, v in jq.quantize_linear(w).items()}},
    # groups of 4 rows: the kernels' row chunks (8 rows) would straddle groups
    "int4 arith group 4": lambda w: jq.quantize_linear_int4(w, 4, "arith"),
    "int4 halves group 4": lambda w: jq.quantize_linear_int4(w, 4),
}


@pytest.mark.parametrize("leaf", list(LEAVES))
def test_mm_matches_jax(leaf):
    K, N = 256, 300
    x, w = _xw(11, 513, K, N)
    jl = LEAVES[leaf](jnp.asarray(w))
    tl = tq.QuantLinear(**{k: t(v) for k, v in jl.items()})
    for M in (1, 4, 8, 9, 256, 257, 512, 513):
        xm = x[:M].reshape(1, M, K) if M % 2 else x[:M].reshape(M // 2, 2, K)
        got = tq.mm(t(xm), tl)
        assert got.shape == xm.shape[:-1] + (N,)
        _close(got, jq.mm(jnp.asarray(xm), jl))
    _close(tq.mm(t(x[:3]), t(w)), x[:3] @ w)


def test_mm_branches():
    """The wrapper (or none: a plain branch) that mm reaches for each leaf
    kind and width; a group that is not a multiple of 8 rows reaches none."""
    K, N = 256, 300
    x, w = _xw(12, 513, K, N)
    plain = {"quant_matmul": quant_matmul_plain, "w4a16_gemv": w4a16_gemv_plain,
             "w4a16_gemv_arith": w4a16_gemv_arith_plain,
             "w4a16_gemm_arith": w4a16_gemm_arith_plain}
    mocks = {n: mock.Mock(side_effect=f) for n, f in plain.items()}
    want = {
        "int8": {1: "quant_matmul", 256: "quant_matmul", 257: None},
        "int4 halves": {1: "w4a16_gemv", 8: "w4a16_gemv", 9: None, 33: None},
        "int4 arith": {1: "w4a16_gemv_arith", 2: "w4a16_gemm_arith",
                       512: "w4a16_gemm_arith", 513: None},
        "int4 arith dual": {1: "w4a16_gemv_arith", 2: "quant_matmul", 257: None},
        "int4 arith group 4": {1: None, 2: None, 33: None},
        "int4 halves group 4": {1: None, 8: None, 9: None},
    }
    with mock.patch.multiple(tq, **mocks):
        for leaf, widths in want.items():
            tl = tq.QuantLinear(**{k: t(v) for k, v in LEAVES[leaf](jnp.asarray(w)).items()})
            for M, name in widths.items():
                for m in mocks.values():
                    m.reset_mock()
                tq.mm(t(x[:M]), tl)
                reached = [n for n, m in mocks.items() if m.called]
                assert reached == ([name] if name else []), (leaf, M, reached)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_kernel_plan_covers_every_row(int4):
    """The launch plans of the weight streams at the 7B products: K13 at M
    > 1 (csrc/weight_stream.cuh): every row block is walked by exactly one
    row split; K10 (int4, csrc/quant_gemv.cu): every carrier row by exactly
    one block of a slab's cluster, and a group that is not a multiple of 8
    rows is refused."""
    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000)):
        if int4:
            p = quant_matmul.gemv_plan(K // 2, N, 128)
            spans = [quant_matmul.block_stages(p, r, K // 2) for r in range(p.cluster)]
            assert spans[0][0] == 0 and spans[-1][1] * p.rs >= K // 2
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            continue
        for M in (2, 4, 256):
            tiles, rc, passes, ksplit = _wstream.plan(M, K, N)
            nb = -(-K // (_wstream.WARPS * rc))
            assert (ksplit - 1) * passes < nb <= ksplit * passes
            assert rc % 8 == 0
            assert ksplit == 1 or tiles <= _wstream.MAX_TICKETS
    if int4:
        with pytest.raises(ValueError, match="group of 86"):
            quant_matmul.gemv_plan(688, 512, 86)


def _covered_once(n, starts, width):
    """Each of n indices lies in exactly one [start, start + width) ∩ [0, n)."""
    hits = np.zeros(n, np.int64)
    for s in starts:
        hits[s:min(n, s + width)] += 1
    return bool((hits == 1).all())


@pytest.mark.parametrize("M", [2, 4, 16, 17, 96, 128, 511, 512])
def test_k11_plan_covers_every_tile(M):
    """K11's plan (csrc/w4_gemm.cu's tiles) at the 7B products and a ragged
    N: every row, column and scale group of each half is walked by exactly
    one block, no split is empty, a split launch has its tickets, and at M
    = 4 and 512 at least 132 blocks run (one per SM of an H100)."""
    for K, N in ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 11008),
                 (4096, 300)):
        small, gps, ksplit, (cols, rows, splits) = w4_stream.gemm_plan(M, K, N)
        gch = K // 2 // w4_stream.GROUP
        bm = w4_stream.SMALL_M if small else w4_stream.TILE_M
        assert small == (M <= w4_stream.SMALL_M) and splits == ksplit
        assert _covered_once(M, [r * bm for r in range(rows)], bm) and rows * bm < M + bm
        assert _covered_once(N, [c * w4_stream.TILE_N for c in range(cols)], w4_stream.TILE_N)
        assert _covered_once(gch, [z * gps for z in range(ksplit)], gps)
        assert (ksplit - 1) * gps < gch <= ksplit * gps
        assert ksplit == 1 or cols * rows <= _wstream.MAX_TICKETS
        if M in (4, 512) and N >= 4096:
            assert cols * rows * ksplit >= w4_stream.SMS
    with pytest.raises(ValueError, match="1 < M <= 512"):
        w4_stream.gemm_plan(513, 4096, 4096)
    with pytest.raises(ValueError, match="% 128"):
        w4_stream.gemm_plan(4, 4096 + 128, 4096)


# (K, N) of K13's products at M = 1: LLaMa-2-7B's fused tree (wqkv, wo, wgu,
# wd) and head, Mistral-7B's wd, ragged widths and depths
K13_SHAPES = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
              (14336, 4096), (4096, 300), (4096, 4112), (1000, 264), (40, 40), (16, 8))


@pytest.mark.parametrize("K,N", K13_SHAPES)
def test_k13_gemv_plan_covers_every_row_and_column(K, N):
    """K13's M = 1 plan (csrc/quant_gemv.cu's slabs, stages and clusters):
    every (row, column) is taken by exactly one block, each block of a
    cluster takes at least one stage, a stage is a multiple of the 16 rows a
    consumer pass takes, the cluster is the largest power of two up to 8
    (and up to the stages) that keeps a clustered grid within two blocks an
    SM of 132 SMs, and a block's shared memory (ring, partials, x rows)
    fits two to an SM."""
    p = quant_matmul.gemv_plan(K, N)
    assert p.rs % quant_matmul.ROW_LANES == 0 and p.rs <= 256 and 2 <= p.stages <= 16
    assert p.cluster in (1, 2, 4, 8)
    assert _covered_once(N, [s * quant_matmul.TN for s in range(p.slabs)], quant_matmul.TN)
    hits = np.zeros(K, np.int64)
    for r in range(p.cluster):
        s0, s1 = quant_matmul.block_stages(p, r, K)
        assert s1 > s0
        hits[s0 * p.rs:min(K, s1 * p.rs)] += 1
    assert (hits == 1).all()
    stages = -(-K // p.rs)
    assert p.cluster == 1 or p.slabs * p.cluster <= 2 * quant_matmul.SMS
    assert 2 * p.cluster > min(8, stages) or p.slabs * 2 * p.cluster > 2 * quant_matmul.SMS
    assert 2 * quant_matmul.gemv_smem(K, p) <= 232448


# (carrier rows, N) of K10's products: LLaMa-2-7B's split tree (wq = wk =
# wv = wo, wg = wu, wd) and head, its fused tree's wqkv and wgu (the
# per-product path without K14), Mistral-7B's wk / wv and wd, ragged widths
K10_SHAPES = ((2048, 4096), (2048, 11008), (5504, 4096), (2048, 32000), (2048, 12288),
              (2048, 22016), (2048, 1024), (7168, 4096), (2048, 300), (512, 264), (64, 40),
              (1536, 4096), (1088, 4096))


@pytest.mark.parametrize("G", [128, 64, 8, 24, 136, 256, 512])
def test_k10_gemv_plan_covers_every_row_and_column(G):
    """K10's plan (csrc/quant_gemv.cu over the arithmetic carrier, groups of
    G carrier rows): every (carrier row, column) is taken by exactly one
    block, each block of a cluster takes at least one stage, a stage is a
    multiple of the 16 rows a consumer pass takes and of G (or G of it)
    where 128-row stages allow it (then stages and cluster splits fall on
    group boundaries: G = 128, the main path's, one group a stage), the cluster
    is the largest power of two up to 8 (and up to the stages) that keeps a
    clustered grid within two blocks an SM, the scale rows a stage's slot
    holds cover every group it overlaps, and a block's shared memory fits
    two to an SM."""
    for R, N in K10_SHAPES:
        if R % G:
            continue
        p = quant_matmul.gemv_plan(R, N, G)
        assert p.rs % quant_matmul.ROW_LANES == 0 and p.rs <= 256 and 2 <= p.stages <= 16
        assert p.cluster in (1, 2, 4, 8)
        assert _covered_once(N, [s * quant_matmul.TN for s in range(p.slabs)], quant_matmul.TN)
        aligned = p.rs % G == 0 or G % p.rs == 0
        assert aligned == (G <= 64 or G % 16 == 0 and (G <= 128 or G % 128 == 0))
        if G == 128:
            assert p.rs == 128
        hits = np.zeros(R, np.int64)
        stages = -(-R // p.rs)
        for r in range(p.cluster):
            s0, s1 = quant_matmul.block_stages(p, r, R)
            assert s1 > s0
            hits[s0 * p.rs:min(R, s1 * p.rs)] += 1
            if aligned and p.rs % G == 0:
                assert s0 * p.rs % G == 0          # the split falls between groups
        assert (hits == 1).all()
        for s in range(stages):
            r0, r1 = s * p.rs, min(R, (s + 1) * p.rs)
            assert (r1 - 1) // G - r0 // G + 1 <= quant_matmul.stage_groups(p.rs, G)
        assert p.cluster == 1 or p.slabs * p.cluster <= 2 * quant_matmul.SMS
        assert 2 * p.cluster > min(8, stages) or p.slabs * 2 * p.cluster > 2 * quant_matmul.SMS
        assert 2 * quant_matmul.gemv_smem(R, p, G) <= 232448


# (Kh, N) of K12's products: LLaMa-2-7B's split tree (wq = wk = wv = wo, wg,
# wd) and head, Mistral-7B's (wk = wv at 8 KV heads, wg, wd), ragged widths
K12_SHAPES = ((2048, 4096), (2048, 11008), (5504, 4096), (2048, 32000), (2048, 1024),
              (2048, 14336), (7168, 4096), (2048, 300), (512, 264), (256, 40), (3072, 4096))


@pytest.mark.parametrize("M", range(1, 9))
def test_k12_plan_covers_every_row_and_column(M):
    """K12's plan (csrc/w4_matmul.cu's slabs, stage rows and clusters) at
    the 7B and Mistral-7B products and ragged widths, groups of 64 and 128
    (and 24) packed rows: every (packed row, column) is taken by exactly
    one block, each block of a cluster takes at least one stage, a stage
    lies in one group, the cluster has at most 8 blocks, the ring's budget
    (the kernel fits 3 to 8 stages of at most 64 rows into it) leaves the
    block's partial (8 x TN f32) and 2 KB of alignment and barriers within
    half of 232,448 bytes, so that two blocks fit an SM, and the rows split
    only while the grid stays within two blocks an SM of 132 SMs."""
    assert w4_matmul.RING_BYTES + 8 * w4_matmul.TN * 4 + 2048 <= 232448 // 2
    for Kh, N in K12_SHAPES:
        for G in (64, 128, 24):
            if Kh % G:
                continue
            p = w4_matmul.plan(M, Kh, N, G)
            assert p.mt >= M and p.mt in (1, 2, 4, 8)
            assert p.rs % 8 == 0 and G % p.rs == 0 and p.rs <= 64
            assert 1 <= p.cluster <= 8
            assert _covered_once(N, [s * w4_matmul.TN for s in range(p.slabs)], w4_matmul.TN)
            spans = [w4_matmul.block_rows(p, r, Kh) for r in range(p.cluster)]
            hits = np.zeros(Kh, np.int64)
            for r0, r1 in spans:
                assert r1 > r0 and r0 % p.rs == 0
                hits[r0:r1] += 1
            assert (hits == 1).all()
            assert p.cluster == 1 or p.slabs * p.cluster <= 2 * w4_matmul.SMS
    with pytest.raises(ValueError, match="group of 86"):
        w4_matmul.plan(1, 688, 512, 86)


# ---------------------------------------------------------------------------
# converted trees: the JAX prefill's logits
# ---------------------------------------------------------------------------

TREES = {
    "int8 split": lambda p: jq.quantize_params(p),
    "int4 arith fused": lambda p: jq.fuse_gemv_params(jq.quantize_params_int4(p, layout="arith")),
    "int4 halves split": lambda p: jq.quantize_params_int4(p),
    "int4 arith dual fused": lambda p: jq.fuse_gemv_params(
        jq.quantize_params_int4(p, layout="arith", dual_int8=True)),
    "int4 halves int4 head": lambda p: jq.quantize_params_int4(p, lm_head_int8=False),
    "int4 arith fused materialized": lambda p: jq.materialize_params(jq.fuse_gemv_params(
        jq.quantize_params_int4(p, layout="arith"))),
}


@pytest.mark.parametrize("bias,Hkv", [(False, 4), (True, 2)], ids=["MHA", "GQA-bias"])
@pytest.mark.parametrize("tree", list(TREES))
def test_converted_tree_prefill_logits_match_jax(tree, bias, Hkv):
    jgen = importlib.import_module("easykv_tpu.engine.generate")
    tgen = importlib.import_module("easykv_tpu_torch.engine.generate")
    cfg = dict(CFG, num_key_value_heads=Hkv, attention_bias=bias)
    jcfg, tcfg = JModelConfig(**cfg), ModelConfig(**cfg)
    jparams = TREES[tree](jllama.init_params(jcfg, jax.random.PRNGKey(0)))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    ids = np.random.default_rng(6).integers(1, 500, size=(2, 40)).astype(np.int32)
    plen = np.array([40, 29], np.int32)
    jst = jgen.EngineStatics(cfg=jcfg, mode="decoding", policy="full", stride=1, length=40,
                             budget=0)
    jcache = jgen._engine_cache(jst, 2, 128)
    _, jlog = jax.jit(lambda c, i, p: jgen._prefill(jst, jparams, c, i, p, None, "zero"))(
        jcache, jnp.asarray(ids), jnp.asarray(plen))
    tst = tgen.EngineStatics(cfg=tcfg, policy="full", length=40, budget=0)
    tcache = tgen._engine_cache(tst, 2, 128, torch.float32, torch.device("cpu"))
    tlog = tgen._prefill(tst, tparams, tcache, t(ids), t(plen))
    assert tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-4, atol=1e-4)


def test_converter_rejects_s4_leaves():
    _, jparams, _ = _trees()
    leaf = {"w4": np.zeros((2, 256, 64), np.int8), "gs": np.ones((2, 2, 64), np.float32)}
    bad = dict(jparams, layers=dict(jparams["layers"], wq=leaf))
    with pytest.raises(ValueError, match="s4"):
        from_jax_params(jax.tree.map(np.asarray, bad), device="cpu")
