"""Model loading, checkpoints, the CLI, utils and testing of the port against
the JAX package, on the CPU at tiny widths (L = 2, D = 64, 4 heads, 2 KV
heads, V = 256). Every checkpoint is written here from a numpy seed with
safetensors.numpy.save_file; nothing is downloaded.

- The port's mmap reader against safetensors.numpy.load_file for every
  dtype (an F32 after an odd-length I8 too), its errors, a view outliving
  its file, and the port's writer read back by load_file.
- load_hf_checkpoint: the port's tree (device="cpu") against the JAX
  package's, converted by from_jax_params, leaf for leaf and bit for bit:
  every quantize mode, the halves layout, F32 / F16 / BF16 storage, a tied
  model, an untied one without lm_head.weight, Qwen2 biases, no `model.`
  prefix, and a bf16 load. The JAX loader quantizes inside jax.jit, where
  XLA turns the int8 scale's `amax / 127` into `amax * (1 / 127)`; the port
  quantizes with ops/quant.py's own functions (so that a loaded tree is the
  in-memory quantized tree, bit for bit), which are the JAX package's eager
  ones. So each quantized tree is held exactly to the JAX package's f32
  load quantized by its own quantize_params(_int4), and to the JAX
  quantized load exactly but for the int8 per-channel scales (s, s8),
  which are within one f32 ulp there.
- params_from_hf_state_dict and params_from_hf_model against the JAX ones.
- Greedy `generate` in `decoding` from loaded f32 and int4 trees (the
  port's one-kernel decode step off, so both packages run the per-layer
  scan): equal tokens.
- save_checkpoint / load_checkpoint round trips bit for bit; the JAX
  package's config.json loads into the port's ModelConfig.
- cache_size_mb against the JAX package's; assert_finite_tree, nan_guard.
- The CLI of both packages on one checkpoint: `generate` in `decoding` and
  `encoding` (equal tokens), `ppl` (within 1e-5 relative), `info` (the same
  JSON); without --device and without a card the port's CLI raises.
"""
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import easykv_tpu
import easykv_tpu_torch
from easykv_tpu import cli as jcli
from easykv_tpu.cache import init_cache as jinit_cache
from easykv_tpu.config import ModelConfig as JModelConfig
from easykv_tpu.models import hf as jhf
from easykv_tpu.ops import quant as jq
from easykv_tpu.utils import cache_size_mb as jcache_size_mb

from easykv_tpu_torch import cli as tcli
from easykv_tpu_torch import flags as tflags
from easykv_tpu_torch.cache import init_cache
from easykv_tpu_torch.config import ModelConfig
from easykv_tpu_torch.models import hf as thf
from easykv_tpu_torch.models.checkpoint import _flat, load_checkpoint, save_checkpoint
from easykv_tpu_torch.models.convert import from_jax_params
from easykv_tpu_torch.models.llama import init_params
from easykv_tpu_torch.native import SafetensorsFile, load_safetensors_dir, save_safetensors
from easykv_tpu_torch.ops import quant as tq
from easykv_tpu_torch.testing import assert_finite_tree, nan_guard
from easykv_tpu_torch.utils import cache_size_mb, device_memory_stats

L, D, H, KV, DH, F, V = 2, 64, 4, 2, 16, 128, 256
HF_CFG = dict(model_type="llama", vocab_size=V, hidden_size=D, intermediate_size=F,
              num_hidden_layers=L, num_attention_heads=H, num_key_value_heads=KV,
              max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
              tie_word_embeddings=False)
LINEARS = {"self_attn.q_proj": (H * DH, D), "self_attn.k_proj": (KV * DH, D),
           "self_attn.v_proj": (KV * DH, D), "self_attn.o_proj": (D, H * DH),
           "mlp.gate_proj": (F, D), "mlp.up_proj": (F, D), "mlp.down_proj": (D, F)}
# checkpoint variant -> (config overrides, stored dtype, prefix, head, biases)
VARIANTS = {
    "f32": ({}, np.float32, "model.", True, False),
    "f16": ({}, np.float16, "model.", True, False),
    "bf16": ({}, ml_dtypes.bfloat16, "model.", True, False),
    "tied": ({"tie_word_embeddings": True}, np.float32, "model.", False, False),
    "no head": ({}, np.float32, "model.", False, False),
    "qwen2": ({"model_type": "qwen2"}, np.float32, "model.", True, True),
    "no prefix": ({}, np.float32, "", True, False),
}
# (variant, quantize, int4 layout, load dtype): every stored dtype and
# variant plain, each quantize mode once (the JAX quantized load compiles a
# jit a weight family, ~3 s a load here)
LOADS = [("f32", None, "arith", "float32"), ("f16", None, "arith", "float32"),
         ("bf16", None, "arith", "float32"), ("tied", None, "arith", "float32"),
         ("no head", None, "arith", "float32"), ("qwen2", None, "arith", "float32"),
         ("no prefix", None, "arith", "float32"), ("f32", None, "arith", "bfloat16"),
         ("no head", "int8", "arith", "float32"), ("bf16", "int4", "arith", "float32"),
         ("qwen2", "int4_dual", "arith", "float32"), ("f32", "int4", "halves", "float32")]
EAGER = {"int8": jq.quantize_params,
         "int4": lambda p, layout: jq.quantize_params_int4(p, layout=layout),
         "int4_dual": lambda p, layout: jq.quantize_params_int4(p, layout=layout,
                                                               dual_int8=True)}


def hf_tensors(seed, dtype, prefix, head, biases):
    rng = np.random.default_rng(seed)
    sd = {f"{prefix}embed_tokens.weight": rng.normal(size=(V, D)),
          f"{prefix}norm.weight": 1 + 0.1 * rng.normal(size=(D,))}
    for i in range(L):
        p = f"{prefix}layers.{i}."
        for name, shape in LINEARS.items():
            sd[p + name + ".weight"] = rng.normal(size=shape) * shape[1] ** -0.5
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[p + name + ".weight"] = 1 + 0.1 * rng.normal(size=(D,))
        if biases:
            for name in ("q_proj", "k_proj", "v_proj"):
                sd[f"{p}self_attn.{name}.bias"] = 0.1 * rng.normal(
                    size=(LINEARS[f"self_attn.{name}"][0],))
    if head:
        sd["lm_head.weight"] = rng.normal(size=(V, D)) * D ** -0.5
    return {k: v.astype(dtype) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for i, (name, (over, dtype, prefix, head, biases)) in enumerate(VARIANTS.items()):
        d = tmp_path_factory.mktemp("ckpt")
        save_file(hf_tensors(i, dtype, prefix, head, biases), str(d / "model.safetensors"))
        (d / "config.json").write_text(json.dumps(dict(HF_CFG, **over)))
        out[name] = str(d)
    return out


def same_leaves(a, b, ulp_keys=()):
    """a and b (name -> tensor) hold the same names, dtypes and bits; leaves
    whose last key is in ulp_keys (f32) within one ulp. Returns the names
    that were not bit-equal."""
    assert a.keys() == b.keys()
    loose = []
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        if torch.equal(a[k], b[k]):
            continue
        assert k.rsplit(".", 1)[-1] in ulp_keys, k
        gap = (a[k].view(torch.int32).long() - b[k].view(torch.int32).long()).abs().max()
        assert int(gap) <= 1, (k, int(gap))
        loose.append(k)
    return loose


# ---------------------------------------------------------------------------
# the reader and the writer
# ---------------------------------------------------------------------------

def test_reader_matches_safetensors_library(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "f32": rng.normal(size=(8, 3)).astype(np.float32),
        "f16": rng.normal(size=(5,)).astype(np.float16),
        "bf16": rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16),
        "i8": rng.integers(-128, 127, size=(3, 3)).astype(np.int8),
        "u8": rng.integers(0, 255, size=(4,)).astype(np.uint8),
        "i32": rng.integers(-2**31, 2**31 - 1, size=(3, 2)).astype(np.int32),
        "i64": rng.integers(-2**62, 2**62, size=(2,)).astype(np.int64),
        "bool": rng.random(size=(7,)) > 0.5,
        "empty": np.zeros((0, 4), np.float32),
    }
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path)
    ref = load_file(path)
    with SafetensorsFile(path) as f:
        assert set(f.keys()) == set(tensors)
        for name, want in ref.items():
            got = f.tensor(name)
            assert tuple(got.shape) == want.shape
            if want.dtype == ml_dtypes.bfloat16:
                assert got.dtype == torch.bfloat16
                np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
            else:
                np.testing.assert_array_equal(got.numpy(), want)


def test_reader_misaligned_f32_after_odd_i8(tmp_path):
    """An F32 tensor at byte offset 3 of the data (after a 3-byte I8): read
    right, into memory aligned for its dtype."""
    i8 = np.array([1, -2, 3], np.int8)
    f32 = np.array([[1.5, -2.25], [3.0, 1e-3]], np.float32)
    header = {"a": {"dtype": "I8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [2, 2], "data_offsets": [3, 19]}}
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(len(head).to_bytes(8, "little") + head + i8.tobytes() + f32.tobytes())
    ref = load_file(str(path))
    np.testing.assert_array_equal(ref["b"], f32)
    with SafetensorsFile(str(path)) as f:
        b = f.tensor("b")
        assert b.data_ptr() % 4 == 0
        np.testing.assert_array_equal(b.numpy(), ref["b"])
        np.testing.assert_array_equal(f.tensor("a").numpy(), ref["a"])


def test_reader_errors(tmp_path):
    save_file({"x": np.ones(3, np.float32)}, str(tmp_path / "ok.safetensors"))
    with SafetensorsFile(str(tmp_path / "ok.safetensors")) as f:
        with pytest.raises(KeyError):
            f.tensor("missing")
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\xff" * 8 + b"{}")
    with pytest.raises(OSError):
        SafetensorsFile(str(bad))
    with pytest.raises(OSError):
        SafetensorsFile(str(tmp_path / "absent.safetensors"))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        load_safetensors_dir(str(empty))


def test_view_outlives_its_file(tmp_path):
    import gc

    w = np.arange(4096, dtype=np.float32).reshape(64, 64)
    path = str(tmp_path / "w.safetensors")
    save_file({"w": w}, path)
    f = SafetensorsFile(path)
    view = f.tensor("w").t()[3:]
    del f
    gc.collect()
    np.testing.assert_array_equal(view.numpy(), w.T[3:])
    with SafetensorsFile(path) as f:
        view = f.tensor("w")
    gc.collect()
    np.testing.assert_array_equal(view.numpy(), w)
    sd, files = load_safetensors_dir(str(tmp_path))
    del files
    gc.collect()
    np.testing.assert_array_equal(sd["w"].numpy(), w)


def test_writer_round_trips_through_the_library(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {"b": torch.randn(3, 5, generator=g).to(torch.bfloat16),
               "h": torch.randn(7, generator=g).to(torch.float16),
               "f": torch.randn(2, 3, generator=g), "d": torch.randn(3, generator=g).double(),
               "i": torch.randint(-100, 100, (9,), generator=g).to(torch.int8),
               "l": torch.arange(5), "m": torch.tensor([True, False, True]),
               "t": torch.randn(4, 6, generator=g).t()}   # not contiguous
    path = str(tmp_path / "w.safetensors")
    n = save_safetensors(path, tensors, {"format": "pt"})
    assert n == (tmp_path / "w.safetensors").stat().st_size
    ref = load_file(path)
    for k, t in tensors.items():
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(ref[k].view(np.int16), t.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(ref[k], t.numpy())
    with SafetensorsFile(path) as f:
        assert all(torch.equal(f.tensor(k), t) for k, t in tensors.items())


# ---------------------------------------------------------------------------
# the loader against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant,quantize,layout,dtype", LOADS,
                         ids=[f"{v}-{q}-{lay}-{dt}" for v, q, lay, dt in LOADS])
def test_load_hf_checkpoint_matches_jax(ckpts, variant, quantize, layout, dtype):
    path = ckpts[variant]
    jcfg, jp = jhf.load_hf_checkpoint(path, dtype=jnp.dtype(dtype), quantize=quantize,
                                      int4_layout=layout)
    tcfg, tp = thf.load_hf_checkpoint(path, dtype=getattr(torch, dtype), quantize=quantize,
                                      int4_layout=layout, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    got = _flat(tp)
    loose = same_leaves(_flat(from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")),
                        got, ulp_keys=("s", "s8"))
    assert (tp.lm_head is None) == (variant == "tied")
    assert ("layers.0.bq" in got) == (variant == "qwen2")
    if quantize is None:
        assert not loose
        return
    assert isinstance(tp.layers[0].wd, tq.QuantLinear) and isinstance(tp.lm_head, tq.QuantLinear)
    assert "q" in tp.lm_head   # the LM head is int8 under every mode
    # the JAX package's own f32 load, quantized in memory by its own functions
    _, jplain = jhf.load_hf_checkpoint(path, dtype=jnp.dtype(dtype))
    eager = EAGER[quantize](jplain) if quantize == "int8" else EAGER[quantize](jplain, layout)
    assert not same_leaves(_flat(from_jax_params(jax.tree.map(np.asarray, eager),
                                                 device="cpu")), got)
    # and the port's own: the loaded tree is the in-memory quantized tree
    _, tplain = thf.load_hf_checkpoint(path, dtype=getattr(torch, dtype), device="cpu")
    mine = (tq.quantize_params(tplain) if quantize == "int8" else tq.quantize_params_int4(
        tplain, layout=layout, dual_int8=quantize == "int4_dual"))
    assert not same_leaves(_flat(mine), got)


def test_loaded_leaves_own_their_memory(ckpts):
    _, tp = thf.load_hf_checkpoint(ckpts["f32"], dtype=torch.float32, device="cpu")
    sd, _ = load_safetensors_dir(ckpts["f32"])
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()) for t in sd.values()]
    for name, t in _flat(tp).items():
        assert not any(a <= t.data_ptr() < b for a, b in spans), name
        t.add_(0)    # writable: no leaf is a view of the read-only mapping


def test_state_dict_and_model_match_jax():
    from transformers import LlamaConfig, LlamaForCausalLM

    hf = LlamaForCausalLM(LlamaConfig(**{k: v for k, v in HF_CFG.items() if k != "model_type"}))
    jcfg, jp = jhf.params_from_hf_model(hf)
    tcfg, tp = thf.params_from_hf_model(hf, device="cpu")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert not same_leaves(_flat(from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")),
                           _flat(tp))
    sd = hf_tensors(7, np.float16, "", True, True)
    cfg = ModelConfig(**{k: v for k, v in HF_CFG.items() if k != "model_type"})
    jp = jhf.params_from_hf_state_dict(JModelConfig(**dataclasses.asdict(cfg)), sd)
    tp = thf.params_from_hf_state_dict(cfg, sd, device="cpu")
    assert not same_leaves(_flat(from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")),
                           _flat(tp))
    back = thf.hf_state_dict(tp)
    assert back.keys() == {("model." + k if k != "lm_head.weight" else k) for k in sd}
    assert all(torch.equal(back[("model." + k if k != "lm_head.weight" else k)],
                           torch.from_numpy(v.astype(np.float32))) for k, v in sd.items())


PROMPT = "The budgeted cache keeps what matters."
GEN = {"budget": 12, "kv_policy": "roco", "temperature": 1e-9, "top_p": 1.0,
       "max_new_tokens": 8, "seed": 0, "keep_attention": False, "streaming": False}


@pytest.mark.parametrize("quantize", [None, "int4"])
def test_generate_from_loaded_trees_matches_jax(ckpts, quantize):
    """Greedy roco `decoding` from the f32 tree (the CLI's `generate
    --mode decoding` call, so the JAX package compiles it once) and from the
    int4 arithmetic fused tree: equal tokens."""
    tflags.use_mega(False)
    try:
        jcfg, jp = jhf.load_hf_checkpoint(ckpts["f32"], dtype=jnp.float32, quantize=quantize)
        tcfg, tp = thf.load_hf_checkpoint(ckpts["f32"], dtype=torch.float32, quantize=quantize,
                                          device="cpu")
        if quantize:
            jp, tp = jq.fuse_gemv_params(jp), tq.fuse_gemv_params(tp)
        tm = easykv_tpu_torch.CausalLM(tcfg, tp, device="cpu")
        ids = tcli.prompt_ids(tm, tcli.parser().parse_args(["generate", "--prompt", PROMPT]))
        ref = easykv_tpu.generate(easykv_tpu.CausalLM(jcfg, jp), ids, GEN, kv_mode="decoding",
                                  stride=8)
        out = easykv_tpu_torch.generate(tm, ids, GEN, kv_mode="decoding", stride=8)
        assert out == ref and len(out) == 8
    finally:
        tflags.use_mega(None)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

TREES = {
    "plain": lambda p: p,
    "int8": tq.quantize_params,
    "int4 arith fused": lambda p: tq.fuse_gemv_params(tq.quantize_params_int4(p, layout="arith")),
    "dual": lambda p: tq.quantize_params_int4(p, layout="arith", dual_int8=True),
}


@pytest.mark.parametrize("tree", list(TREES))
def test_checkpoint_round_trip(tmp_path, tree):
    cfg = ModelConfig(**{k: v for k, v in HF_CFG.items() if k != "model_type"},
                      attention_bias=tree == "plain")
    params = TREES[tree](init_params(cfg, seed=3, dtype=torch.bfloat16, device="cpu"))
    save_checkpoint(str(tmp_path), cfg, params)
    cfg2, back = load_checkpoint(str(tmp_path), device="cpu")
    assert cfg2 == cfg
    assert not same_leaves(_flat(params), _flat(back))
    assert [type(getattr(back.layers[0], k)) for k, _ in params.layers[0].named_children()] \
        == [type(m) for _, m in params.layers[0].named_children()]
    _, cast = load_checkpoint(str(tmp_path), dtype=torch.float32, device="cpu")
    for k, t in _flat(cast).items():   # dtype casts the plain floating leaves only
        src = _flat(params)[k]
        want = src.dtype if k.rsplit(".", 1)[-1] in tq.LEAF_KEYS else torch.float32
        assert t.dtype == want and torch.equal(t, src.to(want)), k


def test_jax_config_json_loads(tmp_path):
    jcfg = JModelConfig(vocab_size=V, hidden_size=D, intermediate_size=F, num_hidden_layers=L,
                        num_attention_heads=H, num_key_value_heads=KV, sliding_window=32,
                        rope_scaling_type="dynamic", rope_scaling_factor=2.0,
                        attention_bias=True)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    save_checkpoint(str(tmp_path), cfg, init_params(cfg, seed=1, device="cpu"))
    (tmp_path / "config.json").write_text(json.dumps(dataclasses.asdict(jcfg), indent=2))
    got, _ = load_checkpoint(str(tmp_path), device="cpu")
    assert got == cfg and dataclasses.asdict(got) == dataclasses.asdict(jcfg)


# ---------------------------------------------------------------------------
# utils and testing
# ---------------------------------------------------------------------------

def test_cache_size_mb_matches_jax():
    """int8: every array both packages allocate is the same. A float cache:
    the JAX package also allocates two (L, B, H, 1) f32 placeholder scale
    arrays, which the port's float cache does not have."""
    for quant in (False, True):
        j = jcache_size_mb(jinit_cache(L, 3, KV, 40, DH, jnp.bfloat16, quantized=quant))
        t = cache_size_mb(init_cache(L, 3, KV, 40, DH, torch.bfloat16, torch.device("cpu"),
                                     quantized=quant))
        assert t == j - (0 if quant else 2 * L * 3 * KV * 4 / 1024**2)
    assert device_memory_stats("cpu") == {}


def test_finite_and_nan_guards():
    cfg = ModelConfig(**{k: v for k, v in HF_CFG.items() if k != "model_type"})
    params = init_params(cfg, seed=0, device="cpu")
    cache = init_cache(L, 1, KV, 8, DH, torch.float32, torch.device("cpu"))
    assert_finite_tree({"params": params, "cache": cache, "x": [torch.ones(2)]})
    with torch.no_grad():
        params.layers[1].wd[2, 3] = float("nan")
    with pytest.raises(FloatingPointError, match=r"params\.layers\.1\.wd"):
        assert_finite_tree(params, "params")
    cache.score[0, 0, 1, 2] = float("inf")
    with pytest.raises(FloatingPointError, match=r"cache\.score"):
        assert_finite_tree(cache, "cache")
    f = nan_guard(lambda x: (x.log() * 2).sum())
    assert float(f(torch.ones(4))) == 0.0
    with pytest.raises(FloatingPointError, match="log"):
        f(-torch.ones(4))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture
def no_tokenizer(monkeypatch):
    """The checkpoint has no tokenizer: the port's CLI looks for none
    (load_tokenizer sees no tokenizer files); the JAX CLI's lookup raises
    here, as it does on such a directory, without reaching transformers'
    loaders."""
    import transformers

    def refuse(*a, **k):
        raise OSError("no tokenizer in this checkpoint")
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained", refuse)


@pytest.mark.parametrize("cmd", ["generate decoding", "generate encoding", "ppl", "info"])
def test_cli_matches_jax(ckpts, cmd, capsys, no_tokenizer):
    argv = cmd.split()[:1] + ["--model", ckpts["f32"], "--dtype", "float32"]
    if cmd.startswith("generate"):
        argv += ["--mode", cmd.split()[1], "--max-new-tokens", "8", "--temperature", "1e-9",
                 "--prompt", PROMPT]
        argv += ["--budget", "12"] if "decoding" in cmd else ["--stride", "4"]
    ref = _cli(jcli.main, argv, capsys)
    out = _cli(tcli.main, argv + ["--device", "cpu"], capsys)
    if cmd == "info":
        assert json.loads(out) == json.loads(ref)
    elif cmd == "ppl":
        (j,), (t,) = (re.findall(r"ppl: ([0-9.]+)", s) for s in (ref, out))
        assert np.isfinite(float(t)) and float(t) == pytest.approx(float(j), rel=1e-5)
    else:
        ids = [re.findall(r"\[[0-9, ]+\]", s)[-1] for s in (ref, out)]
        assert ids[0] == ids[1] and len(json.loads(ids[1])) == 8


def test_cli_needs_a_device_without_a_card(ckpts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["info", "--model", ckpts["f32"]])
