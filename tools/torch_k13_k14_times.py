"""K13 (`quant_matmul`) at M = 1 and K14 (`fused_decode_step`) timed alone on
one CUDA card, at the shapes of chip_smoke.py's phase 5, and the outputs of
K14, K15, K10 and K13 on phase 2's inputs saved for a bit-for-bit comparison
between two builds.

    python3 tools/torch_k13_k14_times.py [--root DIR] [--dump FILE] [--only k13|k14]
                                         [--define NAME ...] [--sweep] [--decode]
    python3 tools/torch_k13_k14_times.py --compare FILE_A FILE_B

K13: bf16 x at M = 1 over the fused tree's four products of LLaMa-2-7B
(wqkv, wo, wgu, wd) and its LM head (f32 out), each a CUDA graph of calls
cycling enough weight copies that L2 is cold (chip_smoke.graph_ms), beside
torch.matmul of x with a bf16 copy dequantized beforehand. K14: the step at
L = 32, S = 768, bf16 and int8 KV (chip_smoke.event_ms). Bounds as phase 5
computes them.

--root DIR imports chip_smoke.py and easykv_tpu_torch from DIR instead of
this checkout (an unpacked older commit, for an A/B in one call: run the
two trees in turns, each in its own process). --dump FILE saves K14's five
outputs at phase 2's cases and at phase 5's L = 32 inputs, K15's at phase
2's cases, K10's at the split tree's products (M = 1) and K13's at the
fused tree's products (M = 1, 4 and 256); --compare reports, per case and
output, whether two dumps are bit-identical and their largest difference.
--define NAME builds the sources the switch belongs to with -DNAME and
times those builds: K13_NO_MATH (quant_gemv.cu: the weight stream without
the arithmetic), K14_NO_DOTS and K14_EMPTY_PHASES (fused_decode.cu). --sweep
also times K13 at M = 1 over cluster sizes and stage rows (the plan's
choice beside them). --decode also reads phase 3's fused int4 B = 1
decode (K14 a step; int8 and bf16 KV) in tok/s. Prints one JSON object
with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K13_WIDTHS = ("wqkv", "wo", "wgu", "wd", "head")
# diagnostic switch prefix: (source, wrapper module, its signatures of that source)
SWITCHES = {"K13_": ("quant_gemv", "quant_matmul", "GEMV_SIGNATURES"),
            "K14_": ("fused_decode", "fused_decode", "SIGNATURES")}


def k13_times(cs, dev, reps):
    import torch
    out = {}
    for j, name in enumerate(K13_WIDTHS):
        K, N = cs.QSHAPES[name]
        ql = cs.quant_case(name, "int8", dev, 440 + j)
        args = cs.quant_args("K13", ql)
        wbytes = sum(a.numel() * a.element_size() for a in args)
        copies = [tuple(a.clone() for a in args) for _ in range(cs.quant_copies(wbytes))]
        deq = cs.quant_mod.dequantize(ql, torch.bfloat16)
        lib_w = [deq.clone() for _ in range(cs.quant_copies(deq.numel() * 2, 8))]
        del ql, deq
        x = torch.randn((1, K), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev).to(torch.bfloat16)
        f32 = name == "head"
        ms = cs.graph_ms(lambda *a: cs.k13(*a, out_f32=f32), [(x, *c) for c in copies], reps)
        lib = cs.graph_ms(torch.matmul, [(x, w) for w in lib_w], 64)
        nbytes = wbytes + K * 2 + N * (4 if f32 else 2)
        out[name] = {"us": ms * 1e3, "matmul_us": lib * 1e3,
                     "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6}
        del copies, lib_w
        torch.cuda.empty_cache()
    return out


def k13_sweep(cs, dev):
    """K13 at M = 1 (bf16 x) over the five widths, with each (cluster, stage
    rows and stages: a 64 KB ring) in place of the plan's; the plan's own
    choice beside them."""
    import torch
    from easykv_tpu_torch.ops.cuda import quant_matmul as qm
    plan = qm.gemv_plan
    out = {}
    for j, name in enumerate(K13_WIDTHS):
        K, N = cs.QSHAPES[name]
        args = cs.quant_args("K13", cs.quant_case(name, "int8", dev, 460 + j))
        wbytes = sum(a.numel() * a.element_size() for a in args)
        copies = [tuple(a.clone() for a in args) for _ in range(cs.quant_copies(wbytes))]
        x = torch.randn((1, K), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev).to(torch.bfloat16)
        f32 = name == "head"
        p = plan(K, N)
        row = {"plan": list(p)}
        for c in (1, 2, 4, 8):
            for rs, st in ((32, 8), (64, 4), (128, 2)):
                qm.gemv_plan = lambda *a, c=c, rs=rs, st=st: plan(*a)._replace(cluster=c, rs=rs,
                                                                             stages=st)
                try:
                    row[f"c{c} rs{rs}"] = cs.graph_ms(lambda *a: cs.k13(*a, out_f32=f32),
                                                      [(x, *cp) for cp in copies], 128) * 1e3
                except RuntimeError as e:   # more blocks than stages, or too much memory
                    row[f"c{c} rs{rs}"] = str(e)
                finally:
                    qm.gemv_plan = plan
        out[name] = row
        del copies
        torch.cuda.empty_cache()
    return out


def k14_times(cs, dev, reps):
    import torch
    cfg, tree = cs.step_tree(dev, 32, 0)
    wbytes = cs.step_tree_bytes(tree)
    L, H, S, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cs.S_MAIN, cfg.head_dim
    out = {}
    for kv in ("bf16", "int8"):
        args, _ = cs.step_case(dev, cfg, 1, kv, False, 800)
        visible = int(((args[2] >= 0) & (args[2] <= args[4])).sum())
        row = D * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
        nbytes = (wbytes + 2 * visible * row + L * H * S * 4 + L * H * S * 4
                  + 2 * L * H * D * 2 + L * H * 4 + cfg.hidden_size * 2)
        ms = cs.event_ms(lambda *a: cs.k14(tree.layers, cfg, *a), [args], reps)
        out[f"{kv} KV"] = {"us": ms * 1e3, "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6}
        del args
        torch.cuda.empty_cache()
    del tree
    torch.cuda.empty_cache()
    return out


def decode_tok_s(cs, dev):
    """Phase 3's runs of bench.py's headline tree at B = 1 (K14 once a
    step): int4 arithmetic fused, roco at budget 200, the 512-token prompt
    and 384 new tokens, greedy, int8 and bf16 KV; decode tok/s on the host
    clock, as phase 3 reads it."""
    import torch
    import easykv_tpu_torch
    from easykv_tpu_torch.models.llama import init_params
    cfg = cs.LLAMA2_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    tree = cs.quant_mod.fuse_gemv_params(cs.quant_mod.quantize_params_int4(params, layout="arith"))
    del params
    torch.cuda.empty_cache()
    prompt = torch.randint(1, cfg.vocab_size, (cs.B_MAX, cs.PROMPT),
                           generator=torch.Generator().manual_seed(0))[0].tolist()
    gc = dict(budget=cs.BUDGET, kv_policy="roco", max_new_tokens=cs.NEW, temperature=1e-9,
              top_p=1.0, eos_token_ids=[], seed=0)
    out = {}
    for kv in ("int8", "bf16"):
        model = easykv_tpu_torch.enable_fixed_kv(
            easykv_tpu_torch.CausalLM(cfg, tree, device=dev, kv_quant=kv == "int8"), None,
            "decoding")
        model.easykv_generate(prompt, dict(gc, max_new_tokens=8))   # warm-up
        before = cs.k14.launches
        model.easykv_generate(prompt, gc)
        st = model.last_run
        out[f"{kv} KV"] = {"tok_s": st.n_tokens / st.decode_s, "K14": cs.k14.launches - before}
        del model
        torch.cuda.empty_cache()
    return out


def dump(cs, dev, path):
    """K14's outputs at phase 2's cases (phase_k14's tree, seeds and
    arguments) and at phase 5's L = 32 inputs; K15's at phase 2's cases
    (phase_k15's); K10's at the split tree's products and K13's at the
    fused tree's (x bf16 and f32), saved to `path`."""
    import torch
    outs = {}
    cfg, tree = cs.step_tree(dev, 2, 7)
    for kv in ("bf16", "int8"):
        for rope, scattered in ((False, False), (True, False), (True, True)):
            args, rope_pos = cs.step_case(dev, cfg, 1, kv, rope, 700 + rope + 2 * scattered,
                                          holes=scattered)
            got = cs.k14(tree.layers, cfg, *args, rope_pos=rope_pos)
            outs[f"K14 L=2 {kv} rope={rope} holes={scattered}"] = [t.cpu() for t in got]
    del tree
    torch.cuda.empty_cache()
    cfg, tree = cs.step_tree(dev, 32, 0)
    for kv in ("bf16", "int8"):
        args, _ = cs.step_case(dev, cfg, 1, kv, False, 800)
        outs[f"K14 L=32 {kv}"] = [t.cpu() for t in cs.k14(tree.layers, cfg, *args)]
    del tree
    torch.cuda.empty_cache()
    for base, Bs in ((cs.LLAMA2_7B, (cs.B_WIDE, cs.B_MAX)), (cs.MISTRAL_7B, (8,))):
        cfg, tree = cs.step_tree(dev, 2, 7, base)
        for B in Bs:
            for kv in ("bf16", "int8"):
                for rope in (False, True):
                    args, rope_pos = cs.step_case(dev, cfg, B, kv, rope, 900 + B + 2 * rope,
                                                  holes=True, dead_row=True)
                    got = cs.k15(tree.layers, cfg, *args, rope_pos=rope_pos)
                    key = f"K15 {'llama' if base is cs.LLAMA2_7B else 'mistral'} B={B} {kv} rope={rope}"
                    outs[key] = [t.cpu() for t in got]
        del tree
        torch.cuda.empty_cache()
    for kernel, fmt, names, ms in (("K10", "arith", cs.SPLIT_SHAPES, (1,)),
                                   ("K13", "int8", cs.FUSED + ("head",), (1, 4, 256))):
        fn = cs.QPAIRS[kernel][0]
        for j, name in enumerate(names):
            args = cs.quant_args(kernel, cs.quant_case(name, fmt, dev, 450 + j))
            for M in ms:
                for dtype in (torch.bfloat16, torch.float32):
                    x = torch.randn((M, cs.QSHAPES[name][0]), device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(M)).to(dtype)
                    outs[f"{kernel} {name} M={M} {dtype}"] = [fn(x, *args).cpu()]
    torch.save(outs, path)
    return sorted(outs)


def compare(a, b):
    """Per case and output of two dumps (keys "<kernel> <case>"): whether
    they are bit-identical (NaN payloads and signed zeros included) and
    their largest difference; and per kernel whether all its cases are."""
    import torch
    da, db = torch.load(a), torch.load(b)
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

    def same(x, y):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        if x.is_floating_point():
            x, y = x.view(bits[x.element_size()]), y.view(bits[y.element_size()])
        return torch.equal(x, y)
    res = {}
    for key in sorted(set(da) & set(db)):
        res[key] = [{"identical": bool(same(x, y)),
                     "max_abs_diff": float((x.float() - y.float()).abs().max())}
                    for x, y in zip(da[key], db[key])]
    same = lambda keys: all(o["identical"] for k in keys for o in res[k])  # noqa: E731
    for kernel in sorted({k.split(" ")[0] for k in list(res)}):
        keys = [k for k in res if k.startswith(kernel + " ")]
        res[f"{kernel} identical"] = same(keys)
        if kernel == "K13":
            res["K13 M>1 identical"] = same([k for k in keys if " M=1 " not in k])
    res["only in one"] = sorted(set(da) ^ set(db))
    return res


def card_name():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def open_tree(root, defines, switches=SWITCHES, smoke=None):
    """chip_smoke of the tree at `root` (its easykv_tpu_torch imported
    first), or, given `smoke`, the chip_smoke.py of the tree at `smoke` run
    on `root`'s easykv_tpu_torch; with the diagnostic builds of `defines`
    (each -DNAME builds the source its prefix in `switches` names) loaded in
    place of the normal ones."""
    sys.path.insert(0, os.path.abspath(root))
    if smoke is None:
        import chip_smoke as cs
    else:
        import importlib.util
        import easykv_tpu_torch  # noqa: F401  (root's package, before chip_smoke imports it)
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      os.path.join(smoke, "chip_smoke.py"))
        cs = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = cs
        spec.loader.exec_module(cs)
    if defines:
        import importlib
        from easykv_tpu_torch.ops.cuda import _build
        for prefix, (source, module, sigs) in switches.items():
            names = [d for d in defines if d.startswith(prefix)]
            if names and source in _build.SOURCES:
                mod = importlib.import_module(f"easykv_tpu_torch.ops.cuda.{module}")
                _build._libs[source] = _build.load_debug(source, names, getattr(mod, sigs))
    return cs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--dump")
    ap.add_argument("--only", choices=("k13", "k14"))
    ap.add_argument("--define", action="append", default=[],
                    help="time the kernels built with -D<DEFINE> (a diagnostic switch)")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--sweep", action="store_true", help="K13 at M = 1 over clusters and stages")
    ap.add_argument("--decode", action="store_true",
                    help="phase 3's fused int4 B = 1 decode tok/s (int8 and bf16 KV)")
    opt = ap.parse_args()
    if opt.compare:
        print(json.dumps(compare(*opt.compare), indent=1))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs = open_tree(opt.root, opt.define)
    dev = torch.device("cuda")
    res = {"card": card_name(), "root": os.path.abspath(opt.root), "define": opt.define}
    if opt.only != "k14":
        res["k13"] = k13_times(cs, dev, 256)
    if opt.only != "k13":
        res["k14"] = k14_times(cs, dev, 20)
    if opt.sweep:
        res["k13_sweep_us"] = k13_sweep(cs, dev)
    if opt.decode:
        res["decode"] = decode_tok_s(cs, dev)
    if opt.dump:
        res["dumped"] = dump(cs, dev, opt.dump)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
