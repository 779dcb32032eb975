"""K12 (`w4a16_gemv`) and K15 (`fused_decode_step_batch`) timed alone on one
CUDA card, at the shapes of chip_smoke.py's phase 5, and the outputs of
K15 (and of K10 and K13, which share no source with K12 any more) on phase
2's inputs saved for a bit-for-bit comparison between two builds.

    python3 tools/torch_k12_k15_times.py [--root DIR] [--dump FILE] [--only k12|k15]
                                         [--define NAME] [--sweep]
    python3 tools/torch_k12_k15_times.py --compare FILE_A FILE_B
    python3 tools/torch_k12_k15_times.py --norm

K12: bf16 x at M = 1 and 8 over LLaMa-2-7B's split-tree widths (wq, wg,
wd), each a CUDA graph of calls cycling enough weight copies that L2 is
cold (chip_smoke.graph_ms), beside torch.matmul of x with a bf16 copy
dequantized beforehand. K15: the step at L = 32, S = 768, B = 4 and 16,
bf16 and int8 KV (chip_smoke.event_ms). Bounds as phase 5 computes them.

--root DIR imports chip_smoke.py and easykv_tpu_torch from DIR instead of
this checkout (an unpacked older commit, for an A/B in one call: run the
two trees in turns, each in its own process). --dump FILE saves K15's five
outputs at every phase-2 case (chip_smoke.phase_k15's trees, seeds and
arguments) and K10's and K13's at the 7B products; --compare reports, per
case and output, whether two dumps are bit-identical and their largest
difference. --define NAME builds both
sources with -DNAME and times those builds: K12_NO_MATH and K15_NO_MMA
leave the products' arithmetic out, to time the weight stream alone.
--sweep also times K12 at M = 1 with each cluster size from 1 to 8 (the
plan's choice beside them). --norm reads K15's first RMSNorm at the card
tests' 7b-B9 draw (norm_rows) and times nothing. Prints one JSON object
with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def k12_times(cs, dev, reps):
    import torch
    out = {}
    for j, name in enumerate(cs.SPLIT_SHAPES):
        K, N = cs.QSHAPES[name]
        ql = cs.quant_case(name, "halves", dev, 410 + j)
        args = cs.quant_args("K12", ql)
        wbytes = sum(a.numel() * a.element_size() for a in args)
        copies = [tuple(a.clone() for a in args) for _ in range(cs.quant_copies(wbytes))]
        deq = cs.quant_mod.dequantize(ql, torch.bfloat16)
        lib_w = [deq.clone() for _ in range(cs.quant_copies(deq.numel() * 2, 8))]
        del ql, deq
        for M in (1, 8):
            x = torch.randn((M, K), generator=torch.Generator(device=dev).manual_seed(M),
                            device=dev).to(torch.bfloat16)
            ms = cs.graph_ms(cs.k12, [(x, *c) for c in copies], reps)
            lib = cs.graph_ms(torch.matmul, [(x, w) for w in lib_w], 64)
            nbytes = wbytes + M * K * 2 + M * N * 2
            out[f"{name} M={M}"] = {"us": ms * 1e3, "matmul_us": lib * 1e3,
                                    "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6}
        del copies, lib_w
        torch.cuda.empty_cache()
    return out


def k12_sweep(cs, dev):
    """K12 at M = 1 (bf16 x) over LLaMa-2-7B's split-tree widths and its
    head, with each cluster size from 1 to 8 in place of the plan's (the
    plan's own choice beside them)."""
    import torch
    from easykv_tpu_torch.ops.cuda import w4_matmul
    plan = w4_matmul.plan
    out = {}
    for j, name in enumerate(cs.SPLIT_SHAPES + ("head",)):
        K, N = cs.QSHAPES[name]
        args = cs.quant_args("K12", cs.quant_case(name, "halves", dev, 430 + j))
        wbytes = sum(a.numel() * a.element_size() for a in args)
        copies = [tuple(a.clone() for a in args) for _ in range(cs.quant_copies(wbytes))]
        x = torch.randn((1, K), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev).to(torch.bfloat16)
        row = {"plan": plan(1, K // 2, N, 128).cluster}
        for c in range(1, 9):
            w4_matmul.plan = lambda *a, c=c: plan(*a)._replace(cluster=c)
            try:
                row[c] = cs.graph_ms(cs.k12, [(x, *cp) for cp in copies], 128) * 1e3
            except RuntimeError as e:   # more blocks than stages
                row[c] = str(e)
            finally:
                w4_matmul.plan = plan
        out[name] = row
        del copies
        torch.cuda.empty_cache()
    return out


def k15_times(cs, dev, reps):
    import torch
    cfg, tree = cs.step_tree(dev, 32, 0)
    wbytes = cs.step_tree_bytes(tree)
    L, H, S, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cs.S_MAIN, cfg.head_dim
    out = {}
    for B in (cs.B_WIDE, cs.B_MAX):
        for kv in ("bf16", "int8"):
            args, _ = cs.step_case(dev, cfg, B, kv, False, 800)
            pos, q_pos = args[2], args[4]
            visible = int(((pos >= 0) & (pos <= q_pos[None, :, None, None])).sum())
            row = D * (1 if kv == "int8" else 2) + (4 if kv == "int8" else 0)
            nbytes = (wbytes + 2 * visible * row + L * B * H * S * 4 + L * B * H * S * 4
                      + 2 * L * B * H * D * 2 + L * B * H * 4 + B * cfg.hidden_size * 2)
            ms = cs.event_ms(lambda *a: cs.k15(tree.layers, cfg, *a), [args], reps)
            out[f"B={B} {kv} KV"] = {"us": ms * 1e3,
                                     "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6}
            del args
            torch.cuda.empty_cache()
    del tree
    torch.cuda.empty_cache()
    return out


def dump(cs, dev, path):
    """K15's outputs at phase 2's cases (phase_k15's loops, seeds and
    arguments), and K10's and K13's at the 7B products their phase-2
    checks cover (x bf16 and f32), saved to `path`."""
    import torch
    outs = {}
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
                                   ("K13", "int8", cs.FUSED, (1, 4))):
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


def norm_rows(dev):
    """K15's first RMSNorm at tests/test_torch_gpu.py's 7b-B9 draw (bf16,
    q_pos, seed 5), per row: 1 / sqrt(mean(h0^2) + eps) as the plain
    version's `_rms` takes it at B = 9 (torch's mean, rsqrt), in K15's
    order of the sums (step_bars.lanes_rs) and in f64 rounded to f32, with
    each f32 value's distance from the f64 one in f32 ulps; and the share
    of the row's layer-0 kn that the kernel gives bit-equal to the plain
    version with either norm."""
    import torch
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_gpu as tg
    from easykv_tpu_torch.ops.cuda import fused_decode_batch as k15
    from easykv_tpu_torch.ops.cuda.fused_decode import step_plain
    from easykv_tpu_torch.ops.cuda.step_bars import lanes_rs, rms_lanes
    cfg, tree, args, _ = tg._k15_args(dev, "7b-B9", "bf16", False, 5)
    k, v, pos, h0, q_pos = args
    eps = cfg.rms_norm_eps
    x = h0.float()
    rs_torch = torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    rs_lanes = lanes_rs(x, eps)
    x64 = x.double()
    rs64 = 1.0 / torch.sqrt((x64 * x64).mean(dim=-1, keepdim=True) + float(torch.tensor(eps)))
    ulp = (torch.nextafter(rs64.float(), torch.full_like(rs64.float(), float("inf")))
           - rs64.float()).double()
    got = k15.fused_decode_step_batch(tree.layers, cfg, *args)
    plain = k15.fused_decode_step_batch_plain(tree.layers, cfg, *args)
    lanes = step_plain(tree.layers, cfg, k, v, pos, h0, q_pos, None, None, None,
                       lambda a, w: k15._product(a, w, h0.dtype), rms_lanes)
    rows = []
    for b in range(x.shape[0]):
        rows.append({
            "rs_torch": float(rs_torch[b]), "rs_lanes": float(rs_lanes[b]),
            "rs_f64": float(rs64[b]),
            "torch_ulps_from_f64": float((rs_torch[b].double() - rs64[b]) / ulp[b]),
            "lanes_ulps_from_f64": float((rs_lanes[b].double() - rs64[b]) / ulp[b]),
            "kn_share_vs_torch_norm": float((got[1][0, b] == plain[1][0, b]).float().mean()),
            "kn_share_vs_lanes_norm": float((got[1][0, b] == lanes[1][0, b]).float().mean())})
    return rows


def compare(a, b):
    import torch
    da, db = torch.load(a), torch.load(b)
    res = {}
    for key in sorted(da):
        res[key] = [{"identical": bool(torch.equal(x, y)),
                     "max_abs_diff": float((x.float() - y.float()).abs().max())}
                    for x, y in zip(da[key], db[key])]
    res["all_identical"] = all(o["identical"] for k, v in res.items() for o in v)
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--dump")
    ap.add_argument("--only", choices=("k12", "k15"))
    ap.add_argument("--define", help="time the kernels built with -D<DEFINE> (a diagnostic switch)")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--sweep", action="store_true", help="K12 at every cluster size")
    ap.add_argument("--norm", action="store_true", help="K15's first norm at the 7b-B9 draw")
    opt = ap.parse_args()
    if opt.compare:
        print(json.dumps(compare(*opt.compare), indent=1))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    sys.path.insert(0, os.path.abspath(opt.root))
    import chip_smoke as cs
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    res = {"card": smi, "root": os.path.abspath(opt.root), "define": opt.define}
    if opt.define:
        from easykv_tpu_torch.ops.cuda import _build, fused_decode_batch, w4_matmul
        for mod, source in ((w4_matmul, "w4_matmul"), (fused_decode_batch, "fused_decode_batch")):
            _build._libs[source] = _build.load_debug(source, opt.define, mod.SIGNATURES)
    if opt.norm:
        res["k15_norm_rows"] = norm_rows(dev)
        print(json.dumps(res, indent=1))
        return
    if opt.only != "k15":
        res["k12"] = k12_times(cs, dev, 256)
    if opt.only != "k12":
        res["k15"] = k15_times(cs, dev, 20)
    if opt.sweep:
        res["k12_clusters_us"] = k12_sweep(cs, dev)
    if opt.dump:
        res["dumped"] = dump(cs, dev, opt.dump)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
