"""K1 (`fused_decode_attend_inflight`: plain, `ordered`, `rank`),
`fused_decode_attend` and K10 (`w4a16_gemv_arith` at M = 1) timed alone on
one CUDA card at the shapes of chip_smoke.py's phase 5, beside their
yardsticks; K1 also at B = 4 and 16 and at phase 2's split edges; and
their outputs on phase 2's inputs saved for a bit-for-bit comparison
between two builds.

    python3 tools/torch_k1_k10_times.py [--root DIR] [--dump FILE] [--only k1|k10]
                                        [--define NAME ...] [--sweep] [--stamps]
    python3 tools/torch_k1_k10_times.py --compare FILE_A FILE_B

K1: phase 5's inputs and bounds (chip_smoke.k1_time_cases: one layer a
launch, 32 layers' K / V cycled so that L2 is cold; the decode at S = 768,
bf16 and int8 KV, the `ordered` variant over the int8 rotate-at-read cache,
the `rank` variant and fused_decode_attend at S = 2304), each beside its
phase 5 yardstick (chip_smoke.k1_library_ms: scaled_dot_product_attention
over the same cache, the attention half alone); the plain variant at
S = 768 also at B = 4 and 16 (8 and 2 layers cycled), with the cluster the
split plan picks. K1 edges: every K1 variant and fused_decode_attend at
each of phase 2's split edges (chip_smoke.K1_EDGES), out's share of K1's
limit against the plain version and against the f64 value
(chip_smoke.k1_exact), the plain version's own share against the f64
value, and the largest probability error. K10: bf16 x over the split
tree's three widths (wq = wk = wv = wo, wg = wu, wd), enough weight copies
cycled that L2 is cold, beside torch.matmul of x with a bf16 copy
dequantized beforehand.

--root DIR runs the kernels of the tree at DIR (an unpacked older commit,
for an A/B in one call: run the two trees in turns, each in its own
process) under this checkout's chip_smoke.py, so that both trees meet the
same inputs, yardsticks and bounds. --dump FILE saves K1's outputs (every
variant, phase 2's 7B cases) and K10's (the split widths, x bf16 and f32);
--compare reports, per case and output, whether two dumps are
bit-identical and their largest difference. --define NAME builds the
source the switch belongs to with -DNAME and times that build:
K1_NO_TABLES (decode_attention.cu: the rank variant without its table
gather), K10_NO_MATH (quant_gemv.cu: K10's carrier stream without the
arithmetic), K10_LO_ONLY (K10 without its hi plane's arithmetic). --sweep
also times K1 at each cluster size (and ring depth) and K10 at each stage
rows, stages and cluster (the plans' choices beside them). --stamps
instead builds K1 with -DK1_STAMPS and prints, for one launch of each
case, when four blocks passed each step and each tile's barrier. Prints
one JSON object with the card's name and power limit.
"""
import argparse
import json
import os
import sys

from torch_k13_k14_times import card_name, compare, open_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# diagnostic switch prefix: (source, wrapper module, its signatures of that source)
SWITCHES = {"K1_": ("decode_attention", "decode_attention", "SIGNATURES"),
            "K10_": ("quant_gemv", "quant_matmul", "GEMV_SIGNATURES")}
K10_WIDTHS = ("wq", "wg", "wd")
# the rotation K1's split plan is asked for, per phase 5 key
ROT = {"K1": 0, "K1 ordered": 1, "K1 rank": 2, "decode_attend": 0}


def k1_times(cs, dev, keys=None, B=1, reps=320):
    """Phase 5's K1 rows (chip_smoke.k1_time_cases) on this tree's kernels,
    each beside phase 5's SDPA yardstick and bound; at B > 1 also the
    cluster the split plan picks (this tree's plan, where it has one)."""
    out = {}
    plan = getattr(cs.da_mod, "split_plan", None)
    for key, kv, sets, run, lib, nbytes, flops, _ in cs.k1_time_cases(dev, keys or cs.K1_TIMED, B):
        fn = cs.kda if key == "decode_attend" else cs.k1
        row = {"us": cs.graph_ms(run(fn), sets, reps) * 1e3,
               "sdpa_us": cs.k1_library_ms(lib, kv == "int8", reps) * 1e3,
               "bound_us": max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.F32_FLOPS) * 1e6}
        if B > 1 and plan is not None:
            row["cluster"] = plan(B, 32, 1, cs.S_MAIN, 128, kv, 0).cluster
        out[f"{key} {kv}"] = row
    return out


def k1_edges(cs, dev):
    """Every K1 variant and fused_decode_attend at phase 2's split edges
    (chip_smoke.k1_edge_results) on this tree's kernels: out's share of
    K1's limit against the plain version and against the f64 value, the
    plain version's share against the f64 value, and the largest error of
    probs and p_new against the plain version."""
    import torch
    out = {}
    for case, (_, _, _, S, window, _, _) in cs.K1_EDGES.items():
        for kind in ("bf16", "int8") + (("f32",) if S == 777 or window else ()):
            try:
                res = cs.k1_edge_results(case, kind, dev)
            except (RuntimeError, ValueError) as e:     # a shape this tree's kernel refuses
                out[f"{case} {kind}"] = str(e)
                continue
            torch.cuda.synchronize()
            out[f"{case} {kind}"] = {
                key: {"to_plain": cs.k1_out_share(got[0], ref[0]),
                      "to_f64": cs.k1_out_share(got[0], exact),
                      "plain_to_f64": cs.k1_out_share(ref[0], exact),
                      "probs_err": max((a.float() - b.float()).abs().max().item()
                                       for a, b in zip(got[1:], ref[1:]))}
                for key, got, ref, exact in res}
    return out


def k1_sweep(cs, dev):
    """K1 at each cluster size and ring depth (the plan's choice beside
    them), bf16 and int8, at phase 5's shapes, and the plain variant at
    B = 4 and 16."""
    from easykv_tpu_torch.ops.cuda import decode_attention as da
    plan = da.split_plan
    out = {}
    cases = ((c, B) for B, keys in ((1, None), (4, ("K1",)), (16, ("K1",)))
             for c in cs.k1_time_cases(dev, keys or cs.K1_TIMED, B))
    for (key, kv, sets, run, _, _, _, _), B in cases:
        fn = cs.kda if key == "decode_attend" else cs.k1
        q, k = sets[0][0], sets[0][3]
        _, Hkv, S, D = k.shape
        rot = ROT[key]
        row = {"plan": list(plan(B, Hkv, q.shape[1] // Hkv, S, D, kv, rot))}
        for c in (1, 2, 4, 8):
            for depth in (2, 4, 0):
                def forced(B, Hkv, rep, S, D, kv, rot=0, c=c, depth=depth):
                    tpb = -(-(-(-S // da.TILE)) // c)
                    n = tpb if depth == 0 else min(depth, tpb)
                    limit = da._build.SMEM_LIMIT
                    while n > 1 and da.split_smem(rep, S, D, kv, rot, c, n, n) > limit:
                        n -= 1
                    return da.SplitPlan(c, n, n, da.split_smem(rep, S, D, kv, rot, c, n, n))
                da.split_plan = forced
                try:
                    row[f"c{c} ring{depth or 'all'}"] = cs.graph_ms(run(fn), sets, 128) * 1e3
                except RuntimeError as e:
                    row[f"c{c} ring{depth or 'all'}"] = str(e)
                finally:
                    da.split_plan = plan
        out[f"{key} {kv}" + (f" B={B}" if B > 1 else "")] = row
    return out


def k1_stamps(cs, dev):
    """One launch of each K1 case built with -DK1_STAMPS: µs from block 0's
    start at which thread 0 of blocks 0, 1 and the grid's last two passed
    each step (0 start, 1 copies issued, 2 q / pos in, 3 its logits done, 4
    every logit, 5 the cluster max, 6 the cluster sums, 7 the
    probabilities, 8 its P V, 9 the cluster's partials, 10 out, 11 the
    last barrier) and each K (k0..) and V (v0..) tile's barrier."""
    import ctypes
    import numpy as np
    import torch
    from easykv_tpu_torch.ops.cuda import _build, decode_attention as da
    lib = _build.load_debug("decode_attention", ["K1_STAMPS"], da.SIGNATURES)
    lib.decode_attend_stamps.argtypes = [ctypes.c_void_p]
    lib.decode_attend_stamps.restype = ctypes.c_int
    _build._libs["decode_attention"] = lib
    buf = np.zeros((4, 64), dtype=np.uint64)
    out = {}
    for key, kv, sets, run, _, _, _, _ in cs.k1_time_cases(dev):
        fn = run(cs.kda if key == "decode_attend" else cs.k1)
        name = f"{key} {kv}"
        for a in sets:
            fn(*a)
        torch.cuda.synchronize()
        _build.check(lib.decode_attend_stamps(buf.ctypes.data), "stamps")
        fn(*sets[0])
        torch.cuda.synchronize()
        _build.check(lib.decode_attend_stamps(buf.ctypes.data), "stamps")
        t0 = int(buf[0][0])
        label = lambda i: str(i) if i < 16 else (f"k{i - 16}" if i < 48 else f"v{i - 48}")  # noqa
        out[name] = [{label(i): round((int(buf[b][i]) - t0) / 1e3, 3) for i in range(64)
                      if buf[b][i]} for b in range(4)]
    return out


def k10_times(cs, dev, reps=256):
    import torch
    out = {}
    for j, name in enumerate(K10_WIDTHS):
        K, N = cs.QSHAPES[name]
        ql = cs.quant_case(name, "arith", dev, 400 + j)
        args = cs.quant_args("K10", ql)
        wbytes = sum(a.numel() * a.element_size() for a in args)
        copies = [tuple(a.clone() for a in args) for _ in range(cs.quant_copies(wbytes))]
        deq = cs.quant_mod.dequantize(ql, torch.bfloat16)
        lib_w = [deq.clone() for _ in range(cs.quant_copies(deq.numel() * 2, 8))]
        del ql, deq
        x = torch.randn((1, K), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev).to(torch.bfloat16)
        out[name] = {"us": cs.graph_ms(cs.k10, [(x, *c) for c in copies], reps) * 1e3,
                     "matmul_us": cs.graph_ms(torch.matmul, [(x, w) for w in lib_w], 64) * 1e3,
                     "bound_us": (wbytes + K * 2 + N * 2) / cs.HBM_BYTES_PER_S * 1e6}
        del copies, lib_w
        torch.cuda.empty_cache()
    return out


def k10_sweep(cs, dev):
    """K10 (bf16 x) over the split widths with each (stage rows, stages,
    cluster) in place of the plan's; the plan's own choice beside them."""
    import torch
    from easykv_tpu_torch.ops.cuda import w4_stream
    plan = w4_stream.gemv_plan
    out = {}
    for j, name in enumerate(K10_WIDTHS):
        K, N = cs.QSHAPES[name]
        args = cs.quant_args("K10", cs.quant_case(name, "arith", dev, 460 + j))
        wbytes = sum(a.numel() * a.element_size() for a in args)
        copies = [tuple(a.clone() for a in args) for _ in range(cs.quant_copies(wbytes))]
        x = torch.randn((1, K), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev).to(torch.bfloat16)
        row = {"plan": list(plan(K // 2, N, 128))}
        for c in (2, 4, 8):
            for rs, st in ((64, 4), (128, 2), (128, 3)):
                key = f"c{c} rs{rs} st{st}"
                w4_stream.gemv_plan = lambda *a, c=c, rs=rs, st=st: plan(*a)._replace(
                    cluster=c, rs=rs, stages=st)
                try:
                    row[key] = cs.graph_ms(cs.k10, [(x, *cp) for cp in copies], 128) * 1e3
                except RuntimeError as e:   # more blocks than stages, or too much memory
                    row[key] = str(e)
                finally:
                    w4_stream.gemv_plan = plan
        out[name] = row
        del copies
        torch.cuda.empty_cache()
    return out


def dump(cs, dev, path):
    """K1's outputs, every variant (plain, ordered, rank, decode_attend), at
    phase 2's 7B cases (chip_smoke.k1_case / rank_case), and K10's at the
    split widths (x bf16 and f32), saved to `path`."""
    import torch
    outs = {}
    for i, (name, B, Hkv, quant) in enumerate((("bf16 MHA B=1", 1, 32, False),
                                               ("bf16 GQA B=2", 2, 8, False),
                                               ("int8 MHA B=1", 1, 32, True),
                                               ("int8 GQA B=2", 2, 8, True))):
        qp = [cs.PROMPT + cs.NEW - 1] + [700] * (B - 1)
        args = cs.k1_case(B, 32, Hkv, cs.S_MAIN, 128, torch.bfloat16, qp, dev, 10 + i, quant)
        rot = cs.rotation_tables(cs.S_MAIN, cs.LLAMA2_7B, dev)
        outs[f"K1 {name}"] = [t.cpu() for t in cs.k1(*args)]
        outs[f"K1 ordered {name}"] = [t.cpu() for t in cs.k1(*args, rot=rot)]
        rargs, rrot, ranks = cs.rank_case(B, 32, Hkv, torch.bfloat16, quant, dev, 200 + i)
        outs[f"K1 rank {name}"] = [t.cpu() for t in cs.k1(*rargs, rot=rrot, rank=ranks)]
        outs[f"K1 decode_attend {name}"] = [t.cpu() for t in cs.kda(rargs[0], *rargs[3:])]
    for j, name in enumerate(K10_WIDTHS):
        args = cs.quant_args("K10", cs.quant_case(name, "arith", dev, 450 + j))
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((1, cs.QSHAPES[name][0]), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(1)).to(dtype)
            outs[f"K10 {name} {dtype}"] = [cs.k10(x, *args).cpu()]
    torch.save(outs, path)
    return sorted(outs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--dump")
    ap.add_argument("--only", choices=("k1", "k10"))
    ap.add_argument("--define", action="append", default=[],
                    help="time the kernels built with -D<DEFINE> (a diagnostic switch)")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--sweep", action="store_true",
                    help="K1 over clusters and ring depths, K10 over stage rows, stages, clusters")
    ap.add_argument("--stamps", action="store_true",
                    help="K1's steps inside one launch (a -DK1_STAMPS build), instead of times")
    opt = ap.parse_args()
    if opt.compare:
        print(json.dumps(compare(*opt.compare), indent=1))
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    cs = open_tree(opt.root, opt.define, SWITCHES, smoke=ROOT)
    dev = torch.device("cuda")
    res = {"card": card_name(), "root": os.path.abspath(opt.root), "define": opt.define}
    if opt.stamps:
        res["k1_stamps_us"] = k1_stamps(cs, dev)
        print(json.dumps(res, indent=1))
        return
    if opt.only != "k10":
        res["k1"] = k1_times(cs, dev)
        res["k1_batch"] = {f"B={B}": k1_times(cs, dev, ("K1",), B) for B in (4, 16)}
        res["k1_edges"] = k1_edges(cs, dev)
    if opt.only != "k1":
        res["k10"] = k10_times(cs, dev)
    if opt.sweep:
        if opt.only != "k10":
            res["k1_sweep_us"] = k1_sweep(cs, dev)
        if opt.only != "k1":
            res["k10_sweep_us"] = k10_sweep(cs, dev)
    if opt.dump:
        res["dumped"] = dump(cs, dev, opt.dump)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
