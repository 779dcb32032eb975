"""K13 (`quant_matmul`) at 1 < M <= 256 and K9 (`fused_kv_compact`) timed
alone on one CUDA card at the shapes of chip_smoke.py's phase 5, beside
their bounds; and their outputs on phase 2's inputs saved for a bit-for-bit
comparison between two builds.

    python3 tools/torch_k13_k9_times.py [--root DIR] [--dump FILE] [--only k13|k9] [--sweep]
    python3 tools/torch_k13_k9_times.py --compare FILE_A FILE_B

K13: bf16 x at M = 4, 16 (batched decode steps), 128 and 256 (ppl blocks)
over the fused tree's four products of LLaMa-2-7B (wqkv, wo, wgu, wd) and
its LM head (f32 out), each a CUDA graph of calls cycling enough weight
copies that L2 is cold, beside torch.matmul of x with a bf16 copy
dequantized beforehand (chip_smoke.quant_times). K9: the rotating shift at
L = 32, H = 32, S = 768, D = 128, B = 1 and 4, bf16 and int8 caches
(chip_smoke.k9_times). Bounds as phase 5 computes them.

--root DIR runs the kernels of the tree at DIR (an unpacked older commit,
for an A/B in one call: run the two trees in turns, each in its own
process) under this checkout's chip_smoke.py, so that both trees meet the
same inputs, yardsticks and bounds. --dump FILE saves K13's outputs at
phase 2's M (chip_smoke.K13_MS; the five widths, x bf16 and f32) and K9's
at phase 2's edges (chip_smoke.k9_edge_cases); --compare reports, per case
and output, whether two dumps are bit-identical and their largest
difference. --sweep also times K13 at M = 4, 16, 128 and 256 under other
stage rows, stages and clusters than its plan's (quant_matmul.matmul_plan)
and K9 at other block sizes and rows a round (kv_compact.shift_plan), the plans' choices beside them; it needs a tree
that has those plans. --define NAME builds quant_matmul.cu with -DNAME and
times that build: K13_MM_NO_MATH (the weight and x stream without the
products), K13_MM_DIRECT (bf16 products added straight into the running
sums, which truncate). Prints one JSON object with the card's name and
power limit.
"""
import argparse
import json
import os
import sys

from torch_k13_k14_times import card_name, compare, open_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K13_WIDTHS = ("wqkv", "wo", "wgu", "wd", "head")
K13_TIMED = (4, 16, 128, 256)
# diagnostic switch prefix: (source, wrapper module, its signatures of that source)
SWITCHES = {"K13_MM_": ("quant_matmul", "quant_matmul", "SIGNATURES")}


def us(ms):
    return None if ms is None else ms * 1e3


def k13_times(cs, dev):
    t = cs.quant_times(dev, [("K13", "int8", K13_WIDTHS, K13_TIMED)])
    return {f"{name} M={M}": {"us": us(r["ms"]), "matmul_us": us(r["library_ms"]),
                              "plain_us": us(r["plain_ms"]), "bound_us": us(r["bound_ms"]),
                              "bound_by": r["bound_by"]}
            for (_, name, M), r in t.items()}


def k9_times(cs, dev):
    out = {}
    for B in (1, 4):
        for (key, kv), r in cs.with_bounds(cs.k9_times(dev, B, plain=False)).items():
            out[f"{key} {kv}"] = {"us": us(r["ms"]), "bound_us": us(r["bound_ms"])}
    return out


def k13_sweep(cs, dev):
    """K13 (bf16 x) at each timed M and width with other stage rows, stages
    and clusters in place of matmul_plan's, where they fit."""
    import torch
    from easykv_tpu_torch.ops.cuda import quant_matmul as qm
    plan = qm.matmul_plan
    out = {}
    for j, name in enumerate(K13_WIDTHS):
        K, N = cs.QSHAPES[name]
        args = cs.quant_args("K13", cs.quant_case(name, "int8", dev, 470 + j))
        wbytes = sum(a.numel() * a.element_size() for a in args)
        copies = [tuple(a.clone() for a in args) for _ in range(cs.quant_copies(wbytes))]
        f32 = name == "head"
        for M in K13_TIMED:
            x = torch.randn((M, K), generator=torch.Generator(device=dev).manual_seed(M),
                            device=dev).to(torch.bfloat16)
            p = plan(M, K, N, False)
            row = {"plan": list(p)}
            for rs in (64, 128):
                for stages in (2, 3, 4, 6):
                    for c in (1, 2, 4, 8):
                        alt = p._replace(rs=rs, stages=stages, cluster=c)
                        if qm.matmul_smem(alt, False) > qm.SMEM_LIMIT or c > -(-K // rs):
                            continue
                        qm.matmul_plan = lambda *a, alt=alt: alt
                        try:
                            row[f"rs{rs} st{stages} c{c}"] = us(cs.graph_ms(
                                lambda *a: cs.k13(*a, out_f32=f32), [(x, *cp) for cp in copies],
                                32))
                        except RuntimeError as e:
                            row[f"rs{rs} st{stages} c{c}"] = str(e)
                        finally:
                            qm.matmul_plan = plan
            out[f"{name} M={M}"] = row
        del copies
        torch.cuda.empty_cache()
    return out


def k9_sweep(cs, dev):
    """K9 (rotate) at B = 1 and 4 with other threads a block and rows a
    round (by the bytes of K and V a round holds) than shift_plan's."""
    from easykv_tpu_torch.ops.cuda import kv_compact as kc
    plan = kc.shift_plan
    out = {}
    for B in (1, 4):
        row = {}
        for threads, tile in ((256, 16384), (256, 32768), (256, 65536), (512, 65536),
                              (128, 65536), (256, 98304)):
            def alt(D, eb, threads=threads, tile=tile):
                p = plan(D, eb)
                return p._replace(threads=threads, rows=tile // (2 * 16 * p.units * p.lanes))
            kc.shift_plan = alt
            try:
                for (key, kv), r in cs.k9_times(dev, B, plain=False).items():
                    row[f"{kv} t{threads} {tile // 1024}KB"] = us(r["ms"])
            finally:
                kc.shift_plan = plan
        out[f"B={B}"] = row
    return out


def dump(cs, dev, path):
    """K13's outputs at phase 2's M over the five widths (x bf16 and f32)
    and K9's at phase 2's edges, saved to `path`."""
    import torch
    outs = {}
    for j, name in enumerate(K13_WIDTHS):
        args = cs.quant_args("K13", cs.quant_case(name, "int8", dev, 480 + j))
        for M in cs.K13_MS:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((M, cs.QSHAPES[name][0]), device=dev,
                                generator=torch.Generator(device=dev).manual_seed(M)).to(dtype)
                outs[f"K13 {name} M={M} {dtype}"] = [cs.k13(x, *args, out_f32=name == "head").cpu()]
        del args
        torch.cuda.empty_cache()
    for label, fn_args in cs.k9_edge_cases(dev, small=True):
        got = cs.k9(*fn_args[0], **fn_args[1])
        outs[f"K9 {label}"] = [t.cpu() for t in got]
    torch.save(outs, path)
    return sorted(outs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--dump")
    ap.add_argument("--only", choices=("k13", "k9"))
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--define", action="append", default=[],
                    help="time K13 built with -D<DEFINE> (a diagnostic switch)")
    ap.add_argument("--sweep", action="store_true",
                    help="K13 over stage rows, stages, clusters; K9 over threads and rows a round")
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
    if opt.only != "k9":
        res["k13"] = k13_times(cs, dev)
    if opt.only != "k13":
        res["k9"] = k9_times(cs, dev)
    if opt.sweep:
        if opt.only != "k9":
            res["k13_sweep_us"] = k13_sweep(cs, dev)
        if opt.only != "k13":
            res["k9_sweep_us"] = k9_sweep(cs, dev)
    if opt.dump:
        res["dumped"] = dump(cs, dev, opt.dump)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
