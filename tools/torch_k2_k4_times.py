"""K2 (`fused_write_update`, every variant) and K4 (`fused_evict`) timed
alone on one CUDA card, at the shapes the decode paths give them, beside
their bounds; where a launch's time goes, by phase; and their outputs on
phase 2's edge inputs saved for a bit-for-bit comparison between two builds.

    python3 tools/torch_k2_k4_times.py [--root DIR] [--dump FILE] [--define NAME ...]
                                       [--stamps] [--sweep]
    python3 tools/torch_k2_k4_times.py --compare FILE_A FILE_B

Times: each a CUDA graph of calls cycling four copies of the inputs, so
that L2 is cold (chip_smoke.graph_ms), at L = H = 32 and chip_smoke's
K2_SHAPES: B = 1, 4 and 16 at S = 768 (every decode path; K15's batches)
and B = 1 at S = 2304 (the encoding family's decode). K2 in its four
variants (chip_smoke.K2_VARIANTS: no scale rows, the int8 cache's scale
rows, `compact` without and with them), roco with the eviction gate on;
at B = 1, S = 768 also h2o_head, recency and random. K4 with roco, the gate
on and off. Bounds as phase 5 computes them (chip_smoke.k2_time_sets,
k4_time_sets): the bytes over 3.35 TB/s. Where K2 takes the step's K / V
rows (the row write K3 inside its launch), also K2 given the rows against
K2 alone at every K2_SHAPES shape, bf16 and int8 (with the scale rows), in
turns (alone, rows, rows, alone), their difference (K3's time inside K2's
launch) and the stand-alone K3 at the same shape.

--root DIR runs the kernels of the tree at DIR (an unpacked older commit,
for an A/B in one call: run the two trees in turns, each in its own
process) under this checkout's chip_smoke.py, so that both trees meet the
same inputs and bounds. --define NAME builds sidecar_update.cu with -DNAME
and times that build: K2_NO_SELECT (the eviction event left out: K2's
load, update and store alone, K4's counter pass alone). --stamps instead
builds it with -DK2_STAMPS and prints, for one launch of each case, when
thread 0 of blocks 0, 1 and the grid's last two passed each phase (0 start,
1 row loaded and updated, 2 write slot chosen, 3 counters bumped, 4 the
selection's keys, 5 the k-th smallest, 6 the victim, 7 the shift, 8 end),
and the grid's span from its first block's start to its last one's end.
--sweep also times K2 and K4 at B = 1, S = 768 with 1, 2, 4 and 8 rows a
block in place of row_plan's 4 (this tree's plan, where it has one). --dump FILE saves K2's and K4's outputs on phase 2's edge inputs
(chip_smoke.k2_edge_results) and phase 2's main-path cases; --compare
reports, per case and output, whether two dumps are bit-identical. Prints
one JSON object with the card's name and power limit.
"""
import argparse
import json
import os
import sys

from torch_k13_k14_times import card_name, compare, open_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# diagnostic switch prefix: (source, wrapper module, its signatures of that source)
SWITCHES = {"K2_": ("sidecar_update", "sidecar_update", "SIGNATURES")}
STAMP_PHASES = ("start", "loaded", "slot", "bumped", "keys", "kth", "victim", "shift", "end",
                "kth: packable", "kth: packed", "kth: one a thread", "kth: packed again")


def k2_cases(cs):
    """(label, B, S, variant, policy) of every K2 timing."""
    cases = [(f"{variant} {shape}", *cs.K2_SHAPES[shape], variant, "roco")
             for shape in cs.K2_SHAPES for variant in cs.K2_VARIANTS]
    return cases + [(f"bf16 B=1 {p}", 1, cs.S_MAIN, "bf16", p)
                    for p in ("h2o_head", "recency", "random")]


def k4_cases(cs):
    """(label, B, S, gate) of every K4 timing."""
    return [(f"{'on' if gate else 'off'} {shape}", *cs.K2_SHAPES[shape], gate)
            for shape in cs.K2_SHAPES for gate in (True, False)]


def bound_us(cs, nbytes, flops):
    return max(nbytes / cs.HBM_BYTES_PER_S, flops / cs.F32_FLOPS) * 1e6


def times(cs, dev, reps=64):
    import torch
    out = {}
    for i, (label, B, S, variant, policy) in enumerate(k2_cases(cs)):
        copies, run, nbytes, flops = cs.k2_time_sets(dev, B, S, variant, policy, seed=300 + 4 * i)
        out[f"K2 {label}"] = {"us": cs.graph_ms(run(cs.k2), copies, reps) * 1e3,
                              "bound_us": bound_us(cs, nbytes, flops)}
        del copies
        torch.cuda.empty_cache()
    for i, (label, B, S, gate) in enumerate(k4_cases(cs)):
        copies, nbytes, flops = cs.k4_time_sets(dev, B, S, gate, seed=400 + 4 * i)
        out[f"K4 {label}"] = {"us": cs.graph_ms(cs.k4, copies, reps) * 1e3,
                              "bound_us": bound_us(cs, nbytes, flops)}
        del copies
        torch.cuda.empty_cache()
    return out


def rows_times(cs, dev, reps=64):
    """K2 (roco, the gate on) given the step's K / V rows against K2 alone
    at K2_SHAPES, bf16 and int8: µs of each (two readings each, in turns),
    the difference, and the stand-alone K3 at the same shape."""
    import torch
    out = {}
    for i, (shape, (B, S)) in enumerate(cs.K2_SHAPES.items()):
        for variant, dtype in (("bf16", torch.bfloat16), ("int8", torch.int8)):
            sets = [cs.k2_time_sets(dev, B, S, variant, seed=700 + 4 * i, rows=rows)
                    for rows in (False, True)]
            t = [cs.graph_ms(sets[r][1](cs.k2), sets[r][0], reps) * 1e3 for r in (0, 1, 1, 0)]
            del sets
            k, v, kn, vn, slots = cs.k3_case(32, B, 32, S, 128, dev, 60, dtype)
            alone, rows = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            out[f"{variant} {shape}"] = {
                "k2_us": t[::3], "k2_rows_us": t[1:3], "k3_in_k2_us": rows - alone,
                "k3_alone_us": cs.graph_ms(cs.k3, [(k, v, kn, vn, slots)], 200) * 1e3}
            del k, v, kn, vn
            torch.cuda.empty_cache()
    return out


def sweep(cs, dev):
    """K2 (bf16 and compact int8, roco) and K4 (roco, gate on) at B = 1,
    S = 768 with r rows a block (a warp a row, 6 chunks a lane); row_plan's
    own choice beside them."""
    from easykv_tpu_torch.ops.cuda import sidecar_update as su
    plan = getattr(su, "row_plan", None)
    if plan is None:
        return "this tree has no row_plan"
    S = cs.S_MAIN
    out = {f"plan S={S}": list(plan(S))}
    k2s = {v: cs.k2_time_sets(dev, 1, S, v, seed=500) for v in ("bf16", "compact int8")}
    k4s = cs.k4_time_sets(dev, 1, S, seed=510)[0]
    for rows in (1, 2, 4, 8):
        su.row_plan = lambda S, r=rows: su.RowPlan(1, 6, r, 32 * r, 0)
        try:
            for v, (copies, run, _, _) in k2s.items():
                out[f"K2 {v} S={S} r{rows}"] = cs.graph_ms(run(cs.k2), copies, 64) * 1e3
            out[f"K4 S={S} r{rows}"] = cs.graph_ms(cs.k4, k4s, 64) * 1e3
        finally:
            su.row_plan = plan
    return out


def stamps(cs, dev, defines=()):
    """One launch of each K2 (roco, gate on; every variant and shape) and
    K4 (gate on and off) case built with -DK2_STAMPS (and `defines`): µs
    from block 0's start at which thread 0 of blocks 0, 1 and the grid's
    last two passed each phase (STAMP_PHASES), and the grid's span from its first block's
    start to its last block's end."""
    import ctypes
    import numpy as np
    import torch
    from easykv_tpu_torch.ops.cuda import _build, sidecar_update as su
    lib = _build.load_debug("sidecar_update", ["K2_STAMPS", *defines], su.SIGNATURES)
    lib.sidecar_stamps.argtypes = [ctypes.c_void_p]
    lib.sidecar_stamps.restype = ctypes.c_int
    _build._libs["sidecar_update"] = lib
    buf = np.zeros((4, 16), dtype=np.uint64)

    def read(fn, arg_sets):
        for a in arg_sets:
            fn(*a)
        torch.cuda.synchronize()
        _build.check(lib.sidecar_stamps(buf.ctypes.data), "stamps")
        fn(*arg_sets[0])
        torch.cuda.synchronize()
        _build.check(lib.sidecar_stamps(buf.ctypes.data), "stamps")
        t0, first, last = int(buf[0][0]), ~int(buf[1][15]) & (2**64 - 1), int(buf[0][15])
        blocks = [{name: round((int(buf[b][i]) - t0) / 1e3, 3)
                   for i, name in enumerate(STAMP_PHASES) if buf[b][i]} for b in range(4)]
        return {"blocks": blocks, "grid_us": round((last - first) / 1e3, 3),
                "block0_after_us": round((t0 - first) / 1e3, 3)}
    out = {}
    for label, B, S, variant, policy in k2_cases(cs):
        copies, run, _, _ = cs.k2_time_sets(dev, B, S, variant, policy, seed=600, n=1)
        out[f"K2 {label}"] = read(run(cs.k2), copies)
    for label, B, S, gate in k4_cases(cs):
        copies = cs.k4_time_sets(dev, B, S, gate, seed=610, n=1)[0]
        out[f"K4 {label}"] = read(cs.k4, copies)
    return out


def dump(cs, dev, path):
    """K2's and K4's outputs on phase 2's edge inputs (every case of
    chip_smoke.k2_edge_results at each of K2_EDGES) and K2's at phase 2's
    main-path shape (L = H = 32, B = 1, S = 768; chip_smoke.k2_case), saved
    to `path`."""
    import torch
    outs = {}
    for i, (case, shape) in enumerate(cs.K2_EDGES.items()):
        for label, got, _ in cs.k2_edge_results(*shape, dev, 600 + i):
            outs[f"{label.split(' ')[0]} {case} {label}"] = [t.cpu() for t in got]
    state, per_b, ev, scales = cs.k2_case(32, 1, 32, cs.S_MAIN, dev, 20)
    for policy in cs.POLICIES:
        for gate_on in ([False] if policy is None else [True, False]):
            for sc in (None, scales):
                got = cs.k2_call(cs.k2, state, per_b, ev, policy, gate_on, sc)
                outs[f"K2 main {policy} gate={gate_on} scales={sc is not None}"] = [
                    t.cpu() for t in got]
    torch.save(outs, path)
    return len(outs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--dump")
    ap.add_argument("--define", action="append", default=[],
                    help="time the kernels built with -D<DEFINE> (a diagnostic switch)")
    ap.add_argument("--compare", nargs=2)
    ap.add_argument("--sweep", action="store_true", help="K2 and K4 under forced launch plans")
    ap.add_argument("--stamps", action="store_true",
                    help="the phases inside one launch (a -DK2_STAMPS build), instead of times")
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
        res["stamps_us"] = stamps(cs, dev, opt.define)
        print(json.dumps(res, indent=1))
        return
    res["us"] = times(cs, dev)
    if hasattr(cs.k2, "rows_launches"):
        res["rows_us"] = rows_times(cs, dev)
    if opt.sweep:
        res["sweep_us"] = sweep(cs, dev)
    if opt.dump:
        res["dumped"] = dump(cs, dev, opt.dump)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
