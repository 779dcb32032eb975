"""How far K15's f32 intermediates lie from its plain version's, stage by
stage, on one CUDA card: the reading that sizes the nudges of K15's
reorder spread (easykv_tpu_torch/ops/cuda/step_bars.py, ULPS).

Builds easykv_tpu_torch/csrc/fused_decode_batch.cu once more with
-DSTEP_DUMP (the kernel then also writes each stage's f32 values of every
layer to a buffer; nothing without the flag) into the gitignored
easykv_tpu_torch/_build/, checks that this build's outputs are bit-equal to
the normal build's, and then, for each layer, gives each plain stage the
kernel's own input of that stage and holds the kernel's output of it
against the plain one:

  * the four product inputs (RMSNorm -> wqkv, attention -> wo, RMSNorm ->
    wgu, SwiGLU -> wd): the f32 ulps between kernel and plain (share at 0,
    1, 2, 3-4 and more; mean; max) and the count of elements whose bf16
    feed value differs ("flips": the A and C rows, then the B rows), beside
    the same for the spread's model of that stage (k15_spread: the
    attention with its slots in a seeded order, k15_permuted_slots; then a
    nudge of binomial(n, 1/2) ulps) for n = 0, 1, 2, 4, 8;
  * the four products (wo and wd as h after them): mean f32 ulps and the
    largest |kernel - plain| over the largest |plain|, beside the same for
    the plain product with its sums in seeded random orders (the spread's
    shuffle).

Cases: chip_smoke.py phase 2's (L=2, S=768; LLaMa-2-7B width at B=4 and 16,
Mistral-7B widths at B=8 with a 512-slot window; bf16 and int8 KV; RoPE at
q_pos and rope_pos; holes and row 1 dead) and a small MHA model (D=256, 4
heads) at B=16. Prints a summary per stage over all cases and layers: the
kernel's and each model's largest mean ulps and their flips added up. A
move of u ulps flips a bf16 feed value with a chance of about u / 2^16, so
a model that matches the kernel's flips (where they are many: the
attention) or its mean ulps (where flips are few: RMSNorm, SwiGLU) moves
the next products as the kernel does. The whole reading goes to
chiprun_out/k15_ulps.json.

    python3 tools/torch_k15_ulps.py
"""
import ctypes
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import B_MAX, B_WIDE, LLAMA2_7B, MISTRAL_7B, step_case, step_tree  # noqa: E402
from easykv_tpu_torch.ops.cuda import _build, step_bars  # noqa: E402
from easykv_tpu_torch.ops.cuda import fused_decode_batch as k15_mod  # noqa: E402
from easykv_tpu_torch.ops.cuda.fused_decode import _rms, step_plain  # noqa: E402

# the kernel's dump stages (fused_decode_batch.cu, DUMP), in layer order
STAGES = ("xq", "qkv", "xo", "h_o", "xg", "gu", "xd", "h_d")
INPUTS = {"wqkv": "xq", "wo": "xo", "wgu": "xg", "wd": "xd"}
NUDGES = (0, 1, 2, 4, 8)
SMALL_MHA = dataclasses.replace(LLAMA2_7B, hidden_size=256, intermediate_size=512,
                                num_attention_heads=4, num_key_value_heads=4)


def load_dump():
    """fused_decode_batch.cu built with -DSTEP_DUMP, with the wrapper's
    signatures and the dump entry declared."""
    dll = _build.load_debug("fused_decode_batch", "STEP_DUMP", k15_mod.SIGNATURES)
    dll.fused_decode_batch_dump.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.fused_decode_batch_dump.restype = ctypes.c_int
    return dll


def ulps(a, b):
    """|a - b| in f32 ulps (int64), element by element."""
    def ordered(t):
        i = t.float().contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def ulp_stats(u):
    n = u.numel()
    share = lambda m: float(m.sum()) / n  # noqa: E731
    return {"n": n, "0": share(u == 0), "1": share(u == 1), "2": share(u == 2),
            "3-4": share((u >= 3) & (u <= 4)), ">4": share(u > 4),
            "mean": float(u.double().mean()), "max": int(u.max())}


def flips(x, y, dt):
    """[elements whose feed value dt(x) differs from dt(y), the same for
    the B rows x_lo - x_hi / 16]."""
    kh = x.shape[1] // 2
    b = lambda t: t[:, :kh] - t[:, kh:] * 0.0625  # noqa: E731
    return [int((x.to(dt) != y.to(dt)).sum()), int((b(x).to(dt) != b(y).to(dt)).sum())]


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def stage_widths(cfg):
    D, F = cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    return {"xq": D, "qkv": (Hq + 2 * Hkv) * Dh, "xo": Hq * Dh, "h_o": D, "xg": D, "gu": 2 * F,
            "xd": F, "h_d": D}


def dump_stages(lib, cfg, tree, args, rope_pos):
    """K15's stages of one call (per layer, a dict of STAGES (B, width)),
    from the -DSTEP_DUMP build, whose outputs must equal the normal
    build's."""
    k, h0 = args[0], args[3]
    L, B = k.shape[0], h0.shape[0]
    widths = stage_widths(cfg)
    width = max(widths.values())

    _build._libs.pop("fused_decode_batch", None)
    normal = k15_mod.fused_decode_step_batch(tree.layers, cfg, *args, rope_pos=rope_pos)
    buf = torch.full((L, len(STAGES), B, width), float("nan"), device=h0.device)
    _build.check(lib.fused_decode_batch_dump(buf.data_ptr(), width), "dump pointer")
    _build._libs["fused_decode_batch"] = lib
    try:
        dumped = k15_mod.fused_decode_step_batch(tree.layers, cfg, *args, rope_pos=rope_pos)
        torch.cuda.synchronize()
    finally:
        _build._libs.pop("fused_decode_batch", None)
    if not all(torch.equal(a, b) for a, b in zip(normal, dumped)):
        sys.exit("the -DSTEP_DUMP build's outputs differ from the normal build's")
    d = [{s: buf[l, i, :, :widths[s]] for i, s in enumerate(STAGES)} for l in range(L)]
    if any(bool(torch.isnan(t).any()) for layer in d for t in layer.values()):
        sys.exit("a stage was not written in full")
    return d


def stage_readings(cfg, tree, args, rope_pos, d):
    """The readings of one case, per layer: each plain stage given the
    kernel's input of it (d: dump_stages) against the kernel's output."""
    k, v, pos, h0, q_pos, *scales = args
    B, D, F, dt = h0.shape[0], cfg.hidden_size, cfg.intermediate_size, h0.dtype
    gen = torch.Generator(device=h0.device).manual_seed(0)
    zeros = lambda n: torch.zeros((B, n), device=h0.device)  # noqa: E731
    out = []
    for l, p in enumerate(tree.layers):
        s = d[l]
        h_in = h0.float() if l == 0 else d[l - 1]["h_d"]
        one = tuple(t[l:l + 1] for t in (k, v, pos)) + (h0, q_pos) + tuple(
            t[l:l + 1] for t in scales)

        def attention(a):
            """The plain attention of this layer from the kernel's QKV sums."""
            seen = []

            def feed_qkv(x, w):
                seen.append(x)
                return [s["qkv"], zeros(D), zeros(2 * F), zeros(D)][len(seen) - 1]
            kk, vv, pp, _, qp, *sc = a
            step_plain(tree.layers[l:l + 1], cfg, kk, vv, pp, h0, qp, *(sc or (None, None)),
                       rope_pos, feed_qkv)
            return seen[1]
        g, up = s["gu"][:, :F], s["gu"][:, F:]
        plain_in = {"xq": _rms(h_in, p.ln_attn, cfg.rms_norm_eps), "xo": attention(one),
                    "xg": _rms(s["h_o"], p.ln_mlp, cfg.rms_norm_eps),
                    "xd": g * torch.sigmoid(g) * up}
        layer = {}
        for prod, st in INPUTS.items():
            xk, xp = s[st], plain_in[st]
            xm = attention(step_bars.k15_permuted_slots(one, gen)[0]) if st == "xo" else xp
            models = {}
            for n in NUDGES:
                x = step_bars.nudge(xm, n, gen)
                models[n] = dict(ulps=ulp_stats(ulps(x, xp)), flips=flips(x, xp, dt))
            layer[st] = dict(ulps=ulp_stats(ulps(xk, xp)), flips=flips(xk, xp, dt),
                             models=models)
        products = {"qkv": ("wqkv", s["xq"], 0, s["qkv"]),
                    "h_o": ("wo", s["xo"], h_in, s["h_o"]),
                    "gu": ("wgu", s["xg"], 0, s["gu"]),
                    "h_d": ("wd", s["xd"], s["h_o"], s["h_d"])}
        for st, (prod, x, base, got) in products.items():
            w = getattr(p, prod)
            ref = base + k15_mod._product(x, w, dt)
            shuf = base + step_bars.k15_shuffled_product(x, w, dt, gen)
            layer[st] = dict(kernel_rel=rel(got, ref), shuffle_rel=rel(shuf, ref),
                             ulps=ulp_stats(ulps(got, ref)),
                             shuffle_ulps=ulp_stats(ulps(shuf, ref)))
        out.append(layer)
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    lib = load_dump()
    res = {"card": smi, "cases": {}}
    for name, base, Bs in (("LLaMa-2-7B", LLAMA2_7B, (B_WIDE, B_MAX)),
                           ("Mistral-7B widths, window 512", MISTRAL_7B, (8,)),
                           ("small MHA", SMALL_MHA, (B_MAX,))):
        cfg, tree = step_tree(dev, 2, 7, base)
        for B in Bs:
            for kv in ("bf16", "int8"):
                for rope in (False, True):
                    args, rope_pos = step_case(dev, cfg, B, kv, rope, 900 + B + 2 * rope,
                                               holes=True, dead_row=True)
                    what = f"{name}, B={B}, {kv} KV, RoPE at {'rope_pos' if rope else 'q_pos'}"
                    d = dump_stages(lib, cfg, tree, args, rope_pos)
                    res["cases"][what] = stage_readings(cfg, tree, args, rope_pos, d)
                    print(f"read {what}", flush=True)
        del tree
        torch.cuda.empty_cache()

    rows_of = lambda st: [layer[st] for case in res["cases"].values()  # noqa: E731
                          for layer in case]

    def side(rows):
        return {"mean ulps, largest": max(r["ulps"]["mean"] for r in rows),
                "share > 4 ulps, largest": max(r["ulps"][">4"] for r in rows),
                "flips (A/C, B), all": [sum(r["flips"][i] for r in rows) for i in (0, 1)]}
    summary = {}
    for st in INPUTS.values():
        rows = rows_of(st)
        summary[st] = {"elements": sum(r["ulps"]["n"] for r in rows),
                       "max ulps": max(r["ulps"]["max"] for r in rows), "kernel": side(rows)}
        for n in NUDGES:
            summary[st][f"model n={n}"] = side([r["models"][n] for r in rows])
    for st in ("qkv", "h_o", "gu", "h_d"):
        rows = rows_of(st)
        summary[st] = {"kernel mean ulps, mean": sum(r["ulps"]["mean"] for r in rows) / len(rows),
                       "shuffle mean ulps, mean": sum(r["shuffle_ulps"]["mean"] for r in rows)
                       / len(rows),
                       "kernel rel, largest": max(r["kernel_rel"] for r in rows),
                       "shuffle rel, largest": max(r["shuffle_rel"] for r in rows)}
    res["summary"] = summary
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    (ROOT / "chiprun_out" / "k15_ulps.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({"card": smi, "summary": summary, "ULPS": step_bars.ULPS}, indent=1))


if __name__ == "__main__":
    main()
