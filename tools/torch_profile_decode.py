#!/usr/bin/env python3
"""Where a decode step of the PyTorch port spends its time, on one CUDA card.

Builds LLaMa-2-7B-width weights on the card from a seed (bf16), prefills a
512-token prompt, and decodes with roco at budget 200 (the chip_smoke.py
main path, whose model, prompt length and budget it imports) for budget +
STEPS_PAST_BUDGET tokens, once untraced and once under torch.profiler,
with a bf16 KV cache and then with an int8 one; with --streaming, the
StreamingLLM decode instead (streaming=True): bf16 and int8 over the
pre-rotated cache, then int8 over the rotate-at-read cache; with --quant,
the same decode over quantized weights made on the card from the bf16 ones
(int4 arithmetic fused with an int8 KV cache, decoded by the one-kernel
step K14, then at B=4 by its batched twin K15; int4 arithmetic split with
an int8 KV cache, int8 fused with an int8 KV cache, int4 halves split with
a bf16 one). Prints, for each, the
host-clock time per step of both runs, the
device time per step (sum of kernel durations), the device's idle share
while traced, the kernels that take most device time, and the PyTorch ops
that take most host time (self CPU time under the tracer, which inflates
it, with calls per step).

    python3 tools/torch_profile_decode.py [--streaming | --quant] [--only TEXT]

--only TEXT keeps the runs whose name holds TEXT (e.g. --quant --only split:
the int4 arithmetic split tree alone).
"""
import importlib
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import B_WIDE, BUDGET, LLAMA2_7B, PROMPT  # noqa: E402
from easykv_tpu_torch import flags  # noqa: E402
from easykv_tpu_torch.models.llama import init_params  # noqa: E402
from easykv_tpu_torch.ops import quant  # noqa: E402

gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
STEPS_PAST_BUDGET = 16     # decode steps that run the eviction


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = LLAMA2_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    P, budget = PROMPT, BUDGET
    ids = torch.randint(1, cfg.vocab_size, (B_WIDE, P),
                        generator=torch.Generator().manual_seed(0), dtype=torch.int32).to(dev)

    streaming = "--streaming" in sys.argv[1:]

    def prefilled(n_new, kv_quant, params, B):
        st = gen_mod.EngineStatics(cfg=cfg, policy="roco", length=P, budget=budget,
                                   max_new_tokens=n_new, recent_window_dec=int(budget * 0.3),
                                   kv_quant=kv_quant, streaming=streaming)
        cache = gen_mod._engine_cache(st, B, P + budget + 1, torch.bfloat16, dev)
        plen = torch.full((B,), P, dtype=torch.int32, device=dev)
        last = gen_mod._prefill(st, params, cache, ids[:B], plen)
        torch.cuda.synchronize()
        return st, cache, last, params, plen

    def decode(st, cache, last, params, plen):
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        gen_mod._decode_loop(st, params, cache, last, plen, plen, plen, st.decode_spec(),
                             gen, 1e-9, 1.0, "budget")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    res = {"card": smi, "layers": cfg.num_hidden_layers}
    # eviction runs in every step from budget + 1 on; the traced decode
    # covers budget + steps tokens, the untraced one the same
    n_steps = budget + STEPS_PAST_BUDGET
    res["decode_steps"] = n_steps
    def bf16():
        return params
    def fused():
        return quant.fuse_gemv_params(quant.quantize_params_int4(params, layout="arith"))
    if streaming:
        runs = [("bf16 KV streaming pre-rotated", False, True, bf16, 1),
                ("int8 KV streaming pre-rotated", True, True, bf16, 1),
                ("int8 KV streaming rotate-at-read", True, False, bf16, 1)]
    elif "--quant" in sys.argv[1:]:
        runs = [("int4 arith fused weights (K14), int8 KV", True, None, fused, 1),
                ("int4 arith fused weights (K15), int8 KV, B=4", True, None, fused, B_WIDE),
                ("int4 arith split weights, int8 KV", True, None,
                 lambda: quant.quantize_params_int4(params, layout="arith"), 1),
                ("int8 fused weights, int8 KV", True, None,
                 lambda: quant.fuse_gemv_params(quant.quantize_params(params)), 1),
                ("int4 halves split weights, bf16 KV", False, None,
                 lambda: quant.quantize_params_int4(params), 1)]
    else:
        runs = [("bf16 KV", False, None, bf16, 1), ("int8 KV", True, None, bf16, 1)]
    if "--only" in sys.argv[1:]:
        text = sys.argv[sys.argv.index("--only") + 1]
        runs = [r for r in runs if text in r[0]]
    for name, kv_quant, prerot, weights, B in runs:
        flags.use_prerot(prerot)
        w = weights()
        decode(*prefilled(8, kv_quant, w, B))          # build + warm-up
        base_s = decode(*prefilled(n_steps, kv_quant, w, B))
        state = prefilled(n_steps, kv_quant, w, B)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dec_s = decode(*state)
        kernels = {}
        busy_us = 0.0
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t = e.time_range.elapsed_us()
                busy_us += t
                kernels[e.name] = kernels.get(e.name, 0.0) + t
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
        host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), key=lambda r: -r[1])[:12]
        flags.use_prerot(None)
        res[name] = {
            "untraced_ms_per_step": base_s / n_steps * 1e3,
            "traced_ms_per_step": dec_s / n_steps * 1e3,
            "device_busy_ms_per_step": busy_us / 1e3 / n_steps,
            "device_idle_share_traced": 1 - (busy_us / 1e6) / dec_s,
            "top_kernels_device_ms_per_step": {k: v / 1e3 / n_steps for k, v in top},
            "top_host_ops_traced_ms_and_calls_per_step": {
                k: [t / 1e3 / n_steps, c / n_steps] for k, t, c in host},
        }
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
