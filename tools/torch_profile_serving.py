#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port spends its time, on one CUDA card.

Runs chip_smoke.py's serving workloads through ScheduledBatchEngine at
LLaMa-2-7B width (weights drawn on the card from a seed): (a)
benchmarks/bench_serving.py's configuration (the int4 arithmetic fused tree
quantized on the card, int8 KV, 8 slots, 16 requests of 128-512 tokens, 128
new, roco b=200, T=1.0, top_p 0.95) and (b) bf16 weights and KV, 4 slots, 8
requests, 128 new, greedy, roco b=64. Each runs twice: with the decode tick
replayed as a CUDA graph (the engine's default on the card) and eagerly
(flags.eager_decode_loop); the merged (prefill) tick is eager either way.
Each of those runs once untraced and once under torch.profiler.

Every tick ends in a (B,) readback, so the kernels of one tick run inside
that tick's host-clock window: each device event is given to the tick
whose window holds its start. Prints, per run and tick kind (merged; decode
eager, capture, replay): the ticks, untraced host ms a tick (median),
traced host ms, device busy ms (sum of kernel, copy and set durations)
and operations (device events) a tick, the device's idle share over those
ticks (1 - busy / traced host) and against the untraced median (1 - busy
/ untraced; the tracer slows the host), and the kernels that take most
device time.

    python3 tools/torch_profile_serving.py [--only a|b]
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (BUDGET, CHUNK, LLAMA2_7B, SERVE_MAX_PROMPT, SERVE_NEW,  # noqa: E402
                        SERVE_REQS, SERVE_SLOTS, SMALL_BUDGET, SMALL_REQS, SMALL_SLOTS,
                        serving_prompts)
import easykv_tpu_torch  # noqa: E402
from easykv_tpu_torch import flags  # noqa: E402
from easykv_tpu_torch.models.llama import init_params  # noqa: E402
from easykv_tpu_torch.ops import quant  # noqa: E402
from easykv_tpu_torch.serving import Request, ScheduledBatchEngine  # noqa: E402
from easykv_tpu_torch.serving import scheduled as sched_mod  # noqa: E402


def drive(eng, prompts, new, traced):
    """Runs the requests a tick at a time. Returns [(kind, host s)], and
    with `traced` each tick inside a record_function range named "tick"."""
    for i, p in enumerate(prompts):
        eng.submit(Request(request_id=i, ids=p, max_new_tokens=new))
    tick = eng.decode_tick
    merged = [0]
    real = sched_mod._merged_step

    def counted(*a, **kw):
        merged[0] += 1
        return real(*a, **kw)
    out = []
    sched_mod._merged_step = counted
    try:
        while eng.requests or eng.sched.num_waiting:
            m0, r0, had, w0 = merged[0], tick.replays, tick.graph is not None, tick.warm
            t0 = time.perf_counter()
            with record_function("tick") if traced else contextlib.nullcontext():
                eng.tick()
            dt = time.perf_counter() - t0
            if merged[0] > m0:
                kind = "merged"
            elif tick.replays > r0:
                kind = "decode replay" if had else "decode capture"
            else:
                kind = "decode eager" if (w0 or not flags.decode_graph_enabled()) else \
                    "decode eager (first)"
            out.append((kind, dt))
    finally:
        sched_mod._merged_step = real
    return out


def attribute(prof, kinds):
    """Device events per tick, by the "tick" host windows in order."""
    ticks = sorted((e for e in prof.events() if e.name == "tick"
                    and e.device_type == DeviceType.CPU), key=lambda e: e.time_range.start)
    if len(ticks) != len(kinds):
        raise RuntimeError(f"{len(ticks)} tick ranges traced for {len(kinds)} ticks")
    starts = np.array([e.time_range.start for e in ticks], dtype=np.float64)
    per = [dict(busy_us=0.0, ops=0, host_us=e.time_range.elapsed_us(), kernels={})
           for e in ticks]
    for e in prof.events():
        # the "tick" ranges come back on the device timeline too, spanning
        # the tick's kernels: they are not device work
        if e.device_type != DeviceType.CUDA or e.name == "tick":
            continue
        i = int(np.searchsorted(starts, e.time_range.start, side="right")) - 1
        if i < 0:
            continue
        t = e.time_range.elapsed_us()
        per[i]["busy_us"] += t
        per[i]["ops"] += 1
        per[i]["kernels"][e.name] = per[i]["kernels"].get(e.name, 0.0) + t
    return per


def summary(kinds_untraced, kinds_traced, per):
    out = {}
    for kind in sorted({k for k, _ in kinds_traced}):
        idx = [i for i, (k, _) in enumerate(kinds_traced) if k == kind]
        busy = sum(per[i]["busy_us"] for i in idx)
        host = sum(per[i]["host_us"] for i in idx)
        kern = {}
        for i in idx:
            for name, t in per[i]["kernels"].items():
                kern[name] = kern.get(name, 0.0) + t
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
        untraced = [dt for k, dt in kinds_untraced if k == kind]
        base = float(np.median(untraced)) * 1e3 if untraced else None
        busy_ms = busy / len(idx) / 1e3
        out[kind] = {
            "ticks": len(idx),
            "untraced_host_ms_median": base,
            "traced_host_ms_mean": host / len(idx) / 1e3,
            "device_busy_ms_mean": busy_ms,
            "operations_mean": sum(per[i]["ops"] for i in idx) / len(idx),
            "device_idle_share": 1 - busy / host if host else None,
            "device_idle_share_of_untraced": 1 - busy_ms / base if base else None,
            "top_kernels_device_ms_per_tick": {k: v / len(idx) / 1e3 for k, v in top},
        }
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = LLAMA2_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv[1:] else None
    runs = []
    if only in (None, "a"):
        runs.append(("(a) int4 arith fused, int8 KV, B=8",
                     lambda: quant.fuse_gemv_params(
                         quant.quantize_params_int4(params, layout="arith")), True,
                     dict(batch_slots=SERVE_SLOTS, budget=BUDGET, temperature=1.0, top_p=0.95),
                     serving_prompts(SERVE_REQS, cfg.vocab_size, 0)))
    if only in (None, "b"):
        runs.append(("(b) bf16 weights, bf16 KV, B=4", lambda: params, False,
                     dict(batch_slots=SMALL_SLOTS, budget=SMALL_BUDGET, temperature=1e-9,
                          top_p=1.0),
                     serving_prompts(SMALL_REQS, cfg.vocab_size, 1)))
    res = {"card": smi}
    for name, weights, kv_quant, kw, prompts in runs:
        model = easykv_tpu_torch.CausalLM(cfg, weights(), device=dev, kv_quant=kv_quant)
        kw = dict(kw, max_prompt=SERVE_MAX_PROMPT, kv_policy="roco", prefill_chunk=CHUNK, seed=0)
        for loop in ("graph", "eager"):
            with flags.eager_decode_loop() if loop == "eager" else contextlib.nullcontext():
                untraced = drive(ScheduledBatchEngine(model, **kw), prompts, SERVE_NEW, False)
                eng = ScheduledBatchEngine(model, **kw)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    traced = drive(eng, prompts, SERVE_NEW, True)
            res[f"{name}, decode tick {loop}"] = dict(
                summary(untraced, traced, attribute(prof, [k for k, _ in traced])),
                capture_s=eng.decode_tick.capture_s, graph_nodes=eng.decode_tick.nodes)
            del prof, eng
        del model
        torch.cuda.empty_cache()
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
