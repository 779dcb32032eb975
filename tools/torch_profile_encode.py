#!/usr/bin/env python3
"""Where the strided encode of the PyTorch port spends its time, on one
CUDA card, and what the encoding_decoding decode step adds.

Builds LLaMa-2-7B-width weights on the card from a seed (bf16) and takes
chip_smoke.py's encoding-family workload (its model, 4096-token prompt and
stride 96): the `encoding` roco run at budget 0.5, prefix prefilled, then
the strided encode (22 chunks x 32 layers) once untraced and once under
torch.profiler, with an int8 KV cache (K6 per chunk and layer) and then a
bf16 one (write_tokens_at + plain attend); then, with the int8 cache, the
`encoding_decoding` roco run at budget 2048: STEPS decode steps after its
encode, each followed by policies.evict_cache, untraced and traced, eager
and as the engine runs them on the card (one step captured as a CUDA graph
and replayed; profiler ranges show only in the eager loop). Prints
host-clock seconds of both runs, the device time (sum of kernel
durations), the device's idle share while traced, the kernels that take
most device time, and the PyTorch ops that take most host time (self CPU
time under the tracer, which inflates it, with calls).

With --streaming it profiles the StreamingLLM encode instead: the same
`encoding` run with streaming=True, chunk-major (engine._strided_encode:
llama.forward per chunk over the unordered cache, one evict_cache per
triggered chunk), int8 then bf16 KV, per chunk (22) and per chunk-layer,
with the device time of the per-layer _age_ranks (the double argsort) and
of the rank rotation of the cached K (apply_rope of the whole cache by its
ranks) as shares of the device busy time, from torch.profiler ranges
around the two (record_function, put in place by this script alone); then
the int8 `encoding_decoding` decode step without and with streaming, in
turns (the latter with the device time of _carry_ranks).

With --step it profiles the layer-major strided encode of the same
`encoding` run with the chunk kernels on (flags.use_chunk_kernel), int8
then bf16 KV, with the one-call chunk step K7 off (K6, then the plain score
update and, on the triggered chunks, the plain eviction) and on (one K7
call a chunk-layer), in turns, per chunk-layer.

Every window also reports its device operations (kernels, copies and
fills) per unit: the launches the host pays for.

    python3 tools/torch_profile_encode.py [--streaming | --step]
"""
import contextlib
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import ENC_PROMPT, LLAMA2_7B, STRIDE  # noqa: E402
from easykv_tpu_torch import flags  # noqa: E402
from easykv_tpu_torch.models.llama import init_params  # noqa: E402
from easykv_tpu_torch.ops.cuda import _build  # noqa: E402

gen_mod = importlib.import_module("easykv_tpu_torch.engine.generate")
llama_mod = importlib.import_module("easykv_tpu_torch.models.llama")
STEPS = 32       # encoding_decoding decode steps, each with an eviction
RANGES = ("age_ranks", "rank_rotation", "carry_ranks")


@contextlib.contextmanager
def labelled():
    """The streaming forward's _age_ranks, its rotation of the whole cache
    by rank (apply_rope of a (B, H, S, D) K by (B, H, S) positions; q's
    rotation by its (B, 1, C) positions is left out) and the decode loop's
    _carry_ranks inside profiler ranges, so that their kernels' device time
    can be read."""
    ranks, rope, carry = llama_mod._age_ranks, llama_mod.apply_rope, gen_mod._carry_ranks

    def age_ranks(pos):
        with record_function("age_ranks"):
            return ranks(pos)

    def apply_rope(x, positions, inv_freq):
        if positions.dim() == x.dim() - 1 and positions.shape[-1] == x.shape[-2] > 1 \
                and positions.shape[1] == x.shape[1]:
            with record_function("rank_rotation"):
                return rope(x, positions, inv_freq)
        return rope(x, positions, inv_freq)
    def carry_ranks(*args):
        with record_function("carry_ranks"):
            return carry(*args)
    with mock.patch.multiple(llama_mod, _age_ranks=age_ranks, apply_rope=apply_rope), \
            mock.patch.object(gen_mod, "_carry_ranks", carry_ranks):
        yield


def range_ms(prof, name):
    """(device ms of the kernels launched inside the profiler ranges called
    `name`, host ms spent in them under the tracer, calls)."""
    for e in prof.key_averages():
        if e.key == name:
            dev = getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
            return dev / 1e3, e.cpu_time_total / 1e3, e.count
    return 0.0, 0.0, 0


def summarize(prof, seconds_traced, seconds_untraced, n):
    """Per-unit (n units: chunk-layers, chunks or decode steps) device and
    host figures of one traced window. The device time sums kernels only:
    the device-side spans of this script's own profiler ranges are left
    out."""
    kernels, busy_us, ops = {}, 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in RANGES:
            t = e.time_range.elapsed_us()
            busy_us += t
            ops += 1
            kernels[e.name] = kernels.get(e.name, 0.0) + t
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])[:10]
    out = {
        "untraced_s": seconds_untraced,
        "traced_s": seconds_traced,
        "untraced_ms_per_unit": seconds_untraced / n * 1e3,
        "device_busy_ms_per_unit": busy_us / 1e3 / n,
        "device_idle_share_traced": 1 - (busy_us / 1e6) / seconds_traced,
        "device_ops_per_unit": ops / n,
        "top_kernels_device_ms_per_unit": {k: v / 1e3 / n for k, v in top},
        "top_host_ops_traced_ms_and_calls_per_unit": {
            k: [t / 1e3 / n, c / n] for k, t, c in host},
    }
    for name in RANGES:
        ms, host_ms, calls = range_ms(prof, name)
        if calls:
            out[f"{name}_device_ms_per_unit"] = ms / n
            out[f"{name}_share_of_device_busy"] = ms * 1e3 / busy_us if busy_us else None
            out[f"{name}_traced_host_ms_and_calls_per_unit"] = [host_ms / n, calls / n]
    return out


def streaming(res, statics, prefixed, encoded, decode, L, n, dev, params, ids):
    """The StreamingLLM `encoding` encode (engine._strided_encode), int8
    then bf16 KV, per chunk; then the int8 `encoding_decoding` decode step
    without and then with streaming (K1 against K1's rank variant and the
    carried ranks), in turns, in the same process."""
    for kv_quant in (True, False):
        st = dataclasses.replace(statics("encoding", kv_quant, 0), streaming=True)
        S = st.idx + st.stride
        chunks = (n - st.r_idx) // STRIDE

        def encode(cache):
            gen = torch.Generator(device=dev).manual_seed(0)
            t0 = time.perf_counter()
            gen_mod._strided_encode(st, params, cache, ids, st.encode_spec(), gen, False)
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        encode(prefixed(st, S))                                  # warm-up
        base_s = encode(prefixed(st, S))
        cache = prefixed(st, S)
        with labelled(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
            enc_s = encode(cache)
        kv = "int8" if kv_quant else "bf16"
        per_chunk = summarize(prof, enc_s, base_s, chunks)
        per_chunk["device_busy_ms_per_chunk_layer"] = per_chunk["device_busy_ms_per_unit"] / L
        res[f"StreamingLLM encode, {kv} KV, per chunk ({chunks} chunks x {L} layers)"] = per_chunk
    for on, graph in ((on, graph) for on in (False, True) for graph in (False, True)):
        st = dataclasses.replace(statics("encoding_decoding", True, STEPS), streaming=on)
        decode(st, *encoded(st), graph)                          # warm-up
        base_s = decode(st, *encoded(st), graph)
        state = encoded(st)
        with labelled(), profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
            dec_s = decode(st, *state, graph)
        res[f"encoding_decoding decode, int8 KV, streaming {on}, "
            f"{'replayed graph' if graph else 'eager'}, per step ({STEPS})"] = \
            summarize(prof, dec_s, base_s, STEPS)


def step(res, statics, prefixed, encode, L, n):
    """The layer-major strided encode with the chunk kernels on, int8 then
    bf16 KV, the step kernel off then on, per chunk-layer."""
    flags.use_chunk_kernel(True)
    try:
        for kv_quant in (True, False):
            st = statics("encoding", kv_quant, 0)
            S = st.idx + st.stride
            units = L * ((n - st.r_idx) // STRIDE)
            for on in (False, True):
                flags.use_step_kernel(on)
                encode(st, prefixed(st, S))                  # warm-up
                base_s, _ = encode(st, prefixed(st, S))
                cache = prefixed(st, S)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    enc_s, _ = encode(st, cache)
                res[f"strided encode, {'int8' if kv_quant else 'bf16'} KV, chunk kernels on, "
                    f"step kernel {'on' if on else 'off'}, per chunk-layer ({units})"] = \
                    summarize(prof, enc_s, base_s, units)
    finally:
        flags.use_chunk_kernel(None)
        flags.use_step_kernel(None)


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.build()                  # every kernel, before any timed region
    cfg = LLAMA2_7B
    L = cfg.num_hidden_layers
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    n = ENC_PROMPT
    ids = torch.randint(1, cfg.vocab_size, (1, n), generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32).to(dev)

    def statics(mode, kv_quant, max_new):
        b = int(n * 0.5) + STRIDE if mode == "encoding" else 2048 + STRIDE
        align = gen_mod.stride_align if mode == "encoding" else gen_mod.stride_align_encdec
        idx, r_idx = align(n, b, STRIDE)
        return gen_mod.EngineStatics(cfg=cfg, policy="roco", length=n, budget=b,
                                     max_new_tokens=max_new, recent_window_dec=int(b * 0.3),
                                     kv_quant=kv_quant, mode=mode, stride=STRIDE, idx=idx,
                                     r_idx=r_idx, recent_window=int(b * 0.1))

    def prefixed(st, S):
        cache = gen_mod._engine_cache(st, 1, S, torch.bfloat16, dev)
        plen = torch.full((1,), st.r_idx, dtype=torch.int32, device=dev)
        gen_mod._prefill(st, params, cache, ids[:, :st.r_idx], plen, None, "encode")
        torch.cuda.synchronize()
        return cache

    def encode(st, cache):
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        out = gen_mod._strided_encode_layer_major(st, params, cache, ids, st.encode_spec(), gen,
                                                  False)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    length = torch.full((1,), n, dtype=torch.int32, device=dev)

    def encoded(st):
        """The int8 encoding_decoding cache after its prefix and encode
        (chunk-major under streaming), and the encode's last logits."""
        cache = prefixed(st, st.idx + st.stride)
        run = gen_mod._strided_encode if st.streaming else gen_mod._strided_encode_layer_major
        last, _, kv_len = run(st, params, cache, ids, st.encode_spec(),
                              torch.Generator(device=dev).manual_seed(0), False)
        torch.cuda.synchronize()
        return cache, last, kv_len

    def decode(st, cache, last, kv_len, graph=True):
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        with contextlib.nullcontext() if graph else flags.eager_decode_loop():
            gen_mod._decode_loop(st, params, cache, last, length, length, kv_len,
                                 st.encdec_decode_spec(), gen, 1e-9, 1.0, "always")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    res = {"card": smi, "layers": L, "prompt": n, "stride": STRIDE}
    if "--streaming" in sys.argv[1:]:
        streaming(res, statics, prefixed, encoded, decode, L, n, dev, params, ids)
        print(json.dumps(res, indent=1))
        return
    if "--step" in sys.argv[1:]:
        step(res, statics, prefixed, encode, L, n)
        print(json.dumps(res, indent=1))
        return
    for kv_quant in (True, False):
        st = statics("encoding", kv_quant, 0)
        S = st.idx + st.stride
        units = L * ((n - st.r_idx) // STRIDE)
        encode(st, prefixed(st, S))                          # build + warm-up
        base_s, _ = encode(st, prefixed(st, S))
        cache = prefixed(st, S)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            enc_s, _ = encode(st, cache)
        res[f"strided encode, {'int8' if kv_quant else 'bf16'} KV, per chunk-layer "
            f"({units})"] = summarize(prof, enc_s, base_s, units)

    st = statics("encoding_decoding", True, STEPS)
    for graph in (False, True):
        decode(st, *encoded(st), graph)                      # warm-up
        base_s = decode(st, *encoded(st), graph)
        state = encoded(st)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            dec_s = decode(st, *state, graph)
        res[f"encoding_decoding decode, int8 KV, {'replayed graph' if graph else 'eager'}, "
            f"per step ({STEPS})"] = summarize(prof, dec_s, base_s, STEPS)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
