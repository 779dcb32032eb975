#!/usr/bin/env python3
"""Host time of one quantized product of the PyTorch port, on one CUDA card.

For each weight format at LLaMa-2-7B's `wo` width (4096 x 4096, made on the
card from a seed) and the row count of a decode step, times eager calls of
`easykv_tpu_torch.ops.quant.mm` on the host clock: the median of CALLS calls,
each timed alone, after a warm-up. A call returns once its kernel is queued,
so this is the Python and launch cost the decode loop pays per product, not
the kernel's time (chip_smoke.py phase 5 has those). `torch.matmul` over a
bf16 copy of the same weight is timed the same way beside them, and so are
the parts of a K10 call: the wrapper alone (without `mm`'s reshapes), the
stream lookup (PyTorch's Stream object, and the raw handle alone), an
output allocation, and the ctypes call into the library with a shape the
C side refuses before any launch.

    python3 tools/torch_quant_host.py

Prints one line per case and, last, one JSON object of the medians in µs.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from easykv_tpu_torch.ops import quant  # noqa: E402
from easykv_tpu_torch.ops.cuda import _build, quant_matmul, w4_stream  # noqa: E402

K = N = 4096
CALLS = 2000
WARMUP = 200


def host_us(fn, x, w):
    for _ in range(WARMUP):
        fn(x, w)
    torch.cuda.synchronize()
    times = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        fn(x, w)
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.build(("quant_matmul", "w4_matmul", "quant_gemv"))
    w = torch.randn((K, N), generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev) * 0.02
    cases = [("K13 int8", quant.quantize_linear(w), 1),
             ("K10 int4 arithmetic", quant.quantize_linear_int4(w, 128, "arith"), 1),
             ("K12 int4 halves", quant.quantize_linear_int4(w, 128, "halves"), 1),
             ("K11 int4 arithmetic", quant.quantize_linear_int4(w, 128, "arith"), 4),
             ("torch.matmul bf16", w.to(torch.bfloat16), 1)]
    out = {}
    for name, lin, M in cases:
        x = torch.randn((1, M, K), device=dev).to(torch.bfloat16)
        fn = torch.matmul if name.startswith("torch") else quant.mm
        out[f"{name} M={M}"] = us = host_us(fn, x, lin)
        print(f"{name}, M={M}, ({K}, {N}): {us:.2f} us of host time a call (median of {CALLS})")
    ql = quant.quantize_linear_int4(w, 128, "arith")
    x = torch.randn((1, K), device=dev).to(torch.bfloat16)
    lib = _build.load("quant_gemv", quant_matmul.GEMV_SIGNATURES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = torch.cuda.current_device()

    def refused(x_, p):       # an odd K: the entry returns an error before launching
        return lib.w4a16_gemv_arith(x_.data_ptr(), p.data_ptr(), ql["gs3"].data_ptr(),
                                    x_.data_ptr(), K + 1, N, 128, 128, 2, 8, 1, 1, stream)
    parts = [("K10 wrapper", lambda x_, p: w4_stream.w4a16_gemv_arith(x_, p, ql["gs3"])),
             ("torch.cuda.current_stream", lambda x_, p: torch.cuda.current_stream(dev)),
             ("raw current stream", lambda x_, p: torch._C._cuda_getCurrentRawStream(index)),
             ("torch.empty (1, N)", lambda x_, p: torch.empty((1, N), dtype=x_.dtype,
                                                               device=dev)),
             ("refused ctypes call", refused)]
    for name, fn in parts:
        out[name] = us = host_us(fn, x, ql["q4a"])
        print(f"part of a K10 call, {name}: {us:.2f} us (median of {CALLS})")
    print(smi)
    print(json.dumps({"host_us": out}))


if __name__ == "__main__":
    main()
