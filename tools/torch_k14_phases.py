"""Where the one-kernel decode step's time goes inside its one launch, on
one CUDA card: K14 (B=1), or with --batch its batched twin K15 (B=4 and 16).

Builds the step's source (easykv_tpu_torch/csrc/fused_decode.cu, or
fused_decode_batch.cu) once more with -DSTEP_STAMPS, which turns on the
kernel's phase clock (fused_step.cuh: block 0 reads the card's nanosecond
clock, %globaltimer, once before the layers and after every grid-wide
barrier: one thread, one store a read), into the gitignored
easykv_tpu_torch/_build/. Runs it through the usual wrapper at the
chip_smoke.py main path's step (LLaMa-2-7B width, L=32, S=768, the prompt
and 200 generated tokens visible; bf16 weights drawn on the card from a
seed, quantized to the fused arithmetic-int4 tree), with a bf16 and with
an int8 KV cache, checks that the kernel made one read per phase of
PHASES a layer, and prints the step's time and each phase's mean time per
layer, in microseconds.

    python3 tools/torch_k14_phases.py [--batch]
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import B_MAX, B_WIDE, LLAMA2_7B, S_MAIN, step_case  # noqa: E402
from easykv_tpu_torch.models.llama import init_params  # noqa: E402
from easykv_tpu_torch.ops import quant  # noqa: E402
from easykv_tpu_torch.ops.cuda import _build  # noqa: E402
from easykv_tpu_torch.ops.cuda import fused_decode as k14_mod  # noqa: E402
from easykv_tpu_torch.ops.cuda import fused_decode_batch as k15_mod  # noqa: E402

# the kernels' phases, in the order of their barriers (fused_decode.cu and
# fused_decode_batch.cu have the same nine)
PHASES = ("qkv", "attention", "combine", "o", "h+=o", "gate|up", "swiglu", "down", "h+=down")
MAX_STAMPS = 8192   # kMaxStamps in fused_step.cuh


def load_stamped(source, module):
    """`source`.cu built with its phase clock on, with `module`'s
    signatures and the source's `..._stamps` entry declared."""
    dll = _build.load_debug(source, "STEP_STAMPS", module.SIGNATURES)
    stamps = getattr(dll, f"{source}_stamps")
    stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    stamps.restype = ctypes.c_int
    return dll, stamps


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    batch = "--batch" in sys.argv[1:]
    source, module = ("fused_decode_batch", k15_mod) if batch else ("fused_decode", k14_mod)
    lib, stamps = load_stamped(source, module)
    _build._libs[source] = lib                  # the wrapper launches the stamped copy
    cfg = LLAMA2_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    tree = quant.fuse_gemv_params(quant.quantize_params_int4(params, layout="arith"))
    del params
    torch.cuda.empty_cache()
    L = cfg.num_hidden_layers
    res = {"card": smi, "S": S_MAIN, "layers": L}
    cases = ([(B, kv) for B in (B_WIDE, B_MAX) for kv in ("bf16", "int8")] if batch
             else [(1, kv) for kv in ("bf16", "int8")])
    for B, kv in cases:
        args, _ = step_case(dev, cfg, B, kv, False, 800)
        step = k15_mod.fused_decode_step_batch if batch else k14_mod.fused_decode_step
        for _ in range(3):
            step(tree.layers, cfg, *args)
        torch.cuda.synchronize()
        buf, n = np.zeros(MAX_STAMPS, dtype=np.uint64), ctypes.c_int(0)
        _build.check(stamps(buf.ctypes.data, ctypes.byref(n)), "stamps copy")
        if n.value != 1 + len(PHASES) * L:
            sys.exit(f"{n.value} clock reads, expected 1 + {len(PHASES)} x {L}: "
                     f"PHASES no longer matches the kernel's barriers")
        t = buf[:n.value].astype(np.int64)
        per_layer = (np.diff(t) / 1e3).reshape(L, len(PHASES)).mean(axis=0)
        res[f"B={B}, {kv} KV"] = {"step_us": float(t[-1] - t[0]) / 1e3,
                           "per_layer_us": {p: float(x) for p, x in zip(PHASES, per_layer)}}
        del args
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
