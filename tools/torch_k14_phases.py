"""Where K14's time goes inside its one launch, on one CUDA card.

Builds easykv_tpu_torch/csrc/fused_decode.cu once more with -DK14_STAMPS,
which turns on the kernel's phase clock (block 0 reads the card's
nanosecond clock, %globaltimer, once before the layers and after every
grid-wide barrier: one thread, one store a read), into the gitignored
easykv_tpu_torch/_build/. Runs it through the usual wrapper at the
chip_smoke.py main path's step (LLaMa-2-7B width, L=32, S=768, the prompt
and 200 generated tokens visible; bf16 weights drawn on the card from a
seed, quantized to the fused arithmetic-int4 tree), with a bf16 and with
an int8 KV cache, checks that the kernel made one read per phase of
PHASES a layer, and prints the step's time and each phase's mean time per
layer, in microseconds.

    python3 tools/torch_k14_phases.py
"""
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import LLAMA2_7B, S_MAIN, k14_case  # noqa: E402
from easykv_tpu_torch.models.llama import init_params  # noqa: E402
from easykv_tpu_torch.ops import quant  # noqa: E402
from easykv_tpu_torch.ops.cuda import _build  # noqa: E402
from easykv_tpu_torch.ops.cuda import fused_decode as k14_mod  # noqa: E402

# the kernel's phases, in the order of its barriers (fused_decode.cu)
PHASES = ("qkv", "attention", "combine", "o", "h+=o", "gate|up", "swiglu", "down", "h+=down")
MAX_STAMPS = 8192   # kMaxStamps in fused_decode.cu


def load_stamped():
    """fused_decode.cu built with its phase clock on, with the wrapper's
    signatures and fused_decode_stamps declared."""
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD / "libfused_decode_stamps.so"
    out = subprocess.run([_build.nvcc_path(), *_build._flags("fused_decode"), "-DK14_STAMPS",
                          "-o", str(lib), str(_build.CSRC / "fused_decode.cu")],
                         capture_output=True, text=True)
    if out.returncode:
        sys.exit(f"nvcc failed:\n{out.stdout}{out.stderr}")
    dll = ctypes.CDLL(str(lib))
    for fn, (argtypes, restype) in k14_mod.SIGNATURES.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = restype
    dll.fused_decode_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dll.fused_decode_stamps.restype = ctypes.c_int
    return dll


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    lib = load_stamped()
    _build._libs["fused_decode"] = lib          # the wrapper launches the stamped copy
    cfg = LLAMA2_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    tree = quant.fuse_gemv_params(quant.quantize_params_int4(params, layout="arith"))
    del params
    torch.cuda.empty_cache()
    L = cfg.num_hidden_layers
    res = {"card": smi, "S": S_MAIN, "layers": L}
    for kv in ("bf16", "int8"):
        args, _ = k14_case(dev, cfg, kv, False, False, 800)
        for _ in range(3):
            k14_mod.fused_decode_step(tree.layers, cfg, *args)
        torch.cuda.synchronize()
        buf, n = np.zeros(MAX_STAMPS, dtype=np.uint64), ctypes.c_int(0)
        _build.check(lib.fused_decode_stamps(buf.ctypes.data, ctypes.byref(n)), "stamps copy")
        if n.value != 1 + len(PHASES) * L:
            sys.exit(f"{n.value} clock reads, expected 1 + {len(PHASES)} x {L}: "
                     f"PHASES no longer matches the kernel's barriers")
        t = buf[:n.value].astype(np.int64)
        per_layer = (np.diff(t) / 1e3).reshape(L, len(PHASES)).mean(axis=0)
        res[f"{kv} KV"] = {"step_us": float(t[-1] - t[0]) / 1e3,
                           "per_layer_us": {p: float(x) for p, x in zip(PHASES, per_layer)}}
        del args
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
