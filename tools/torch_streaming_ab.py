#!/usr/bin/env python3
"""Paired A/B of the two ordered StreamingLLM strategies of the PyTorch
port, on one CUDA card: the pre-rotated cache (K2 `compact` + K9 each step)
against rotate-at-read (K1 `ordered`, then K4 and K8 each step).

The workload is chip_smoke.py's streaming run, whose model, prompt length,
budget and token count it imports: LLaMa-2-7B width, bf16 weights drawn on
the card from a seed, a 512-token prompt, 384 new tokens, roco at budget
200, greedy, through `easykv_generate` with streaming=True. For a bf16 and
an int8 KV cache it runs the strategies alternately, in the order
A B B A repeated ROUNDS times (so drift on the card weighs on both alike),
after one short warm-up of each. Prints each run's decode tok/s, the median
per strategy, the median of the per-pair ratios rotate-at-read over
pre-rotated, and how many leading greedy tokens the two strategies share,
as one JSON object with the card's name and power limit.

    python3 tools/torch_streaming_ab.py
"""
import json
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import easykv_tpu_torch  # noqa: E402
from chip_smoke import BUDGET, LLAMA2_7B, NEW, PROMPT  # noqa: E402
from easykv_tpu_torch import flags  # noqa: E402
from easykv_tpu_torch.models.llama import init_params  # noqa: E402

ROUNDS = 2          # each round is A B B A: ROUNDS * 2 runs per strategy


def main():
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = LLAMA2_7B
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    prompt = torch.randint(1, cfg.vocab_size, (PROMPT,),
                           generator=torch.Generator().manual_seed(0)).tolist()
    gc = dict(budget=BUDGET, kv_policy="roco", max_new_tokens=NEW, temperature=1e-9,
              top_p=1.0, eos_token_ids=[], seed=0, streaming=True)
    res = {"card": smi, "workload": f"{PROMPT}-token prompt, {NEW} new tokens, roco b={BUDGET}",
           "order": "A B B A x %d (A pre-rotated, B rotate-at-read)" % ROUNDS}
    for kv in ("bf16", "int8"):
        model = easykv_tpu_torch.enable_fixed_kv(
            easykv_tpu_torch.CausalLM(cfg, params, device=dev, kv_quant=kv == "int8"), None,
            "decoding")

        def run(prerot, n_new=NEW):
            flags.use_prerot(prerot)
            try:
                out = model.easykv_generate(prompt, dict(gc, max_new_tokens=n_new))
            finally:
                flags.use_prerot(None)
            st = model.last_run
            return st.n_tokens / st.decode_s, out

        for prerot in (True, False):
            run(prerot, 8)                                   # build + warm-up
        tok_s = {True: [], False: []}
        outs = {}
        for _ in range(ROUNDS):
            for prerot in (True, False, False, True):
                t, outs[prerot] = run(prerot)
                tok_s[prerot].append(t)
        ratios = [b / a for a, b in zip(tok_s[True], tok_s[False])]
        a, b = outs[True], outs[False]
        agree = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
        res[f"{kv} KV"] = {
            "pre-rotated tok/s": tok_s[True],
            "rotate-at-read tok/s": tok_s[False],
            "pre-rotated median tok/s": statistics.median(tok_s[True]),
            "rotate-at-read median tok/s": statistics.median(tok_s[False]),
            "median ratio rotate-at-read / pre-rotated": statistics.median(ratios),
            "greedy tokens shared before the first difference": agree,
        }
        del model
        torch.cuda.empty_cache()
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
