"""Command-line interface: `python -m easykv_tpu_torch <command>`
(counterpart of easykv_tpu/cli.py, with the same arguments and outputs, and
--device).

    generate  — budget-constrained generation in any kv_mode
    ppl       — perplexity under a KV budget
    info      — print a checkpoint/config summary

The model runs on the card unless --device names another (--device cpu);
without a card and without --device every command raises. --model loads a
local HF checkpoint directory through the port's own mmap reader: no
`safetensors` package is needed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

DTYPES = ("bfloat16", "float16", "float32")


def _add_common(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--model", help="local HF checkpoint directory")
    ap.add_argument("--random", action="store_true",
                    help="small random-weight model (no checkpoint needed); its weights "
                         "are drawn by torch from --seed and differ from the JAX package's")
    ap.add_argument("--dtype", default="bfloat16", choices=DTYPES)
    ap.add_argument("--device", help="torch device (default: the CUDA card)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 compressed-KV cache")
    ap.add_argument("--stride", type=int, default=8)
    ap.add_argument("--budget", type=float, default=0.5,
                    help="int token budget or float fraction (<= 1.0)")
    ap.add_argument("--policy", default="roco")
    ap.add_argument("--seed", type=int, default=0)


RANDOM_CONFIG = dict(
    vocab_size=32000, hidden_size=512, intermediate_size=1376,
    num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
    max_position_embeddings=4096,
)


def _config(args):
    """The model's config: config.json of --model, or the --random model's."""
    from .config import ModelConfig

    if args.model:
        with open(os.path.join(args.model, "config.json")) as f:
            return ModelConfig.from_hf_config(json.load(f))
    return ModelConfig(**RANDOM_CONFIG)


TOKENIZER_FILES = ("tokenizer.json", "tokenizer.model", "tokenizer_config.json")


def load_tokenizer(path):
    """The checkpoint's tokenizer through transformers, where the directory
    holds tokenizer files and transformers can be imported; else None (the
    hash ids of prompt_ids)."""
    if not any(os.path.exists(os.path.join(path, f)) for f in TOKENIZER_FILES):
        return None
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(path)
    except Exception:
        return None


def build_model(args):
    """CausalLM of --model (with load_tokenizer's tokenizer) or of --random,
    on args.device."""
    import torch

    from .engine.generate import CausalLM
    from .models import llama

    dtype = getattr(torch, args.dtype)
    if args.model:
        from .models.hf import load_hf_checkpoint

        cfg, params = load_hf_checkpoint(args.model, dtype=dtype, device=args.device)
        return CausalLM(cfg, params, tokenizer=load_tokenizer(args.model), device=args.device,
                        kv_quant=args.kv_quant)
    cfg = _config(args)
    params = llama.init_params(cfg, args.seed, dtype=dtype, device=args.device)
    return CausalLM(cfg, params, device=args.device, kv_quant=args.kv_quant)


def prompt_ids(model, args):
    """The prompt's ids: the tokenizer's, else the JAX package's hash ids,
    so both packages feed the same ids."""
    import numpy as np

    if args.prompt_file:
        text = open(args.prompt_file).read()
    else:
        text = args.prompt or "Hello, world."
    if model.tokenizer is not None:
        return model.tokenizer(text, return_tensors="np").input_ids[0]
    return np.asarray(
        [3 + (ord(c) * 31) % (model.cfg.vocab_size - 4) for c in text[:2048]],
        np.int32,
    )


def _budget(args):
    b = args.budget
    return int(b) if b > 1.0 else float(b)


def run_generate(model, args):
    """The `generate` command's output on a built model."""
    from .engine.generate import generate

    return generate(
        model, prompt_ids(model, args),
        {
            "budget": _budget(args), "kv_policy": args.policy,
            "temperature": args.temperature, "top_p": args.top_p,
            "max_new_tokens": args.max_new_tokens, "seed": args.seed,
            "keep_attention": args.keep_attention,
            "streaming": args.streaming,
        },
        kv_mode=args.mode, stride=args.stride,
        report_decoding_latency=args.verbose,
    )


def run_ppl(model, args) -> float:
    """The `ppl` command's perplexity on a built model."""
    from .engine.generate import generate

    return generate(
        model, prompt_ids(model, args), {"budget": _budget(args), "kv_policy": args.policy},
        kv_mode="ppl", stride=args.stride,
    )


def cmd_generate(args) -> int:
    print(run_generate(build_model(args), args))
    return 0


def cmd_ppl(args) -> int:
    print(f"ppl: {run_ppl(build_model(args), args):.4f}")
    return 0


def cmd_info(args) -> int:
    print(json.dumps(dataclasses.asdict(_config(args)), indent=2))
    return 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="easykv_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="budget-constrained generation")
    _add_common(g)
    g.add_argument("--mode", default="auto",
                   choices=["auto", "decoding", "encoding", "encoding_decoding"])
    g.add_argument("--prompt")
    g.add_argument("--prompt-file")
    g.add_argument("--max-new-tokens", type=int, default=128)
    g.add_argument("--temperature", type=float, default=1.0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--keep-attention", action="store_true")
    g.add_argument("--streaming", action="store_true")
    g.add_argument("-v", "--verbose", action="store_true")
    g.set_defaults(fn=cmd_generate)

    p = sub.add_parser("ppl", help="perplexity under a KV budget")
    _add_common(p)
    p.add_argument("--prompt")
    p.add_argument("--prompt-file")
    p.set_defaults(fn=cmd_ppl)

    i = sub.add_parser("info", help="print model config")
    _add_common(i)
    i.set_defaults(fn=cmd_info)
    return ap


def main(argv=None) -> int:
    from .config import resolve_device

    args = parser().parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
