"""Debug and validation helpers (counterpart of easykv_tpu/testing.py: the
"race detection / sanitizers" row of SURVEY.md §5). The JAX package checks
jit against eager and runs under jax.debug_nans; here the "jit" is the CUDA
graph capture the decode loop replays (engine/generate.capture_step) and the
NaN check is a TorchDispatchMode."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Tuple

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map


def _leaves(tree: Any, path: str, modules: bool = True) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, nn.Module):
        if modules:
            for k, t in tree.state_dict(keep_vars=True).items():
                yield f"{path}.{k}", t
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}", modules)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]", modules)
    elif isinstance(tree, (list, tuple)):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{fields[i]}" if fields else f"{path}[{i}]", modules)
    else:
        yield path, tree


def assert_finite_tree(tree: Any, name: str = "tree") -> None:
    """Raise FloatingPointError, naming the leaf's path, if a floating
    tensor of `tree` (LlamaParams or any module, KVCache or another
    dataclass, dicts, lists, tuples, tensors) holds a NaN or an Inf."""
    for path, leaf in _leaves(tree, name):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(f"non-finite values in {path}")


class NanGuard(TorchDispatchMode):
    """Raises FloatingPointError at the first op whose floating output holds
    a NaN (the counterpart of jax.debug_nans). Every op's output is read
    back: a debugging aid, not for timed or captured code."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.is_floating_point() and bool(t.isnan().any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


def nan_guard(fn: Callable) -> Callable:
    """Wrap fn to run under NanGuard (fail fast at the op producing the
    first NaN)."""

    def wrapped(*args, **kwargs):
        with NanGuard():
            return fn(*args, **kwargs)

    return wrapped


def check_graph_eager_parity(fn: Callable, *args, atol: float = 1e-5,
                             rtol: float = 1e-4) -> None:
    """Run fn(*args) eagerly, then capture it as a CUDA graph and replay it
    on the same inputs; assert all outputs match within atol / rtol. Catches
    what a capture gets wrong (a host value read at capture time, a tensor
    rebound rather than written in place). fn may write its tensor
    arguments in place (tensors, and the tensors of dataclasses such as
    KVCache, dicts, lists and tuples): they are put back before the replay.
    A module's weights (LlamaParams) are read only. Needs a card: the
    tensors must be CUDA tensors."""
    from .engine.generate import capture_step

    tensors: List[torch.Tensor] = [t for _, t in _leaves(args, "args", modules=False)
                                   if isinstance(t, torch.Tensor)]
    if not tensors or any(not t.is_cuda for t in tensors):
        raise ValueError("check_graph_eager_parity needs CUDA tensors")
    saved = [t.clone() for t in tensors]
    eager = tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, fn(*args))
    for t, s in zip(tensors, saved):
        t.copy_(s)
    held = []
    captured = capture_step(lambda: held.append(fn(*args)),
                            torch.Generator(device=tensors[0].device))
    captured.replay()
    torch.cuda.synchronize()
    flat_e, spec_e = tree_flatten(eager)
    flat_g, spec_g = tree_flatten(held[0])
    assert spec_e == spec_g, "the graph's outputs are not the eager call's"
    for a, b in zip(flat_e, flat_g):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(b.float(), a.float(), atol=atol, rtol=rtol)
        else:
            assert a == b, f"{a!r} != {b!r}"
