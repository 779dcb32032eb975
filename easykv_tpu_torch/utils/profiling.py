"""Profiling helpers (counterpart of easykv_tpu/utils/profiling.py): a
torch.profiler trace and per-step wall timing (the reference's only perf
instrumentation is a time.time() mean, easykv.py:507-528)."""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List

import torch


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Trace a block with torch.profiler (host and, where there is a card,
    CUDA activity) and write it to `logdir`/trace.json, a Chrome trace
    (chrome://tracing, Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class step_timer:
    """Collects per-step wall latencies; mean excludes the first (warm-up)
    step like the reference (easykv.py:528)."""

    def __init__(self) -> None:
        self.times: List[float] = []
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        body = self.times[1:] or self.times
        return sum(body) / max(len(body), 1)
