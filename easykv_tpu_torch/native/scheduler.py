"""ctypes binding of the C++ continuous-batching scheduler, native/scheduler.cc
(counterpart of easykv_tpu/native/scheduler.py: PREFILL_CHUNK, DECODE,
Action, NativeScheduler, with the same C signatures).

The scheduler is framework-neutral host code. It is compiled from the
repository's native/scheduler.cc at first use into easykv_tpu_torch/_build/
(native/_host_build.py: the host C++ compiler, native/Makefile's flags, a
name hashed from the source). Nothing is written into native/ and nothing is
built at import. A failed build raises.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path
from typing import List

from . import _host_build
from ._host_build import BUILD

SOURCE = _host_build.NATIVE / "scheduler.cc"

PREFILL_CHUNK = 0
DECODE = 1


class _CAction(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("request_id", ctypes.c_int64),
        ("slot", ctypes.c_int32),
        ("chunk_start", ctypes.c_int32),
        ("chunk_len", ctypes.c_int32),
    ]


@dataclass(frozen=True)
class Action:
    kind: int
    request_id: int
    slot: int
    chunk_start: int
    chunk_len: int


_i32, _i64, _ptr = ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p
SIGNATURES = {  # name: (argtypes, restype), as native/scheduler.cc declares them
    "sched_create": ([_i32, _i32, _i32], _ptr),
    "sched_destroy": ([_ptr], None),
    "sched_submit": ([_ptr, _i64, _i32, _i32, _i32], _i32),
    "sched_plan": ([_ptr, ctypes.POINTER(_CAction), _i32], _i32),
    "sched_report": ([_ptr, _i64, _i32, _i32, _i32], _i32),
    "sched_slot_of": ([_ptr, _i64], _i32),
    "sched_dump": ([_ptr, ctypes.POINTER(_i64), ctypes.POINTER(_i32), _i32], _i32),
    "sched_restore": ([_ptr, _i64, _i32, _i32, _i32, _i32, _i32, _i32], _i32),
    "sched_num_waiting": ([_ptr], _i32),
    "sched_num_active": ([_ptr], _i32),
}

def library_path() -> Path:
    return _host_build.library_path(SOURCE)


def _load() -> ctypes.CDLL:
    return _host_build.load(SOURCE, SIGNATURES)


class NativeScheduler:
    """Continuous-batching planner: slot assignment, chunked-prefill token
    budgeting, FIFO within a priority, implemented in C++."""

    def __init__(self, n_slots: int, max_prefill_tokens_per_tick: int, chunk_cap: int = 0):
        """chunk_cap: the per-request prefill cap of a tick (0: the whole
        budget). Set to the engine's chunk width, several requests each
        prefill one chunk a tick, in one merged dispatch."""
        self._lib = _load()
        self._h = self._lib.sched_create(n_slots, max_prefill_tokens_per_tick, chunk_cap)
        self._cap = max(64, 2 * n_slots)
        self._buf = (_CAction * self._cap)()

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.sched_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def submit(self, request_id: int, prompt_len: int, max_new_tokens: int,
               priority: int = 0) -> None:
        if self._lib.sched_submit(self._h, request_id, prompt_len, max_new_tokens, priority):
            raise ValueError(f"duplicate request id {request_id}")

    def plan(self) -> List[Action]:
        n = self._lib.sched_plan(self._h, self._buf, self._cap)
        return [Action(a.kind, a.request_id, a.slot, a.chunk_start, a.chunk_len)
                for a in self._buf[:n]]

    def report_prefill(self, request_id: int, n_tokens: int) -> None:
        self._lib.sched_report(self._h, request_id, 0, n_tokens, 0)

    def report_token(self, request_id: int, is_eos: bool = False) -> bool:
        """True when the request completed (its slot is free)."""
        return self._lib.sched_report(self._h, request_id, 1, 1, int(is_eos)) == 1

    def dump(self) -> List[dict]:
        """Every live request in admission order (the crash snapshot)."""
        cap = max(64, 4 * self._cap)
        ids = (ctypes.c_int64 * cap)()
        fields = (ctypes.c_int32 * (6 * cap))()
        n = self._lib.sched_dump(self._h, ids, fields, cap)
        keys = ("slot", "prompt_len", "max_new_tokens", "prefilled", "generated", "priority")
        return [dict(request_id=int(ids[i]), **dict(zip(keys, map(int, fields[6 * i:6 * i + 6]))))
                for i in range(n)]

    def restore(self, row: dict) -> None:
        """Re-create one dumped request with its progress (see dump())."""
        rc = self._lib.sched_restore(self._h, row["request_id"], row["slot"], row["prompt_len"],
                                     row["max_new_tokens"], row["prefilled"], row["generated"],
                                     row["priority"])
        if rc != 0:
            raise ValueError(f"restore failed ({rc}) for {row}")

    def slot_of(self, request_id: int) -> int:
        return self._lib.sched_slot_of(self._h, request_id)

    @property
    def num_waiting(self) -> int:
        return self._lib.sched_num_waiting(self._h)

    @property
    def num_active(self) -> int:
        return self._lib.sched_num_active(self._h)
