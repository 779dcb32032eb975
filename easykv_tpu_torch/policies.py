"""Eviction-policy constants and the static policy spec (counterpart of
easykv_tpu/policies.py:36-57).

Only what the decode spec needs lives here: the decode-phase selection
itself runs inside the sidecar pass (ops/cuda/sidecar_update.py), which
folds the step's gated eviction into the slot write. The position tests
that stand for the reference's buffer-order semantics:

  * recent-window protection  "scores[:, :, :-w]"  -> pos <  next_pos - w
  * roco std guard            "std[:, :, -10:]=1e9" -> pos >= next_pos - 10
  * decode prompt protection  (easykv.py:290,311)   -> pos >= prompt_len
"""
from __future__ import annotations

import dataclasses

INT_MAX = 2**31 - 1
STD_FORCE = 1e9      # reference's 1e9 std override (easykv.py:321)
STD_EXCLUDE = 1e30   # strictly above STD_FORCE: never feasible
ROCO_STD_GUARD = 10  # "last 10 slots" guard (easykv.py:321, 472)

# Phase determines candidate masks and the score-update flavour.
PHASE_DECODE = "decode"                # reference easykv.py:288-362
PHASE_ENCODE = "encode"                # reference easykv.py:443-499
PHASE_ENCDEC_DECODE = "encdec_decode"  # reference easykv.py:694-747


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Static policy configuration for one engine run."""

    policy: str               # canonical: random|recency|h2o_head|tova|roco|full
    phase: str                # PHASE_*
    k: int                    # slots evicted per event (1 decode, stride encode)
    sink_length: int          # temp_length, reference easykv.py:206
    recent_window: int        # int(budget * recent_ratio), phase-specific
    feasible_k: int = 0       # roco stage-1 top-k size
    protect_prompt: bool = False  # decode mode: only generated slots evictable
