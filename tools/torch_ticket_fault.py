#!/usr/bin/env python3
"""Shows the fault that keying K11's split tickets by the CUDA graph capture
repairs, on one CUDA card.

Runs the card test tests/test_torch_gpu.py::test_two_graphs_replayed_at_once_keep_their_own_tickets
(two graphs of the split int4 decode step at B = 4, captured on one stream,
replayed at once on two) in turns with the tickets as the port keys them
(the capture's own row inside a capture) and keyed by stream alone, as they
were before (ops/cuda/_wstream.tickets with the capture id ignored, patched
in this process only), and prints each run's pytest exit code (0: the
replays gave the eager step's bits).

    python3 tools/torch_ticket_fault.py [--runs N]
"""
import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST = ("tests/test_torch_gpu.py::"
        "test_two_graphs_replayed_at_once_keep_their_own_tickets")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3, help="runs of each keying, in turns")
    opt = ap.parse_args()
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import pytest
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    from easykv_tpu_torch.ops.cuda import _wstream
    by_capture = _wstream.tickets

    def by_stream(device, stream, capture=0):
        return by_capture(device, stream)
    for _ in range(opt.runs):
        for keyed, fn in (("stream", by_stream), ("capture", by_capture)):
            _wstream.tickets = fn
            rc = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider", TEST])
            print(f"tickets keyed by {keyed}: pytest exit {int(rc)}", flush=True)
    _wstream.tickets = by_capture


if __name__ == "__main__":
    main()
