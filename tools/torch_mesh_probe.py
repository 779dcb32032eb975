#!/usr/bin/env python3
"""Which torch.distributed collectives a backend runs on CUDA tensors when
several ranks share the card(s): all_reduce (sum, min), all_gather,
all_gather_into_tensor, broadcast and barrier, over f32 / bf16 / int32 /
bool tensors, and a (1, ranks) DeviceMesh's groups. Each rank runs on card
rank % device_count(). Prints one line a case (ok, or the error) and the
last line as JSON. Usage:

    python3 tools/torch_mesh_probe.py [--ranks 2] [--backend gloo]
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32,
          "bool": torch.bool}


def _case(name, fn, results):
    try:
        fn()
        torch.cuda.synchronize()
        results[name] = "ok"
    except Exception as e:  # noqa: BLE001 - the probe reports every failure
        results[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def worker(rank, world, backend, init, out_dir):
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", torch.cuda.current_device())
    res = {}
    for tag, dt in DTYPES.items():
        def mk():
            return (torch.arange(8, device=dev) + rank).to(dt)

        if dt != torch.bool:
            def reduce_sum():
                t = mk()
                dist.all_reduce(t)
                want = (torch.arange(8, device=dev) * world + sum(range(world))).to(dt)
                assert torch.equal(t, want), (t, want)
            _case(f"all_reduce sum {tag}", reduce_sum, res)

        def reduce_min():
            t = mk()
            dist.all_reduce(t, op=dist.ReduceOp.MIN)
            assert torch.equal(t, torch.arange(8, device=dev).to(dt))
        _case(f"all_reduce min {tag}", reduce_min, res)

        def gather():
            parts = [torch.empty(8, dtype=dt, device=dev) for _ in range(world)]
            dist.all_gather(parts, mk())
            for r, p in enumerate(parts):
                assert torch.equal(p, (torch.arange(8, device=dev) + r).to(dt))
        _case(f"all_gather {tag}", gather, res)

        def gather_base():
            out = torch.empty(8 * world, dtype=dt, device=dev)
            dist.all_gather_into_tensor(out, mk())
        _case(f"all_gather_into_tensor {tag}", gather_base, res)

        def bcast():
            t = mk()
            dist.broadcast(t, src=0)
            assert torch.equal(t, torch.arange(8, device=dev).to(dt))
        _case(f"broadcast {tag}", bcast, res)
    _case("barrier", dist.barrier, res)

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh

        dm = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        t = torch.ones(4, device=dev)
        dist.all_reduce(t, group=dm.get_group("model"))
        assert float(t[0]) == world
    _case("init_device_mesh (1, ranks) + all_reduce over model", device_mesh, res)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        try:
            mp.start_processes(worker, args=(a.ranks, a.backend, init, tmp), nprocs=a.ranks,
                               start_method="spawn")
        except Exception:  # noqa: BLE001
            traceback.print_exc()
            sys.exit(1)
        res = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(a.ranks)]
    for k, v in res[0].items():
        print(f"{a.backend} x{a.ranks} on {torch.cuda.device_count()} card(s): {k}: {v}")
    print(json.dumps({"backend": a.backend, "ranks": a.ranks,
                      "cards": torch.cuda.device_count(), "results": res[0]}))


if __name__ == "__main__":
    main()
