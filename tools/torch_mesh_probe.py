#!/usr/bin/env python3
"""Which torch.distributed collectives and point-to-point sends a backend
runs on CUDA tensors when several ranks share the card(s): all_reduce (sum,
min), all_gather, all_gather_into_tensor, broadcast and barrier, over f32 /
bf16 / int32 / bool tensors, and a (1, ranks) DeviceMesh's groups; then the
ring step of the sequence-parallel prefill (each rank sends to rank + 1 and
receives from rank - 1) by isend / irecv and by batch_isend_irecv, over
f32 / bf16 / int32 CUDA tensors, and by the port's
easykv_tpu_torch.parallel.mesh.ring_shift (its transport named). Each
point-to-point way runs in its own spawn of ranks with a time limit, each
case's result written as it ends, so a rank that crashes (a backend that
reads a card's pointer as host memory) or hangs is reported and the next
way still runs. Each rank runs on card rank % device_count(). Prints one
line a case (ok, or the error) and the last line as JSON. Usage:

    python3 tools/torch_mesh_probe.py [--ranks 2] [--backend gloo] [--p2p-only]
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32,
          "bool": torch.bool}
P2P_DTYPES = ("f32", "bf16", "int32")
P2P_WAYS = ("isend/irecv", "batch_isend_irecv", "ring_shift")
P2P_TIMEOUT = 90      # seconds a point-to-point spawn may take


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


def p2p_worker(rank, world, backend, init, out_dir, way):
    """One rank of a point-to-point spawn: the ring step by `way` for each
    dtype, each case's result appended to rank{rank}-p2p.txt as it ends."""
    torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=P2P_TIMEOUT // 2))
    dev = torch.device("cuda", torch.cuda.current_device())
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    path = os.path.join(out_dir, f"rank{rank}-p2p.txt")
    mesh = None
    if way == "ring_shift":
        from easykv_tpu_torch.parallel.mesh import make_sp_mesh, ring_transport

        mesh = make_sp_mesh("cuda")
    for tag in P2P_DTYPES:
        dt = DTYPES[tag]
        name = f"{way} {tag}"
        if mesh is not None:
            name += f" ({ring_transport(mesh, dev)})"
        mine = (torch.arange(1000, device=dev) + 1000 * rank).to(dt)
        want = (torch.arange(1000, device=dev) + 1000 * prv).to(dt)

        def ring():
            got = torch.empty_like(mine)
            if way == "isend/irecv":
                works = [dist.isend(mine, nxt), dist.irecv(got, prv)]
            elif way == "batch_isend_irecv":
                works = dist.batch_isend_irecv([dist.P2POp(dist.isend, mine, nxt),
                                                dist.P2POp(dist.irecv, got, prv)])
            else:
                from easykv_tpu_torch.parallel.mesh import ring_shift

                got = ring_shift([mine, mine[:3].clone()], mesh)[0]
                works = []
            for w in works:
                w.wait()
            torch.cuda.synchronize()
            assert torch.equal(got, want), "received values differ from the sender's"

        res = {}
        _case(name, ring, res)
        with open(path, "a") as f:
            f.write(json.dumps([name, res[name]]) + "\n")
    dist.destroy_process_group()


def p2p(ranks, backend):
    """Each point-to-point way in a spawn of its own: {case: result}. A
    spawn whose rank crashed or outlived P2P_TIMEOUT reports that for the
    cases it did not finish."""
    ctx = mp.get_context("spawn")
    out = {}
    for way in P2P_WAYS:
        with tempfile.TemporaryDirectory() as tmp:
            init = "file://" + os.path.join(tmp, "rendezvous")
            procs = [ctx.Process(target=p2p_worker, args=(r, ranks, backend, init, tmp, way))
                     for r in range(ranks)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(P2P_TIMEOUT)
            codes = []
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
                    codes.append("killed at the time limit")
                else:
                    codes.append(f"exit code {p.exitcode}")
            path = os.path.join(tmp, "rank0-p2p.txt")
            done = [json.loads(x) for x in open(path)] if os.path.exists(path) else []
            for name, r in done:
                out[name] = r
            for tag in P2P_DTYPES[len(done):]:
                out[f"{way} {tag}"] = f"not finished: ranks {codes}"
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--p2p-only", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    results = {}
    if not a.p2p_only:
        with tempfile.TemporaryDirectory() as tmp:
            init = "file://" + os.path.join(tmp, "rendezvous")
            try:
                mp.start_processes(worker, args=(a.ranks, a.backend, init, tmp), nprocs=a.ranks,
                                   start_method="spawn")
            except Exception:  # noqa: BLE001
                traceback.print_exc()
                sys.exit(1)
            res = [json.load(open(os.path.join(tmp, f"rank{r}.json"))) for r in range(a.ranks)]
        results.update(res[0])
    results.update(p2p(a.ranks, a.backend))
    for k, v in results.items():
        print(f"{a.backend} x{a.ranks} on {torch.cuda.device_count()} card(s): {k}: {v}")
    print(json.dumps({"backend": a.backend, "ranks": a.ranks,
                      "cards": torch.cuda.device_count(), "results": results}))


if __name__ == "__main__":
    main()
