"""Scheduled serving engine (counterpart of easykv_tpu/serving/scheduled.py:
ScheduledBatchEngine, single-process). The C++ continuous-batching
scheduler (native/scheduler.cc, through native/scheduler.py) plans each
tick: which request prefills which chunk, who decodes. This engine runs the
plan with the steps of serving/engine.py.

Unlike ContinuousBatchEngine, which prefills a whole admission before
decoding, prefill here is chunked and interleaved with decode ticks, so a
long prompt stalls the rows in flight for no more than one chunk a tick.

With `mesh` (parallel.make_mesh) and `mesh_config`, the JAX engine's
(easykv_tpu/serving/scheduled.py:27-140 there), the slots shard over the
`data` axis and the model over `model`, across processes, one rank each:
every process drives the same native scheduler with the same host state
(submit() is called identically everywhere), runs its own slots on its own
shards, and gathers the sampled tokens over `data`, so every process
advances the same state. The snapshot of such an engine is a directory:
each rank writes its cache shard (torch.save), rank 0 the host state, and
no rank returns before all have written (a barrier).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import flags
from ..cache import KVCache
from ..config import MeshConfig, ModelConfig
from ..native.scheduler import DECODE, PREFILL_CHUNK, NativeScheduler
from ..parallel.mesh import all_gather_cat, barrier, rows_of
from ..parallel.sharding import local_config, shard_params
from ..sampling import sample_topp
from .engine import (Request, _clear_row, _DecodeTick, _merged_step, serving_cache,
                     serving_spec)


class ScheduledBatchEngine:
    """B slots planned by the native scheduler. A tick with any prefill runs
    the merged (B, pc) step eagerly; a pure-decode tick runs the decode
    step, replayed as a CUDA graph on the card (serving/engine._DecodeTick).
    Either way one on-device sample_topp over the rows the tick needs and
    one (B,) readback. Runs on the model's device: the card unless the
    model was made with device="cpu".

    With `mesh`, model.params is the global tree; the engine keeps this
    rank's shards of it (parallel.shard_params, on the model's device) and
    leaves the model as it was; batch_slots must divide over `data`."""

    def __init__(
        self,
        model,
        batch_slots: int = 4,
        max_prompt: int = 512,
        budget: int = 200,
        kv_policy: str = "roco",
        temperature: float = 1.0,
        top_p: float = 1.0,
        eos_token_ids: Tuple[int, ...] = (),
        prefill_chunk: int = 128,
        seed: int = 0,
        mesh=None,
        mesh_config: MeshConfig = None,
    ):
        self.model = model
        self.cfg: ModelConfig = model.cfg
        self.device = model.device
        self.B = batch_slots
        self.params = model.params
        self.mesh, self.tp, self.row0, self.Bl, self.rows = mesh, None, 0, batch_slots, None
        if mesh is not None:
            mc = mesh_config or MeshConfig(mesh.shape.get("data", 1), mesh.shape.get("model", 1))
            self.row0, self.Bl = rows_of(mesh, mc.axis_data, batch_slots)
            if mesh.size > 1:
                self.tp = (mesh, mc.axis_data, mc.axis_model)
                self.rows = (self.row0, batch_slots)
            self.params = shard_params(model.params, model.cfg, mc, mesh, device=model.device)
            self.cfg = local_config(model.cfg, mc)
        self.max_prompt = max_prompt
        self.budget = budget
        self.pc = min(prefill_chunk, max_prompt)
        self.eos = tuple(eos_token_ids)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.spec = serving_spec(kv_policy, budget)
        self.cache = serving_cache(model, self.Bl, max_prompt, budget, self.cfg)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.decode_tick = _DecodeTick(self)
        # chunk_cap = pc: a request prefills at most one chunk a tick, but up
        # to B requests may do so in the same tick, in one merged dispatch
        self.sched = NativeScheduler(batch_slots, batch_slots * self.pc, chunk_cap=self.pc)
        self.requests: Dict[int, Request] = {}
        self.ids_pad: Dict[int, np.ndarray] = {}
        self.prompt_len = np.zeros(self.B, np.int32)
        self.gen_count = np.zeros(self.B, np.int32)
        self.next_token = np.full(self.B, -1, np.int32)
        self.has_token = np.zeros(self.B, bool)
        self.finished: Dict[int, Request] = {}

    def _pad(self, ids: np.ndarray) -> np.ndarray:
        """The prompt padded by one pc more than its chunks: a scheduler
        window may start mid-chunk, so any start in [0, T) slices a full
        pc-wide window."""
        n_chunks = (len(ids) + self.pc - 1) // self.pc
        pad = np.zeros((max(n_chunks, 1) + 1) * self.pc, np.int32)
        pad[:len(ids)] = ids
        return pad

    def submit(self, req: Request) -> None:
        if len(req.ids) > self.max_prompt:
            raise ValueError(f"prompt of {len(req.ids)} tokens exceeds max_prompt {self.max_prompt}")
        self.requests[req.request_id] = req
        self.ids_pad[req.request_id] = self._pad(np.asarray(req.ids, np.int32))
        self.sched.submit(req.request_id, len(req.ids), req.max_new_tokens)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """This rank's rows of a host (B, ...) array, on the device."""
        arr = arr[self.row0:self.row0 + self.Bl]
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _merged_tick(self, prefills, active: np.ndarray) -> Tuple[np.ndarray, list]:
        """The merged (B, pc) step of a tick with prefills: returns the
        sampled (B,) tokens and the prefills that finished their prompt, each
        with its last row."""
        tokens = np.zeros((self.B, self.pc), np.int32)
        start = np.zeros(self.B, np.int32)
        limit = np.zeros(self.B, np.int32)
        is_decode = active.copy()
        act = active.copy()
        for a in prefills:
            tokens[a.slot] = self.ids_pad[a.request_id][a.chunk_start:a.chunk_start + self.pc]
            start[a.slot] = a.chunk_start
            limit[a.slot] = a.chunk_start + a.chunk_len
            self.prompt_len[a.slot] = len(self.requests[a.request_id].ids)
            act[a.slot] = True
        tokens[:, self.pc - 1] = np.where(is_decode, self.next_token, tokens[:, self.pc - 1])
        # the logit row each slot needs: a decode row's last column, a
        # finishing prefill's final real token
        last_idx = np.where(is_decode, self.pc - 1, 0).astype(np.int64)
        finishing = []
        for a in prefills:
            T = len(self.requests[a.request_id].ids)
            li = T - 1 - a.chunk_start
            if T <= a.chunk_start + a.chunk_len and 0 <= li < self.pc:
                last_idx[a.slot] = li
                finishing.append(a)
        logits = _merged_step(self.cfg, self.spec, self.budget, self.pc, self.params,
                              self.cache, self._dev(tokens), self._dev(start), self._dev(limit),
                              self._dev(self.prompt_len), self._dev(self.gen_count),
                              self._dev(is_decode), self._dev(act), self.generator, self.rows)
        rows = logits[torch.arange(self.Bl, device=self.device), self._dev(last_idx)]
        toks = sample_topp(self.generator, rows, self.temperature, self.top_p, rows=self.rows)
        if self.tp is not None:
            toks = all_gather_cat(toks, self.tp[0], self.tp[1], dim=0)
        return toks.cpu().numpy(), finishing

    def tick(self) -> List[Tuple[int, int]]:
        """One scheduler tick in one device dispatch: the merged step when
        the plan holds a prefill, else the decode tick. Returns the
        [(request_id, token), ...] emitted."""
        with flags.mesh_scope(self.tp):
            return self._tick()

    def _tick(self) -> List[Tuple[int, int]]:
        plan = self.sched.plan()
        emitted: List[Tuple[int, int]] = []
        prefills = [a for a in plan if a.kind == PREFILL_CHUNK]
        decode_live = [a for a in plan if a.kind == DECODE and a.request_id in self.requests
                       and self.has_token[self.sched.slot_of(a.request_id)]]
        if not prefills and not decode_live:
            return emitted
        active = np.zeros(self.B, bool)
        for a in decode_live:
            active[self.sched.slot_of(a.request_id)] = True

        if prefills:
            toks, finishing = self._merged_tick(prefills, active)
            for a in prefills:
                self.sched.report_prefill(a.request_id, a.chunk_len)
            for a in finishing:
                # prompt fully consumed: emit the first sampled token
                tok = int(toks[a.slot])
                self.gen_count[a.slot] = 0
                self.next_token[a.slot] = tok
                self.has_token[a.slot] = True
                self.requests[a.request_id].out.append(tok)
                emitted.append((a.request_id, tok))
                self._check_done(a.request_id, a.slot, tok)
        else:
            toks = self.decode_tick(self.next_token, active, self.prompt_len, self.gen_count)

        for a in decode_live:
            rid = a.request_id
            slot = self.sched.slot_of(rid)
            self.gen_count[slot] += 1
            tok = int(toks[slot])
            self.next_token[slot] = tok
            self.requests[rid].out.append(tok)
            emitted.append((rid, tok))
            self._check_done(rid, slot, tok)
        return emitted

    def _check_done(self, rid: int, slot: int, tok: int) -> bool:
        done = self.sched.report_token(rid, is_eos=bool(self.eos and tok in self.eos))
        if done:
            req = self.requests.pop(rid)
            req.done = True
            self.finished[rid] = req
            self.ids_pad.pop(rid, None)
            self.has_token[slot] = False
            if self.row0 <= slot < self.row0 + self.Bl:    # this rank's slot
                _clear_row(self.cache, slot - self.row0)
        return done

    def run_all(self, checkpoint_path: str = None,
                checkpoint_every: int = 0) -> Dict[int, List[int]]:
        """Drain the queue. With checkpoint_path and checkpoint_every = N, a
        snapshot is written every N ticks: a crashed server resumes its
        requests in flight with ScheduledBatchEngine.resume()."""
        n = 0
        while self.requests or self.sched.num_waiting:
            if not self.tick() and not self.sched.num_waiting and not self.requests:
                break
            n += 1
            if checkpoint_path and checkpoint_every and n % checkpoint_every == 0:
                self.snapshot(checkpoint_path)
        return {rid: r.out for rid, r in self.finished.items()}

    # -- failure recovery: snapshot / resume ---------------------------------

    def snapshot(self, path: str) -> None:
        """Write everything a resumed engine needs: the cache arrays (as CPU
        tensors: numpy has no bfloat16), the host bookkeeping, the sampling
        generator's state and the scheduler's rows (sched_dump), pickled to
        one file through a .tmp file and a rename. Under a multi-rank mesh
        `path` is a directory (the JAX package's Orbax layout, written with
        plain files): `cache-rank{r}.pt` each rank's shard, `host.pkl` the
        host state, written by rank 0; every rank must call it, and none
        returns before all have written."""
        if self.tp is not None:
            os.makedirs(path, exist_ok=True)
            self._write(os.path.join(path, f"cache-rank{self.mesh.rank}.pt"),
                        torch.save, self._cache_cpu())
            if self.mesh.rank == 0:
                self._write(os.path.join(path, "host.pkl"), pickle.dump, self._host_state())
            barrier(self.mesh)
            return
        self._write(path, pickle.dump, {"cache": self._cache_cpu(), **self._host_state()})

    @staticmethod
    def _write(path: str, dump, obj) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            dump(obj, f)
        os.replace(tmp, path)

    def _cache_cpu(self) -> list:
        return [None if x is None else x.cpu()
                for x in (getattr(self.cache, f.name) for f in dataclasses.fields(KVCache))]

    def _host_state(self) -> dict:
        def reqs(table):
            return {rid: (np.asarray(r.ids), r.max_new_tokens, list(r.out))
                    for rid, r in table.items()}
        return {
            "generator": self.generator.get_state(),
            "prompt_len": self.prompt_len.copy(),
            "gen_count": self.gen_count.copy(),
            "next_token": self.next_token.copy(),
            "has_token": self.has_token.copy(),
            "sched_rows": self.sched.dump(),
            "requests": reqs(self.requests),
            "finished": reqs(self.finished),
        }

    @classmethod
    def resume(cls, path: str, model, **engine_kwargs) -> "ScheduledBatchEngine":
        """An engine (the crashed one's constructor arguments) rebuilt from a
        snapshot(): the saved arrays are copied into its cache in place, and
        the requests in flight keep their slots, prefill progress, emitted
        tokens and cache contents; waiting requests keep their order. A
        directory snapshot (a multi-rank mesh: pass the same mesh) is read by
        each rank: its own cache shard and the shared host state."""
        eng = cls(model, **engine_kwargs)
        if os.path.isdir(path):
            with open(os.path.join(path, "host.pkl"), "rb") as f:
                state = pickle.load(f)
            state["cache"] = torch.load(os.path.join(path, f"cache-rank{eng.mesh.rank}.pt"))
        else:
            with open(path, "rb") as f:
                state = pickle.load(f)
        for field, saved in zip(dataclasses.fields(KVCache), state["cache"]):
            dst = getattr(eng.cache, field.name)
            if (dst is None) != (saved is None) or (dst is not None and dst.shape != saved.shape):
                raise ValueError(f"snapshot cache array {field.name} does not fit this engine")
            if dst is not None:
                dst.copy_(saved)
        eng.generator.set_state(state["generator"])
        eng.prompt_len = state["prompt_len"]
        eng.gen_count = state["gen_count"]
        eng.next_token = state["next_token"]
        eng.has_token = state["has_token"]
        for rid, (ids, mx, out) in state["requests"].items():
            eng.requests[rid] = Request(request_id=rid, ids=ids, max_new_tokens=mx, out=out)
            eng.ids_pad[rid] = eng._pad(np.asarray(ids, np.int32))
        for rid, (ids, mx, out) in state["finished"].items():
            eng.finished[rid] = Request(request_id=rid, ids=ids, max_new_tokens=mx, out=out,
                                        done=True)
        for row in state["sched_rows"]:
            eng.sched.restore(row)
        return eng
