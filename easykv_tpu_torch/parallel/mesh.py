"""The (data, model) device mesh and the 1-D sequence-parallel mesh over
torch.distributed (counterpart of easykv_tpu/parallel/mesh.py: make_mesh,
init_distributed; the sp mesh the JAX package builds as a 1-D jax Mesh for
flags.set_sp_mesh, and the ring ppermute of ops/ring_attention.py there).

One process per rank, each holding only its own shards, with explicit
collectives; where the JAX package lets GSPMD insert them, the port calls
them by name:

  * `data` shards the batch: each rank decodes B / data rows;
  * `model` shards attention heads, the MLP, the LM head's vocab and the
    budgeted KV ring buffer. Eviction is per (layer, kv-head), so the score
    / evict / attend loop never crosses a model shard; the collectives are
    the all-reduce after wo and after wd (row-parallel products), the
    all-gather of the vocab-sharded logits, and the all-gather of tova's
    per-head statistics for its cross-head mean in the encode phase.

Ranks map onto cards as rank % torch.cuda.device_count(), so two ranks may
share one card. NCCL refuses that ("Duplicate GPU detected"), so the caller
names the backend: gloo for ranks sharing a card (or on the CPU), NCCL for
a card each. Nothing here picks a backend or a device on its own.

Gloo runs every collective used here (all_reduce sum and min, all_gather,
broadcast, barrier) on CUDA tensors itself, staging them through the host
internally: `python3 tools/torch_mesh_probe.py --ranks 2` (and 4) checks
that on the card, as it did with torch 2.11 on one H100. Gloo collectives
cannot be captured in a CUDA graph, so under gloo the decode loop runs
eagerly (engine/generate.decode_graph_ok).

The sp mesh (SeqMesh, make_sp_mesh) has one axis over every rank of the
process group. Its one operation is ring_shift, the JAX package's ppermute
with perm [(i, (i + 1) % n)]: each rank sends its blocks to rank i + 1 and
receives rank i - 1's, through point-to-point sends (batch_isend_irecv, the
send and the receive posted together, so two ranks that are each other's
peer cannot wait on each other). Its transport (ring_transport) follows the
backend and the device: NCCL sends the device tensors themselves; gloo sends
host memory only (its point-to-point send takes a card tensor's pointer as
host memory: on one H100 with torch 2.11, isend / irecv of CUDA tensors
failed with "writev ... Bad address" and batch_isend_irecv aborted the
process; `python3 tools/torch_mesh_probe.py --p2p-only` shows it), so under
gloo a card's blocks are staged through pinned host buffers, all the blocks
of a shift packed into one buffer and sent as one message; CPU tensors go
as they are.
"""
from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig


def init_distributed(backend: str, init_method: str, world_size: int, rank: int,
                     timeout_s: float = 600.0) -> None:
    """torch.distributed's process group for `world_size` ranks (the JAX
    package's init_distributed: jax.distributed.initialize). The caller
    names the backend ("gloo" or "nccl") and the rendezvous (a `file://`
    path or `tcp://host:port`). A no-op for a single process."""
    if world_size <= 1:
        return
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: name 'gloo' or 'nccl'")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(device_type: str) -> torch.device:
    """This rank's device: the CPU, or card rank % device_count() (two ranks
    may share a card). Sets it as the current card."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device_type {device_type!r}: 'cpu' or 'cuda'")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """A (data, model) mesh of torch.distributed ranks: rank = i_data *
    model + i_model, as jax.sharding.Mesh lays out its device array.

    shape[name] is an axis's size, size the number of ranks, index(name)
    this rank's coordinate on an axis and group(name) the process group of
    the ranks that differ from this one only on that axis (None for an axis
    of size 1, or a mesh of one rank). `device` is this rank's device and
    `backend` the process group's ("gloo", "nccl"; None for one rank)."""

    def __init__(self, cfg: MeshConfig, device: torch.device, device_mesh=None):
        self.cfg = cfg
        self.axis_names = (cfg.axis_data, cfg.axis_model)
        self.shape: Dict[str, int] = {cfg.axis_data: cfg.data, cfg.axis_model: cfg.model}
        self.size = cfg.data * cfg.model
        self.device = device
        self._dm = device_mesh
        self.rank = dist.get_rank() if device_mesh is not None else 0
        self.backend = dist.get_backend() if device_mesh is not None else None
        self._index = {cfg.axis_data: self.rank // cfg.model,
                       cfg.axis_model: self.rank % cfg.model}

    def index(self, name: str) -> int:
        return self._index[name]

    def group(self, name: str):
        if self._dm is None or self.shape[name] == 1:
            return None
        return self._dm.get_group(name)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, {self.device}, "
                f"backend {self.backend})")


def make_mesh(cfg: MeshConfig, device_type: str) -> Mesh:
    """The (data, model) mesh of the current process group, whose world
    size must be cfg.data * cfg.model (a mesh of one rank needs no group).
    device_type "cuda" puts this rank on card rank % device_count(), "cpu"
    on the CPU; the backend is the process group's, chosen by its caller."""
    n = cfg.data * cfg.model
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"a {cfg.shape} mesh needs {n} ranks: call init_distributed first")
        return Mesh(cfg, rank_device(device_type))
    if dist.get_world_size() != n:
        raise ValueError(f"a {cfg.shape} mesh needs {n} ranks, the process group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    dev = rank_device(device_type)
    dm = init_device_mesh(device_type, (cfg.data, cfg.model),
                          mesh_dim_names=(cfg.axis_data, cfg.axis_model))
    return Mesh(cfg, dev, dm)


class SeqMesh:
    """The 1-D sequence-parallel mesh over every rank of the process group
    (or one process without a group), with the Mesh interface the
    collectives read: shape[axis], size, index(axis), group(axis), device,
    backend, rank; and `staging`, ring_shift's pinned host buffers by size."""

    def __init__(self, axis: str, n: int, device: torch.device, device_mesh=None):
        self.staging: Dict[Tuple[int, int], torch.Tensor] = {}
        self.axis_names = (axis,)
        self.shape: Dict[str, int] = {axis: n}
        self.size = n
        self.device = device
        self._dm = device_mesh
        self.rank = dist.get_rank() if device_mesh is not None else 0
        self.backend = dist.get_backend() if device_mesh is not None else None

    def index(self, name: str) -> int:
        return self.rank if name in self.shape else 0

    def group(self, name: str):
        if self._dm is None or self.shape[name] == 1:
            return None
        return self._dm.get_group(name)

    def __repr__(self) -> str:
        return f"SeqMesh({self.shape}, rank {self.rank}, {self.device}, backend {self.backend})"


def make_sp_mesh(device_type: str, axis: str = "sp") -> SeqMesh:
    """The sp mesh of the current process group: one axis, named `axis`,
    over all of its ranks (one rank without a group). device_type "cuda"
    puts this rank on card rank % device_count(), "cpu" on the CPU; the
    backend is the process group's, chosen by its caller."""
    if not dist.is_initialized():
        return SeqMesh(axis, 1, rank_device(device_type))
    from torch.distributed.device_mesh import init_device_mesh

    dev = rank_device(device_type)
    n = dist.get_world_size()
    dm = init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))
    return SeqMesh(axis, n, dev, dm)


def ring_transport(mesh, device: torch.device) -> str:
    """How ring_shift moves a block of `device` over `mesh`: 'nccl' (the
    device tensors), 'gloo, pinned host staging' (a card's blocks through
    pinned host buffers) or 'gloo, host tensors'."""
    if mesh.backend == "nccl":
        return "nccl"
    return "gloo, pinned host staging" if device.type == "cuda" else "gloo, host tensors"


def _staging(mesh: SeqMesh, nbytes: int, slot: int) -> torch.Tensor:
    """A pinned host byte buffer of nbytes, kept on the mesh for the next
    shift of the same size (slot 0 sends, slot 1 receives)."""
    buf = mesh.staging.get((nbytes, slot))
    if buf is None:
        buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        mesh.staging[nbytes, slot] = buf
    return buf


def ring_shift(ts: Sequence[torch.Tensor], mesh: SeqMesh,
               axis: str = "sp") -> List[torch.Tensor]:
    """Every tensor of `ts` moved one step around the ring of `axis`: rank i
    sends its own to rank (i + 1) % n and returns rank (i - 1) % n's, of the
    same shapes and dtypes (the ppermute of easykv_tpu/ops/ring_attention.py
    with perm [(i, (i + 1) % n)]). The tensors themselves over an axis of
    one rank."""
    group = mesh.group(axis)
    if group is None:
        return list(ts)
    n, i = mesh.shape[axis], mesh.index(axis)
    dst = dist.get_global_rank(group, (i + 1) % n)
    src = dist.get_global_rank(group, (i - 1) % n)
    dev = ts[0].device
    how = ring_transport(mesh, dev)
    if how == "nccl":
        srcs = [t.contiguous() for t in ts]
        outs = [torch.empty_like(t) for t in srcs]
        ops = ([dist.P2POp(dist.isend, t, dst, group) for t in srcs]
               + [dist.P2POp(dist.irecv, o, src, group) for o in outs])
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return outs
    sizes = [t.numel() * t.element_size() for t in ts]
    offs = [0]
    for nb in sizes:
        offs.append(offs[-1] + -(-nb // 16) * 16)     # each block 16-byte aligned
    if how == "gloo, host tensors":
        send = torch.empty(offs[-1], dtype=torch.uint8)
        recv = torch.empty_like(send)
    else:
        send, recv = _staging(mesh, offs[-1], 0), _staging(mesh, offs[-1], 1)
    for t, at, nb in zip(ts, offs, sizes):
        send[at:at + nb].copy_(t.contiguous().view(torch.uint8).reshape(-1))
    for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, dst, group),
                                     dist.P2POp(dist.irecv, recv, src, group)]):
        w.wait()
    got = recv.to(dev) if dev.type == "cuda" else recv
    return [got[at:at + nb].view(t.dtype).reshape(t.shape)
            for t, at, nb in zip(ts, offs, sizes)]


# ---------------------------------------------------------------------------
# collectives (each a no-op over an axis of size 1)
# ---------------------------------------------------------------------------

def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of t over `axis`, reduced in f32 and returned in t's dtype (a
    bf16 partial product is summed once, in f32, and rounded once)."""
    group = mesh.group(axis)
    if group is None:
        return t
    acc = t.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(acc, group=group)
    return acc.to(t.dtype)


def all_gather_cat(t: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of `axis` concatenated along `dim`, in axis order."""
    group = mesh.group(axis)
    if group is None:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_min(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]) -> torch.Tensor:
    """The elementwise minimum of t over every rank of `axes` (an AND of
    bools), in t's dtype."""
    acc = t.to(torch.float32, copy=True).contiguous()
    for axis in axes:
        group = mesh.group(axis)
        if group is not None:
            dist.all_reduce(acc, op=dist.ReduceOp.MIN, group=group)
    return acc.to(t.dtype)


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh reaches this point before any leaves it."""
    if mesh is not None and mesh._dm is not None:
        dist.barrier()


def rows_of(mesh: Optional[Mesh], axis: str, B: int) -> Tuple[int, int]:
    """(first row, rows) of this rank's shard of a batch of B rows over
    `axis`; B must divide evenly."""
    if mesh is None:
        return 0, B
    n = mesh.shape[axis]
    if B % n:
        raise ValueError(f"a batch of {B} rows does not shard evenly over {axis}={n}")
    per = B // n
    return mesh.index(axis) * per, per


def local_dims(name: str, mesh: Mesh, data_axis: str, model_axis: str,
               args: List[Tuple[str, Optional[torch.Tensor], tuple]]) -> None:
    """The sharded wrappers' check of their arguments, each (name, tensor or
    None, spec) with spec naming, per dimension, the mesh axis it is sharded
    over (data_axis, model_axis) or None (replicated): every tensor is this
    rank's local shard, its data-sharded dims agree, and so do its
    model-sharded dims. The global batch and kv-heads are these times the
    axes' sizes, so the shards are even by construction (uneven ones were
    refused where they were made: shard_cache, generate's rows_of)."""
    if mesh.shape.get(data_axis) is None or mesh.shape.get(model_axis) is None:
        raise ValueError(f"{name}: the mesh has axes {mesh.axis_names}, not "
                         f"({data_axis!r}, {model_axis!r})")
    seen = {data_axis: None, model_axis: None}
    for arg, t, spec in args:
        if t is None:
            continue
        if t.dim() != len(spec):
            raise ValueError(f"{name}: {arg} has {t.dim()} dims, its spec {spec} {len(spec)}")
        for size, ax in zip(t.shape, spec):
            if ax is None:
                continue
            if seen[ax] is None:
                seen[ax] = size
            elif seen[ax] != size:
                raise ValueError(f"{name}: {arg} holds {size} along {ax}, another argument "
                                 f"{seen[ax]}: not one rank's shards")
