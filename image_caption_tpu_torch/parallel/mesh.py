"""The device mesh of the port: data and tensor parallelism over
torch.distributed.

The counterpart of the JAX package's ``parallel/mesh.py``.  Its mesh has
three named axes; the port implements two:

  * ``data``: the global batch splits into contiguous row blocks, one per
    data index, as ``data_sharding`` splits it (rows ``[i·B/D, (i+1)·B/D)``
    on data index ``i``).  Inside a process group the axis spans the
    processes, one device each (``make_mesh``); in one process it spans
    the local devices given to it, for batch-parallel extraction and
    decode with a replica of the parameters per device;
  * ``model``: tensor parallelism (``parallel/tensor.py``).  Inside a
    process group of ``data × model`` ranks, rank ``r`` holds data index
    ``r // model`` and model index ``r % model``, the order of the JAX
    package's ``devices.reshape(data, model, sequence)``; the ranks of one
    data index (a model group) hold the same rows and one slice each of
    the sharded parameters.  In one process a model axis only replicates:
    decode runs each data index's rows once, on replicated parameters;
  * ``sequence``: sequence parallelism is the last module to port
    (ROADMAP.md §1); a size above 1 raises ``NotImplementedError`` rather
    than running with the axis ignored.

Where XLA inserts the collectives of the JAX step, the port calls them
here, over the data group (the ranks of one model index): ``global_mean``
forms a loss over every data index's rows, ``all_reduce_grads`` sums the
gradients, flat, before the update, and ``gather_rows`` all-gathers small
host operands (tokens, samples, captions), which the JAX package gathers
with ``multihost_utils.process_allgather``.  ``broadcast_params`` makes
rank 0's weights everyone's, before the model is sharded.  The model
group's collectives are ``parallel/tensor.py``'s.
"""

from __future__ import annotations

import copy
import functools
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.tree import tree_map, tree_stack
from . import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"

_NEXT_SLICE = ("is the last module of the port still to come (ROADMAP.md "
               "§1: the sequence axis); this port implements the data and "
               "model axes")
_LAUNCH = ("tensor parallelism runs one process per device: torchrun "
           "--nproc-per-node N -m image_caption_tpu_torch.main --distributed "
           "--set train.model_axis=K train")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``data × model`` mesh; this process drives ``devices`` (in one
    process every device, data index major), the first at data index
    ``offset``.  ``group`` is the whole process group when the mesh spans
    processes, else None; ``data_group`` then holds the ranks of this
    rank's model index, and ``model_group`` (with ``model > 1``) the ranks
    of its data index, at model index ``model_index``."""
    devices: Tuple[torch.device, ...]
    data: int
    offset: int = 0
    group: Optional[dist.ProcessGroup] = None
    model: int = 1
    model_index: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model,
                SEQUENCE_AXIS: 1}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def is_main(self) -> bool:
        """This process holds data and model index 0: the one that
        writes."""
        return self.offset == 0 and self.model_index == 0

    @functools.cached_property
    def over_data(self) -> "Mesh":
        """The mesh that runs each data index once: in one process the
        devices of model index 0, with the model axis folded away (its
        other devices would repeat the same rows on the same replicated
        parameters); in a process group this mesh, whose rows are its data
        index's."""
        if self.group is not None or self.model == 1:
            return self
        return replace(self, devices=self.devices[::self.model], model=1)

    def row_blocks(self, rows: int) -> List[slice]:
        """The rows of a global batch of ``rows`` that each of this
        process's devices holds: the block of its data index."""
        if rows % self.data:
            raise ValueError(f"batch {rows} not divisible by data axis "
                             f"{self.data}")
        per = rows // self.data
        return [slice(i * per, (i + 1) * per)
                for i in (self.offset + j // self.model
                          for j in range(len(self.devices)))]


def _normalize(device) -> torch.device:
    """``cuda`` names the current card explicitly, as tensors name it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _groups(data: int, model: int):
    """(data group, model group) of this rank: every rank makes every
    group, in the same order, as ``dist.new_group`` requires."""
    rank = distributed.rank()
    mine = {}
    for i in range(model):
        g = dist.new_group([d * model + i for d in range(data)])
        if rank % model == i:
            mine["data"] = g
    for d in range(data):
        g = dist.new_group([d * model + i for i in range(model)])
        if rank // model == d:
            mine["model"] = g
    return mine["data"], mine["model"]


def make_mesh(devices: Optional[Sequence] = None, data: int = -1,
              model: int = 1, sequence: int = 1) -> Mesh:
    """A (data, model, sequence) mesh.  Inside a process group the mesh
    spans the processes, and ``devices`` is this process's one device
    (``parallel.distributed.device`` of it: None or "cuda" is the rank's
    card).  In one process it spans ``devices`` (None in it is the card),
    or every local card when ``devices`` is None; without a card either
    raises.  ``data=-1`` takes every remaining device; the axis sizes must
    multiply to the device count, as the JAX package asserts.  A model
    axis that one process cannot build raises ``ValueError`` naming the
    launch that builds it."""
    if sequence > 1:
        raise NotImplementedError(f"a {SEQUENCE_AXIS} axis of {sequence} "
                                  f"{_NEXT_SLICE}")
    in_group = distributed.is_initialized()
    if in_group:
        if devices is not None and len(devices) != 1:
            raise ValueError("inside a process group each process drives "
                             f"one device, not {len(devices)}")
        devs = [distributed.device(None if devices is None else devices[0])]
        n = distributed.world_size()
    else:
        if devices is None:
            resolve_device(None)                 # raises without a card
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = [resolve_device(d) for d in devices]
        n = len(devs)
    hint = "" if in_group or model == 1 else f"; {_LAUNCH}"
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices do not divide into model {model}"
                             f" x sequence {sequence}{hint}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model}x{sequence} != {n} "
                         f"devices{hint}")
    devs = tuple(_normalize(d) for d in devs)
    if not in_group:
        return Mesh(devs, data, model=model)
    rank = distributed.rank()
    if model == 1:
        return Mesh(devs, data, rank, dist.group.WORLD,
                    data_group=dist.group.WORLD)
    data_group, model_group = _groups(data, model)
    return Mesh(devs, data, rank // model, dist.group.WORLD, model,
                rank % model, data_group, model_group)


def shard_batch(mesh: Mesh, batch) -> List:
    """One block of ``batch`` (nested tuples, lists or dicts of arrays or
    tensors with the batch first) per device of this process: the rows of
    its data index.  Every process reads the same global batch, as every
    JAX host does, and keeps its own rows; a batch that does not divide by
    the data axis raises."""
    def rows(i):
        return tree_map(lambda x: x[mesh.row_blocks(x.shape[0])[i]], batch)
    return [rows(i) for i in range(len(mesh.devices))]


def shard_batch_stacked(mesh: Mesh, batches: Sequence) -> List:
    """K same-shape host batches stacked into ``[K, B, ...]`` leaves, of
    which each device of this process keeps the rows of its data index on
    dim 1: the counterpart of the JAX package's ``shard_batch_stacked``,
    the input of K updates in one dispatch, copied to the device once a
    leaf rather than once a step."""
    stacked = tree_stack(batches)

    def rows(i):
        return tree_map(lambda x: x[:, mesh.row_blocks(x.shape[1])[i]],
                        stacked)
    return [rows(i) for i in range(len(mesh.devices))]


def all_gather(group: dist.ProcessGroup, t: torch.Tensor,
               device: torch.device) -> List[torch.Tensor]:
    """Every rank of ``group``'s ``t``, in rank order, on ``t``'s device.
    NCCL gathers on ``device`` (this rank's card); gloo gathers on the
    host, where it gathers any tensor (it all-gathers no CUDA tensor)."""
    if dist.get_backend(group) == "nccl":
        work = t.to(device)
    else:
        work = t.cpu()
    out = [torch.empty_like(work) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, work.contiguous(), group=group)
    return [o.to(t.device) for o in out]


def gather_rows(mesh: Optional[Mesh], local: np.ndarray, *,
                world: bool = False) -> np.ndarray:
    """Every data index's rows of a host array, concatenated in data-axis
    order, from the ranks of this rank's data group: the counterpart of
    the JAX package's ``_gather_global_rows``, for small operands only.
    ``world`` gathers one entry from every rank instead (a check that all
    ranks agree).  ``local`` already holds every row outside a process
    group."""
    if mesh is None or mesh.group is None:
        return local
    group = mesh.group if world else mesh.data_group
    if dist.get_world_size(group) == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local))
    return torch.cat(all_gather(group, t, mesh.devices[0])).numpy()


# one (source params, mesh) -> per-device copies entry per parameter set;
# strong references to both keys keep their id()s from being reused while
# cached.  Capacity 2 with LRU refresh: serving holds two sets live at once
# (extractor and captioner), and a third set used now and then must evict
# the stale entry, not a hot one.
_REPLICATED_CACHE: dict = {}
_REPLICATED_CAPACITY = 2


def _place(params, device: torch.device):
    """``params`` on ``device``: itself where it lies there already, else
    a copy (a module is deep-copied, as ``Module.to`` moves in place)."""
    if isinstance(params, torch.nn.Module):
        if next(params.parameters()).device == device:
            return params
        return copy.deepcopy(params).to(device)
    return params.to(device)


def replicate_cached(mesh: Mesh, params) -> List:
    """One copy of ``params`` (a module, or parameters with ``.to``) per
    device of this process, made once and reused: a hot loop (extraction
    or decode per batch) must not copy the weights on every call."""
    key = (id(params), id(mesh))
    hit = _REPLICATED_CACHE.get(key)
    if hit is not None:
        _REPLICATED_CACHE[key] = _REPLICATED_CACHE.pop(key)
        return hit[2]
    out = [_place(params, d) for d in mesh.devices]
    while len(_REPLICATED_CACHE) >= _REPLICATED_CAPACITY:
        _REPLICATED_CACHE.pop(next(iter(_REPLICATED_CACHE)))
    _REPLICATED_CACHE[key] = (params, mesh, out)
    return out


def decode_placement(mesh: Optional[Mesh], params, batch_size: int):
    """Placement for batch-parallel decode: ``(replicas, place)``, where
    ``place(x)`` gives this process's blocks of a batch on its devices and
    ``replicas`` the parameters for each; or ``(params, None)`` when the
    mesh cannot shard it (no mesh, one device, or a batch that does not
    divide by the data axis).  Shared by ``serve.decode_split`` and
    ``serve.caption_images`` so the rule cannot drift between them.  Rows
    shard over the data axis only, on replicated parameters, as in the JAX
    package: in one process each data index's rows run once
    (``Mesh.over_data``); in a process group every rank of a model group
    decodes the same rows, and the parameters stay where they are (the
    trainer's full replica, or the checkpoint's model, on this rank's
    device)."""
    if (mesh is None or mesh.size <= 1
            or batch_size % mesh.shape[DATA_AXIS] != 0):
        return params, None
    mesh = mesh.over_data
    replicas = ([params] if mesh.group is not None
                else replicate_cached(mesh, params))

    def place(x) -> List[torch.Tensor]:
        return [torch.as_tensor(blk).to(d, non_blocking=True)
                for blk, d in zip(shard_batch(mesh, x), mesh.devices)]
    return replicas, place


# ---------------------------------------------------------------------------
# Collectives of the data axis
# ---------------------------------------------------------------------------

def global_mean(total: torch.Tensor, count: Union[torch.Tensor, int],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``sum(total) / sum(count)`` over every data index, where each rank
    passes the sum and the count of its own rows (a tensor, or a host number,
    which reaches the device only under a process group).  The value is
    the global mean on every rank; the gradient flows through this rank's
    ``total`` alone, scaled by the global count, so the ranks' gradients
    sum to the gradient of the global mean.  A function applied to the
    result (the focal loss) is then differentiated at the global value, as
    the JAX step, which computes one function of the whole batch, does."""
    if mesh is None or mesh.group is None:
        return total / (count.clamp_min(1.0) if torch.is_tensor(count)
                         else max(count, 1))
    stats = torch.stack([total.detach(), torch.as_tensor(
        count, device=total.device).detach().to(total.dtype)])
    dist.all_reduce(stats, group=mesh.data_group)
    return (stats[0] + (total - total.detach())) / stats[1].clamp_min(1.0)


def _flat_collective(mesh: Mesh, tensors: Sequence[torch.Tensor],
                     op) -> None:
    """Apply the in-place collective ``op(flat)`` to ``tensors`` through
    one flat buffer a dtype, in a fixed order, writing the results back
    (one multi-tensor copy a dtype)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for run in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in run])
        op(flat)
        parts = flat.split([t.numel() for t in run])
        torch._foreach_copy_(run, [p.view_as(t) for p, t in zip(parts, run)])


def all_reduce_grads(mesh: Optional[Mesh],
                     params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients over the data group, in place,
    through one flat buffer a dtype.  Every rank of it then holds the same
    bits, so the same update keeps their weights (or their shards of the
    weights) bitwise equal."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat_collective(mesh, grads, lambda flat: dist.all_reduce(
        flat, group=mesh.data_group))


@torch.no_grad()
def broadcast_params(mesh: Optional[Mesh], module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank, over the whole
    process group: a full model, before ``parallel.tensor.shard_model``."""
    if mesh is None or mesh.group is None:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    _flat_collective(mesh, tensors, lambda flat: dist.broadcast(
        flat, src=0, group=mesh.group))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every process of the mesh."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)
