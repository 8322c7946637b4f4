"""The device mesh of the port: data parallelism over torch.distributed.

The counterpart of the JAX package's ``parallel/mesh.py``.  Its mesh has
three named axes; the port implements the data axis:

  * ``data``: the global batch splits into contiguous row blocks, one per
    device in axis order, as ``data_sharding`` splits it (rows
    ``[i·B/D, (i+1)·B/D)`` on data index ``i``).  Inside a process group
    the axis spans the processes, one device each (``make_mesh``); in one
    process it spans the local devices given to it, for batch-parallel
    extraction and decode with a replica of the parameters per device;
  * ``model`` and ``sequence``: tensor and sequence parallelism are the
    next slice of the port (ROADMAP.md §1); a size above 1 raises
    ``NotImplementedError`` rather than running with the axis ignored.

Where XLA inserts the collectives of the JAX step, the port calls them
here: ``global_mean`` forms a loss over every rank's rows,
``all_reduce_grads`` sums the gradients, flat, before the
update, ``broadcast_params`` makes rank 0's weights everyone's, and
``gather_rows`` all-gathers small host operands (tokens, samples,
captions), which the JAX package gathers with
``multihost_utils.process_allgather``.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.tree import tree_map
from . import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQUENCE_AXIS = "sequence"

_NEXT_SLICE = ("is the next slice of the port (ROADMAP.md §1: tensor "
               "parallelism over model_axis and the sequence axis); this "
               "slice implements the data axis only")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A data axis of ``data`` devices; this process drives ``devices``,
    at data indices ``offset`` onwards.  ``group`` is the process group
    when the axis spans processes, else None."""
    devices: Tuple[torch.device, ...]
    data: int
    offset: int = 0
    group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: 1, SEQUENCE_AXIS: 1}

    @property
    def size(self) -> int:
        return self.data

    @property
    def is_main(self) -> bool:
        """This process holds data index 0: the one that writes."""
        return self.offset == 0

    def row_blocks(self, rows: int) -> List[slice]:
        """The rows of a global batch of ``rows`` that each of this
        process's devices holds, in data-axis order."""
        if rows % self.data:
            raise ValueError(f"batch {rows} not divisible by data axis "
                             f"{self.data}")
        per = rows // self.data
        return [slice(i * per, (i + 1) * per)
                for i in range(self.offset, self.offset + len(self.devices))]


def _normalize(device) -> torch.device:
    """``cuda`` names the current card explicitly, as tensors name it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(devices: Optional[Sequence] = None, data: int = -1,
              model: int = 1, sequence: int = 1) -> Mesh:
    """A (data, model, sequence) mesh.  Inside a process group the data
    axis spans the processes, and ``devices`` is this process's one device
    (``parallel.distributed.device`` of it: None or "cuda" is the rank's
    card).  In one process it spans ``devices`` (None in it is the card),
    or every local card when ``devices`` is None; without a card either
    raises.  ``data=-1`` takes every remaining device; the axis sizes must
    multiply to the device count, as the JAX package asserts."""
    for name, size in ((MODEL_AXIS, model), (SEQUENCE_AXIS, sequence)):
        if size > 1:
            raise NotImplementedError(f"a {name} axis of {size} {_NEXT_SLICE}")
    if distributed.is_initialized():
        if devices is not None and len(devices) != 1:
            raise ValueError("inside a process group each process drives "
                             f"one device, not {len(devices)}")
        devs = [distributed.device(None if devices is None else devices[0])]
        n, offset, group = (distributed.world_size(), distributed.rank(),
                            dist.group.WORLD)
    else:
        if devices is None:
            resolve_device(None)                 # raises without a card
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devs = [resolve_device(d) for d in devices]
        n, offset, group = len(devs), 0, None
    if data == -1:
        if n % (model * sequence):
            raise ValueError(f"{n} devices do not divide into model {model} "
                             f"x sequence {sequence}")
        data = n // (model * sequence)
    if data * model * sequence != n:
        raise ValueError(f"mesh {data}x{model}x{sequence} != {n} devices")
    return Mesh(tuple(_normalize(d) for d in devs), data, offset, group)


def shard_batch(mesh: Mesh, batch) -> List:
    """One block of ``batch`` (nested tuples, lists or dicts of arrays or
    tensors with the batch first) per device of this process, in
    data-axis order.  Every process reads the same global batch, as every
    JAX host does, and keeps its own rows; a batch that does not divide by
    the data axis raises."""
    def rows(i):
        return tree_map(lambda x: x[mesh.row_blocks(x.shape[0])[i]], batch)
    return [rows(i) for i in range(len(mesh.devices))]


def gather_rows(mesh: Optional[Mesh], local: np.ndarray) -> np.ndarray:
    """Every process's rows of a host array, concatenated in data-axis
    order: the counterpart of the JAX package's ``_gather_global_rows``,
    for small operands only.  ``local`` already holds every row outside a
    process group.  NCCL gathers on the card; gloo on the host, where it
    gathers any tensor."""
    if mesh is None or mesh.group is None or mesh.data == 1:
        return local
    t = torch.from_numpy(np.ascontiguousarray(local))
    if dist.get_backend(mesh.group) == "nccl":
        t = t.to(mesh.devices[0])
    out = [torch.empty_like(t) for _ in range(mesh.data)]
    dist.all_gather(out, t, group=mesh.group)
    return torch.cat(out).cpu().numpy()


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
    ``serve.caption_images`` so the rule cannot drift between them.  In a
    process group the parameters stay where they are: the trainer or
    checkpoint put them on this rank's device."""
    if (mesh is None or mesh.size <= 1
            or batch_size % mesh.shape[DATA_AXIS] != 0):
        return params, None
    replicas = ([params] if mesh.group is not None
                else replicate_cached(mesh, params))

    def place(x) -> List[torch.Tensor]:
        return [torch.as_tensor(blk).to(d, non_blocking=True)
                for blk, d in zip(shard_batch(mesh, x), mesh.devices)]
    return replicas, place


# ---------------------------------------------------------------------------
# Collectives of the data-parallel step
# ---------------------------------------------------------------------------

def global_mean(total: torch.Tensor, count: Union[torch.Tensor, int],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``sum(total) / sum(count)`` over every rank, where each rank passes
    the sum and the count of its own rows (a tensor, or a host number,
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
    dist.all_reduce(stats, group=mesh.group)
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
    """Sum the parameters' gradients over the ranks, in place, through one
    flat buffer a dtype.  Every rank then holds the same bits, so the same
    update keeps their weights bitwise equal."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat_collective(mesh, grads, lambda flat: dist.all_reduce(
        flat, group=mesh.group))


@torch.no_grad()
def broadcast_params(mesh: Optional[Mesh], module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if mesh is None or mesh.group is None:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    _flat_collective(mesh, tensors, lambda flat: dist.broadcast(
        flat, src=0, group=mesh.group))


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every process of the mesh."""
    if mesh is not None and mesh.group is not None:
        dist.barrier(group=mesh.group)
