"""The device mesh of the port: data, tensor and sequence parallelism
over torch.distributed.

The counterpart of the JAX package's ``parallel/mesh.py``, with its three
named axes:

  * ``data``: the global batch splits into contiguous row blocks, one per
    data index, as ``data_sharding`` splits it (rows ``[i·B/D, (i+1)·B/D)``
    on data index ``i``).  Inside a process group the axis spans the
    processes, one device each (``make_mesh``); in one process it spans
    the local devices given to it, for batch-parallel extraction and
    decode with a replica of the parameters per device;
  * ``model``: tensor parallelism (``parallel/tensor.py``): the ranks of
    a model group hold the same rows and one slice each of the sharded
    parameters;
  * ``sequence``: sequence parallelism (``parallel/sequence.py``): the
    ranks of a sequence group hold the same rows and one contiguous block
    each of the object slots, as ``activation_sharding`` places them
    (every slot where the axis does not divide them), and the encoder runs
    on its block.

Inside a process group of ``data × model × sequence`` ranks, rank ``r``
holds sequence index ``r % sequence``, model index ``(r // sequence) %
model`` and data index ``r // (model · sequence)``: the order of the JAX
package's ``devices.reshape(data, model, sequence)``.  In one process the
model and sequence axes only replicate: decode and extraction run each
data index's rows once (``Mesh.over_data``), and a trainer refuses such a
mesh.

Where XLA inserts the collectives of the JAX step, the port calls them
here, over two groups named by their role:

  * the **reduce group** (the ranks of this rank's model index: every data
    and sequence index) sums the gradients and the losses:
    ``global_mean`` forms a loss over every rank's rows, counting each
    data index's rows once per sequence index, and ``all_reduce_grads``
    sums the gradients, flat, before the update (the gradient rule of
    ``parallel/sequence.py``);
  * the **row group** (the ranks of this rank's model and sequence index:
    one per data index) gathers rows: ``gather_rows`` all-gathers small
    host operands (tokens, samples, captions), which the JAX package
    gathers with ``multihost_utils.process_allgather``.

Without a sequence axis the two are one group, the data group.
``broadcast_params`` makes rank 0's weights everyone's, before the model
is sharded.  The model and sequence groups' collectives are
``parallel/tensor.py``'s and ``parallel/sequence.py``'s.
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

_LAUNCH = ("tensor and sequence parallelism run one process per device: "
           "torchrun --nproc-per-node N -m image_caption_tpu_torch.main "
           "--distributed --set train.model_axis=K train")


@dataclass(frozen=True, eq=False)
class Mesh:
    """A ``data × model × sequence`` mesh; this process drives ``devices``
    (in one process every device, in the order of the JAX package's
    ``reshape(data, model, sequence)``), the first at data index
    ``offset``, model index ``model_index`` and sequence index
    ``sequence_index``.  ``group`` is the whole process group when the
    mesh spans processes, else None; ``reduce_group`` then holds the ranks
    of this rank's model index, ``row_group`` those of its model and
    sequence index, ``model_group`` (with ``model > 1``) those of its data
    and sequence index, and ``sequence_group`` (with ``sequence > 1``)
    those of its data and model index."""
    devices: Tuple[torch.device, ...]
    data: int
    offset: int = 0
    group: Optional[dist.ProcessGroup] = None
    model: int = 1
    model_index: int = 0
    reduce_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    sequence: int = 1
    sequence_index: int = 0
    row_group: Optional[dist.ProcessGroup] = None
    sequence_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model,
                SEQUENCE_AXIS: self.sequence}

    @property
    def size(self) -> int:
        return self.data * self.model * self.sequence

    @property
    def is_main(self) -> bool:
        """This process holds data, model and sequence index 0: the one
        that writes."""
        return (self.offset == 0 and self.model_index == 0
                and self.sequence_index == 0)

    @functools.cached_property
    def over_data(self) -> "Mesh":
        """The mesh that runs each data index once: in one process the
        devices of model and sequence index 0, with both axes folded away
        (the other devices would repeat the same rows on the same
        replicated parameters); in a process group this mesh, whose rows
        are its data index's."""
        folded = self.model * self.sequence
        if self.group is not None or folded == 1:
            return self
        return replace(self, devices=self.devices[::folded], model=1,
                       sequence=1)

    def coords(self) -> List[Tuple[int, int, int]]:
        """The (data, model, sequence) index of each of this process's
        devices."""
        m, s = self.model, self.sequence
        first = (self.offset * m + self.model_index) * s + self.sequence_index
        return [((first + j) // (m * s), (first + j) // s % m, (first + j) % s)
                for j in range(len(self.devices))]

    def row_blocks(self, rows: int) -> List[slice]:
        """The rows of a global batch of ``rows`` that each of this
        process's devices holds: the block of its data index."""
        if rows % self.data:
            raise ValueError(f"batch {rows} not divisible by data axis "
                             f"{self.data}")
        per = rows // self.data
        return [slice(d * per, (d + 1) * per) for d, _, _ in self.coords()]

    def slot_blocks(self, slots: int) -> Optional[List[slice]]:
        """The object slots that each of this process's devices holds: the
        contiguous block of its sequence index; None when there is no
        sequence axis or it does not divide ``slots`` (every device then
        holds every slot, as ``activation_sharding`` falls back)."""
        if self.sequence == 1 or slots % self.sequence:
            return None
        per = slots // self.sequence
        return [slice(s * per, (s + 1) * per) for _, _, s in self.coords()]


def _normalize(device) -> torch.device:
    """``cuda`` names the current card explicitly, as tensors name it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _groups(data: int, model: int, sequence: int) -> Dict[str, object]:
    """This rank's reduce, row, model and sequence groups (the last two
    None at size 1): every rank makes every group, in the same order, as
    ``dist.new_group`` requires.  Rank ``(d·model + m)·sequence + s``
    holds data index d, model index m and sequence index s."""
    coords = [(d, m, s) for d in range(data) for m in range(model)
              for s in range(sequence)]
    mine = coords[distributed.rank()]
    # each role's group holds the ranks equal to this one on some axes
    # (0 data, 1 model, 2 sequence)
    roles = {"reduce": (1,), "row": (1, 2)}
    if model > 1:
        roles["model"] = (0, 2)
    if sequence > 1:
        roles["sequence"] = (0, 1)
    out: Dict[str, object] = {"model": None, "sequence": None}
    for role, axes in roles.items():
        groups: Dict[tuple, List[int]] = {}
        for r, c in enumerate(coords):
            groups.setdefault(tuple(c[a] for a in axes), []).append(r)
        for key, ranks in groups.items():
            g = dist.new_group(ranks)
            if key == tuple(mine[a] for a in axes):
                out[role] = g
    return out


def make_mesh(devices: Optional[Sequence] = None, data: int = -1,
              model: int = 1, sequence: int = 1) -> Mesh:
    """A (data, model, sequence) mesh.  Inside a process group the mesh
    spans the processes, and ``devices`` is this process's one device
    (``parallel.distributed.device`` of it: None or "cuda" is the rank's
    card).  In one process it spans ``devices`` (None in it is the card),
    or every local card when ``devices`` is None; without a card either
    raises.  ``data=-1`` takes every remaining device; the axis sizes must
    multiply to the device count, as the JAX package asserts.  A model or
    sequence axis that one process cannot build raises ``ValueError``
    naming the launch that builds it."""
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
    hint = "" if in_group or model * sequence == 1 else f"; {_LAUNCH}"
    if data == -1:
        if n % (model * sequence):
            raise ValueError(f"{n} devices do not divide into model {model}"
                             f" x sequence {sequence}{hint}")
        data = n // (model * sequence)
    if data * model * sequence != n:
        raise ValueError(f"mesh {data}x{model}x{sequence} != {n} "
                         f"devices{hint}")
    devs = tuple(_normalize(d) for d in devs)
    if not in_group:
        return Mesh(devs, data, model=model, sequence=sequence)
    rank = distributed.rank()
    world = dist.group.WORLD
    if model == 1 and sequence == 1:
        return Mesh(devs, data, rank, world, reduce_group=world,
                    row_group=world)
    g = _groups(data, model, sequence)
    return Mesh(devs, data, rank // (model * sequence), world, model,
                rank // sequence % model, g["reduce"], g["model"], sequence,
                rank % sequence, g["row"], g["sequence"])


def _block(mesh: Mesh, x, i: int, dim: int, num_slots: Optional[int]):
    """Device ``i``'s block of leaf ``x`` whose batch dim is ``dim``: the
    rows of its data index, and, for a leaf of rank >= ``dim`` + 3 whose
    next dim holds ``num_slots`` slots, the slots of its sequence index
    where the axis divides them (``activation_sharding``'s rule)."""
    idx = [slice(None)] * dim + [mesh.row_blocks(x.shape[dim])[i]]
    if (num_slots is not None and x.ndim >= dim + 3
            and x.shape[dim + 1] == num_slots):
        slots = mesh.slot_blocks(num_slots)
        if slots is not None:
            idx.append(slots[i])
    return x[tuple(idx)]


def shard_batch(mesh: Mesh, batch, num_slots: Optional[int] = None) -> List:
    """One block of ``batch`` (nested tuples, lists or dicts of arrays or
    tensors with the batch first) per device of this process: the rows of
    its data index.  ``num_slots`` names the [B, S, ...] activations: a
    leaf of rank >= 3 whose dim 1 is ``num_slots`` also keeps the
    contiguous slot block of the device's sequence index, when the
    sequence axis divides it (else every slot, as the JAX package's
    ``activation_sharding`` falls back); None places every leaf by data
    index only.  Every process reads the same global batch, as every JAX
    host does, and keeps its own block; a batch that does not divide by
    the data axis raises."""
    return [tree_map(lambda x: _block(mesh, x, i, 0, num_slots), batch)
            for i in range(len(mesh.devices))]


def shard_batch_stacked(mesh: Mesh, batches: Sequence,
                        num_slots: Optional[int] = None) -> List:
    """K same-shape host batches stacked into ``[K, B, ...]`` leaves, of
    which each device of this process keeps the block ``shard_batch``
    gives it, one dim to the right (a leaf of rank >= 4 whose dim 2 is
    ``num_slots`` keeps its slot block): the counterpart of the JAX
    package's ``shard_batch_stacked``, the input of K updates in one
    dispatch, copied to the device once a leaf rather than once a step."""
    stacked = tree_stack(batches)
    return [tree_map(lambda x: _block(mesh, x, i, 1, num_slots), stacked)
            for i in range(len(mesh.devices))]


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


def all_reduce(group: dist.ProcessGroup, t: torch.Tensor,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of every rank of ``group``'s ``t``, as a new tensor
    on ``t``'s device (gloo reduces a CUDA tensor through the host)."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def gather_rows(mesh: Optional[Mesh], local: np.ndarray, *,
                world: bool = False) -> np.ndarray:
    """Every data index's rows of a host array, concatenated in data-axis
    order, from the ranks of this rank's row group: the counterpart of
    the JAX package's ``_gather_global_rows``, for small operands only.
    ``world`` gathers one entry from every rank instead (a check that all
    ranks agree).  ``local`` already holds every row outside a process
    group."""
    if mesh is None or mesh.group is None:
        return local
    group = mesh.group if world else mesh.row_group
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
    (``Mesh.over_data``); in a process group every rank of a model or
    sequence group decodes the same rows, on every slot, and the
    parameters stay where they are (the
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
# Collectives of the reduce group
# ---------------------------------------------------------------------------

def global_mean(total: torch.Tensor, count: Union[torch.Tensor, int],
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``sum(total) / sum(count)`` over the reduce group, where each rank
    passes the sum and the count of its own rows (a tensor, or a host number,
    which reaches the device only under a process group).  The value is
    the global mean on every rank (the ranks of a sequence group pass the
    same rows, so each data index counts once per sequence index, in both
    sums); the gradient flows through this rank's ``total`` alone, scaled
    by the summed count, so the reduce group's gradients sum to the
    gradient of the global mean.  A function applied to the
    result (the focal loss) is then differentiated at the global value, as
    the JAX step, which computes one function of the whole batch, does."""
    if mesh is None or mesh.group is None:
        return total / (count.clamp_min(1.0) if torch.is_tensor(count)
                         else max(count, 1))
    stats = torch.stack([total.detach(), torch.as_tensor(
        count, device=total.device).detach().to(total.dtype)])
    dist.all_reduce(stats, group=mesh.reduce_group)
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
    """Sum the parameters' gradients over the reduce group (every data and
    sequence index of this model index), in place, through one flat
    buffer a dtype.  Every rank of it then holds the same
    bits, so the same update keeps their weights (or their shards of the
    weights) bitwise equal."""
    if mesh is None or mesh.group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    _flat_collective(mesh, grads, lambda flat: dist.all_reduce(
        flat, group=mesh.reduce_group))


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
