"""Sequence parallelism over the mesh's sequence axis: the encoder on a
rank's block of the object slots.

The counterpart of the JAX package's slot sharding (``activation_sharding``
and ``batch_shardings`` in its ``parallel/mesh.py``), with the collectives
that XLA inserts there written out.  A rank of a sequence group of n holds
the slots ``[i·S/n, (i+1)·S/n)`` of its data index's rows
(``parallel.mesh.shard_batch(num_slots=)``); the parameters are whole on
every rank.

  * The encoder runs the embeddings, the norms, the FFNs and the queries
    on the rank's slots.  Each encoder block's attention gathers its input
    over the group (``SequenceShard.gather``) for the keys and values, so
    kernels #1 and #2 run with ``Lq = S/n`` queries against all S keys,
    and its mask rows are the full mask's at the block's global offsets.
  * The pair block (``split_image_objects``) pairs each of the rank's
    slots with the whole image, slot 0, broadcast from sequence index 0
    (``SequenceShard.broadcast_first``).
  * The encoder's output is gathered once before the decoder, which runs
    on the full memory and the unsharded tokens, the same on every rank
    of the group, as do ``move_first_image_feature``, the logits and the
    losses.
  * Every dropout on the rank's slots draws one process's mask of the full
    shape and keeps this rank's part (``ops.attention.dropout(parts=)``),
    so a run follows one process's dropout.

**The gradient rule.**  After a step's reduction every parameter's
gradient is one process's gradient on the global batch:

  1. every gather's backward sums the gradient over the group and keeps
     this rank's slots (the broadcast's sums it into sequence index 0);
  2. the loss is ``global_mean`` over the reduce group (every data and
     sequence index), which counts each data index's rows once per
     sequence index, so each rank's loss carries 1/n of its rows'
     gradient;
  3. the gradients are summed over the reduce group
     (``parallel.mesh.all_reduce_grads``).

The decoder's and the classifier's gradients, the same on the n ranks at
1/n each, sum to one process's.  Below the final gather each rank receives
the whole gradient of its own slots (n shares of 1/n), and the encoder's
parameters collect the share of those slots, which the sum completes.
Where the axis does not divide the slots, every rank of the group holds
every slot and runs the model whole, and rules 2 and 3 alone give the
same gradient.  With tensor parallelism the reduce group is the ranks of
one model index, and the model group's collectives run inside a rank's
slots unchanged.

Every collective raises when it fails; nothing falls back to one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from .mesh import Mesh, all_gather, all_reduce


@dataclass(frozen=True)
class SequenceShard:
    """This rank's place in its sequence group: slots ``block`` of
    ``slots``, sequence index ``index`` of ``size``."""
    group: dist.ProcessGroup
    size: int
    index: int
    device: torch.device
    slots: int

    @property
    def count(self) -> int:
        return self.slots // self.size

    @property
    def block(self) -> slice:
        return slice(self.index * self.count, (self.index + 1) * self.count)

    def part(self, dim: int) -> Tuple[int, int, int, int]:
        """The ``ops.attention.dropout`` part of a tensor whose ``dim``
        runs over this rank's slots (in runs of ``count``, one per row
        when the rows are folded into it)."""
        return (dim, self.block.start, self.count, self.slots)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S/n, ...] -> [B, S, ...]: every rank's slots in order; the
        gradient is summed over the group and this rank's slots kept."""
        return _GatherSlots.apply(x, self)

    def broadcast_first(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 1, ...] from sequence index 0 (its first slot, the whole
        image) on every rank; the gradient is summed into index 0."""
        return _BroadcastFirst.apply(x, self)


class _GatherSlots(torch.autograd.Function):
    """All-gather along dim 1 forward; the summed gradient's slice of this
    rank backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return torch.cat(all_gather(shard.group, x, shard.device), dim=1)

    @staticmethod
    def backward(ctx, grad):
        block = ctx.shard.block
        return all_reduce(ctx.shard.group, grad)[:, block], None


class _BroadcastFirst(torch.autograd.Function):
    """Sequence index 0's tensor on every rank forward; the summed
    gradient on index 0, zero elsewhere, backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        out = x.contiguous().clone()
        dist.broadcast(out, src=dist.get_global_rank(shard.group, 0),
                       group=shard.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce(ctx.shard.group, grad)
        return (total if ctx.shard.index == 0
                else torch.zeros_like(total)), None


def shard_sequence(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Give ``model`` (a ``Captioner``) this rank's ``SequenceShard`` as
    ``model.sp`` when the mesh has a sequence axis that divides the
    model's slots, and return it.  Without one, or where the axis does not
    divide the slots (the fallback, as ``activation_sharding``'s), the
    model runs whole on every rank."""
    if mesh is None or mesh.sequence_group is None:
        return model
    slots = model.cfg.num_slots
    if slots % mesh.sequence == 0:
        model.sp = SequenceShard(mesh.sequence_group, mesh.sequence,
                                 mesh.sequence_index, mesh.devices[0], slots)
    return model
