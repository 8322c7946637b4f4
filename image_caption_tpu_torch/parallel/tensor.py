"""Tensor parallelism over the mesh's model axis (Megatron style).

The counterpart of the JAX package's ``param_spec`` layout
(``parallel/mesh.py``), mapped onto the port's names, with the collectives
that XLA inserts there written out.  The port's ``Linear.weight`` is
``[out, in]``, the transpose of the JAX kernel, so a JAX column shard is
a shard of the port's dim 0:

  * column-parallel (output dim, and its bias): the attention's
    ``q_linear``, ``k_linear`` and ``v_linear``, whose heads split
    contiguously, H/k a rank, as the JAX column shard and ``_split_heads``
    give; the FFN's ``position_wise_1`` in every block and in the
    decoder's tail (JAX ``w1/kernel``);
  * row-parallel (input dim; the bias is added once, after the
    all-reduce): ``joint_linear`` and ``position_wise_2``;
  * vocabulary-parallel: ``classifer`` (weight and bias over the
    vocabulary: this rank's logits are its slice of the vocabulary) and
    ``word_embedding`` (rows: ids outside this rank's slice give zero,
    then one all-reduce);
  * everything else is replicated, as in the JAX package.

Before a column-parallel layer the activations pass an identity whose
backward all-reduces the gradient over the model group; after a
row-parallel one an all-reduce whose backward is the identity.  With them
every replicated activation, and so every replicated parameter's
gradient, is the same on every rank of a model group.  The attention's
probability dropout is the one dropout on head-sharded data: each rank
draws the mask of all H heads from the shared generator and keeps its own
(``ops.attention.dropout``), so a run follows one process's dropout.

``shard_model`` swaps the sharded layers into a full ``Captioner``,
``full_state_dict`` gathers the reference layout back,
``load_full_state_dict`` slices one in, and
``vocab_parallel_cross_entropy`` and ``gather_vocab`` read the logits'
vocabulary slices.  Every collective raises when it fails; nothing falls
back to one process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models import layers as L
from .mesh import Mesh, all_gather, all_reduce


@dataclass(frozen=True)
class ModelShard:
    """This rank's place in its model group: ``index`` of ``size``."""
    group: dist.ProcessGroup
    size: int
    index: int
    device: torch.device

    def split(self, n: int, what: str) -> slice:
        """This rank's contiguous slice of ``n`` (a dim ``what``)."""
        if n % self.size:
            raise ValueError(f"{what} {n} does not divide by the model "
                             f"axis {self.size}")
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(ctx.shard.group, grad), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward; identity backward."""

    @staticmethod
    def forward(ctx, x, shard):
        return all_reduce(shard.group, x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherVocab(torch.autograd.Function):
    """All-gather of the last dim forward; this rank's slice backward."""

    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard, ctx.n = shard, x.shape[-1]
        return torch.cat(all_gather(shard.group, x, shard.device), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.shard.index * ctx.n
        return grad[..., lo:lo + ctx.n], None


def gather_vocab(logits: torch.Tensor,
                 shard: Optional[ModelShard]) -> torch.Tensor:
    """The full rows of vocabulary-sharded ``logits`` on every rank of the
    model group (the logits themselves without a shard); the gradient
    flows back into this rank's slice."""
    return logits if shard is None else _GatherVocab.apply(logits, shard)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross entropy of logits split over the vocabulary: the max,
    the sum of exponentials and the target's logit, each all-reduced over
    the model group; the gradient is this slice of softmax - onehot."""

    @staticmethod
    def forward(ctx, logits, target, shard):
        n = logits.shape[-1]
        m = all_reduce(shard.group, logits.max(dim=-1).values,
                       dist.ReduceOp.MAX)
        z = logits - m[:, None]
        e = z.exp()
        s = all_reduce(shard.group, e.sum(dim=-1))
        local = target - shard.index * n
        inside = (local >= 0) & (local < n)
        idx = local.clamp(0, n - 1)
        t = all_reduce(shard.group, z.gather(1, idx[:, None])[:, 0]
                       * inside.to(z.dtype))
        ctx.save_for_backward(e / s[:, None], idx, inside)
        return s.log() - t

    @staticmethod
    def backward(ctx, grad):
        p, idx, inside = ctx.saved_tensors
        out = p.scatter_add(1, idx[:, None], -inside.to(p.dtype)[:, None])
        return out * grad[:, None], None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                                 shard: ModelShard) -> torch.Tensor:
    """``-log softmax(logits)[target]`` per row: logits [N, V/k] (this
    rank's vocabulary slice), target [N] ids of the whole vocabulary.
    Every rank of the model group gets the same [N] values."""
    return _VocabParallelCE.apply(logits, target.long(), shard)


# ---------------------------------------------------------------------------
# Sharded layers: their parameters keep the names and order of the layers
# they replace, and ``shard_dims`` says which dim of each is split
# ---------------------------------------------------------------------------

class ColumnParallelLinear(nn.Module):
    """``Linear`` with its output dim split: weight [out/k, in], bias
    [out/k].  Takes the replicated input, gives this rank's columns."""

    def __init__(self, full: L.Linear, shard: ModelShard, what: str):
        super().__init__()
        rows = shard.split(full.weight.shape[0], what)
        self.weight = nn.Parameter(full.weight.detach()[rows].clone())
        self.bias = (None if full.bias is None else
                     nn.Parameter(full.bias.detach()[rows].clone()))
        self.shard = shard
        self.shard_dims = {"weight": 0, "bias": 0}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _CopyToModel.apply(x, self.shard)
        y = nn.functional.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class RowParallelLinear(nn.Module):
    """``Linear`` with its input dim split: weight [out, in/k], the bias
    whole.  Takes this rank's columns, gives the replicated output."""

    def __init__(self, full: L.Linear, shard: ModelShard, what: str):
        super().__init__()
        cols = shard.split(full.weight.shape[1], what)
        self.weight = nn.Parameter(full.weight.detach()[:, cols].clone())
        self.bias = (None if full.bias is None else
                     nn.Parameter(full.bias.detach().clone()))
        self.shard = shard
        self.shard_dims = {"weight": 1}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = nn.functional.linear(x, self.weight.to(x.dtype))
        y = _ReduceFromModel.apply(y, self.shard)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class VocabParallelEmbedding(nn.Module):
    """An embedding table split by rows: ids outside this rank's rows
    ``[vocab_start, vocab_start + V/k)`` look up zero, and one all-reduce
    sums the ranks' lookups."""

    def __init__(self, full: nn.Embedding, shard: ModelShard):
        super().__init__()
        rows = shard.split(full.weight.shape[0], "vocabulary")
        self.weight = nn.Parameter(full.weight.detach()[rows].clone())
        self.vocab_start = rows.start
        self.shard = shard
        self.shard_dims = {"weight": 0}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        local = ids - self.vocab_start
        outside = (local < 0) | (local >= self.weight.shape[0])
        out = nn.functional.embedding(local.masked_fill(outside, 0),
                                      self.weight)
        out = out.masked_fill(outside[..., None], 0.0)
        return _ReduceFromModel.apply(out, self.shard)


def shard_model(model: nn.Module, mesh: Optional[Mesh]) -> nn.Module:
    """Swap the sharded layers into ``model`` (a full ``Captioner``, the
    same weights on every rank of the model group) in place, each holding
    this rank's slice, and return it; ``model.tp`` becomes this rank's
    ``ModelShard``.  Without a model axis the model is returned as it is.
    A width the model axis does not divide raises ``ValueError``."""
    if mesh is None or mesh.model_group is None:
        return model
    shard = ModelShard(mesh.model_group, mesh.model, mesh.model_index,
                       mesh.devices[0])
    for mod in list(model.modules()):
        if isinstance(mod, L.MultiHeadAttention):
            heads = shard.split(mod.num_heads, "attention heads")
            for name in ("q_linear", "k_linear", "v_linear"):
                setattr(mod, name, ColumnParallelLinear(
                    getattr(mod, name), shard, "attention width"))
            mod.joint_linear = RowParallelLinear(mod.joint_linear, shard,
                                                 "attention width")
            mod.num_heads, total = heads.stop - heads.start, mod.num_heads
            mod.dropout_heads = (1, heads.start, mod.num_heads, total)
        elif isinstance(mod, L.FeedForward):
            _shard_ffn(mod, shard)
    dec = model.decoder
    if model.cfg.move_first_image_feature:
        _shard_ffn(dec, shard)
    dec.word_embedding = VocabParallelEmbedding(dec.word_embedding, shard)
    model.classifer = ColumnParallelLinear(model.classifer, shard,
                                           "vocabulary")
    model.tp = shard
    return model


def _shard_ffn(mod: nn.Module, shard: ModelShard) -> None:
    mod.position_wise_1 = ColumnParallelLinear(mod.position_wise_1, shard,
                                               "FFN hidden width")
    mod.position_wise_2 = RowParallelLinear(mod.position_wise_2, shard,
                                            "FFN hidden width")


def shard_dims(model: nn.Module) -> Dict[str, int]:
    """The dim along which each sharded parameter is split, by its
    state_dict name; replicated parameters are absent."""
    return {f"{name}.{p}": d for name, mod in model.named_modules()
            for p, d in getattr(mod, "shard_dims", {}).items()
            if getattr(mod, p) is not None}


def gather_dim(model: nn.Module, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The full tensor of which ``t`` is this rank's slice along ``dim``."""
    shard = model.tp
    return torch.cat(all_gather(shard.group, t.detach(), shard.device),
                     dim=dim)


def slice_dim(model: nn.Module, full: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's slice of ``full`` along ``dim``."""
    rows = model.tp.split(full.shape[dim], f"dim {dim}")
    return full.narrow(dim, rows.start, rows.stop - rows.start)


def gather_full(model: nn.Module,
                tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name: the parameters, their gradients,
    the optimizer's moments) in the full layout: every sharded one
    gathered over the model group, the rest as they are.  A collective on
    every rank of the model group under tensor parallelism."""
    if getattr(model, "tp", None) is None:
        return dict(tensors)
    dims = shard_dims(model)
    return {n: gather_dim(model, t, dims[n]) if n in dims else t
            for n, t in tensors.items()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state_dict in the reference layout, on every rank of
    the model group (its own state_dict without tensor parallelism)."""
    return gather_full(model, model.state_dict())


def load_full_state_dict(model: nn.Module,
                         state: Dict[str, torch.Tensor]) -> None:
    """Load a state_dict of the reference layout (a full model's, or a
    checkpoint's) into ``model``, each sharded entry sliced to this
    rank's part."""
    if getattr(model, "tp", None) is not None:
        dims = shard_dims(model)
        state = {n: slice_dim(model, v, dims[n]) if n in dims else v
                 for n, v in state.items()}
    model.load_state_dict(state)
