"""Training state: the model, its Adam optimizer and the step count.

The reference holds torch modules with an Adam(lr=5e-4) over the
``requires_grad`` params (``core/models.py:111-113``); the JAX package
holds the same as one pytree (params, optax Adam state, step).  Here the
state is the live ``Captioner``, a ``torch.optim.Adam`` over its
parameters, and the number of updates taken.  Under tensor parallelism
the model holds this rank's shards (``parallel.tensor``) and Adam steps
them: its update is elementwise, so that is the full update's slice.
Under sequence parallelism the parameters are whole and the model runs on
this rank's slots (``parallel.sequence``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import torch

from ..config import Config
from ..models.captioner import Captioner
from ..parallel.mesh import Mesh, broadcast_params
from ..parallel.sequence import shard_sequence
from ..parallel.tensor import shard_model
from ..utils.device import DeviceLike


@dataclass
class TrainState:
    step: int
    model: Captioner
    optimizer: torch.optim.Optimizer


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 5e-4) -> torch.optim.Adam:
    """torch.optim.Adam with betas (0.9, 0.999) and eps 1e-8
    (core/models.py:111-113), the update of the JAX package's
    ``optax.adam``."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8)


def create_train_state(cfg: Config, *, device: DeviceLike = None,
                       seed: int = 0,
                       mesh: Optional[Mesh] = None) -> TrainState:
    """A fresh model (weights from ``torch.Generator`` seed ``seed``) on
    ``device`` (the card when None), its optimizer, and step 0.  Over a
    process-group ``mesh`` rank 0's weights are broadcast first, then the
    model is sharded over the model axis, and the optimizer holds the
    shards; over a sequence axis it runs on this rank's slots."""
    model = Captioner(cfg.model, device=device,
                      generator=torch.Generator().manual_seed(seed))
    broadcast_params(mesh, model)
    model = shard_sequence(shard_model(model, mesh), mesh)
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               cfg.train.learning_rate))


def zero_pad_embedding_grad(model: Captioner, pad_idx: int) -> None:
    """torch freezes the padding_idx embedding row (no gradient,
    model.py:389-391); the port's embedding has no padding_idx, so the
    row's gradient is zeroed here, in place, by the rank whose rows hold
    it under tensor parallelism."""
    emb = model.decoder.word_embedding
    row = pad_idx - getattr(emb, "vocab_start", 0)
    if emb.weight.grad is not None and 0 <= row < emb.weight.shape[0]:
        emb.weight.grad[row] = 0.0
