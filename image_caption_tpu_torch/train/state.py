"""Training state: the model, its Adam optimizer and the step count.

The reference holds torch modules with an Adam(lr=5e-4) over the
``requires_grad`` params (``core/models.py:111-113``); the JAX package
holds the same as one pytree (params, optax Adam state, step).  Here the
state is the live ``Captioner``, a ``torch.optim.Adam`` over its
parameters, and the number of updates taken.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import torch

from ..config import Config
from ..models.captioner import Captioner
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
                       seed: int = 0) -> TrainState:
    """A fresh model (weights from ``torch.Generator`` seed ``seed``) on
    ``device`` (the card when None), its optimizer, and step 0."""
    model = Captioner(cfg.model, device=device,
                      generator=torch.Generator().manual_seed(seed))
    return TrainState(step=0, model=model,
                      optimizer=make_optimizer(model.parameters(),
                                               cfg.train.learning_rate))


def zero_pad_embedding_grad(model: Captioner, pad_idx: int) -> None:
    """torch freezes the padding_idx embedding row (no gradient,
    model.py:389-391); the port's embedding has no padding_idx, so the
    row's gradient is zeroed here, in place."""
    grad = model.decoder.word_embedding.weight.grad
    if grad is not None:
        grad[pad_idx] = 0.0
