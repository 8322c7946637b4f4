"""XE / focal train and eval steps on one device.

The counterpart of the JAX package's ``train/step.py``
(``core/models.py:115-135`` semantics): loss, backward, the pad row of the
word embedding frozen, one Adam update.  Dropout of step ``s`` draws from a
generator seeded from ``(seed, s)`` on the model's device, as the JAX step
folds ``state.step`` into its rng.  ``train_steps`` runs K updates as a
loop, where the JAX package scans.

The steps ask for the fused attention kernels (``use_kernel=True``, as
``serve.decode_split`` does), and ``sdp_attention``'s dispatch rule
decides: with attention dropout active (the presets' 0.1) the plain path
runs; with ``model.attention_dropout=0.0``, and in ``eval_step``, the
forward and backward kernels run.  The JAX step leaves ``use_pallas`` off
(``train/step.py:27``); the function computed is the same, only the route
differs.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..models.captioner import Captioner, xe_loss
from ..utils.rng import fold_in, generator
from .state import TrainState, zero_pad_embedding_grad

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def to_device(batch, device) -> Batch:
    """(features, positions, captions) from numpy or tensors -> f32, f32 and
    int64 tensors on ``device``.  The host arrays are pageable, so each
    copy is staged and waits for the card's stream."""
    f, p, c = batch[:3]

    def put(x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=device, dtype=dtype, non_blocking=True)

    return put(f, torch.float32), put(p, torch.float32), put(c, torch.int64)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout key of update ``step``: ``fold_in(seed, step)``."""
    return generator(fold_in(seed, step), device)


def train_step(state: TrainState, batch: Batch, *, seed: int,
               use_kernel: bool = True) -> Dict[str, torch.Tensor]:
    """One XE/focal update of ``state`` in place (core/models.py:115-126).
    Returns the loss before the update, as a tensor on the device (reading
    it waits for the step).  The parameters' ``.grad`` keep this step's
    gradients until the next step."""
    model = state.model
    gen = step_generator(seed, state.step, model.device)
    loss = xe_loss(model, *batch, generator=gen, deterministic=False,
                   use_kernel=use_kernel)["loss"]
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    zero_pad_embedding_grad(model, model.cfg.pad_idx)
    state.optimizer.step()
    state.step += 1
    return {"loss": loss.detach()}


def train_steps(state: TrainState, batches: Sequence[Batch], *, seed: int,
                use_kernel: bool = True) -> Dict[str, torch.Tensor]:
    """K updates, one per batch, equal to K ``train_step`` calls; the
    losses come back stacked [K]."""
    losses = [train_step(state, b, seed=seed, use_kernel=use_kernel)["loss"]
              for b in batches]
    return {"loss": torch.stack(losses)}


@torch.no_grad()
def eval_step(model: Captioner, batch: Batch, *,
              use_kernel: bool = True) -> Dict[str, torch.Tensor]:
    """Deterministic loss (core/models.py:128-135)."""
    return xe_loss(model, *batch, deterministic=True, use_kernel=use_kernel)
