"""XE / focal train and eval steps, on one device, data or tensor parallel.

The counterpart of the JAX package's ``train/step.py``
(``core/models.py:115-135`` semantics): loss, backward, the pad row of the
word embedding frozen, one Adam update.  Dropout of step ``s`` draws from a
generator seeded from ``(seed, s)`` on the model's device, as the JAX step
folds ``state.step`` into its rng.  ``train_steps`` runs the K updates of
one ``train.scan_steps`` dispatch as a loop, where the JAX package scans.

With a process-group ``mesh`` each rank steps on its data index's rows of
the global batch: the loss is the global one (``parallel.mesh.global_mean``
over the reduce group), and the gradients are summed over the reduce
group, flat, before the pad row is zeroed and Adam steps, so the ranks of
a reduce group apply the same update and their weights stay bitwise
equal.  Under tensor parallelism the model holds this rank's shards and
its collectives run inside the forward and backward (``parallel.tensor``);
under sequence parallelism it runs on this rank's slots
(``parallel.sequence``).  The caller folds the data index into ``seed``
(``Trainer`` does), so the data indices draw different dropout masks and
the ranks of a model or sequence group the same.

``sdp_attention``'s dispatch rule picks each attention's route: with
attention dropout active (the presets' 0.1) the plain path runs; with
``model.attention_dropout=0.0``, and in ``eval_step``, the forward and
backward kernels run on the card, on this rank's heads under tensor
parallelism.  The JAX step leaves ``use_pallas`` off
(``train/step.py:27``); the function computed is the same, only the route
differs.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.prefetch import PinnedCopier
from ..models.captioner import Captioner, xe_loss
from ..parallel.mesh import all_reduce_grads
from ..utils.debug import annotate, check_finite, count
from ..utils.rng import fold_in, generator
from .state import TrainState, zero_pad_embedding_grad

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def to_device(batch, device, copier: Optional[PinnedCopier] = None
              ) -> Batch:
    """(features, positions, captions) from numpy or tensors -> f32, f32 and
    int64 tensors on ``device``.  With a ``copier`` (a trainer's on the
    card) host leaves go through its pinned slots on its copy stream, and
    the compute stream waits for them on the device before the step reads
    them; otherwise each leaf is a plain ``.to``, on the current stream.
    Either way the tensors are bitwise the same (the captions' int64 cast
    is exact wherever it runs).  Counts ``train.copies``."""
    f, p, c = batch[:3]
    count("train.copies", 1)
    if copier is not None and all(
            isinstance(x, np.ndarray) or x.device.type == "cpu"
            for x in (f, p, c)):
        return copier.copy((f, p, c),
                           (torch.float32, torch.float32, torch.int64))

    def put(x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=device, dtype=dtype, non_blocking=True)

    return put(f, torch.float32), put(p, torch.float32), put(c, torch.int64)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout key of update ``step``: ``fold_in(seed, step)``."""
    return generator(fold_in(seed, step), device)


def apply_update(state: TrainState, loss: torch.Tensor, mesh=None) -> None:
    """Backward of ``loss``, the gradients summed over the mesh's data
    group, the pad row's gradient zeroed, one Adam step.  Under
    ``utils.debug.enable_nan_debugging`` a non-finite loss or gradient
    raises first."""
    model = state.model
    check_finite("loss", [loss], state.step)
    with annotate("train.backward", device=True):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads(mesh, model.parameters())
        zero_pad_embedding_grad(model, model.cfg.pad_idx)
    check_finite("gradient", (p.grad for p in model.parameters()
                              if p.grad is not None), state.step)
    with annotate("train.adam", device=True):
        state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, batch: Batch, *, seed: int,
               mesh=None) -> Dict[str, torch.Tensor]:
    """One XE/focal update of ``state`` in place (core/models.py:115-126).
    Returns the loss before the update, as a tensor on the device (reading
    it waits for the step).  The parameters' ``.grad`` keep this step's
    gradients until the next step."""
    model = state.model
    gen = step_generator(seed, state.step, model.device)
    with annotate("train.forward", device=True):
        loss = xe_loss(model, *batch, generator=gen, deterministic=False,
                       mesh=mesh)["loss"]
    apply_update(state, loss, mesh)
    return {"loss": loss.detach()}


def train_steps(state: TrainState, batches: Sequence[Batch], *, seed: int,
                mesh=None) -> Dict[str, torch.Tensor]:
    """K updates, one per batch, equal to K ``train_step`` calls; the
    losses come back stacked [K]."""
    losses = [train_step(state, b, seed=seed, mesh=mesh)["loss"]
              for b in batches]
    return {"loss": torch.stack(losses)}


def unstack(stacked: Batch) -> List[Batch]:
    """The K batches of a stacked batch (``[K, B, ...]`` leaves), as views
    along dim 0."""
    return [tuple(x[i] for x in stacked) for i in range(stacked[0].shape[0])]


@torch.no_grad()
def eval_step(model: Captioner, batch: Batch, *,
              mesh=None) -> Dict[str, torch.Tensor]:
    """Deterministic loss (core/models.py:128-135), over every data index's
    rows with a process-group ``mesh``."""
    return xe_loss(model, *batch, deterministic=True, mesh=mesh)
