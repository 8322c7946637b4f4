"""Checkpoints of the whole train state: model, optimizer and step.

The reference saves a bare ``state_dict`` per epoch as ``model_N.pt`` and
never keeps the optimizer, so a resume restarts Adam's moments
(``core/models.py:62-68``, ``main.py:151``); the JAX package keeps params,
optimizer and step through orbax.  Here each epoch's state goes through
``torch.save`` to ``{directory}/train_state_{epoch}.pt``, a name that
cannot be taken for a reference ``model_N.pt`` (which
``utils/weights.load_reference_checkpoint`` reads).  A write goes to a
temporary file first and then ``os.replace``s it, so a reader never sees
half a checkpoint; the newest ``keep`` are kept.

A checkpoint always holds the full layout, as orbax's global arrays do in
the JAX package: under tensor parallelism ``save`` gathers the shards of
the model and of Adam's ``exp_avg``/``exp_avg_sq`` (along the same dims)
on every rank, the main rank writes, and every rank waits at a barrier;
``restore`` slices this rank's part.  So a checkpoint written at one
``train.model_axis`` restores at any other, and ``load_model_state``
reads it as it is.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

from ..parallel.mesh import Mesh, barrier
from ..parallel.tensor import (full_state_dict, gather_dim,
                               load_full_state_dict, shard_dims, slice_dim)
from .state import TrainState

_NAME = re.compile(r"^train_state_(\d+)\.pt$")


class CheckpointManager:
    """Epoch-indexed checkpoints under ``{output_path}/model`` (the
    reference's layout, main.py:28-30) with keep-N rotation."""

    def __init__(self, directory: str, keep: int = 5):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"train_state_{epoch}.pt")

    def save(self, epoch: int, state: TrainState,
             mesh: Optional[Mesh] = None) -> None:
        """Write epoch ``epoch`` of ``state`` in the full layout.  Over a
        process-group ``mesh`` every rank calls it (the gather is a
        collective); the main rank writes, and all wait for it."""
        payload = {"step": state.step,
                   "model": full_state_dict(state.model),
                   "optimizer": _moments(state, gather_dim)}
        if mesh is None or mesh.is_main:
            self._write(epoch, payload)
        barrier(mesh)

    def _write(self, epoch: int, payload: dict) -> None:
        path = self.path(epoch)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self.all_epochs()[:-self.keep]:
            os.unlink(self.path(old))

    def restore(self, epoch: int, state: TrainState) -> TrainState:
        """Load epoch ``epoch`` into ``state`` (model and optimizer in
        place, on the model's device; this rank's slices of a sharded
        model) and return it."""
        payload = torch.load(self.path(epoch), map_location="cpu",
                             weights_only=True)
        load_full_state_dict(state.model, payload["model"])
        state.optimizer.load_state_dict(_moments(state, slice_dim,
                                                 payload["optimizer"]))
        state.step = int(payload["step"])
        return state

    def load_model_state(self, epoch: int) -> Dict[str, torch.Tensor]:
        """The model's state_dict of epoch ``epoch`` (CPU tensors), without
        the optimizer: what serving restores."""
        return torch.load(self.path(epoch), map_location="cpu",
                          weights_only=True)["model"]

    def all_epochs(self) -> List[int]:
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _moments(state: TrainState, fn, opt: Optional[dict] = None) -> dict:
    """The optimizer's state_dict (``state``'s own when ``opt`` is None)
    with ``fn(model, moment, dim)`` applied to Adam's moments of every
    sharded parameter: ``gather_dim`` to the full layout, ``slice_dim``
    to this rank's.  Without tensor parallelism it is returned as it
    is."""
    opt = state.optimizer.state_dict() if opt is None else opt
    model = state.model
    if model.tp is None:
        return opt
    dims = shard_dims(model)
    # the optimizer numbers the parameters in the model's order
    names = [n for n, _ in model.named_parameters()]
    moved = {}
    for i, st in opt["state"].items():
        dim = dims.get(names[i])
        moved[i] = {k: fn(model, v, dim) if dim is not None
                    and k in _MOMENTS else v for k, v in st.items()}
    return dict(opt, state=moved)
