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
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

import torch

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

    def save(self, epoch: int, state: TrainState) -> None:
        payload = {"step": state.step,
                   "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict()}
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
        place, on the model's device) and return it."""
        payload = torch.load(self.path(epoch), map_location="cpu",
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
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
