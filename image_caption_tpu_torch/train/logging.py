"""Observability sinks: TensorBoard scalars and text, and the append-only
scores file.

The port's own copy of the JAX package's ``train/logging.py``, mirroring the
reference's three sinks:
  * TensorBoard per-batch train/valid loss pairs, per-epoch scalars, and
    sample-caption text (``core/logger.py:3-27``, ``main.py:77-102,149``);
  * ``{split}_scores.txt`` appended per epoch (``core/utils.py:120-138``);
  * stdout prints.

TensorBoard writing goes through ``torch.utils.tensorboard`` when the
``tensorboard`` package is installed and is a no-op sink otherwise.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence


class TensorBoardWriter:
    """core/logger.py equivalent; ``write_batch`` pairs train/valid values
    under one tag, ``write_epoch`` ditto, ``write_text`` for samples."""

    def __init__(self, log_dir: str, enabled: bool = True):
        # ``enabled=False`` turns the writer into a no-op sink — multi-host
        # runs log from process 0 only
        self._w = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._w = SummaryWriter(log_dir)
        except Exception:
            pass

    def write_batch(self, key: str, train_value: float, valid_value: float,
                    step: int) -> None:
        if self._w is None:
            return
        self._w.add_scalars(f"batch/{key}",
                            {"train": float(train_value),
                             "valid": float(valid_value)}, step)

    def write_epoch(self, key: str, train_value: float, valid_value: float,
                    epoch: int) -> None:
        if self._w is None:
            return
        self._w.add_scalars(f"epoch/{key}",
                            {"train": float(train_value),
                             "valid": float(valid_value)}, epoch)

    def write_scalar(self, tag: str, value: float, step: int) -> None:
        if self._w is None:
            return
        self._w.add_scalar(tag, float(value), step)

    def write_text(self, tag: str, text: str, step: int) -> None:
        if self._w is None:
            return
        self._w.add_text(tag, text, step)

    def flush(self) -> None:
        if self._w is not None:
            self._w.flush()

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


def write_scores(output_path: str, split: str, epoch: int,
                 scores: Dict[str, float]) -> None:
    """Append ``Epoch N`` + ``{split}_{metric}: value`` lines to
    ``{output_path}/{split}_scores.txt`` (core/utils.py:120-138)."""
    os.makedirs(output_path, exist_ok=True)
    path = os.path.join(output_path, f"{split}_scores.txt")
    with open(path, "a") as f:
        f.write(f"Epoch {epoch}\n")
        for name, value in scores.items():
            f.write(f"{split}_{name}: {value}\n")
        f.write("\n")


def format_sample(caption: str, ground_truths: Sequence[str]) -> str:
    lines = [f"generated: {caption}"]
    for i, gt in enumerate(ground_truths):
        lines.append(f"gt[{i}]: {gt}")
    return "\n".join(lines)
