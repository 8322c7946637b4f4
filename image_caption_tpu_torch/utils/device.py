"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the card: CUDA, or an error when there is none.  The
    port never falls back to the CPU on its own; a caller that wants the CPU
    (the tests) says ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
