"""Random streams for dropout, used as the JAX package uses its keys.

A ``torch.Generator`` handed to the model is treated as a key: it is
split into child generators, one per dropout site, exactly where the JAX
package calls ``jax.random.split``, and only a leaf site draws from its
generator.  Children are seeded on the host from the parent's initial
seed, so splitting never waits for the card, and the same key gives the
same masks.  The streams differ from ``jax.random``'s; the sites, rates and
the split structure are the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional

import torch

_MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser: a bijection of 64-bit integers that spreads
    neighbouring inputs over the whole range."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new seed from ``seed`` and an integer, the counterpart of
    ``jax.random.fold_in``; non-negative and below 2**63."""
    return _mix(_mix(seed & _MASK64) ^ (data & _MASK64)) & ((1 << 63) - 1)


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` (a CUDA generator draws on the card)."""
    return torch.Generator(device=device).manual_seed(seed)


def split(parent: Optional[torch.Generator],
          n: int) -> List[Optional[torch.Generator]]:
    """``n`` child generators on the parent's device, the counterpart of
    ``jax.random.split``.  The parent's own stream is not consumed.  No
    parent (dropout off) gives ``n`` Nones."""
    if parent is None:
        return [None] * n
    seed = parent.initial_seed()
    return [generator(fold_in(seed, i), parent.device) for i in range(n)]
