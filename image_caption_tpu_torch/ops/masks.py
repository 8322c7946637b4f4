"""Attention mask builders.

Boolean convention matches the reference: ``True`` = masked out (the
reference fills ``-inf`` at True positions, modules.py:20-21).

  * encoder key-pad / non-pad from all-zero feature rows (model.py:334-359)
  * decoder key-pad / non-pad from pad tokens           (model.py:461-486)
  * subsequent (causal, upper-triangular)               (model.py:343-354)
  * cross-attention key-pad                             (model.py:202-209)
"""

from __future__ import annotations

from typing import Optional

import torch


def key_pad_mask_from_features(k_features: torch.Tensor,
                               q_len: int) -> torch.Tensor:
    """[B, Lk, D] -> bool [B, q_len, Lk]; True where the key row is all
    zero (count_nonzero == 0, model.py:206,338)."""
    pad = (k_features == 0).all(dim=-1)                 # [B, Lk]
    return pad[:, None, :].expand(pad.shape[0], q_len, pad.shape[1])


def key_pad_mask_from_tokens(tokens: torch.Tensor, q_len: int,
                             pad_idx: int = 0) -> torch.Tensor:
    """[B, Lk] int -> bool [B, q_len, Lk]; True at pad tokens (model.py:465)."""
    pad = tokens == pad_idx
    return pad[:, None, :].expand(pad.shape[0], q_len, pad.shape[1])


def subsequent_mask(batch: int, length: int, device=None,
                    rows: Optional[slice] = None) -> torch.Tensor:
    """Strictly upper-triangular bool [B, L, L] (model.py:346-352); with
    ``rows``, its query rows at those global offsets, [B, len(rows), L]
    (one rank's slots under sequence parallelism)."""
    tri = torch.ones((length, length), dtype=torch.bool,
                     device=device).triu(diagonal=1)
    if rows is not None:
        tri = tri[rows]
    return tri[None].expand(batch, *tri.shape)


def non_pad_mask_from_features(features: torch.Tensor) -> torch.Tensor:
    """[B, L, D] -> float [B, L, 1]; 1.0 where the row has any nonzero
    (model.py:356-359)."""
    return (features != 0).any(dim=-1, keepdim=True).float()


def non_pad_mask_from_tokens(tokens: torch.Tensor,
                             pad_idx: int = 0) -> torch.Tensor:
    """[B, L] -> float [B, L, 1] (model.py:483-486)."""
    return (tokens != pad_idx)[..., None].float()


def combine_masks(*masks: torch.Tensor) -> torch.Tensor:
    """(key_pad + subsequent).gt(0): boolean OR (model.py:317-319,428-430)."""
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out
