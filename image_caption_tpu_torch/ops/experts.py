"""Routed experts as one grouped computation: each token's ``k`` chosen
experts, over all of them at once.

Expert ``e`` is a SiLU-gated MLP, ``down_e(silu(gate_e x) ⊙ up_e x)``, its
weights stacked over the experts: ``w13`` [E, 2I, D] (the gate's I rows,
then the up's) and ``w2`` [E, D, I].  ``grouped_experts`` sorts the N·k
(token, choice) rows by expert (a stable sort, so a token's rows keep
their order within an expert), counts the rows of each expert and runs
the two products as ``torch._grouped_mm`` over the experts' runs of rows,
the offsets on the device: the launches do not depend on the number of
experts, and nothing waits for the host, so a graph can capture it.  The
rows come back in (token, choice) order and are summed with their routing
weights in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sort_rows(idx: torch.Tensor, num_experts: int):
    """``idx`` [N, k] expert ids -> (``order`` [N·k]: the flat (token,
    choice) rows sorted by expert, ``counts`` [E] int32: rows an expert,
    ``offs`` [E] int32: the end of each expert's run)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(num_experts, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return order, counts, torch.cumsum(counts, 0, dtype=torch.int32)


def grouped_experts(x: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor, w13: torch.Tensor,
                    w2: torch.Tensor):
    """x [N, D], idx [N, k], weights [N, k] float32 -> ([N, D] in x's
    dtype: ``Σ_j weights[:, j] · expert_{idx[:, j]}(x)``, the rows of each
    expert [E] int32)."""
    n, k = idx.shape
    order, counts, offs = sort_rows(idx, w13.shape[0])
    rows = x.index_select(0, order // k)
    h = torch._grouped_mm(rows, w13.transpose(1, 2), offs=offs)
    gate, up = h.chunk(2, dim=-1)
    y = torch._grouped_mm(F.silu(gate) * up, w2.transpose(1, 2),
                          offs=offs)
    out = torch.empty_like(y).index_copy_(0, order, y)
    return torch.bmm(weights.float()[:, None, :],
                     out.view(n, k, -1).float())[:, 0].to(x.dtype), counts

