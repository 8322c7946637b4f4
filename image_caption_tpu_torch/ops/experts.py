"""Routed experts as one grouped computation: each token's ``k`` chosen
experts, over all of them at once.

Expert ``e`` is a SiLU-gated MLP, ``down_e(silu(gate_e x) ⊙ up_e x)``, its
weights stacked over the experts: ``w13`` [E, 2I, D] (the gate's I rows,
then the up's) and ``w2`` [E, D, I].  ``grouped_experts`` sorts the N·k
(token, choice) rows by expert (a stable sort, so a token's rows keep
their order within an expert), counts the rows of each expert and runs
the two products as ``torch._grouped_mm`` over the experts' runs of rows,
the offsets on the device: the launches do not depend on the number of
experts, and nothing waits for the host, so a graph can capture it.

Between and after the products run the two entries of the glue:

  * ``silu_up``: h [R, 2I] -> ``silu(gate) ⊙ up`` [R, I];
  * ``combine``: the rows back in (token, choice) order through ``inv``
    and summed with their routing weights in float32, rounded once.

On CUDA tensors each launches its hand-written kernel of
``csrc/experts_glue.cu`` (kernel #6) on the current stream and adds one to
its ``launches``, or raises; on CPU tensors each takes its plain version
(``silu_up_reference``, ``combine_reference``), the PyTorch chain the
kernels replaced.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the most choices a token the combine kernel holds
MAX_K = 8


def sort_rows(idx: torch.Tensor, num_experts: int):
    """``idx`` [N, k] expert ids -> (``order`` [N·k]: the flat (token,
    choice) rows sorted by expert, ``inv`` [N·k] int32: where each flat
    row lies in that order, ``counts`` [E] int32: rows an expert, ``offs``
    [E] int32: the end of each expert's run)."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    inv = torch.empty_like(flat, dtype=torch.int32).scatter_(
        0, order, torch.arange(flat.numel(), dtype=torch.int32,
                               device=idx.device))
    counts = torch.zeros(num_experts, dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return order, inv, counts, torch.cumsum(counts, 0, dtype=torch.int32)


def _takes_kernel(*xs: torch.Tensor) -> bool:
    """Whether the inputs take the kernel (CUDA) or the plain version
    (CPU); raises on another device or a mix."""
    if len({x.device for x in xs}) != 1:
        raise ValueError("every input must lie on one device")
    if xs[0].device.type not in ("cuda", "cpu"):
        raise ValueError(f"the experts' glue runs on cuda or cpu, not "
                         f"{xs[0].device}")
    return xs[0].device.type == "cuda"


def _check_rows(name: str, x: torch.Tensor, width: int) -> None:
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} must be bfloat16 or float32, got {x.dtype}")
    if width % 8:
        raise ValueError(f"{name}'s width {width} must be a multiple of 8")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and start 16-byte "
                         f"aligned")


def check_silu_up(h: torch.Tensor) -> None:
    """Raise on an ``h`` that ``silu_up`` does not take."""
    if h.dim() != 2 or h.shape[1] % 2:
        raise ValueError(f"h must be [R, 2I], got {tuple(h.shape)}")
    _check_rows("h", h, h.shape[1] // 2)


def check_combine(y: torch.Tensor, inv: torch.Tensor,
                  weights: torch.Tensor) -> None:
    """Raise on inputs that ``combine`` does not take."""
    if weights.dim() != 2 or weights.dtype != torch.float32:
        raise ValueError(f"weights must be float32 [N, k], got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    n, k = weights.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k (weights' columns) must be 1 to {MAX_K}, got "
                         f"{k}")
    if y.dim() != 2 or y.shape[0] != n * k:
        raise ValueError(f"y must be [N·k, D] = [{n * k}, D], got "
                         f"{tuple(y.shape)}")
    if inv.shape != (n * k,) or inv.dtype != torch.int32:
        raise ValueError(f"inv must be int32 [{n * k}], got {inv.dtype} "
                         f"{tuple(inv.shape)}")
    _check_rows("y", y, y.shape[1])
    if not (inv.is_contiguous() and weights.is_contiguous()):
        raise ValueError("inv and weights must be contiguous")


def silu_up_reference(h: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.silu(gate) * up`` on h's two halves."""
    gate, up = h.chunk(2, dim=-1)
    return F.silu(gate) * up


def combine_reference(y: torch.Tensor, inv: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """The plain version: the rows in (token, choice) order, summed with
    their weights by a float32 batched product, cast to y's dtype."""
    n, k = weights.shape
    rows = y.index_select(0, inv).view(n, k, -1)
    return torch.bmm(weights[:, None, :], rows.float())[:, 0].to(y.dtype)


def _kernel(name: str):
    fn = getattr(_build.load("experts_glue"), name)
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = ([ptr, ptr, i64, i32, i32, ptr] if name == "silu_up"
                       else [ptr, ptr, ptr, ptr, i64, i32, i32, i32, ptr])
        fn.restype = ctypes.c_int
    return fn


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"experts_glue {name} kernel launch failed: CUDA "
                           f"error {err}")


def silu_up(h: torch.Tensor) -> torch.Tensor:
    """h [R, 2I] (gate columns, then up columns) -> [R, I] in h's dtype,
    the same bits as ``silu_up_reference``."""
    check_silu_up(h)
    if not _takes_kernel(h):
        return silu_up_reference(h)
    r, i = h.shape[0], h.shape[1] // 2
    out = torch.empty((r, i), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        err = _kernel("silu_up")(
            h.data_ptr(), out.data_ptr(), r, i, DTYPES[h.dtype],
            torch.cuda.current_stream().cuda_stream)
    _launched("silu_up", err)
    silu_up.launches += 1
    return out


def combine(y: torch.Tensor, inv: torch.Tensor,
            weights: torch.Tensor) -> torch.Tensor:
    """y [N·k, D] in expert-sorted order, ``inv`` [N·k] int32 (the row of
    y that holds token n's j-th choice is ``inv[n·k + j]``), weights [N, k]
    float32 -> ``Σ_j weights[:, j] · y[inv[n·k + j]]`` [N, D] in y's
    dtype, summed in float32."""
    check_combine(y, inv, weights)
    if not _takes_kernel(y, inv, weights):
        return combine_reference(y, inv, weights)
    n, k = weights.shape
    out = torch.empty((n, y.shape[1]), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        err = _kernel("combine")(
            y.data_ptr(), inv.data_ptr(), weights.data_ptr(), out.data_ptr(),
            n, k, y.shape[1], DTYPES[y.dtype],
            torch.cuda.current_stream().cuda_stream)
    _launched("combine", err)
    combine.launches += 1
    return out


silu_up.launches = 0
combine.launches = 0


def grouped_experts(x: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor, w13: torch.Tensor,
                    w2: torch.Tensor):
    """x [N, D], idx [N, k], weights [N, k] float32 -> ([N, D] in x's
    dtype: ``Σ_j weights[:, j] · expert_{idx[:, j]}(x)``, the rows of each
    expert [E] int32)."""
    k = idx.shape[1]
    order, inv, counts, offs = sort_rows(idx, w13.shape[0])
    rows = x.index_select(0, order // k)
    h = torch._grouped_mm(rows, w13.transpose(1, 2), offs=offs)
    y = torch._grouped_mm(silu_up(h), w2.transpose(1, 2), offs=offs)
    return combine(y, inv, weights), counts
