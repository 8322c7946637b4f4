"""Scaled dot-product attention: the plain path and the fused CUDA kernels.

Semantics match the reference (modules.py:6-27):
``softmax(q/temperature @ k^T  masked_fill -inf)``, optional dropout on the
attention weights, then ``@ v``.  Returns ``(output, attention_weights)``.

  * ``attention_reference`` — plain PyTorch, the counterpart of the JAX
    package's ``_attention_xla``; used whenever the weights are wanted or
    dropout runs, and for every CPU tensor.
  * ``fused_attention`` — differentiable fused attention through
    ``FusedAttentionFn``: on CUDA tensors its forward is the hand-written
    ``sm_90a`` kernel of ``csrc/fused_attention.cu`` and its backward the
    kernel of ``csrc/fused_attention_bwd.cu`` (the JAX package's
    ``jax.custom_vjp`` pair); on CPU tensors the same Function runs
    ``attention_reference`` and ``attention_bwd_reference``.

Shapes: q [B, H, Lq, Dh], k/v [B, H, Lk, Dh], mask bool [B, Lq, Lk]
(True = masked).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import _build

_NEG_INF = float("-inf")


# a part of a dim that ``dropout`` draws whole, ``(dim, start, count,
# total)``: ``x``'s dim ``dim`` is runs of ``count`` entries, each of them
# entries ``start`` to ``start + count`` of ``total`` (one run when the dim
# is the part alone; one per row when rows are folded into it)
Part = Tuple[int, int, int, int]


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool, parts: Sequence[Part] = ()) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) in training).  Without a
    generator it is off, as the JAX version is without an rng.  The mask is
    drawn on ``x``'s device, so the generator must lie there too (a CUDA
    generator for a CUDA tensor).  ``parts``: ``x`` is one rank's part of
    what one process holds (its heads under tensor parallelism, its slots
    under sequence parallelism); the mask is drawn for the whole and this
    part kept, the bits one process draws for it."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    shape = list(x.shape)
    for dim, _, count, total in parts:
        shape[dim] = shape[dim] // count * total
    keep = torch.rand(shape, generator=generator, device=x.device) >= rate
    for dim, start, count, total in parts:
        keep = keep.unflatten(dim, (-1, total)).narrow(
            dim + 1, start, count).flatten(dim, dim + 1)
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def masked_softmax(scores: torch.Tensor) -> torch.Tensor:
    """Stable softmax over the last axis that tolerates fully masked (-inf)
    rows: the max is guarded to 0 when not finite and the denominator is
    floored at 1e-30, so such rows come out as exact zeros."""
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    unnorm = torch.exp(scores - m)
    denom = unnorm.sum(dim=-1, keepdim=True)
    return unnorm / denom.clamp_min(1e-30)


def attention_reference(q, k, v, mask, temperature, *,
                        dropout_rate: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        deterministic: bool = True,
                        dropout_parts: Sequence[Part] = ()):
    """Plain path: scores and weighted sum in f32, output in q's dtype;
    ``dropout_parts`` as ``dropout``'s ``parts`` of the weights
    [B, H, Lq, Lk]."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() / temperature,
                          k.float())
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :, :], _NEG_INF)
        attn = masked_softmax(scores)
    else:
        attn = torch.softmax(scores, dim=-1)
    attn_dropped = dropout(attn, dropout_rate, generator, deterministic,
                           dropout_parts)
    out = torch.einsum("bhqk,bhkd->bhqd", attn_dropped, v.float())
    return out.to(q.dtype), attn


def attention_bwd_reference(q, k, v, mask_i8, d_out, temperature):
    """Plain version of the backward kernel, the formula of the JAX
    package's ``_attention_bwd_kernel`` step by step in f32: recompute P
    with the forward's guard, then dV = P^T dO, dP = dO V^T,
    dS = P * (dP - rowsum(dP * P)), dQ = dS K / t, dK = dS^T Q / t.
    Returns (dq, dk, dv) in the inputs' dtypes."""
    f32 = torch.float32
    qf, kf, vf, do = (t.to(f32) for t in (q, k, v, d_out))
    inv_t = 1.0 / temperature
    scores = torch.einsum("bhqd,bhkd->bhqk", qf * inv_t, kf)
    scores = scores.masked_fill((mask_i8 != 0)[:, None], _NEG_INF)
    p = masked_softmax(scores)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vf)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * inv_t
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * inv_t
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64
# the dynamic shared memory one thread block may use on sm_90 (227 KB); a
# backward block holds at least one (b, h)'s q, k, v, dO, P and dS there
MAX_BWD_SHARED_BYTES = 232448


def bwd_shared_bytes(lq: int, lk: int, dh: int) -> int:
    """Shared memory of a backward block that holds one (b, h): q, dO
    [Lq, Dp], k, v [Lk, Dp] with Dp = Dh rounded up to even, and P, dS
    [Lq, Lk], all f32 (``csrc/fused_attention_bwd.cu:smem_bytes`` with one
    unit; such a block writes dQ and reads the mask in device memory).  The
    kernel packs more (b, h) into a block, with their dQ and mask tiles,
    only where they fit."""
    dp = dh + dh % 2
    return 4 * (2 * (lq + lk) * dp + 2 * lq * lk)


# source in csrc/ -> its C entry point
_ENTRY = {"fused_attention": "fused_attention_fwd",
          "fused_attention_bwd": "fused_attention_bwd"}


def _kernel(source: str, n_ptrs: int):
    fn = getattr(_build.load(source), _ENTRY[source])
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * n_ptrs + [i32] * 5
                       + [ctypes.c_float, i32, ptr])
        fn.restype = ctypes.c_int
    return fn


def _launch(source: str, tensors, q, k, temperature) -> None:
    """Launch the kernel of ``csrc/<source>.cu`` on ``tensors`` (pointers
    first, then B, H, Lq, Lk, Dh, 1/t, dtype and the current stream);
    raise if the launch is refused."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(source, len(tensors))(
            *(t.data_ptr() for t in tensors), b, h, lq, lk, dh,
            1.0 / temperature, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")


def _check(q, k, v, mask_i8, temperature):
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_attention takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if mask_i8.dtype != torch.int8:
        raise TypeError(f"mask must be int8, got {mask_i8.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, Dh]")
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if k.shape != (b, h, lk, dh) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if mask_i8.shape != (b, lq, lk):
        raise ValueError(f"mask must be [{b}, {lq}, {lk}], "
                         f"got {tuple(mask_i8.shape)}")
    if min(b, h, lq, lk, dh) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}")
    if len({t.device for t in (q, k, v, mask_i8)}) != 1:
        raise ValueError("q, k, v and mask must lie on one device")
    if not all(t.is_contiguous() for t in (q, k, v, mask_i8)):
        raise ValueError("q, k, v and mask must be contiguous")
    if not temperature > 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_attention runs on cuda or cpu, "
                         f"not {q.device}")


def _check_bwd(q, k, v, mask_i8, d_out, temperature):
    _check(q, k, v, mask_i8, temperature)
    if d_out.dtype != q.dtype:
        raise TypeError(f"d_out must be {q.dtype}, got {d_out.dtype}")
    if d_out.shape != q.shape:
        raise ValueError(f"d_out must be {tuple(q.shape)}, "
                         f"got {tuple(d_out.shape)}")
    if d_out.device != q.device:
        raise ValueError("d_out must lie on q's device")
    if not d_out.is_contiguous():
        raise ValueError("d_out must be contiguous")
    lq, lk, dh = q.shape[2], k.shape[2], q.shape[3]
    need = bwd_shared_bytes(lq, lk, dh)
    if need > MAX_BWD_SHARED_BYTES:
        raise ValueError(
            f"attention backward needs {need} bytes of shared memory for "
            f"Lq={lq}, Lk={lk}, Dh={dh}; one block holds at most "
            f"{MAX_BWD_SHARED_BYTES}")


def _fused_forward(q, k, v, mask_i8, temperature):
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask_i8 != 0, temperature)[0]
    out = torch.empty_like(q)
    _launch("fused_attention", (q, k, v, mask_i8, out), q, k, temperature)
    fused_attention.launches += 1
    return out


def fused_attention_bwd(q, k, v, mask_i8, d_out, temperature):
    """Gradients (dq, dk, dv) of ``fused_attention`` for the output
    gradient ``d_out`` [B,H,Lq,Dh] (contiguous, q's dtype).  A CUDA tensor
    launches the kernel of ``csrc/fused_attention_bwd.cu`` on the current
    stream and adds one to ``fused_attention_bwd.launches``; a CPU tensor
    takes ``attention_bwd_reference``.  Raises ``ValueError`` when one
    (b, h)'s tiles do not fit a block's shared memory
    (``bwd_shared_bytes``)."""
    _check_bwd(q, k, v, mask_i8, d_out, temperature)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, mask_i8, d_out, temperature)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("fused_attention_bwd", (q, k, v, mask_i8, d_out, dq, dk, dv),
            q, k, temperature)
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class FusedAttentionFn(torch.autograd.Function):
    """The JAX package's ``jax.custom_vjp`` fused attention: the residuals
    are (q, k, v, mask) and the backward recomputes P.  No gradient flows
    to the mask or the temperature."""

    @staticmethod
    def forward(ctx, q, k, v, mask_i8, temperature):
        ctx.save_for_backward(q, k, v, mask_i8)
        ctx.temperature = temperature
        return _fused_forward(q, k, v, mask_i8, temperature)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, mask_i8 = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, mask_i8,
                                         d_out.contiguous(), ctx.temperature)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_i8: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Differentiable fused attention (no dropout, no weight output).

    q [B,H,Lq,Dh], k/v [B,H,Lk,Dh] (f32 or bf16, contiguous, Dh <= 64),
    mask_i8 int8 [B,Lq,Lk] (nonzero = masked).  A CUDA tensor launches the
    kernel of ``csrc/fused_attention.cu`` on the current stream and adds one
    to ``fused_attention.launches``; its gradient launches
    ``fused_attention_bwd``.  A CPU tensor takes the plain versions.  Any
    other device raises."""
    _check(q, k, v, mask_i8, temperature)
    return FusedAttentionFn.apply(q, k, v, mask_i8, temperature)


fused_attention.launches = 0


def sdp_attention(q, k, v, mask, temperature, *,
                  dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = True,
                  need_weights: bool = True,
                  dropout_parts: Sequence[Part] = ()
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatch between the fused route and the plain path.

    A call that wants no weights and runs no dropout takes
    ``fused_attention``, whose wrapper picks by device: kernels #1 and #2
    on a CUDA tensor, the plain versions on a CPU one.  Any other call
    takes ``attention_reference``."""
    dropout_active = (not deterministic and dropout_rate > 0.0
                      and generator is not None)
    if not need_weights and not dropout_active:
        b, lq = q.shape[0], q.shape[2]
        lk = k.shape[2]
        mask_i8 = (torch.zeros((b, lq, lk), dtype=torch.int8,
                               device=q.device) if mask is None
                   else mask.to(torch.int8).contiguous())
        return fused_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), mask_i8, temperature), None
    out, attn = attention_reference(q, k, v, mask, temperature,
                                    dropout_rate=dropout_rate,
                                    generator=generator,
                                    deterministic=deterministic,
                                    dropout_parts=dropout_parts)
    return out, (attn if need_weights else None)
