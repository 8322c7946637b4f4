"""Scaled dot-product attention: the plain path and the fused CUDA kernel.

Semantics match the reference (modules.py:6-27):
``softmax(q/temperature @ k^T  masked_fill -inf)``, optional dropout on the
attention weights, then ``@ v``.  Returns ``(output, attention_weights)``.

  * ``attention_reference`` — plain PyTorch, the counterpart of the JAX
    package's ``_attention_xla``; used whenever the weights are wanted or
    dropout runs, and for every CPU tensor.
  * ``fused_attention`` — the hand-written ``sm_90a`` kernel in
    ``csrc/fused_attention.cu`` for CUDA tensors (forward only).

Shapes: q [B, H, Lq, Dh], k/v [B, H, Lk, Dh], mask bool [B, Lq, Lk]
(True = masked).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

_NEG_INF = float("-inf")


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            deterministic: bool) -> torch.Tensor:
    """Inverted dropout (scale by 1/(1-p) in training).  Without a
    generator it is off, as the JAX version is without an rng."""
    if deterministic or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator,
                      device=generator.device) >= rate
    return torch.where(keep.to(x.device), x / (1.0 - rate),
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
                        deterministic: bool = True):
    """Plain path: scores and weighted sum in f32, output in q's dtype."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() / temperature,
                          k.float())
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :, :], _NEG_INF)
        attn = masked_softmax(scores)
    else:
        attn = torch.softmax(scores, dim=-1)
    attn_dropped = dropout(attn, dropout_rate, generator, deterministic)
    out = torch.einsum("bhqk,bhkd->bhqd", attn_dropped, v.float())
    return out.to(q.dtype), attn


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64


def _kernel():
    lib = _build.load("fused_attention")
    fn = lib.fused_attention_fwd
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                       ctypes.c_float, i32, ptr]
        fn.restype = ctypes.c_int
    return fn


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


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask_i8: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """Fused attention forward (no dropout, no weight output).

    q [B,H,Lq,Dh], k/v [B,H,Lk,Dh] (f32 or bf16, contiguous, Dh <= 64),
    mask_i8 int8 [B,Lq,Lk] (nonzero = masked).  A CUDA tensor launches the
    kernel of ``csrc/fused_attention.cu`` on the current stream and adds one
    to ``fused_attention.launches``; a CPU tensor takes
    ``attention_reference``.  Any other device raises."""
    _check(q, k, v, mask_i8, temperature)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, mask_i8 != 0, temperature)[0]
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, "
                         f"not {q.device}")
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        mask_i8.data_ptr(), out.data_ptr(), b, h, lq, lk, dh,
                        1.0 / temperature, _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: "
                           f"CUDA error {err}")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def sdp_attention(q, k, v, mask, temperature, *,
                  dropout_rate: float = 0.0,
                  generator: Optional[torch.Generator] = None,
                  deterministic: bool = True,
                  use_kernel: bool = False,
                  need_weights: bool = True
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Dispatch between the fused kernel and the plain path.

    ``use_kernel`` is the JAX package's ``use_pallas``, renamed: the fused
    kernel runs when the caller asks for it, needs no weights and runs no
    dropout; otherwise the plain path runs.  On a CPU tensor the kernel's
    wrapper itself takes the plain path."""
    dropout_active = (not deterministic and dropout_rate > 0.0
                      and generator is not None)
    if use_kernel and not need_weights and not dropout_active:
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
                                    deterministic=deterministic)
    return out, (attn if need_weights else None)
