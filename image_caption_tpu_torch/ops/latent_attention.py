"""The absorbed latent attention of an ``mla_moe`` decode step: the plain
path and the CUDA kernel.

For each batch row and head, over the latent cache's rows t = 0..pos
where ``visible`` lets them through:

    s_t = scale * (q_lat . c_t[:r] + q_pe . c_t[r:])     (float32)
    out = Σ_t softmax(s)_t c_t[:r]

with ``r`` the latent width: the scores and the softmax in float32, the
weights rounded to the cache's dtype for the weighted sum, as
``models/lm.MLA.step`` computed them (it now calls ``latent_attention``).

  * ``latent_attention_reference``: plain PyTorch, for every CPU tensor;
  * ``latent_attention``: on CUDA tensors the hand-written ``sm_90a``
    kernel of ``csrc/mla_decode.cu`` (published sizes only: 16 heads,
    latent 512, rope 64, at most ``MAX_ROWS`` cache rows, bf16), which
    reads ``pos`` on the device and loads no row after it; on CPU tensors
    the plain version.

Shapes: q_lat [B, H, r], q_pe [B, H, e], cache [B, T, r + e], visible
[B, T] bool, pos a long tensor [1] on the same device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

HEADS, LATENT, ROPE = 16, 512, 64
# the most cache rows a block of the kernel holds (six tiles of 16)
MAX_ROWS = 96


def latent_attention_reference(q_lat, q_pe, cache, visible, pos, scale):
    """The plain version: [B, H, r] in the cache's dtype."""
    r = q_lat.shape[-1]
    q = torch.cat([q_lat, q_pe], dim=-1)
    scores = torch.bmm(q.float(), cache.transpose(1, 2).float()) * scale
    order = torch.arange(cache.shape[1], device=cache.device)
    scores = scores.masked_fill(~(visible & (order <= pos))[:, None],
                                float("-inf"))
    a = torch.softmax(scores, dim=-1).to(cache.dtype)
    return torch.bmm(a, cache[..., :r])


def check(q_lat, q_pe, cache, visible, pos, kernel: bool) -> None:
    """Raise on inputs the function does not take; ``kernel``: on inputs
    the CUDA kernel does not take (its published sizes, dtype and
    layout)."""
    if q_lat.dim() != 3 or q_pe.dim() != 3 or cache.dim() != 3:
        raise ValueError("q_lat, q_pe must be [B, H, *] and cache [B, T, *]")
    b, h, r = q_lat.shape
    t = cache.shape[1]
    if q_pe.shape[:2] != (b, h) or cache.shape != (b, t, r + q_pe.shape[2]):
        raise ValueError(f"shape mismatch: q_lat {tuple(q_lat.shape)}, "
                         f"q_pe {tuple(q_pe.shape)}, cache "
                         f"{tuple(cache.shape)}")
    if visible.shape != (b, t) or visible.dtype != torch.bool:
        raise ValueError(f"visible must be bool [{b}, {t}], got "
                         f"{visible.dtype} {tuple(visible.shape)}")
    if pos.shape != (1,) or pos.dtype != torch.long:
        raise ValueError(f"pos must be a long tensor [1], got {pos.dtype} "
                         f"{tuple(pos.shape)}")
    if len({x.device for x in (q_lat, q_pe, cache, visible, pos)}) != 1:
        raise ValueError("every input must lie on one device")
    if cache.device.type not in ("cuda", "cpu"):
        raise ValueError(f"latent_attention runs on cuda or cpu, not "
                         f"{cache.device}")
    if q_lat.dtype != cache.dtype or q_pe.dtype != cache.dtype:
        raise TypeError("q_lat, q_pe and cache must share one dtype")
    if not kernel:
        return
    if cache.dtype != torch.bfloat16:
        raise TypeError(f"the kernel takes bfloat16, got {cache.dtype}")
    if (h, r, q_pe.shape[2]) != (HEADS, LATENT, ROPE):
        raise ValueError(f"the kernel takes {HEADS} heads, latent {LATENT} "
                         f"and rope {ROPE}, got {h}, {r}, {q_pe.shape[2]}")
    if not 1 <= t <= MAX_ROWS:
        raise ValueError(f"the kernel takes 1 to {MAX_ROWS} cache rows, "
                         f"got {t}")
    if not (cache.is_contiguous() and visible.is_contiguous()):
        raise ValueError("cache and visible must be contiguous")
    for name, x in (("q_lat", q_lat), ("q_pe", q_pe)):
        if x.stride(2) != 1 or x.stride(0) % 2 or x.stride(1) % 2 \
                or x.data_ptr() % 4:
            raise ValueError(f"{name} must have a contiguous last dim, even "
                             f"strides and a 4-byte aligned start, got "
                             f"strides {x.stride()}")
    if cache.data_ptr() % 16:
        raise ValueError("cache must start 16-byte aligned")


def _kernel():
    fn = _build.load("mla_decode").mla_decode
    if fn.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i64, i64, ptr, i64, i64, ptr, ptr, ptr, ptr,
                       i32, i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    return fn


def latent_attention(q_lat: torch.Tensor, q_pe: torch.Tensor,
                     cache: torch.Tensor, visible: torch.Tensor,
                     pos: torch.Tensor, scale: float) -> torch.Tensor:
    """The attention of the tokens at ``pos`` over the cache rows 0..pos
    where ``visible``: [B, H, r] in the cache's dtype.  A CUDA tensor
    launches the kernel of ``csrc/mla_decode.cu`` on the current stream
    (its output lies as [H, B, r]; the result is a view of it) and adds one
    to ``latent_attention.launches``, or raises; a CPU tensor takes the
    plain version."""
    kernel = q_lat.device.type != "cpu"
    check(q_lat, q_pe, cache, visible, pos, kernel)
    if not kernel:
        return latent_attention_reference(q_lat, q_pe, cache, visible, pos,
                                          scale)
    b, h, r = q_lat.shape
    out = torch.empty((h, b, r), dtype=cache.dtype, device=cache.device)
    with torch.cuda.device(cache.device):
        err = _kernel()(
            q_lat.data_ptr(), q_lat.stride(0), q_lat.stride(1),
            q_pe.data_ptr(), q_pe.stride(0), q_pe.stride(1),
            cache.data_ptr(), visible.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, cache.shape[1], scale,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mla_decode kernel launch failed: CUDA error "
                           f"{err}")
    latent_attention.launches += 1
    return out.transpose(0, 1)


latent_attention.launches = 0
