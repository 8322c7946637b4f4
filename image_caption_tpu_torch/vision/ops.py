"""Image ops on the device: batched crop-and-resize, letterbox geometry, box
unmapping.

The counterpart of the JAX package's ``vision/ops.py``.  Cropping IS
resizing: each output patch is sampled straight from the letterboxed
canvas.  JAX does it with ``jax.image.scale_and_translate`` (Keys cubic,
a = -0.5, no antialiasing, a per-box scale and translation); PyTorch has no
such call (``F.interpolate``'s bicubic uses a = -0.75 and takes no
translation), so this module builds the same dense [out, in] weight
matrices per box, with JAX's normalisation and its zeroing of samples
outside the image, and applies them as two batched matmuls.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_EPS32 = float(np.finfo(np.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 on |distance|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resample_weights(lo: torch.Tensor, hi: torch.Tensor, in_size: int,
                     out_size: int, method: str = "cubic") -> torch.Tensor:
    """Sampling weights [..., out_size, in_size] that map the span
    [lo, hi) (pixels, any leading shape) onto ``out_size`` samples: JAX's
    ``compute_weight_mat`` with scale = out / max(hi - lo, 1e-3) and
    translation = -lo * scale, in float32."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; expected one "
                         f"of {sorted(_KERNELS)}")
    lo = lo.float()
    scale = out_size / torch.clamp(hi.float() - lo, min=1e-3)
    translation = -lo * scale
    inv_scale = 1.0 / scale
    dev = lo.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    sample = ((i + 0.5) * inv_scale[..., None]
              - (translation * inv_scale)[..., None] - 0.5)  # [..., out]
    src = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = _KERNELS[method]((sample[..., :, None] - src).abs())  # [.., out, in]
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * _EPS32,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[..., None], w, torch.zeros_like(w))


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor,
                    out_size: int = 224,
                    method: str = "cubic") -> torch.Tensor:
    """images [B, H, W, C] (float, any device), boxes [B, M, 4] xyxy pixels
    -> [B, M, out_size, out_size, C] in the images' dtype.  The weights are
    computed in float32 and cast to that dtype, as JAX casts them."""
    b, h, w, c = images.shape
    m = boxes.shape[1]
    s = out_size
    dt = images.dtype
    boxes = boxes.float()
    wy = resample_weights(boxes[..., 1], boxes[..., 3], h, s, method)
    wx = resample_weights(boxes[..., 0], boxes[..., 2], w, s, method)
    # rows: [B, M*S, H] @ [B, H, W*C] -> [B, M, S, W, C]
    rows = torch.matmul(wy.to(dt).reshape(b, m * s, h),
                        images.reshape(b, h, w * c))
    rows = rows.reshape(b * m, s, w, c).permute(0, 2, 1, 3)    # [BM,W,S,C]
    # columns: [BM, S, W] @ [BM, W, S*C] -> [BM, S(x), S(y), C]
    out = torch.matmul(wx.to(dt).reshape(b * m, s, w),
                       rows.reshape(b * m, w, s * c))
    return out.reshape(b, m, s, s, c).transpose(2, 3)


def letterbox_params(h: int, w: int, size: int
                     ) -> Tuple[float, int, int, int, int]:
    """YOLO letterbox geometry: scale and top/left padding of an h x w
    image centred on a size x size canvas (fit the long side)."""
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    top = (size - nh) // 2
    left = (size - nw) // 2
    return r, nh, nw, top, left


def letterbox_params_rect(h: int, w: int, size: int, stride: int = 32
                          ) -> Tuple[float, int, int, int, int, int, int]:
    """Ultralytics ``auto=True`` rectangular letterbox geometry: scale to
    fit, pad the short side only to the next multiple of ``stride``, split
    with the 0.1-offset rounding.  Returns (r, nh, nw, top, left, rect_h,
    rect_w); the rect sits at the top-left of the square canvas and the
    detector masks cells beyond it."""
    r = min(size / h, size / w)
    nh, nw = int(round(h * r)), int(round(w * r))
    dh, dw = (size - nh) % stride, (size - nw) % stride
    top = int(round(dh / 2 - 0.1))
    bottom = int(round(dh / 2 + 0.1))
    left = int(round(dw / 2 - 0.1))
    right = int(round(dw / 2 + 0.1))
    return r, nh, nw, top, left, nh + top + bottom, nw + left + right


def unletterbox_boxes(boxes: torch.Tensor, metas: torch.Tensor,
                      orig_h: torch.Tensor,
                      orig_w: torch.Tensor) -> torch.Tensor:
    """Canvas xyxy boxes [B, K, 4] -> original-image pixels, clipped;
    metas [B, >=3] (scale, top, left), orig_h/orig_w [B]."""
    r = metas[:, 0, None]
    top, left = metas[:, 1, None], metas[:, 2, None]
    oh, ow = orig_h[:, None], orig_w[:, None]
    x1 = torch.minimum(torch.clamp((boxes[..., 0] - left) / r, min=0), ow)
    y1 = torch.minimum(torch.clamp((boxes[..., 1] - top) / r, min=0), oh)
    x2 = torch.minimum(torch.clamp((boxes[..., 2] - left) / r, min=0), ow)
    y2 = torch.minimum(torch.clamp((boxes[..., 3] - top) / r, min=0), oh)
    return torch.stack([x1, y1, x2, y2], dim=-1)
