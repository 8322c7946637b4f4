"""Fused ResNet identity bottlenecks: the plain versions and the CUDA kernels.

The counterpart of the JAX package's ``vision/pallas_bottleneck.py``.  A
stride-1 identity bottleneck with BN folded into a scale and a bias:

    h1 = relu(x . w1 * s1 + b1)            1x1 conv, C -> Wd
    h2 = relu(conv3x3(h1, w2) * s2 + b2)   3x3 conv, Wd -> Wd, pad 1
    y  = relu(h2 . w3 * s3 + b3 + x)       1x1 conv, Wd -> C

Products accumulate in f32, the epilogues run in f32, and h1, h2 and y are
rounded to x's dtype (the arithmetic of the TPU kernel, not of the plain
route ``vision/resnet._bottleneck``, which applies BN in x's dtype).

  * ``bottleneck_reference`` / ``stage_reference``: plain PyTorch, used for
    every CPU tensor and by the checks on the card;
  * ``fused_bottleneck`` (kernel #3) / ``fused_stage`` (kernel #4): on CUDA
    tensors the hand-written ``sm_90a`` kernel of
    ``csrc/fused_bottleneck.cu``, one launch per call (a whole stack of
    blocks for ``fused_stage``); each call adds one to its ``launches``.
    bf16 runs every phase as one GEMM over all crops on a persistent
    cooperative grid, one CTA per SM; f32 runs one thread block per crop.

Layout: x is an NCHW tensor in ``torch.channels_last`` memory (NHWC bytes,
what the kernel reads); the output has the same layout.  Weights are the
port's (torch) layout with the 1x1 kernels squeezed: w1 [Wd, C], w2
[Wd, Wd, 3, 3], w3 [C, Wd]; stacked with a leading block axis for
``fused_stage``, with scale/bias rows sb [n, 2, dim].
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the kernels' output tiles are 64 or 128 channels wide
CHANNEL_MULTIPLE = 64
# the kernels index an element of h1, h2 or y with a 32-bit int
_INT32_MAX = 2 ** 31 - 1


def check_kernel_shape(n: int, h: int, w: int, c: int, wd: int) -> None:
    """Raise on a shape the CUDA kernels do not take: C and Wd must be
    multiples of their 64-channel tiles, and N*H*W*max(C, Wd) must fit
    their 32-bit element index."""
    if c % CHANNEL_MULTIPLE or wd % CHANNEL_MULTIPLE:
        raise ValueError(f"the CUDA kernel takes C and Wd in multiples of "
                         f"{CHANNEL_MULTIPLE}, got C={c}, Wd={wd}")
    if n * h * w * max(c, wd) > _INT32_MAX:
        raise ValueError(f"{n * h * w} pixels of {max(c, wd)} channels "
                         f"overflow the kernel's 32-bit element index")


def _rows(v: torch.Tensor) -> torch.Tensor:
    return v.float()[None, :, None, None]


def bottleneck_reference(x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """One block in plain PyTorch with the kernel's arithmetic: the
    weights rounded to x's dtype, every conv in f32 (exact products of the
    rounded operands), the f32 epilogue, h1/h2/y rounded to x's dtype.  On
    the card it needs TF32 off for cuDNN to be a float32 reference."""
    dt = x.dtype
    xf = x.float()

    def conv(h, w, pad=0):
        w = w.to(dt).float()
        if w.dim() == 2:
            w = w[:, :, None, None]
        return F.conv2d(h, w, padding=pad)

    h1 = torch.relu(conv(xf, w1) * _rows(s1) + _rows(b1)).to(dt)
    h2 = torch.relu(conv(h1.float(), w2, 1) * _rows(s2) + _rows(b2)).to(dt)
    y = torch.relu(conv(h2.float(), w3) * _rows(s3) + _rows(b3) + xf)
    return y.to(dt).contiguous(memory_format=torch.channels_last)


def stage_reference(x, w1, sb1, w2, sb2, w3, sb3):
    """``bottleneck_reference`` over a stack of blocks, x carried in its
    dtype from block to block."""
    for i in range(w1.shape[0]):
        x = bottleneck_reference(x, w1[i], sb1[i, 0], sb1[i, 1], w2[i],
                                 sb2[i, 0], sb2[i, 1], w3[i], sb3[i, 0],
                                 sb3[i, 1])
    return x


def stack_identity_blocks(blocks: Sequence[dict]) -> Tuple[torch.Tensor, ...]:
    """Identity-block param dicts (``vision/resnet.py``, shared shapes) ->
    ``fused_stage``'s stacked (w1, sb1, w2, sb2, w3, sb3)."""
    def stk(f):
        return torch.stack([f(b) for b in blocks])

    def sb(bn):
        return torch.stack([bn["scale"], bn["bias"]])

    w1 = stk(lambda b: b["conv1"][:, :, 0, 0])
    w2 = stk(lambda b: b["conv2"])
    w3 = stk(lambda b: b["conv3"][:, :, 0, 0])
    return (w1, stk(lambda b: sb(b["bn1"])), w2, stk(lambda b: sb(b["bn2"])),
            w3, stk(lambda b: sb(b["bn3"])))


def params_from_block(block: dict) -> tuple:
    """An identity-block param dict -> ``fused_bottleneck``'s weights
    (w1, s1, b1, w2, s2, b2, w3, s3, b3)."""
    return (block["conv1"][:, :, 0, 0], block["bn1"]["scale"],
            block["bn1"]["bias"], block["conv2"], block["bn2"]["scale"],
            block["bn2"]["bias"], block["conv3"][:, :, 0, 0],
            block["bn3"]["scale"], block["bn3"]["bias"])


# ---------------------------------------------------------------------------
# The CUDA kernels
# ---------------------------------------------------------------------------

def _check(x, w1, sb1, w2, sb2, w3, sb3) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the fused bottleneck takes float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [N, C, H, W], got {tuple(x.shape)}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("x must be NHWC in memory (channels_last)")
    n, c, h, w = x.shape
    if min(n, c, h, w) < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if w1.dim() != 3 or w1.shape[2] != c:
        raise ValueError(f"w1 must be [n, Wd, {c}], got {tuple(w1.shape)}")
    nblk, wd = w1.shape[0], w1.shape[1]
    want = {"sb1": (sb1, (nblk, 2, wd)), "w2": (w2, (nblk, wd, wd, 3, 3)),
            "sb2": (sb2, (nblk, 2, wd)), "w3": (w3, (nblk, c, wd)),
            "sb3": (sb3, (nblk, 2, c))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} for x "
                             f"{tuple(x.shape)} and w1 {tuple(w1.shape)}, "
                             f"got {tuple(t.shape)}")
    for t in (w1, sb1, w2, sb2, w3, sb3):
        if not t.is_floating_point():
            raise TypeError(f"weights must be floating point, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("x and the weights must lie on one device")
    if x.device.type == "cuda":
        check_kernel_shape(n, h, w, c, wd)
        cap = torch.cuda.get_device_capability(x.device)
        if cap != (9, 0):
            raise RuntimeError(f"the fused bottleneck kernel is built for "
                               f"sm_90a; {x.device} is sm_{cap[0]}{cap[1]}")
    elif x.device.type != "cpu":
        raise ValueError(f"the fused bottleneck runs on cuda or cpu, not "
                         f"{x.device}")


def _entry(name: str, n_ints: int):
    fn = getattr(_build.load("fused_bottleneck"), name)
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 11 + [i32] * n_ints + [ptr]
        fn.restype = ctypes.c_int
    return fn


def _launch(entry: str, x, w1, sb1, w2, sb2, w3, sb3,
            max_ctas: int = 0) -> torch.Tensor:
    """Run the kernel ``entry`` of ``csrc/fused_bottleneck.cu`` on the
    current stream: weights cast to x's dtype and laid out K-major (w2 as
    [n, out, 3, 3, in]); scratch for h1 and h2 and, for bf16, the zeroed
    grid-barrier word allocated here.  bf16 launches one CTA per SM, or at
    most ``max_ctas`` where that is above 0 (the grid-independence check of
    ``chip_smoke.py``)."""
    dt = x.dtype
    n, c, h, w = x.shape
    nblk, wd = w1.shape[0], w1.shape[1]
    w1k = w1.to(dt).contiguous()
    w2k = w2.to(dt).permute(0, 1, 3, 4, 2).contiguous()
    w3k = w3.to(dt).contiguous()
    sbs = [t.float().contiguous() for t in (sb1, sb2, sb3)]
    y = torch.empty_like(x, memory_format=torch.channels_last)
    h1 = torch.empty((n, h, w, wd), dtype=dt, device=x.device)
    h2 = torch.empty_like(h1)
    bar = (torch.zeros(1, dtype=torch.int32, device=x.device)
           if dt == torch.bfloat16 else None)
    ints = ([n, h, w, c, wd] + ([nblk] if entry == "fused_stage" else [])
            + [max_ctas, _DTYPE_CODE[dt]])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _entry(entry, len(ints))(
            x.data_ptr(), y.data_ptr(), h1.data_ptr(), h2.data_ptr(),
            w1k.data_ptr(), sbs[0].data_ptr(), w2k.data_ptr(),
            sbs[1].data_ptr(), w3k.data_ptr(), sbs[2].data_ptr(),
            None if bar is None else bar.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")
    return y


def fused_bottleneck(x: torch.Tensor, w1, s1, b1, w2, s2, b2, w3, s3,
                     b3) -> torch.Tensor:
    """One identity bottleneck (the counterpart of the JAX package's
    ``fused_bottleneck``).  x [N, C, H, W] channels_last, f32 or bf16.  A
    CUDA tensor launches kernel #3 and adds one to
    ``fused_bottleneck.launches``; a CPU tensor takes
    ``bottleneck_reference``; anything the kernel does not take raises."""
    sb1 = torch.stack([s1, b1])[None]
    sb2 = torch.stack([s2, b2])[None]
    sb3 = torch.stack([s3, b3])[None]
    _check(x, w1[None], sb1, w2[None], sb2, w3[None], sb3)
    if x.device.type == "cpu":
        return bottleneck_reference(x, w1, s1, b1, w2, s2, b2, w3, s3, b3)
    y = _launch("fused_bottleneck", x, w1[None], sb1, w2[None], sb2,
                w3[None], sb3)
    fused_bottleneck.launches += 1
    return y


fused_bottleneck.launches = 0


def fused_stage(x: torch.Tensor, w1, sb1, w2, sb2, w3, sb3) -> torch.Tensor:
    """A stack of identity bottlenecks in one call (the counterpart of the
    JAX package's ``fused_stage``): stacked w1 [n, Wd, C], sb1 [n, 2, Wd],
    w2 [n, Wd, Wd, 3, 3], sb2 [n, 2, Wd], w3 [n, C, Wd], sb3 [n, 2, C].
    A CUDA tensor launches kernel #4 once for the whole stack and adds one
    to ``fused_stage.launches``; a CPU tensor takes ``stage_reference``."""
    _check(x, w1, sb1, w2, sb2, w3, sb3)
    if x.device.type == "cpu":
        return stage_reference(x, w1, sb1, w2, sb2, w3, sb3)
    y = _launch("fused_stage", x, w1, sb1, w2, sb2, w3, sb3)
    fused_stage.launches += 1
    return y


fused_stage.launches = 0
