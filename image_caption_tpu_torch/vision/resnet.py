"""ResNet region encoder (ResNet-101: crops -> 2048-d global features) and
trunk (ResNet-50: Faster R-CNN's C2-C5 maps).

The counterpart of the JAX package's ``vision/resnet.py``: torchvision's
resnet101 truncated after the average pool, or any other blocks per stage
(``RESNET50_STAGES`` for Faster R-CNN's body), with inference BatchNorm
folded into a scale and a bias per channel.  Parameters are nested dicts of
tensors, conv kernels in torch OIHW layout.  Activations run NCHW in
``channels_last`` memory, so cuDNN runs channels-last convolutions and the
fused bottleneck kernel reads NHWC bytes without a transpose.

Identity bottlenecks (stride 1, no downsample) come in runs inside each
stage (2, 3, 22 and 2 for ResNet-101).  With ``use_kernel=True`` every run
goes through ``vision/bottleneck.fused_stage``: kernel #4 on CUDA tensors,
one launch per run.  With ``use_kernel=False``, and for the stem, the
strided and the downsample blocks, each conv is ``F.conv2d`` with BN in
the compute dtype, as the JAX package's XLA route computes it.
``resnet_feature_maps`` (the stage outputs the ``roi`` feature mode pools
from) runs that route only.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .bottleneck import fused_stage, stack_identity_blocks

Params = Dict[str, Any]

# torchvision resnet101 and resnet50: blocks per stage
RESNET101_STAGES = (3, 4, 23, 3)
RESNET50_STAGES = (3, 4, 6, 3)
BN_EPS = 1e-5

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


# ---------------------------------------------------------------------------
# Init (random weights: no checkpoint ships with the repository)
# ---------------------------------------------------------------------------

def _conv_init(gen, k, cin, cout):
    """torch kaiming_normal(fan_out, relu)."""
    std = math.sqrt(2.0 / (k * k * cout))
    return torch.randn((cout, cin, k, k), generator=gen) * std


def _bn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_resnet(generator: Optional[torch.Generator] = None,
                stages: Sequence[int] = RESNET101_STAGES) -> Params:
    """Random CPU float32 parameters (identity BN) from ``generator`` (seed
    0 if None)."""
    gen = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    p: Params = {"stem": {"conv": _conv_init(gen, 7, 3, 64),
                          "bn": _bn_init(64)},
                 "layers": []}
    cin = 64
    for i, num_blocks in enumerate(stages):
        width = 64 * 2 ** i
        cout = width * 4
        blocks = []
        for b in range(num_blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            c_in = cin if b == 0 else cout
            blk = {"conv1": _conv_init(gen, 1, c_in, width),
                   "bn1": _bn_init(width),
                   "conv2": _conv_init(gen, 3, width, width),
                   "bn2": _bn_init(width),
                   "conv3": _conv_init(gen, 1, width, cout),
                   "bn3": _bn_init(cout)}
            if stride != 1 or c_in != cout:
                blk["downsample"] = {"conv": _conv_init(gen, 1, c_in, cout),
                                     "bn": _bn_init(cout)}
            blocks.append(blk)
        p["layers"].append(blocks)
        cin = cout
    return p


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _conv(x, w, stride=1, padding=0):
    return F.conv2d(x, w.to(x.dtype), stride=stride, padding=padding)


def _bn(x, p):
    return x * p["scale"].to(x.dtype)[None, :, None, None] \
        + p["bias"].to(x.dtype)[None, :, None, None]


def _bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """One bottleneck, BN in x's dtype (the plain route)."""
    out = torch.relu(_bn(_conv(x, p["conv1"]), p["bn1"]))
    out = torch.relu(_bn(_conv(out, p["conv2"], stride, 1), p["bn2"]))
    out = _bn(_conv(out, p["conv3"]), p["bn3"])
    if "downsample" in p:
        x = _bn(_conv(x, p["downsample"]["conv"], stride), p["downsample"]["bn"])
    return torch.relu(out + x)


def resnet_features(params: Params, images: torch.Tensor, *,
                    compute_dtype=torch.float32,
                    use_kernel: bool = False) -> torch.Tensor:
    """[N, H, W, 3] ImageNet-normalized images -> [N, 2048] float32
    features (stem, 4 stages, global average pool, as torchvision's
    ``children()[:9]``).  The mean is taken in float32 and rounded to the
    compute dtype, as ``jnp.mean`` does."""
    x = images.to(compute_dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    x = torch.relu(_bn(_conv(x, params["stem"]["conv"], 2, 3),
                       params["stem"]["bn"]))
    x = F.max_pool2d(x, 3, 2, 1)
    for i, blocks in enumerate(params["layers"]):
        run = []                  # consecutive identity blocks
        for b, block in enumerate(blocks):
            stride = 2 if (b == 0 and i > 0) else 1
            if use_kernel and stride == 1 and "downsample" not in block:
                run.append(block)
                continue
            if run:
                x = fused_stage(x.contiguous(memory_format=torch.channels_last),
                                *stack_identity_blocks(run))
                run = []
            x = _bottleneck(block, x, stride)
        if run:
            x = fused_stage(x.contiguous(memory_format=torch.channels_last),
                            *stack_identity_blocks(run))
    return x.mean(dim=(2, 3), dtype=torch.float32).to(x.dtype).float()


def resnet_feature_maps(params: Params, images: torch.Tensor, *,
                        compute_dtype=torch.float32) -> List[torch.Tensor]:
    """[N, H, W, 3] ImageNet-normalized images -> the four stage outputs
    [C2, C3, C4, C5] (strides 4, 8, 16 and 32) as [N, h, w, C] views in
    the compute dtype, on the plain route: the JAX package computes them
    outside its Pallas kernel (``roi`` mode's trunk, Faster R-CNN's
    body)."""
    x = images.to(compute_dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)
    x = torch.relu(_bn(_conv(x, params["stem"]["conv"], 2, 3),
                       params["stem"]["bn"]))
    x = F.max_pool2d(x, 3, 2, 1)
    maps = []
    for i, blocks in enumerate(params["layers"]):
        for b, block in enumerate(blocks):
            x = _bottleneck(block, x, 2 if (b == 0 and i > 0) else 1)
        maps.append(x.permute(0, 2, 3, 1))
    return maps


# ---------------------------------------------------------------------------
# torchvision state_dict import
# ---------------------------------------------------------------------------

def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _fold_bn(sd, prefix):
    gamma, beta = _np(sd[f"{prefix}.weight"]), _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": torch.from_numpy(scale),
            "bias": torch.from_numpy(beta - mean * scale)}


def _conv_w(sd, name):
    return torch.from_numpy(_np(sd[name]).copy())


def _stages_in(sd: Dict[str, Any]) -> Tuple[int, ...]:
    """Blocks per stage of a torchvision resnet state_dict."""
    stages = []
    while f"layer{len(stages) + 1}.0.conv1.weight" in sd:
        i, n = len(stages) + 1, 0
        while f"layer{i}.{n}.conv1.weight" in sd:
            n += 1
        stages.append(n)
    return tuple(stages)


def import_torch_state_dict(sd: Dict[str, Any],
                            stages: Optional[Sequence[int]] = None
                            ) -> Params:
    """A torchvision resnet state_dict (tensors or arrays) -> CPU float32
    parameters, BN folded at eps 1e-5.  ``stages`` (blocks per stage) is
    read from the keys when not given."""
    if stages is None:
        stages = _stages_in(sd)
    p: Params = {"stem": {"conv": _conv_w(sd, "conv1.weight"),
                          "bn": _fold_bn(sd, "bn1")},
                 "layers": []}
    for i, num_blocks in enumerate(stages):
        blocks = []
        for b in range(num_blocks):
            pre = f"layer{i + 1}.{b}"
            blk = {"conv1": _conv_w(sd, f"{pre}.conv1.weight"),
                   "bn1": _fold_bn(sd, f"{pre}.bn1"),
                   "conv2": _conv_w(sd, f"{pre}.conv2.weight"),
                   "bn2": _fold_bn(sd, f"{pre}.bn2"),
                   "conv3": _conv_w(sd, f"{pre}.conv3.weight"),
                   "bn3": _fold_bn(sd, f"{pre}.bn3")}
            if f"{pre}.downsample.0.weight" in sd:
                blk["downsample"] = {
                    "conv": _conv_w(sd, f"{pre}.downsample.0.weight"),
                    "bn": _fold_bn(sd, f"{pre}.downsample.1")}
            blocks.append(blk)
        p["layers"].append(blocks)
    return p


def load_torch_checkpoint(path: str,
                          stages: Optional[Sequence[int]] = None) -> Params:
    """A torchvision resnet ``.pth``/``.pt`` state_dict or an ``.npz``."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return import_torch_state_dict(dict(z), stages)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return import_torch_state_dict(sd, stages)
