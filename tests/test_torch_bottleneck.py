"""The plain versions of the fused bottleneck kernels (#3 and #4) against the
JAX package's Pallas kernels run in interpret mode, the kernels' wrappers
on CPU tensors, and the wrappers' input checks.  The CUDA kernel itself is
held against these plain versions on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.vision import pallas_bottleneck as JB
from image_caption_tpu_torch.ops import _build
from image_caption_tpu_torch.utils.weights import resnet_state_from_jax_params
from image_caption_tpu_torch.vision import bottleneck as TB

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _block(seed, c, wd):
    """A random identity block in the JAX package's layout (HWIO)."""
    rng = np.random.RandomState(seed)

    def bn(n, lo):
        return {"scale": (rng.rand(n) * 0.5 + lo).astype(np.float32),
                "bias": (rng.randn(n) * 0.1).astype(np.float32)}

    def conv(k, ci, co):
        return (rng.randn(k, k, ci, co) * np.sqrt(2.0 / (k * k * ci))
                ).astype(np.float32)
    return {"conv1": conv(1, c, wd), "bn1": bn(wd, 0.5),
            "conv2": conv(3, wd, wd), "bn2": bn(wd, 0.5),
            "conv3": conv(1, wd, c), "bn3": bn(c, 0.2)}


def _x(seed, n, h, c):
    """Post-relu activations: NHWC numpy, and the port's NCHW view of the
    same bytes (channels_last)."""
    x = np.maximum(np.random.RandomState(seed).randn(n, h, h, c), 0).astype(
        np.float32)
    return x, torch.from_numpy(x).permute(0, 3, 1, 2)


def _port_layout(y: torch.Tensor) -> np.ndarray:
    return y.float().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
def test_bottleneck_reference_matches_pallas_kernel(dtype, tol, n):
    jdt, tdt = DTYPES[dtype]
    blk = _block(0, 64, 32)
    xn, xt = _x(1, n, 7, 64)
    want = JB.fused_bottleneck(jnp.asarray(xn).astype(jdt),
                               *JB.params_from_block(blk), interpret=True)
    port_blk = resnet_state_from_jax_params(blk)
    got = TB.bottleneck_reference(xt.to(tdt), *TB.params_from_block(port_blk))
    assert got.dtype == tdt
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(_port_layout(got),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # the wrapper on a CPU tensor is the plain version and launches nothing
    before = TB.fused_bottleneck.launches
    wrapped = TB.fused_bottleneck(xt.to(tdt), *TB.params_from_block(port_blk))
    assert torch.equal(wrapped, got)
    assert TB.fused_bottleneck.launches == before


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5), ("bfloat16", 3e-2)])
def test_stage_reference_matches_pallas_stage(dtype, tol, n):
    jdt, tdt = DTYPES[dtype]
    blocks = [_block(10 + i, 64, 32) for i in range(3)]
    xn, xt = _x(2, n, 6, 64)
    want = JB.fused_stage(jnp.asarray(xn).astype(jdt),
                          *JB.stack_identity_blocks(
                              jax.tree_util.tree_map(jnp.asarray, blocks)),
                          interpret=True)
    stacked = TB.stack_identity_blocks(
        [resnet_state_from_jax_params(b) for b in blocks])
    got = TB.stage_reference(xt.to(tdt), *stacked)
    np.testing.assert_allclose(_port_layout(got),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    before = TB.fused_stage.launches
    assert torch.equal(TB.fused_stage(xt.to(tdt), *stacked), got)
    assert TB.fused_stage.launches == before


def test_stacked_weights_are_the_jax_stack_in_torch_layout():
    blocks = [_block(20 + i, 64, 32) for i in range(2)]
    w1, sb1, w2, sb2, w3, sb3 = (np.asarray(a) for a in JB.stack_identity_blocks(
        jax.tree_util.tree_map(jnp.asarray, blocks)))
    t = [a.numpy() for a in TB.stack_identity_blocks(
        [resnet_state_from_jax_params(b) for b in blocks])]
    np.testing.assert_array_equal(t[0], w1.transpose(0, 2, 1))
    np.testing.assert_array_equal(t[2], w2.transpose(0, 4, 3, 1, 2))
    np.testing.assert_array_equal(t[4], w3.transpose(0, 2, 1))
    for got, want in zip(t[1::2], (sb1, sb2, sb3)):
        np.testing.assert_array_equal(got, want)


def _args(n=2, c=64, wd=32, h=5, nblk=2):
    g = torch.Generator().manual_seed(0)
    x = torch.rand(n, c, h, h, generator=g).contiguous(
        memory_format=torch.channels_last)
    return [x, torch.randn(nblk, wd, c, generator=g),
            torch.rand(nblk, 2, wd, generator=g),
            torch.randn(nblk, wd, wd, 3, 3, generator=g),
            torch.rand(nblk, 2, wd, generator=g),
            torch.randn(nblk, c, wd, generator=g),
            torch.rand(nblk, 2, c, generator=g)]


@pytest.mark.parametrize("case,error,match", [
    ("float16", TypeError, "float32 or bfloat16"),
    ("three_dims", ValueError, r"\[N, C, H, W\]"),
    ("nchw_memory", ValueError, "channels_last"),
    ("w1_width", ValueError, "w1"),
    ("w2_shape", ValueError, "w2"),
    ("sb3_shape", ValueError, "sb3"),
    ("int_weights", TypeError, "floating"),
    ("meta_device", ValueError, "cuda or cpu"),
])
def test_fused_stage_rejects_bad_input(case, error, match):
    a = _args()
    if case == "float16":
        a[0] = a[0].half()
    elif case == "three_dims":
        a[0] = a[0][0]
    elif case == "nchw_memory":
        a[0] = a[0].contiguous()
    elif case == "w1_width":
        a[1] = a[1][:, :, :32]
    elif case == "w2_shape":
        a[3] = a[3][:, :, :, :1]
    elif case == "sb3_shape":
        a[6] = a[6][:, :, :32]
    elif case == "int_weights":
        a[5] = a[5].long()
    elif case == "meta_device":
        a = [t.to("meta") for t in a]
    with pytest.raises(error, match=match):
        TB.fused_stage(*a)


def test_fused_bottleneck_rejects_mismatched_widths():
    x, w1, sb1, w2, sb2, w3, sb3 = _args(nblk=1)
    with pytest.raises(ValueError, match="sb3"):
        TB.fused_bottleneck(x, w1[0], sb1[0, 0], sb1[0, 1], w2[0], sb2[0, 0],
                            sb2[0, 1], w3[0], sb3[0, 0, :16], sb3[0, 1, :16])


def test_the_kernel_source_is_built_with_the_others():
    assert "fused_bottleneck" in _build.KERNELS
    src = (_build.CSRC / "fused_bottleneck.cu").read_text()
    assert 'extern "C" int fused_bottleneck(' in src
    assert 'extern "C" int fused_stage(' in src
    # bf16 multiplies on wgmma under a cooperative (all-resident) launch
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "cudaLaunchAttributeCooperative" in src
    assert "cp.async.bulk.tensor.2d" in src      # TMA: weights, 1x1 rows
    assert "cp.async.cg.shared.global" in src   # the 3x3 gather
    assert _build.library_path("fused_bottleneck").name.startswith(
        "libfused_bottleneck-")


# ResNet-101's identity runs (h, C, Wd) at the crop counts the card check
# uses, 36 (the last batch of a 70-image caption run) among them
@pytest.mark.parametrize("n", [192, 133, 36, 5, 3, 1])
@pytest.mark.parametrize("h,c,wd", [(56, 256, 64), (28, 512, 128),
                                    (14, 1024, 256), (7, 2048, 512)])
def test_the_kernel_takes_every_resnet101_identity_run(n, h, c, wd):
    TB.check_kernel_shape(n, h, h, c, wd)


@pytest.mark.parametrize("args,match", [
    ((1, 7, 7, 96, 64), "multiples of 64"),
    ((1, 7, 7, 256, 32), "multiples of 64"),
    ((2 ** 20, 56, 56, 256, 64), "32-bit"),
    ((2 ** 31 // (56 * 56 * 256) + 1, 56, 56, 256, 64), "32-bit"),
])
def test_the_kernel_shape_check_refuses_what_the_kernel_does_not_take(
        args, match):
    with pytest.raises(ValueError, match=match):
        TB.check_kernel_shape(*args)
