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
    # bf16 multiplies on wgmma under a cooperative (all-resident) launch;
    # f32 on wgmma too, in three TF32 passes of operands split by cvt.rna
    assert "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16" in src
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in src
    assert "cvt.rna.tf32.f32" in src
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


# ---------------------------------------------------------------------------
# The f32 kernel's arithmetic: three TF32 passes
# ---------------------------------------------------------------------------

def _tf32_oracle(v: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away from zero, to 10 stored mantissa bits,
    in float64 arithmetic: normal float32 values only."""
    v = v.astype(np.float64)
    _, e = np.frexp(v)                 # v = m 2^e, 0.5 <= |m| < 1
    ulp = np.ldexp(1.0, e - 11)        # TF32's spacing at v
    return (np.sign(v) * np.floor(np.abs(v) / ulp + 0.5) * ulp).astype(
        np.float32)


def test_tf32_round_is_round_to_nearest_ties_away_on_ten_mantissa_bits():
    rng = np.random.RandomState(3)
    v = (rng.randn(20000) * np.exp(rng.uniform(-30, 30, 20000))).astype(
        np.float32)
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 3 * 2 ** -11 + 1,
                     1 + 2 ** -12, 1.5 + 2 ** -11], np.float32)
    v = np.concatenate([v, ties])
    got = TB.tf32_round(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, _tf32_oracle(v))
    np.testing.assert_array_equal(got[-5:], np.array(
        [1 + 2 ** -10, -(1 + 2 ** -10), 1 + 2 ** -9, 1, 1.5 + 2 ** -10],
        np.float32))


def test_tf32_split_parts_are_tf32_and_recover_the_weight():
    rng = np.random.RandomState(4)
    w = (rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(
        np.float32)
    hi, lo = TB.tf32_split(torch.from_numpy(w))
    for part in (hi, lo):              # 13 low mantissa bits zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    hi, lo = hi.numpy().astype(np.float64), lo.numpy().astype(np.float64)
    # hi + lo recovers w within one TF32 ulp of lo (half an ulp: rounded)
    _, e = np.frexp(lo)
    ulp_lo = np.where(lo != 0, np.ldexp(1.0, e - 11), 0.0)
    assert np.all(np.abs(w - hi - lo) <= 0.5 * ulp_lo)
    assert np.all(np.abs(w - hi - lo) <= 2.0 ** -22 * np.abs(w))
    assert np.all(np.abs(lo) <= 2.0 ** -11 * np.abs(w))


def test_tf32_split_keeps_signs_zeros_and_subnormals():
    tiny = np.float32(2.0 ** -136)     # TF32's subnormal spacing
    w = np.array([0.0, -0.0, 3 * tiny, -5 * tiny, tiny + np.float32(2.0 ** -149),
                  -(7 * tiny + np.float32(2.0 ** -140)), 2.0 ** -149,
                  np.finfo(np.float32).tiny], np.float32)
    hi, lo = (t.numpy() for t in TB.tf32_split(torch.from_numpy(w)))
    np.testing.assert_array_equal(np.signbit(hi[:2]), [False, True])
    np.testing.assert_array_equal(hi[:2], [0.0, 0.0])
    np.testing.assert_array_equal(lo[:2], [0.0, 0.0])
    # a subnormal TF32 value is its own high part
    np.testing.assert_array_equal(hi[2:4], w[2:4])
    np.testing.assert_array_equal(lo[2:4], [0.0, 0.0])
    # a subnormal below TF32's spacing rounds to it, sign kept
    np.testing.assert_array_equal(hi[4:6], [tiny, -7 * tiny])
    assert np.all(np.abs(w[4:6].astype(np.float64) - hi[4:6] - lo[4:6])
                  <= 2.0 ** -137)
    np.testing.assert_array_equal(hi[6:], [0.0, np.finfo(np.float32).tiny])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_layout(dtype):
    _, w1, _, w2, _, w3, _ = _args(nblk=2)
    got = TB.kernel_weights(dtype, w1, w2, w3)
    want = (w1.to(dtype), w2.to(dtype).permute(0, 1, 3, 4, 2),
            w3.to(dtype))
    for g, w in zip(got, want):
        assert g.is_contiguous() and g.dtype == dtype
        if dtype == torch.bfloat16:
            assert torch.equal(g, w)
            continue
        # f32: [2, ...], TF32 high parts then low parts
        assert g.shape == (2,) + tuple(w.shape)
        assert torch.equal(g[0], TB.tf32_round(w))
        assert torch.equal(g[1], TB.tf32_round(w - g[0]))


def _tf32x3_stage(x, w1, sb1, w2, sb2, w3, sb3, passes=3):
    """The f32 kernel's arithmetic in plain PyTorch: each conv's operands
    split into TF32 high and low parts as the kernel splits them (cvt.rna,
    so the tensor cores read them exactly), the three products a_lo.b_hi,
    a_hi.b_lo and a_hi.b_hi (each exact in f32) summed in f32, then the
    f32 epilogue; h1, h2 and y held in f32.  ``passes=1`` keeps a_hi.b_hi
    alone: plain TF32."""
    import torch.nn.functional as F

    def conv(a, w, pad=0):
        ahi, alo = TB.tf32_split(a)
        whi, wlo = TB.tf32_split(w)
        out = F.conv2d(ahi, whi, padding=pad)
        if passes == 3:
            out = (F.conv2d(alo, whi, padding=pad)
                   + F.conv2d(ahi, wlo, padding=pad) + out)
        return out

    def rows(v):
        return v[None, :, None, None]

    for i in range(w1.shape[0]):
        h1 = torch.relu(conv(x, w1[i][:, :, None, None]) * rows(sb1[i, 0])
                        + rows(sb1[i, 1]))
        h2 = torch.relu(conv(h1, w2[i], 1) * rows(sb2[i, 0])
                        + rows(sb2[i, 1]))
        x = torch.relu(conv(h2, w3[i][:, :, None, None]) * rows(sb3[i, 0])
                       + rows(sb3[i, 1]) + x)
    return x


# the card's bar for the f32 route: max error <= 1e-4 x max|ref|
@pytest.mark.parametrize("n", [1, 2])
def test_three_tf32_passes_meet_the_f32_bar_on_a_full_width_stage3_run(n):
    blocks = [_block(30 + i, 1024, 256) for i in range(2)]
    xn, xt = _x(5, n, 14, 1024)
    want = np.asarray(JB.fused_stage(
        jnp.asarray(xn), *JB.stack_identity_blocks(
            jax.tree_util.tree_map(jnp.asarray, blocks)), interpret=True))
    stacked = TB.stack_identity_blocks(
        [resnet_state_from_jax_params(b) for b in blocks])
    got = _port_layout(_tf32x3_stage(xt, *stacked))
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), (err, np.abs(want).max())
    # the bar tells the two apart: one TF32 pass misses it
    one = np.abs(_port_layout(_tf32x3_stage(xt, *stacked, passes=1))
                 - want).max()
    assert one > 1e-4 * np.abs(want).max(), (one, np.abs(want).max())
