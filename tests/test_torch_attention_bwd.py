"""The port's attention backward against the JAX package's: the gradients of
``FusedAttentionFn`` against ``jax.vjp`` of the Pallas ``fused_attention``
run in interpret mode (its backward is ``_attention_bwd_kernel``), the plain
backward against torch autograd, and the backward wrapper's checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.ops import attention as JA
from image_caption_tpu_torch.ops import attention as TA
from test_torch_attention import MASK_CLASSES


@pytest.fixture(autouse=True)
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def wrapper(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", wrapper)
    monkeypatch.setattr(JA.pl, "pallas_call", wrapper)


def _setup(b=2, h=3, lq=5, lk=7, dh=4, seed=0):
    """Inputs with one fully masked query row (item 0, row 1) and one fully
    masked item (the last), and an output gradient."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, lq, dh).astype(np.float32)
    k = rng.randn(b, h, lk, dh).astype(np.float32)
    v = rng.randn(b, h, lk, dh).astype(np.float32)
    do = rng.randn(b, h, lq, dh).astype(np.float32)
    mask = rng.rand(b, lq, lk) > 0.6
    mask[:, :, 0] = False
    mask[0, min(1, lq - 1), :] = True
    mask[-1] = True
    return q, k, v, mask.astype(np.int8), do


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


SHAPES = [(2, 3, 5, 7, 4), (4, 32, 2, 2, 8), (2, 32, 37, 37, 8),
          (2, 32, 50, 50, 8), (2, 32, 50, 37, 8)]


@pytest.mark.parametrize("shape", SHAPES)
def test_function_grads_match_pallas_vjp(shape):
    q, k, v, mask, do = _setup(*shape)
    temp = float(np.sqrt(shape[-1]))
    want_out, vjp = jax.vjp(
        lambda a, b, c: JA.fused_attention(a, b, c, jnp.asarray(mask), temp),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = TA.fused_attention(*leaves, _t(mask), temp)
    got = torch.autograd.grad(out, leaves, _t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=1e-4, atol=1e-5)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", sorted(MASK_CLASSES))
def test_function_grads_match_pallas_vjp_mask_classes(kind):
    b, h, length, mask_b = MASK_CLASSES[kind]()
    q, k, v, _, do = _setup(b, h, length, length, 8, seed=9)
    mask = mask_b.astype(np.int8)
    temp = float(np.sqrt(8))
    _, vjp = jax.vjp(
        lambda a, b_, c: JA.fused_attention(a, b_, c, jnp.asarray(mask),
                                            temp),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = TA.fused_attention(*leaves, _t(mask), temp)
    got = torch.autograd.grad(out, leaves, _t(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-5)
    dead = mask_b.all(axis=-1)
    assert np.all(got[0].numpy()[dead[:, None, :].repeat(h, 1)] == 0.0)


def test_fully_masked_rows_give_zero_dq_and_finite_grads():
    q, k, v, mask, do = _setup(2, 3, 5, 7, 4)
    dq, dk, dv = TA.fused_attention_bwd(_t(q), _t(k), _t(v), _t(mask),
                                        _t(do), 2.0)
    assert torch.all(dq[0, :, 1] == 0) and torch.all(dq[-1] == 0)
    # no key of the masked item is attended: its dk and dv are zero too
    assert torch.all(dk[-1] == 0) and torch.all(dv[-1] == 0)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 4), (3, 4, 5, 70, 16)])
def test_bwd_reference_matches_autograd(shape, dtype):
    q, k, v, mask, do = _setup(*shape, seed=1)
    temp = 1.7
    leaves = [_t(x).to(dtype).requires_grad_(True) for x in (q, k, v)]
    out, _ = TA.attention_reference(*leaves, _t(mask) != 0, temp)
    want = torch.autograd.grad(out, leaves, _t(do).to(dtype))
    got = TA.attention_bwd_reference(*(x.detach() for x in leaves),
                                     _t(mask), _t(do).to(dtype), temp)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("need_grad", ["q", "k", "v", "all"])
def test_sdp_attention_kernel_route_grads_match_plain(need_grad):
    q, k, v, mask, do = _setup(3, 4, 6, 9, 8, seed=2)
    grads = {}
    # without weights the fused route, with them the plain path
    for need_weights in (False, True):
        leaves = [_t(x).requires_grad_(need_grad in (n, "all"))
                  for n, x in zip("qkv", (q, k, v))]
        # the model's head split gives transposed (non-contiguous) views
        views = [x.transpose(1, 2).contiguous().transpose(1, 2)
                 for x in leaves]
        out, attn = TA.sdp_attention(*views, _t(mask) != 0, 2.0,
                                     need_weights=need_weights)
        assert (attn is None) != need_weights
        wrt = [x for x in leaves if x.requires_grad]
        # a transposed output gradient reaches the Function non-contiguous
        g_out = _t(do).transpose(2, 3).contiguous().transpose(2, 3)
        grads[need_weights] = torch.autograd.grad(out, wrt, g_out)
    for g, w in zip(grads[False], grads[True]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_cpu_never_launches_the_kernels():
    q, k, v, mask, do = _setup()
    before = (TA.fused_attention.launches, TA.fused_attention_bwd.launches)
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = TA.fused_attention(*leaves, _t(mask), 2.0)
    out.backward(_t(do))
    assert (TA.fused_attention.launches,
            TA.fused_attention_bwd.launches) == before == (0, 0)


def test_no_gradient_for_mask_or_temperature():
    q, k, v, mask, do = _setup()
    fn = TA.FusedAttentionFn
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = fn.apply(*leaves, _t(mask), 2.0)
    ctx_grads = out.grad_fn.apply(_t(do))
    assert len(ctx_grads) == 5
    assert ctx_grads[3] is None and ctx_grads[4] is None


def test_shared_memory_limit_raises_naming_it():
    assert TA.bwd_shared_bytes(37, 37, 8) < 30_000
    assert TA.bwd_shared_bytes(50, 50, 8) < 30_000
    lq = lk = 200                      # 2 * 200 * 200 * 4 B alone > 227 KB
    z = torch.zeros(1, 1, lq, 8)
    m = torch.zeros(1, lq, lk, dtype=torch.int8)
    with pytest.raises(ValueError, match="232448"):
        TA.fused_attention_bwd(z, z, z, m, z, 1.0)


# the largest Lq = Lk that one backward block takes at each head dim: the
# refusal rule of csrc/fused_attention_bwd.cu's launch (smem_bytes of one
# unit against 232,448 bytes), which _check_bwd mirrors
@pytest.mark.parametrize("dh,largest", [(8, 162), (5, 164), (6, 164),
                                        (64, 118)])
def test_bwd_accepts_up_to_the_largest_square_tile(dh, largest):
    q, k, v, mask, do = _setup(2, 1, largest, largest, dh, seed=3)
    dq, dk, dv = TA.fused_attention_bwd(_t(q), _t(k), _t(v), _t(mask),
                                        _t(do), 1.0)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    n = largest + 1
    z = torch.zeros(1, 1, n, dh)
    m = torch.zeros(1, n, n, dtype=torch.int8)
    with pytest.raises(ValueError, match="232448"):
        TA.fused_attention_bwd(z, z, z, m, z, 1.0)


def _good():
    q, k, v, mask, do = _setup()
    return [_t(q), _t(k), _t(v), _t(mask), _t(do), 1.0]


BAD = {
    "float64": lambda a: [x.double() for x in a[:3]] + [a[3],
                                                       a[4].double(), 1.0],
    "float16": lambda a: [x.half() for x in a[:3]] + [a[3], a[4].half(),
                                                     1.0],
    "mixed_dtype": lambda a: [a[0], a[1].bfloat16()] + a[2:],
    "bool_mask": lambda a: a[:3] + [a[3].bool()] + a[4:],
    "3d_q": lambda a: [a[0][0]] + a[1:],
    "kv_mismatch": lambda a: [a[0], a[1], a[2][:, :, :-1]] + a[3:],
    "mask_shape": lambda a: a[:3] + [a[3][:, :-1]] + a[4:],
    "empty": lambda a: [x[:0] for x in a[:5]] + [1.0],
    "non_contiguous_q": lambda a: [a[0].transpose(0, 1).contiguous()
                                   .transpose(0, 1)] + a[1:],
    "temperature": lambda a: a[:5] + [0.0],
    "dout_dtype": lambda a: a[:4] + [a[4].bfloat16(), 1.0],
    "dout_shape": lambda a: a[:4] + [a[4][:, :, :-1], 1.0],
    "dout_non_contiguous": lambda a: a[:4] + [
        a[4].transpose(2, 3).contiguous().transpose(2, 3), 1.0],
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_bwd_wrapper_rejects_bad_input(case, device):
    args = [x.to(device) if isinstance(x, torch.Tensor) else x
            for x in BAD[case](_good())]
    with pytest.raises((TypeError, ValueError)):
        TA.fused_attention_bwd(*args)


def test_bwd_wrapper_rejects_unknown_device():
    args = [x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in _good()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        TA.fused_attention_bwd(*args)


def test_bwd_wrapper_rejects_dout_elsewhere():
    args = _good()
    args[4] = args[4].to("meta")
    with pytest.raises(ValueError, match="device"):
        TA.fused_attention_bwd(*args)


def test_build_lists_both_kernels():
    from image_caption_tpu_torch.ops import _build
    assert _build.KERNELS == ("fused_attention", "fused_attention_bwd",
                              "fused_bottleneck", "mla_decode",
                              "experts_glue")
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").exists()
        # the library's name carries a hash of the source
        assert _build.library_path(name).name.startswith(f"lib{name}-")
