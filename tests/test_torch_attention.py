"""The port's attention against the JAX package's: the plain path against
``_attention_xla``, the fused wrapper on CPU tensors against the Pallas
kernel in interpret mode, and the wrapper's checks on every device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.ops import attention as JA
from image_caption_tpu_torch.ops import attention as TA


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


def _setup(b=2, h=3, lq=5, lk=7, dh=4, seed=0, full_row=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, lq, dh).astype(np.float32)
    k = rng.randn(b, h, lk, dh).astype(np.float32)
    v = rng.randn(b, h, lk, dh).astype(np.float32)
    mask = rng.rand(b, lq, lk) > 0.6
    mask[:, :, 0] = False
    if full_row:
        mask[0, 1, :] = True                  # one fully masked query row
        mask[-1] = True                       # an all-masked item
    return q, k, v, mask


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 4), (3, 4, 2, 2, 8),
                                   (1, 2, 6, 9, 16)])
def test_reference_matches_attention_xla(shape, masked):
    q, k, v, mask = _setup(*shape, full_row=masked)
    temp = 1.9
    jmask = jnp.asarray(mask) if masked else None
    want_out, want_attn = JA._attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask, temp)
    got_out, got_attn = TA.attention_reference(
        _t(q), _t(k), _t(v), _t(mask) if masked else None, temp)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 4), (4, 32, 2, 2, 8),
                                   (2, 32, 37, 37, 8), (2, 32, 50, 50, 8),
                                   (3, 4, 5, 70, 16)])
def test_fused_cpu_matches_pallas_interpret(shape):
    q, k, v, mask = _setup(*shape, full_row=True)
    temp = float(np.sqrt(shape[-1]))
    want = JA.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask.astype(np.int8)), temp)
    got = TA.fused_attention(_t(q), _t(k), _t(v),
                             _t(mask.astype(np.int8)), temp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def causal_key_pad_mask(b, length, seed):
    """The decoder's self-attention mask: causal OR a padded key tail
    (item 0 keeps one token, so its later rows see one key)."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, length + 1, size=b)
    lengths[0] = 1
    pad = np.arange(length)[None, :] >= lengths[:, None]
    causal = np.triu(np.ones((length, length), bool), 1)
    return pad[:, None, :] | causal[None]


def pair_block_mask(b, slots, seed):
    """The split_image_objects pair block's mask [b*slots, 2, 2]: token 0
    the whole image, token 1 an object, causal, empty slots padded (item 0
    is an all-zero image, so its pairs are fully masked)."""
    rng = np.random.RandomState(seed)
    n_obj = rng.randint(1, slots - 1, size=b)
    pad = np.arange(slots)[None, :] > n_obj[:, None]
    pad[0] = True
    pair = np.stack([np.repeat(pad[:, :1], slots, axis=1), pad], axis=2)
    pair = pair.reshape(b * slots, 2)
    return pair[:, None, :] | np.triu(np.ones((2, 2), bool), 1)[None]


MASK_CLASSES = {
    "causal_key_pad": lambda: (2, 32, 50, causal_key_pad_mask(2, 50, 7)),
    "pair_block": lambda: (3 * 9, 32, 2, pair_block_mask(3, 9, 8)),
}


@pytest.mark.parametrize("kind", sorted(MASK_CLASSES))
def test_fused_cpu_matches_pallas_interpret_mask_classes(kind):
    b, h, length, mask = MASK_CLASSES[kind]()
    q, k, v, _ = _setup(b, h, length, length, 8, seed=6)
    temp = float(np.sqrt(8))
    want = JA.fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask.astype(np.int8)), temp)
    got = TA.fused_attention(_t(q), _t(k), _t(v),
                             _t(mask.astype(np.int8)), temp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    # fully masked rows (the pair block's empty slots) are exactly zero
    dead = mask.all(axis=-1)
    assert dead.any() == (kind == "pair_block")
    assert np.all(got.numpy()[dead[:, None, :].repeat(h, 1)] == 0.0)


def test_fully_masked_rows_are_exactly_zero():
    q, k, v, mask = _setup(full_row=True)
    out = TA.fused_attention(_t(q), _t(k), _t(v), _t(mask.astype(np.int8)),
                             1.0).numpy()
    assert np.all(out[0, :, 1] == 0.0)
    assert np.all(out[-1] == 0.0)
    _, attn = TA.attention_reference(_t(q), _t(k), _t(v), _t(mask), 1.0)
    assert np.all(attn.numpy()[-1] == 0.0)
    assert np.all(np.isfinite(out))


def test_masked_softmax_matches_jax():
    rng = np.random.RandomState(4)
    s = rng.randn(3, 4, 6).astype(np.float32)
    s[0, 1] = -np.inf
    s[1, 2, :3] = -np.inf
    np.testing.assert_allclose(
        TA.masked_softmax(_t(s)).numpy(),
        np.asarray(JA.masked_softmax(jnp.asarray(s))), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_mask", [True, False])
def test_sdp_attention_weights_only_when_asked(with_mask):
    q, k, v, mask = _setup()
    m = _t(mask) if with_mask else None
    # a transposed (non-contiguous) q as the model's head split gives it
    qt = _t(q).transpose(2, 3).contiguous().transpose(2, 3)
    before = TA.fused_attention.launches
    out, attn = TA.sdp_attention(qt, _t(k), _t(v), m, 2.0,
                                 need_weights=False)
    assert attn is None
    out2, attn2 = TA.sdp_attention(qt, _t(k), _t(v), m, 2.0,
                                   need_weights=True)
    assert attn2 is not None and attn2.shape == (2, 3, 5, 7)
    np.testing.assert_allclose(out.numpy(), out2.numpy(), rtol=1e-6,
                               atol=1e-6)
    # CPU tensors never launch the kernel
    assert TA.fused_attention.launches == before == 0


@pytest.mark.parametrize("dropout_active", [False, True])
@pytest.mark.parametrize("need_weights", [False, True])
@pytest.mark.parametrize("with_mask", [True, False])
def test_sdp_attention_takes_the_fused_route_without_weights_or_dropout(
        with_mask, need_weights, dropout_active, monkeypatch):
    """The dispatch rule: ``FusedAttentionFn`` (kernels #1 and #2 on the
    card) exactly when no weights are wanted and no dropout runs;
    ``attention_reference`` otherwise."""
    q, k, v, mask = _setup()
    calls = {"fused": 0, "plain": 0}
    real_apply, real_reference = (TA.FusedAttentionFn.apply,
                                  TA.attention_reference)

    def apply(*a):
        calls["fused"] += 1
        return real_apply(*a)

    def reference(*a, **k):
        calls["plain"] += 1
        return real_reference(*a, **k)

    monkeypatch.setattr(TA.FusedAttentionFn, "apply", apply)
    monkeypatch.setattr(TA, "attention_reference", reference)
    out, attn = TA.sdp_attention(
        _t(q), _t(k), _t(v), _t(mask) if with_mask else None, 2.0,
        dropout_rate=0.1, generator=torch.Generator().manual_seed(0),
        deterministic=not dropout_active, need_weights=need_weights)
    fused = not need_weights and not dropout_active
    # on a CPU tensor the fused route's forward is the plain version
    assert calls == {"fused": int(fused), "plain": 1}
    assert (attn is None) == (not need_weights)
    assert out.shape == (2, 3, 5, 4)


def test_dropout_matches_jax_semantics():
    x = torch.ones(4000)
    assert TA.dropout(x, 0.3, None, deterministic=False) is x
    g = torch.Generator().manual_seed(0)
    assert TA.dropout(x, 0.3, g, deterministic=True) is x
    y = TA.dropout(x, 0.3, g, deterministic=False)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(kept.float().mean().item() - 0.7) < 0.03


def _good():
    q, k, v, mask = _setup()
    return [_t(q), _t(k), _t(v), _t(mask.astype(np.int8)), 1.0]


BAD = {
    "float64": lambda a: [a[0].double(), a[1].double(), a[2].double()]
    + a[3:],
    "float16": lambda a: [a[0].half(), a[1].half(), a[2].half()] + a[3:],
    "mixed_dtype": lambda a: [a[0], a[1].bfloat16()] + a[2:],
    "bool_mask": lambda a: a[:3] + [a[3].bool(), 1.0],
    "3d_q": lambda a: [a[0][0]] + a[1:],
    "kv_mismatch": lambda a: [a[0], a[1], a[2][:, :, :-1]] + a[3:],
    "head_mismatch": lambda a: [a[0][:, :2]] + a[1:],
    "mask_shape": lambda a: a[:3] + [a[3][:, :-1], 1.0],
    "head_dim_65": lambda a: [torch.zeros(1, 1, 2, 65),
                              torch.zeros(1, 1, 3, 65),
                              torch.zeros(1, 1, 3, 65),
                              torch.zeros(1, 2, 3, dtype=torch.int8), 1.0],
    "empty": lambda a: [x[:0] for x in a[:4]] + [1.0],
    "non_contiguous": lambda a: [a[0].transpose(0, 1).contiguous()
                                 .transpose(0, 1)] + a[1:],
    "temperature": lambda a: a[:4] + [0.0],
}


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("case", sorted(BAD))
def test_fused_wrapper_rejects_bad_input(case, device):
    args = [x.to(device) if isinstance(x, torch.Tensor) else x
            for x in BAD[case](_good())]
    with pytest.raises((TypeError, ValueError)):
        TA.fused_attention(*args)


def test_fused_wrapper_rejects_unknown_device():
    args = [x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in _good()]
    with pytest.raises(ValueError, match="cuda or cpu"):
        TA.fused_attention(*args)
