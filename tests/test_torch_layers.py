"""The port's layers against the JAX package's, with the same weights
(carried over through the reference state_dict names) and the same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.models import layers as JL
from image_caption_tpu_torch.models import layers as TL

D, HID, HEADS = 16, 24, 4


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _load(module, sd):
    module.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                            for k, v in sd.items()}, strict=True)
    return module


def _lin_sd(p, pre=""):
    out = {f"{pre}weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        out[f"{pre}bias"] = np.asarray(p["bias"])
    return out


def _norm_sd(p, pre):
    return {f"{pre}weight": np.asarray(p["scale"]),
            f"{pre}bias": np.asarray(p["bias"])}


def _mha_sd(p, pre=""):
    sd = {}
    for name, key in (("q_linear", "q"), ("k_linear", "k"),
                      ("v_linear", "v"), ("joint_linear", "joint")):
        sd.update(_lin_sd(p[key], f"{pre}{name}."))
    sd.update(_norm_sd(p["norm"], f"{pre}layer_norm."))
    return sd


def _ffn_sd(p, pre=""):
    sd = _lin_sd(p["w1"], f"{pre}position_wise_1.")
    sd.update(_lin_sd(p["w2"], f"{pre}position_wise_2."))
    sd.update(_norm_sd(p["norm"], f"{pre}layer_norm."))
    return sd


def _gen():
    return torch.Generator().manual_seed(0)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(bias):
    p = JL.init_linear(jax.random.PRNGKey(0), D, HID, bias=bias)
    m = _load(TL.Linear(D, HID, bias=bias, generator=_gen()), _lin_sd(p))
    x = _x((3, 5, D), 1)
    _close(m(torch.from_numpy(x)), JL.linear(p, jnp.asarray(x)))


def test_linear_bf16_matches_jax_within_bf16():
    p = JL.init_linear(jax.random.PRNGKey(0), D, HID, bias=True)
    m = _load(TL.Linear(D, HID, bias=True, generator=_gen()), _lin_sd(p))
    x = _x((3, 5, D), 1)
    got = m(torch.from_numpy(x).bfloat16())
    want = JL.linear(p, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_layer_norm_matches_jax():
    rng = np.random.RandomState(2)
    p = {"scale": rng.randn(D).astype(np.float32),
         "bias": rng.randn(D).astype(np.float32)}
    m = _load(TL.LayerNorm(D), _norm_sd(p, ""))
    x = 3.0 + 2.0 * _x((4, 6, D), 3)
    _close(m(torch.from_numpy(x)), JL.layer_norm(p, jnp.asarray(x)))


@pytest.mark.parametrize("need_weights", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
def test_mha_matches_jax(with_mask, need_weights):
    p = JL.init_mha(jax.random.PRNGKey(1), D, D, D, HEADS)
    m = _load(TL.MultiHeadAttention(D, D, D, HEADS, generator=_gen()),
              _mha_sd(p))
    q, kv = _x((2, 5, D), 4), _x((2, 7, D), 5)
    mask = np.random.RandomState(6).rand(2, 5, 7) > 0.6
    mask[1, 2] = True
    jmask = jnp.asarray(mask) if with_mask else None
    want, want_attn = JL.mha(p, jnp.asarray(q), jnp.asarray(kv),
                             jnp.asarray(kv), jmask, num_heads=HEADS,
                             dropout_rate=0.0)
    got, got_attn = m(torch.from_numpy(q), torch.from_numpy(kv),
                      torch.from_numpy(kv),
                      torch.from_numpy(mask) if with_mask else None,
                      need_weights=need_weights)
    _close(got, want)
    if need_weights:
        _close(got_attn, want_attn)


def test_ffn_matches_jax():
    p = JL.init_ffn(jax.random.PRNGKey(2), D, HID)
    m = _load(TL.FeedForward(D, HID, generator=_gen()), _ffn_sd(p))
    x = _x((3, 4, D), 7)
    _close(m(torch.from_numpy(x)),
           JL.ffn(p, jnp.asarray(x), dropout_rate=0.0))


def test_encoder_block_matches_jax():
    p = JL.init_encoder_block(jax.random.PRNGKey(3), D, HID, HEADS, D, D)
    sd = _mha_sd(p["mha"], "multihead_attention.")
    sd.update(_ffn_sd(p["ffn"], "feed_forward."))
    m = _load(TL.EncoderBlock(D, HID, HEADS, D, D, generator=_gen()), sd)
    x = _x((2, 6, D), 8)
    x[1, 4:] = 0.0
    non_pad = np.any(x != 0, axis=-1, keepdims=True).astype(np.float32)
    mask = np.broadcast_to(~non_pad[:, None, :, 0].astype(bool), (2, 6, 6))
    mask = mask | np.triu(np.ones((6, 6), bool), 1)[None]
    want, _ = JL.encoder_block(p, jnp.asarray(x), num_heads=HEADS,
                               dropout_rate=0.0,
                               non_pad_mask=jnp.asarray(non_pad),
                               attention_mask=jnp.asarray(mask))
    got, _ = m(torch.from_numpy(x), non_pad_mask=torch.from_numpy(non_pad),
               attention_mask=torch.from_numpy(mask.copy()),
               need_weights=False)
    _close(got, want)


def test_decoder_block_matches_jax():
    p = JL.init_decoder_block(jax.random.PRNGKey(4), D, HID, HEADS, D, D)
    sd = _mha_sd(p["self_attn"], "self_attention.")
    sd.update(_mha_sd(p["cross_attn"], "encode_attention."))
    sd.update(_ffn_sd(p["ffn"], "feed_forward."))
    m = _load(TL.DecoderBlock(D, HID, HEADS, D, D, generator=_gen()), sd)
    x, enc = _x((2, 5, D), 9), _x((2, 7, D), 10)
    toks = np.array([[1, 4, 5, 2, 0], [1, 6, 0, 0, 0]])
    non_pad = (toks != 0)[..., None].astype(np.float32)
    self_mask = (toks == 0)[:, None, :] | np.triu(np.ones((5, 5), bool), 1)
    ctx = np.zeros((2, 5, 7), bool)
    ctx[1, :, 5:] = True
    want = JL.decoder_block(p, jnp.asarray(x), jnp.asarray(enc),
                            num_heads=HEADS, dropout_rate=0.0,
                            non_pad_mask=jnp.asarray(non_pad),
                            self_attention_mask=jnp.asarray(self_mask),
                            context_attention_mask=jnp.asarray(ctx))
    got = m(torch.from_numpy(x), torch.from_numpy(enc),
            non_pad_mask=torch.from_numpy(non_pad),
            self_attention_mask=torch.from_numpy(self_mask),
            context_attention_mask=torch.from_numpy(ctx))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("n,d", [(50, 64), (12, 32), (7, 9)])
def test_sinusoid_table_matches_jax(n, d):
    got = TL.sinusoid_table(n, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL.sinusoid_table(n, d)))


def test_inits_follow_the_reference_distributions():
    g = torch.Generator().manual_seed(0)
    w = TL.normal_fan_sum(g, 300, 500)
    assert w.shape == (500, 300)
    assert abs(w.std().item() - np.sqrt(2 / 800)) < 2e-3
    u = TL.torch_default_kernel(g, 400, 300)
    assert u.abs().max().item() <= 1 / np.sqrt(400)
    b = TL.torch_default_bias(g, 400, 300)
    assert b.shape == (300,) and b.abs().max().item() <= 1 / np.sqrt(400)
    e = TL.embedding_table(g, 100, 8, pad_idx=0)
    assert torch.all(e[0] == 0) and abs(e[1:].std().item() - 1) < 0.15
    # the same generator state gives the same weights
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert torch.equal(TL.normal_fan_sum(g1, 3, 4), TL.normal_fan_sum(g2, 3, 4))
