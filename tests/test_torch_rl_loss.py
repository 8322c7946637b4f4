"""The port's SCST loss against the JAX package's ``rl/loss.py``: argmax
samples exactly (ties included), categorical samples by their
statistics, ``structure_loss`` over its options, and ``rl_composite_loss``
with its gradients on carried-over weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.rl import loss as JL
from image_caption_tpu.train import state as JS
from image_caption_tpu_torch.models.captioner import Captioner
from image_caption_tpu_torch.rl import loss as TL
from image_caption_tpu_torch.utils.weights import state_dict_from_jax_params

from conftest import make_fake_batch

NO_DROPOUT = {"model.dropout": 0.0, "model.attention_dropout": 0.0}


def test_argmax_sample_equals_jax_ties_included():
    rng = np.random.RandomState(0)
    # integer logits: many rows hold tied maxima
    logits = rng.randint(0, 3, size=(4, 6, 7)).astype(np.float32)
    want_seq, want_lp = JL.sample_from_logits(jnp.asarray(logits), None,
                                              "argmax", num_samples=3)
    seq, lp = TL.sample_from_logits(torch.from_numpy(logits), None,
                                    "argmax", num_samples=3)
    assert seq.shape == (4, 1, 6) and seq.dtype == torch.int64
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0,
                               atol=1e-6)


def test_categorical_sample_shape_and_generator():
    logits = torch.from_numpy(
        np.random.RandomState(1).randn(3, 5, 11).astype(np.float32))
    a, _ = TL.sample_from_logits(logits, torch.Generator().manual_seed(7),
                                 "categorical", num_samples=4)
    b, _ = TL.sample_from_logits(logits, torch.Generator().manual_seed(7),
                                 "categorical", num_samples=4)
    c, _ = TL.sample_from_logits(logits, torch.Generator().manual_seed(8),
                                 "categorical", num_samples=4)
    assert a.shape == (3, 4, 5) and a.dtype == torch.int64
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 11
    # no generator: the fixed seed-0 stream, as the JAX eval's PRNGKey(0)
    d, _ = TL.sample_from_logits(logits, None, "categorical", 4)
    e, _ = TL.sample_from_logits(logits, torch.Generator().manual_seed(0),
                                 "categorical", 4)
    assert torch.equal(d, e)
    with pytest.raises(ValueError, match="sample mode"):
        TL.sample_from_logits(logits, None, "nucleus")


def test_categorical_frequencies_follow_the_softmax():
    logits = np.array([[[2.0, 0.5, -1.0, 1.0, 0.0]]], np.float32)
    n = 20000
    seq, _ = TL.sample_from_logits(torch.from_numpy(logits),
                                   torch.Generator().manual_seed(3),
                                   "categorical", num_samples=n)
    freq = np.bincount(seq.numpy().ravel(), minlength=5) / n
    want = np.asarray(jax.nn.softmax(jnp.asarray(logits[0, 0])))
    np.testing.assert_allclose(freq, want, rtol=0, atol=0.01)
    # and the JAX sampler's frequencies agree with the same softmax
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jseq = jax.vmap(lambda k: jax.random.categorical(
        k, jnp.asarray(logits[0, 0])))(keys)
    jfreq = np.bincount(np.asarray(jseq), minlength=5) / n
    np.testing.assert_allclose(freq, jfreq, rtol=0, atol=0.02)


@pytest.mark.parametrize("n,ndim", [(1, 2), (1, 3), (3, 3)])
@pytest.mark.parametrize("self_cider_weight", [0.0, 1.0])
@pytest.mark.parametrize("entropy_weight", [0.0, 1.0])
def test_structure_loss_matches_jax(entropy_weight, self_cider_weight, n,
                                    ndim):
    rng = np.random.RandomState(2)
    b, t, v = 4, 9, 13
    logprobs = np.array(jax.nn.log_softmax(
        jnp.asarray(rng.randn(b, t, v).astype(np.float32)), axis=-1))
    seq = rng.randint(1, v, size=(b, n, t))
    for i in range(b):                      # ragged ends: pad after <END>
        seq[i, :, rng.randint(2, t):] = 0
    rewards = rng.rand(b, n).astype(np.float32)
    self_cider = rng.rand(b, n).astype(np.float32)
    if ndim == 2:
        seq, rewards, self_cider = seq[:, 0], rewards[:, 0], self_cider[:, 0]
    kw = dict(entropy_weight=entropy_weight,
              self_cider_weight=self_cider_weight)
    want = JL.structure_loss(jnp.asarray(logprobs),
                             jnp.asarray(seq, jnp.int32),
                             jnp.asarray(rewards), jnp.asarray(self_cider),
                             **kw)
    got = TL.structure_loss(torch.from_numpy(logprobs), torch.from_numpy(seq),
                            torch.from_numpy(rewards),
                            torch.from_numpy(self_cider), **kw)
    for key in ("loss", "reward"):
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


_PARAMS = {}


def _jax_params(cfg):
    if "p" not in _PARAMS:
        _PARAMS["p"] = jax.device_get(
            JS.create_train_state(cfg, jax.random.PRNGKey(0)).params)
    return _PARAMS["p"]


@pytest.mark.parametrize("weight", [0.0, 0.5, 1.0])
def test_rl_composite_loss_and_gradients_match_jax(weight,
                                                   flagship_tiny_cfg):
    cfg = flagship_tiny_cfg.with_overrides(
        **NO_DROPOUT, **{"rl.structure_loss_weight": weight})
    params = _jax_params(cfg)
    f, p, c = make_fake_batch(cfg, batch=5, seed=3)
    f[1], p[1] = 0.0, 0.0                    # an all-zero image
    rng = np.random.RandomState(4)
    rewards = rng.rand(5, 1).astype(np.float32)
    self_cider = rng.rand(5, 1).astype(np.float32)

    def jax_loss(prm):
        return JL.rl_composite_loss(
            prm, cfg, (jnp.asarray(f), jnp.asarray(p), jnp.asarray(c)),
            rewards=jnp.asarray(rewards), self_cider=jnp.asarray(self_cider),
            rng=None, deterministic=True)

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)
    model = Captioner(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg.model))
    loss, got = TL.rl_composite_loss(
        model, cfg, tuple(torch.from_numpy(x) for x in (f, p, c)),
        rewards=torch.from_numpy(rewards),
        self_cider=torch.from_numpy(self_cider))
    assert set(got) == {"loss", "language_model_loss", "structure_loss",
                        "reward"}
    for key, value in got.items():
        np.testing.assert_allclose(value.item(), float(want[key]), rtol=0,
                                   atol=2e-4, err_msg=key)
    loss.backward()
    want_grads = state_dict_from_jax_params(jax.device_get(grads), cfg.model)
    for name, prm in model.named_parameters():
        w = want_grads[name]
        rel = ((prm.grad - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-4, (name, rel)

    # the explicit sample the rewards were scored on gives the same loss
    seq = TL.rl_sample_sequence(
        model, cfg, tuple(torch.from_numpy(x) for x in (f, p, c)))
    again = TL.rl_composite_loss(
        model, cfg, tuple(torch.from_numpy(x) for x in (f, p, c)),
        rewards=torch.from_numpy(rewards),
        self_cider=torch.from_numpy(self_cider), sample_seq=seq)[1]
    assert all(torch.equal(again[k], got[k]) for k in got)
