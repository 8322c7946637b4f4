"""The port's captioner against the JAX package's: teacher-forced logits
(against both JAX attention routes), losses and the bf16 compute path,
with the JAX weights carried over."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.models import captioner as JC
from image_caption_tpu.ops import attention as JA
from image_caption_tpu_torch.models import captioner as TC
from image_caption_tpu_torch.utils.weights import state_dict_from_jax_params

from conftest import make_fake_batch

# jitted once per config: the JAX side's eager op-by-op dispatch dominates
# these tests' time otherwise
init_captioner = jax.jit(JC.init_captioner, static_argnums=1)
captioner_logits = jax.jit(JC.captioner_logits, static_argnums=1,
                           static_argnames=("use_pallas",))
captioner_xe_loss = jax.jit(JC.captioner_xe_loss, static_argnums=1)


def port_model(cfg, seed=0):
    """JAX init_captioner params -> a CPU port Captioner holding them."""
    params = init_captioner(jax.random.PRNGKey(seed), cfg.model)
    model = TC.Captioner(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg.model),
                          strict=True)
    return params, model


def _cfg(name, tiny_cfg, flagship_tiny_cfg):
    return tiny_cfg if name == "tiny" else flagship_tiny_cfg


@pytest.fixture
def jax_pallas(monkeypatch):
    """``use_pallas=True`` takes the JAX package's fused attention on the
    CPU: its probe (off on a CPU backend) passed, its Pallas kernels run
    in interpret mode."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def interpret(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(JA, "_PALLAS_OK", True)
    monkeypatch.setattr(JA.pl, "pallas_call", interpret)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("cfg_name", ["tiny", "flagship"])
def test_logits_match_jax(cfg_name, use_pallas, tiny_cfg, flagship_tiny_cfg,
                          jax_pallas):
    cfg = _cfg(cfg_name, tiny_cfg, flagship_tiny_cfg)
    params, model = port_model(cfg, seed=1)
    f, p, c = make_fake_batch(cfg, batch=4, seed=2)
    f[2], p[2] = 0.0, 0.0                      # an all-zero item
    want = captioner_logits(params, cfg.model, jnp.asarray(f),
                               jnp.asarray(p), jnp.asarray(c),
                               use_pallas=use_pallas)
    got = model.logits(torch.from_numpy(f), torch.from_numpy(p),
                       torch.from_numpy(c))
    assert got.shape == (4, cfg.model.max_length - 1, cfg.model.num_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("cfg_name", ["tiny", "flagship"])
def test_losses_match_jax(cfg_name, tiny_cfg, flagship_tiny_cfg):
    cfg = _cfg(cfg_name, tiny_cfg, flagship_tiny_cfg)
    params, model = port_model(cfg, seed=3)
    f, p, c = make_fake_batch(cfg, batch=3, seed=4)
    logits = model.logits(f, p, c)
    targets = torch.from_numpy(c[:, 1:])
    ce = TC.cross_entropy_ignore_pad(logits, targets, cfg.model.pad_idx)
    want_ce = JC.cross_entropy_ignore_pad(jnp.asarray(logits.numpy()),
                                          jnp.asarray(c[:, 1:]))
    np.testing.assert_allclose(ce.item(), float(want_ce), rtol=2e-4)
    want_xe = captioner_xe_loss(params, cfg.model, f, p, c)["loss"]
    np.testing.assert_allclose(ce.item(), float(want_xe), rtol=2e-4)
    focal = TC.focal_loss_from_ce(ce, 2.0)
    np.testing.assert_allclose(
        focal.item(), float(JC.focal_loss_from_ce(want_ce, 2.0)), rtol=2e-4)


def test_all_pad_targets_give_zero_loss():
    logits = torch.randn(2, 3, 7)
    assert TC.cross_entropy_ignore_pad(logits, torch.zeros(2, 3)).item() == 0


def test_bf16_compute_close_to_f32(tiny_cfg):
    cfg16 = tiny_cfg.with_overrides(**{"model.compute_dtype": "bfloat16"})
    _, m32 = port_model(tiny_cfg, seed=0)
    m16 = TC.Captioner(cfg16.model, device="cpu")
    m16.load_state_dict(m32.state_dict(), strict=True)
    f, p, c = make_fake_batch(tiny_cfg, batch=3, seed=0)
    targets = torch.from_numpy(c[:, 1:])
    l32 = TC.cross_entropy_ignore_pad(m32.logits(f, p, c), targets).item()
    logits16 = m16.logits(f, p, c)
    assert logits16.dtype == torch.float32
    l16 = TC.cross_entropy_ignore_pad(logits16, targets).item()
    assert np.isfinite(l16)
    assert abs(l16 - l32) / abs(l32) < 0.05, (l16, l32)


def test_generator_seed_fixes_the_weights(tiny_cfg):
    def build(seed):
        return TC.Captioner(tiny_cfg.model, device="cpu",
                            generator=torch.Generator().manual_seed(seed))
    a, b, c = build(3), build(3), build(4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["classifer.weight"], sc["classifer.weight"])
    assert torch.all(sa["decoder.word_embedding.weight"][0] == 0)
