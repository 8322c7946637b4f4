"""The port's train step against the JAX package's ``train_step`` (all
dropout off, the JAX weights carried over), on both attention routes and
for the cross-entropy and focal losses; the K-step loop; and the dropout
sites, rates and keys."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.config import get_preset
from image_caption_tpu.models import captioner as JC
from image_caption_tpu.models import layers as JL
from image_caption_tpu.ops import attention as JA
from image_caption_tpu.train import state as JS
from image_caption_tpu.train import step as JSTEP
from image_caption_tpu_torch.models import captioner as TC
from image_caption_tpu_torch.models import layers as TL
from image_caption_tpu_torch.ops import attention as TA
from image_caption_tpu_torch.train import state as TS
from image_caption_tpu_torch.train import step as TSTEP
from image_caption_tpu_torch.utils import rng as TR
from image_caption_tpu_torch.utils.weights import state_dict_from_jax_params

from conftest import make_fake_batch

SMALL = {"model.num_vocab": 50, "model.max_length": 13,
         "model.num_objects": 6,
         "model.encode_input_size": 32, "model.encode_q_k_dim": 32,
         "model.encode_v_dim": 32, "model.encode_hidden_size": 32,
         "model.encode_num_heads": 4, "model.encode_num_blocks": 2,
         "model.dim_word_embedding": 32, "model.decode_input_size": 32,
         "model.decode_q_k_dim": 32, "model.decode_v_dim": 32,
         "model.decode_hidden_size": 32, "model.decode_num_heads": 4,
         "model.decode_num_blocks": 2}
NO_DROPOUT = {"model.dropout": 0.0, "model.attention_dropout": 0.0}
STEPS = 3


def _cfg(name, tiny_cfg):
    if name == "tiny":
        return tiny_cfg.with_overrides(**NO_DROPOUT)
    cfg = get_preset("maxlen49_36obj_1wordCount_256_25b_32h_FocalLoss")
    assert cfg.model.xe_loss == "focal"
    return cfg.with_overrides(**SMALL, **NO_DROPOUT)


def _batches(cfg, n=STEPS):
    out = []
    for s in range(n):
        f, p, c = make_fake_batch(cfg, batch=4, seed=10 + s)
        if s == 0:
            f[2], p[2] = 0.0, 0.0          # an all-zero image
        out.append((f, p, c))
    return out


def _port_state(cfg, params):
    model = TC.Captioner(cfg.model, device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params, cfg.model),
                          strict=True)
    return TS.TrainState(step=0, model=model,
                         optimizer=TS.make_optimizer(
                             model.parameters(), cfg.train.learning_rate))


_JAX_RUNS = {}


def _jax_run(name, cfg):
    """JAX reference, once per config: initial params, the deterministic
    loss of batch 0 (``eval_step``'s) and its gradients (pad row zeroed, as
    the step applies them), the losses of 3 jitted ``train_step`` calls and
    the params after them."""
    if name in _JAX_RUNS:
        return _JAX_RUNS[name]
    state = JS.create_train_state(cfg, jax.random.PRNGKey(0))
    batches = [tuple(jnp.asarray(x) for x in b) for b in _batches(cfg)]
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: JSTEP.eval_step(
        p, b, cfg=cfg)["loss"]))
    loss0, grads = grad_fn(state.params, batches[0])
    grads = JS.zero_pad_embedding_grad(grads, cfg.model.pad_idx)
    step = jax.jit(functools.partial(
        JSTEP.train_step, cfg=cfg,
        tx=JS.make_optimizer(cfg.train.learning_rate)))
    losses, st = [], state
    for b in batches:
        st, m = step(st, b, jax.random.PRNGKey(1))
        losses.append(float(m["loss"]))
    _JAX_RUNS[name] = (jax.device_get(state.params), jax.device_get(grads),
                       losses, jax.device_get(st.params), float(loss0))
    return _JAX_RUNS[name]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", ["tiny", "focal"])
def test_train_step_matches_jax(name, use_kernel, tiny_cfg):
    cfg = _cfg(name, tiny_cfg)
    params, grads, want_losses, want_params, _ = _jax_run(name, cfg)
    st = _port_state(cfg, params)
    want_grads = state_dict_from_jax_params(grads, cfg.model)
    losses = []
    for i, b in enumerate(_batches(cfg)):
        m = TSTEP.train_step(st, TSTEP.to_device(b, "cpu"), seed=0,
                             use_kernel=use_kernel)
        losses.append(m["loss"].item())
        if i == 0:
            for n, p in st.model.named_parameters():
                w = want_grads[n]
                rel = ((p.grad - w).norm() / w.norm().clamp_min(1e-30))
                assert rel.item() <= 1e-4, (n, rel.item())
    assert st.step == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=2e-4)
    got = st.model.state_dict()
    lr = cfg.train.learning_rate
    for n, w in state_dict_from_jax_params(want_params, cfg.model).items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=0,
                                   atol=3 * lr, err_msg=n)
    pad = got["decoder.word_embedding.weight"][cfg.model.pad_idx]
    assert torch.all(pad == 0)


@pytest.mark.parametrize("name", ["tiny", "focal"])
def test_eval_step_matches_jax(name, tiny_cfg):
    cfg = _cfg(name, tiny_cfg)
    params, want = _jax_run(name, cfg)[0], _jax_run(name, cfg)[4]
    st = _port_state(cfg, params)
    b = TSTEP.to_device(_batches(cfg)[0], "cpu")
    for use_kernel in (True, False):
        got = TSTEP.eval_step(st.model, b, use_kernel=use_kernel)["loss"]
        assert not got.requires_grad
        np.testing.assert_allclose(got.item(), want, rtol=2e-4)


def test_train_steps_equal_single_steps_with_dropout(tiny_cfg):
    """K updates in one ``train_steps`` call equal K ``train_step`` calls,
    dropout on: each update draws the key of its own step."""
    cfg = tiny_cfg
    assert cfg.model.dropout > 0 and cfg.model.attention_dropout > 0
    batches = [TSTEP.to_device(b, "cpu") for b in _batches(cfg)]
    a = TS.create_train_state(cfg, device="cpu", seed=5)
    b = TS.create_train_state(cfg, device="cpu", seed=5)
    many = TSTEP.train_steps(a, batches, seed=9)["loss"]
    ones = [TSTEP.train_step(b, x, seed=9)["loss"] for x in batches]
    assert many.shape == (STEPS,) and a.step == b.step == STEPS
    assert torch.equal(many, torch.stack(ones))
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # a different key gives other dropout masks, so another loss
    c = TS.create_train_state(cfg, device="cpu", seed=5)
    other = TSTEP.train_step(c, batches[0], seed=10)["loss"]
    assert other.item() != many[0].item()


def test_optimizer_is_torch_adam_with_the_reference_settings(tiny_cfg):
    st = TS.create_train_state(tiny_cfg, device="cpu")
    opt = st.optimizer
    assert isinstance(opt, torch.optim.Adam)
    group = opt.param_groups[0]
    assert group["lr"] == tiny_cfg.train.learning_rate == 5e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    n_params = sum(1 for _ in st.model.parameters())
    assert len(group["params"]) == n_params


def test_zero_pad_embedding_grad(tiny_cfg):
    model = TC.Captioner(tiny_cfg.model, device="cpu")
    TS.zero_pad_embedding_grad(model, 0)            # no grad yet: no-op
    w = model.decoder.word_embedding.weight
    w.grad = torch.ones_like(w)
    TS.zero_pad_embedding_grad(model, 0)
    assert torch.all(w.grad[0] == 0) and torch.all(w.grad[1:] == 1)


# ---------------------------------------------------------------------------
# Dropout: sites, rates, keys
# ---------------------------------------------------------------------------

def _record(calls, fn, stats=None):
    def wrapped(x, rate, rng, deterministic):
        out = fn(x, rate, rng, deterministic)
        calls.append((float(rate), tuple(x.shape)))
        if stats is not None and rng is not None and not deterministic:
            stats.append((float(rate), x.detach(), out.detach()))
        return out
    return wrapped


@pytest.mark.parametrize("cfg_name", ["tiny", "flagship"])
def test_dropout_sites_and_rates_match_jax(cfg_name, tiny_cfg,
                                           flagship_tiny_cfg, monkeypatch):
    cfg = tiny_cfg if cfg_name == "tiny" else flagship_tiny_cfg
    cfg = cfg.with_overrides(**{"model.dropout": 0.3,
                                "model.attention_dropout": 0.1})
    f, p, c = make_fake_batch(cfg, batch=3, seed=1)
    # tracing alone calls every site: shapes, no compile or run
    params = jax.eval_shape(
        lambda: JC.init_captioner(jax.random.PRNGKey(0), cfg.model))

    jax_calls, port_calls, stats = [], [], []
    monkeypatch.setattr(JA, "dropout", _record(jax_calls, JA.dropout))
    monkeypatch.setattr(JL, "_dropout", _record(jax_calls, JL._dropout))
    monkeypatch.setattr(JC, "_dropout", _record(jax_calls, JC._dropout))
    monkeypatch.setattr(TA, "dropout", _record(port_calls, TA.dropout,
                                               stats))
    monkeypatch.setattr(TL, "dropout", _record(port_calls, TL.dropout,
                                               stats))
    monkeypatch.setattr(TC, "dropout", _record(port_calls, TC.dropout,
                                               stats))

    jax.eval_shape(lambda prm: JC.captioner_logits(
        prm, cfg.model, jnp.asarray(f), jnp.asarray(p), jnp.asarray(c),
        rng=jax.random.PRNGKey(3), deterministic=False), params)
    model = TC.Captioner(cfg.model, device="cpu")
    model(f, p, c, generator=torch.Generator().manual_seed(3),
          deterministic=False)
    assert port_calls == jax_calls
    assert {r for r, _ in port_calls} == {0.3, 0.1}

    # the rates, pooled over the sites of each rate: the share of zeroed
    # entries among nonzero inputs, and the 1/(1-p) scale of the rest
    for rate in (0.3, 0.1):
        dropped = kept = 0
        for r, x, y in stats:
            if r != rate:
                continue
            live = x != 0
            dropped += int((live & (y == 0)).sum())
            kept += int((live & (y != 0)).sum())
            torch.testing.assert_close(y[live & (y != 0)],
                                       x[live & (y != 0)] / (1 - rate))
        share = dropped / (dropped + kept)
        assert abs(share - rate) < 0.02, (rate, share, dropped + kept)


def test_dropout_off_is_the_identity(tiny_cfg):
    cfg = tiny_cfg
    model = TC.Captioner(cfg.model, device="cpu")
    f, p, c = make_fake_batch(cfg, batch=3, seed=2)
    plain = model.logits(f, p, c)
    gen = torch.Generator().manual_seed(7)
    same = model(f, p, c, generator=gen, deterministic=True)
    assert torch.equal(plain, same.detach())
    mha = TL.MultiHeadAttention(16, 16, 16, 4, generator=gen,
                                dropout_rate=0.5, attention_dropout=0.5)
    x = torch.randn(2, 5, 16)
    a, _ = mha(x, x, x, None, generator=gen, deterministic=True)
    b, _ = mha(x, x, x, None)
    assert torch.equal(a, b)
    ffn = TL.FeedForward(16, 8, generator=gen, dropout_rate=0.5)
    assert torch.equal(ffn(x, generator=gen, deterministic=True), ffn(x))


def test_dropout_keys_are_reproducible(tiny_cfg):
    model = TC.Captioner(tiny_cfg.model, device="cpu")
    f, p, c = make_fake_batch(tiny_cfg, batch=3, seed=2)

    def run(seed):
        return model(f, p, c, generator=torch.Generator().manual_seed(seed),
                     deterministic=False).detach()

    assert torch.equal(run(4), run(4))
    assert not torch.equal(run(4), run(5))
    assert not torch.equal(run(4), model.logits(f, p, c))


def test_rng_split_and_fold_in():
    g = torch.Generator().manual_seed(11)
    kids = TR.split(g, 3)
    again = TR.split(g, 3)
    draws = [torch.rand(4, generator=k) for k in kids]
    assert all(torch.equal(d, torch.rand(4, generator=k))
               for d, k in zip(draws, again))
    assert not torch.equal(draws[0], draws[1])
    # splitting does not consume the parent's stream
    assert torch.equal(torch.rand(3, generator=g),
                       torch.rand(3, generator=torch.Generator()
                                  .manual_seed(11)))
    seeds = {TR.fold_in(0, s) for s in range(1000)}
    assert len(seeds) == 1000 and all(0 <= s < 2 ** 63 for s in seeds)
    gen = TSTEP.step_generator(3, 7, "cpu")
    assert gen.device.type == "cpu"
    assert gen.initial_seed() == TR.fold_in(3, 7)
