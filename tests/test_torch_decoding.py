"""The port's KV-cached greedy and beam decode against the JAX package's:
exactly the same tokens, the greedy cross-attention within 1e-5, and the
top-k tie rule of ``jax.lax.top_k``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.models import decoding as JD
from image_caption_tpu_torch.models import decoding as TD

from conftest import make_fake_batch
from test_torch_captioner import port_model


def _cfg(name, tiny_cfg, flagship_tiny_cfg):
    return tiny_cfg if name == "tiny" else flagship_tiny_cfg


def _batch(cfg, seed):
    """Five items: item 2 all zero (every attention row fully masked) and
    item 3 a copy of item 0 (equal beams, tie-heavy top-k)."""
    f, p, _ = make_fake_batch(cfg, batch=5, seed=seed)
    f[2], p[2] = 0.0, 0.0
    f[3], p[3] = f[0], p[0]
    return f, p


@pytest.mark.parametrize("cfg_name", ["tiny", "flagship"])
def test_greedy_matches_jax(cfg_name, tiny_cfg, flagship_tiny_cfg):
    cfg = _cfg(cfg_name, tiny_cfg, flagship_tiny_cfg)
    params, model = port_model(cfg, seed=5)
    f, p = _batch(cfg, seed=6)
    want_tok, want_attn = JD.greedy_decode(
        params, cfg.model, jnp.asarray(f), jnp.asarray(p), use_pallas=True,
        return_attention=True)
    got_tok, got_attn = TD.greedy_decode(model, f, p, return_attention=True,
                                         device="cpu")
    assert got_tok.shape == (5, cfg.model.max_length + 1)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    np.testing.assert_array_equal(got_tok[3].numpy(), got_tok[0].numpy())
    assert got_attn.shape == (cfg.model.max_length - 1, 5,
                              cfg.model.num_slots)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn),
                               rtol=1e-5, atol=1e-5)
    assert np.all(got_attn[:, 2].numpy() == 0.0)


@pytest.mark.parametrize("score_mode,stop_at_end", [
    ("prob", False), ("logprob", False), ("logprob", True)])
@pytest.mark.parametrize("cfg_name", ["tiny", "flagship"])
def test_beam_matches_jax(cfg_name, score_mode, stop_at_end, tiny_cfg,
                          flagship_tiny_cfg):
    cfg = _cfg(cfg_name, tiny_cfg, flagship_tiny_cfg)
    params, model = port_model(cfg, seed=7)
    f, p = _batch(cfg, seed=8)
    want = JD.beam_search(params, cfg.model, jnp.asarray(f), jnp.asarray(p),
                          beam_size=3, score_mode=score_mode,
                          use_pallas=True, stop_at_end=stop_at_end)
    got = TD.beam_search(model, f, p, beam_size=3, score_mode=score_mode,
                         stop_at_end=stop_at_end, device="cpu")
    assert got.shape == (5, cfg.model.max_length)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_beam_rejects_an_unknown_score_mode(tiny_cfg):
    _, model = port_model(tiny_cfg)
    f, p = _batch(tiny_cfg, seed=0)
    with pytest.raises(ValueError, match="score_mode"):
        TD.beam_search(model, f, p, beam_size=2, score_mode="sum",
                       device="cpu")


@pytest.mark.parametrize("caption_model,mode", [
    ("Transformer", "prob"), ("RL_Transformer", "logprob")])
def test_beam_score_mode_matches_jax(caption_model, mode):
    assert TD.beam_score_mode(caption_model) == mode
    assert JD.beam_score_mode(caption_model) == mode
    with pytest.raises(ValueError):
        TD.beam_score_mode("LSTM")


@pytest.mark.parametrize("width,k", [(9, 1), (40, 3), (40, 7), (600, 3)])
def test_topk_lowest_index_matches_lax_top_k(width, k):
    rng = np.random.RandomState(width + k)
    x = rng.randint(0, 4, size=(6, width)).astype(np.float32)
    x[0] = 1.0                                  # a row of one value
    x[1, ::2] = 5.0                             # many equal maxima
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = TD.topk_lowest_index(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    # the chunked top-k that the JAX beam runs on its logits agrees too
    _, two_level_i = JD.topk_exact_2level(jnp.asarray(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(two_level_i))
