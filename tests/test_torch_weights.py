"""Weights into the port: JAX params and reference checkpoints."""

import jax
import numpy as np
import pytest
import torch

from image_caption_tpu.models.captioner import init_captioner
from image_caption_tpu.utils.torch_import import export_reference_state_dict
from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.models.captioner import Captioner
from image_caption_tpu_torch.utils.weights import (REFERENCE_POS_TABLE,
                                                   load_reference_checkpoint,
                                                   state_dict_from_jax_params)

from conftest import make_fake_batch

SMALL = {"model.num_vocab": 30, "model.max_length": 9,
         "model.num_objects": 4, "model.dim_features": 16}


def _variant(name):
    """Presets that reach every optional parameter group, shrunk."""
    cfg = get_preset(name).with_overrides(**SMALL)
    m = cfg.model
    return cfg.with_overrides(**{
        "model.encode_input_size": 16, "model.encode_q_k_dim": 16,
        "model.encode_v_dim": 16, "model.encode_hidden_size": 24,
        "model.encode_num_heads": 2, "model.dim_word_embedding": 12,
        "model.decode_input_size": 16, "model.decode_q_k_dim": 16,
        "model.decode_v_dim": 16, "model.decode_hidden_size": 24,
        "model.decode_num_heads": 2,
        "model.decode_num_blocks": min(m.decode_num_blocks, 2)})


VARIANTS = [
    "RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj",
    "maxlen49_36obj_1wordCount_256_25b_32h_SplitPosition",
    "maxlen49_36obj_1wordCount_256_25b_32h_move",
]


@pytest.mark.parametrize("name", VARIANTS)
def test_state_dict_equals_export_reference_state_dict(name):
    cfg = _variant(name)
    params = init_captioner(jax.random.PRNGKey(0), cfg.model)
    want = export_reference_state_dict(params, cfg.model)
    got = state_dict_from_jax_params(params, cfg.model)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32
        assert got[key].is_contiguous()
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value),
                                      err_msg=key)
    model = Captioner(cfg.model, device="cpu")
    assert sorted(model.state_dict()) == sorted(want)
    model.load_state_dict(got, strict=True)


def test_reference_checkpoint_loads_as_it_is(tmp_path, flagship_tiny_cfg):
    cfg = flagship_tiny_cfg
    params = init_captioner(jax.random.PRNGKey(7), cfg.model)
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_reference_state_dict(params, cfg.model).items()}
    # the reference also saves its sinusoid buffer, which the port rebuilds
    sd[REFERENCE_POS_TABLE] = torch.zeros(1, cfg.model.max_length - 1, 32)
    path = tmp_path / "model_3.pt"
    torch.save(sd, path)
    model = load_reference_checkpoint(str(path), cfg.model, device="cpu")
    direct = Captioner(cfg.model, device="cpu")
    direct.load_state_dict(state_dict_from_jax_params(params, cfg.model))
    f, p, c = make_fake_batch(cfg, batch=2, seed=1)
    torch.testing.assert_close(model.logits(f, p, c), direct.logits(f, p, c),
                               rtol=0, atol=0)


def test_reference_checkpoint_of_another_config_is_refused(
        tmp_path, tiny_cfg, flagship_tiny_cfg):
    params = init_captioner(jax.random.PRNGKey(0), tiny_cfg.model)
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in export_reference_state_dict(params,
                                                  tiny_cfg.model).items()}
    path = tmp_path / "model_1.pt"
    torch.save(sd, path)
    with pytest.raises(RuntimeError):
        load_reference_checkpoint(str(path), flagship_tiny_cfg.model,
                                  device="cpu")
