"""Weights into the port: from the JAX package's params and from reference
checkpoints.

The port's parameter names are the reference's state_dict names, so a
reference ``model_N.pt`` (``torch.save(model.state_dict())``,
core/models.py:62-63) loads with ``load_state_dict`` as it is.  JAX params
store Linear kernels ``[in, out]``; torch stores ``[out, in]``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..config import ModelConfig
from ..models.captioner import Captioner
from .device import DeviceLike

# the reference's sinusoid buffer (model.py:495-500); the port recomputes it
REFERENCE_POS_TABLE = "decoder.position_embedding.pos_table"


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(out, name, p):
    # ascontiguousarray: a strided transpose view changes the BLAS
    # accumulation order (ULP-level drift against a natively laid-out
    # weight)
    out[f"{name}.weight"] = _t(np.ascontiguousarray(
        np.asarray(p["kernel"], dtype=np.float32).T))
    if "bias" in p:
        out[f"{name}.bias"] = _t(p["bias"])


def _norm(out, name, p):
    out[f"{name}.weight"] = _t(p["scale"])
    out[f"{name}.bias"] = _t(p["bias"])


def _mha(out, pre, p):
    _lin(out, f"{pre}.q_linear", p["q"])
    _lin(out, f"{pre}.k_linear", p["k"])
    _lin(out, f"{pre}.v_linear", p["v"])
    _lin(out, f"{pre}.joint_linear", p["joint"])
    _norm(out, f"{pre}.layer_norm", p["norm"])


def _ffn(out, pre, p):
    _lin(out, f"{pre}.position_wise_1", p["w1"])
    _lin(out, f"{pre}.position_wise_2", p["w2"])
    _norm(out, f"{pre}.layer_norm", p["norm"])


def state_dict_from_jax_params(params: Dict[str, Any],
                               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The JAX package's captioner param pytree (numpy or array leaves) ->
    the port's state_dict (f32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    enc = params["encoder"]
    _lin(out, "encoder.feature_embedding", enc["feature_embedding"])
    _lin(out, "encoder.position_embedding", enc["position_embedding"])
    if cfg.split_position:
        _lin(out, "encoder.object_embedding", enc["object_embedding"])
    _norm(out, "encoder.norm", enc["norm"])
    if cfg.split_image_objects:
        blk = enc["image_encoder"]
        _mha(out, "encoder.image_encoder.multihead_attention", blk["mha"])
        _ffn(out, "encoder.image_encoder.feed_forward", blk["ffn"])
    for i, blk in enumerate(enc["blocks"]):
        _mha(out, f"encoder.encoder.{i}.multihead_attention", blk["mha"])
        _ffn(out, f"encoder.encoder.{i}.feed_forward", blk["ffn"])

    dec = params["decoder"]
    out["decoder.word_embedding.weight"] = _t(dec["word_embedding"]["table"])
    _lin(out, "decoder.word_embedding_linear", dec["word_embedding_linear"])
    _norm(out, "decoder.norm", dec["norm"])
    for i, blk in enumerate(dec["blocks"]):
        _mha(out, f"decoder.decoder.{i}.self_attention", blk["self_attn"])
        _mha(out, f"decoder.decoder.{i}.encode_attention", blk["cross_attn"])
        _ffn(out, f"decoder.decoder.{i}.feed_forward", blk["ffn"])
    if cfg.move_first_image_feature:
        m = dec["move_ffn"]
        _lin(out, "decoder.position_wise_1", m["w1"])
        _lin(out, "decoder.position_wise_2", m["w2"])
        _norm(out, "decoder.layer_norm", m["norm"])

    # the reference's (sic) 'classifer' Linear(d, vocab)
    _lin(out, "classifer", params["classifier"])
    return out


def load_reference_checkpoint(path: str, cfg: ModelConfig, *,
                              device: DeviceLike = None) -> Captioner:
    """A reference ``model_N.pt`` -> a ``Captioner(cfg)`` on ``device``
    holding its weights.  Only the recomputed sinusoid buffer is dropped;
    ``load_state_dict(strict=True)`` checks every other name and shape."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model = Captioner(cfg, device=device)
    model.load_state_dict({k: v.float() for k, v in sd.items()
                           if k != REFERENCE_POS_TABLE})
    return model
