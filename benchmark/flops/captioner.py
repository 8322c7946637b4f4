"""Floating-point operations of the caption Transformer, from its sizes.

A product of [m, k] by [k, n] counts 2mkn.  Attention counts its two
products over every query and key its mask lets through the layer's
shapes: all of them in the teacher-forced forward (the dense [Lq, Lk]
products), the keys written so far in a cached decode step.
"""

from __future__ import annotations

from typing import Dict


def _attn(lq: int, lk: int, d: int, qk: int, v: int) -> int:
    """Projections, the two products and the output projection of one
    attention over one sequence."""
    return 2 * (lq * d * qk + lk * d * (qk + v) + lq * lk * (qk + v)
                + lq * v * d)


def _ffn(n: int, d: int, hidden: int) -> int:
    return 4 * n * d * hidden


def encoder(m: Dict) -> int:
    """One image's encoder forward."""
    s, d = m["num_objects"] + 1, m["encode_input_size"]
    qk, v, h = m["encode_q_k_dim"], m["encode_v_dim"], m["encode_hidden_size"]
    tokens = 2 * s if m["split_image_objects"] else s
    out = 2 * tokens * (m["dim_features"] + m["dim_positions"]) * d
    if m["split_image_objects"]:
        out += s * (_attn(2, 2, d, qk, v) + _ffn(2, d, h))
    return out + m["encode_num_blocks"] * (_attn(s, s, d, qk, v)
                                           + _ffn(s, d, h))


def forward(m: Dict) -> int:
    """One caption's teacher-forced forward over ``max_length - 1``
    tokens: encoder, decoder and classifier."""
    s, t = m["num_objects"] + 1, m["max_length"] - 1
    d, qk, v = m["decode_input_size"], m["decode_q_k_dim"], m["decode_v_dim"]
    h = m["decode_hidden_size"]
    block = (_attn(t, t, d, qk, v) + _attn(t, s, d, qk, v) + _ffn(t, d, h))
    out = encoder(m) + 2 * t * m["dim_word_embedding"] * d \
        + m["decode_num_blocks"] * block + 2 * t * d * m["num_vocab"]
    if m["move_first_image_feature"]:
        out += _ffn(t, d, h)
    return out


def train_step_per_item(m: Dict) -> int:
    """Forward and backward of one caption: three forwards (the backward
    computes a product for each operand)."""
    return 3 * forward(m)


def greedy_per_image(m: Dict) -> int:
    """One image's greedy decode through the KV cache: the encoder, the
    cross-attention keys and values once, then ``max_length - 1`` steps of
    one token each."""
    s, t = m["num_objects"] + 1, m["max_length"] - 1
    d, qk, v = m["decode_input_size"], m["decode_q_k_dim"], m["decode_v_dim"]
    h, n = m["decode_hidden_size"], m["decode_num_blocks"]
    out = encoder(m) + n * 2 * s * d * (qk + v)
    for step in range(t):
        keys = step + 1
        self_attn = 2 * (d * (2 * qk + v) + keys * (qk + v) + v * d)
        cross = 2 * (d * qk + s * (qk + v) + v * d)
        out += 2 * m["dim_word_embedding"] * d \
            + n * (self_attn + cross + _ffn(1, d, h)) + 2 * d * m["num_vocab"]
        if m["move_first_image_feature"]:
            out += _ffn(1, d, h)
    return out
