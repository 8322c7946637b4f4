"""Transformer layers as ``nn.Module``s whose parameter names are the
reference's state_dict names (modules.py:30-206): ``q_linear``,
``k_linear``, ``v_linear``, ``joint_linear``, ``layer_norm``,
``position_wise_1``/``_2``, ``multihead_attention``, ``feed_forward``,
``self_attention``, ``encode_attention``.  Weights are stored ``[out, in]``
as torch stores them.

Semantics follow the JAX package's ``models/layers.py``:
  * MultiHeadAttention — bias-free projections, dropout on the attention
    weights, post-norm residual ``LayerNorm(dropout(joint(attn)) + q)``,
    temperature sqrt(head dim);
  * FeedForward — Linear-ReLU-Linear with bias, dropout, post-norm
    residual;
  * EncoderBlock / DecoderBlock — pad rows zeroed after the FFN.

Dropout runs where the JAX package's runs, at the module's rates, when a
``generator`` is given and ``deterministic`` is False.  The generator is
split per site as the JAX code splits its rng (``utils/rng.split``).  Every
initializer takes a CPU ``torch.Generator``.

Under sequence parallelism (``parallel/sequence.py``) the blocks run on a
rank's slots: ``slots`` (an ``ops.attention.Part`` of the [B, L, D]
activations) places them among all of them for the dropouts, and an
encoder block's attention takes its keys and values from ``kv``, every
slot gathered.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.attention import Part, dropout, sdp_attention
from ..utils.rng import split


# ---------------------------------------------------------------------------
# Initializers matching the reference's torch inits
# ---------------------------------------------------------------------------

def normal_fan_sum(generator: torch.Generator, in_dim: int,
                   out_dim: int) -> torch.Tensor:
    """N(0, sqrt(2/(in+out))), [out, in]: the reference q/k/v init
    (modules.py:45-53) and xavier_normal_ with gain 1."""
    std = math.sqrt(2.0 / (in_dim + out_dim))
    return std * torch.randn((out_dim, in_dim), generator=generator)


def torch_default_kernel(generator: torch.Generator, in_dim: int,
                         out_dim: int) -> torch.Tensor:
    """torch.nn.Linear's default, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(in_dim)
    return (torch.rand((out_dim, in_dim), generator=generator) * 2 - 1) * bound


def torch_default_bias(generator: torch.Generator, in_dim: int,
                       out_dim: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(in_dim)
    return (torch.rand((out_dim,), generator=generator) * 2 - 1) * bound


def embedding_table(generator: torch.Generator, num_embeddings: int,
                    dim: int, pad_idx: Optional[int] = 0) -> torch.Tensor:
    """torch.nn.Embedding's default N(0, 1) with the pad row zeroed
    (model.py:389-391)."""
    table = torch.randn((num_embeddings, dim), generator=generator)
    if pad_idx is not None:
        table[pad_idx] = 0.0
    return table


# ---------------------------------------------------------------------------
# Linear and LayerNorm
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``y = x W^T (+ b)`` with f32 accumulation.  The weight is cast to the
    activation dtype and the bias is added in that dtype, so under bf16 the
    product runs in bf16 while the parameters stay f32."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool,
                 generator: torch.Generator,
                 kernel_init=torch_default_kernel):
        super().__init__()
        self.weight = nn.Parameter(kernel_init(generator, in_dim, out_dim))
        self.bias = (nn.Parameter(torch_default_bias(generator, in_dim,
                                                     out_dim))
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.nn.functional.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class LayerNorm(nn.Module):
    """torch LayerNorm semantics (biased variance), eps 1e-6
    (modules.py:57,105), statistics in f32 whatever the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention, feed-forward and the blocks
# ---------------------------------------------------------------------------

def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


class MultiHeadAttention(nn.Module):
    """Post-norm residual MHA: ``LayerNorm(dropout(joint(attn)) + q_in)``
    (modules.py:30-92).  Under tensor parallelism
    (``parallel.tensor.shard_model``) it runs ``num_heads`` of the heads,
    ``dropout_heads`` (the ``Part`` of dim 1 of the attention weights)
    placing them among all of them."""

    def __init__(self, input_size: int, q_k_dim: int, v_dim: int,
                 num_heads: int, *, generator: torch.Generator,
                 dropout_rate: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.attention_dropout = attention_dropout
        self.dropout_heads: Optional[Part] = None

        def lin(i, o):
            return Linear(i, o, bias=False, generator=generator,
                          kernel_init=normal_fan_sum)

        self.q_linear = lin(input_size, q_k_dim)
        self.k_linear = lin(input_size, q_k_dim)
        self.v_linear = lin(input_size, v_dim)
        # xavier_normal (modules.py:62); in = num_heads * v_head = v_dim
        self.joint_linear = lin(v_dim, input_size)
        self.layer_norm = LayerNorm(input_size)

    def forward(self, q_in, k_in, v_in, mask, *,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, need_weights: bool = True,
                slots: Optional[Part] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``slots``: the queries' ``Part`` of the [B, Lq, D] activations
        (dim 0 where each row of the batch is folded with its slots, as in
        the pair block; dim 1 for the slots themselves), the keys whole."""
        q = split_heads(self.q_linear(q_in), self.num_heads)
        k = split_heads(self.k_linear(k_in), self.num_heads)
        v = split_heads(self.v_linear(v_in), self.num_heads)
        temperature = math.sqrt(q.shape[-1])
        attn_gen, out_gen = split(generator, 2)
        parts = [] if self.dropout_heads is None else [self.dropout_heads]
        if slots is not None:
            # the queries' dim of the weights [B, H, Lq, Lk]
            parts.append((0 if slots[0] == 0 else 2, *slots[1:]))
        out, attn = sdp_attention(q, k, v, mask, temperature,
                                  dropout_rate=self.attention_dropout,
                                  generator=attn_gen,
                                  deterministic=deterministic,
                                  need_weights=need_weights,
                                  dropout_parts=parts)
        out = self.joint_linear(merge_heads(out))
        out = dropout(out, self.dropout_rate, out_gen, deterministic,
                      () if slots is None else (slots,))
        return self.layer_norm(out + q_in), attn


class FeedForward(nn.Module):
    """Linear-ReLU-Linear, dropout, post-norm residual
    (modules.py:95-122)."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: torch.Generator, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.position_wise_1 = Linear(input_size, hidden_size, bias=True,
                                      generator=generator,
                                      kernel_init=normal_fan_sum)
        self.position_wise_2 = Linear(hidden_size, input_size, bias=True,
                                      generator=generator,
                                      kernel_init=normal_fan_sum)
        self.layer_norm = LayerNorm(input_size)

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True,
                slots: Optional[Part] = None) -> torch.Tensor:
        h = torch.relu(self.position_wise_1(x))
        h = self.position_wise_2(h)
        h = dropout(h, self.dropout_rate, generator, deterministic,
                    () if slots is None else (slots,))
        return self.layer_norm(h + x)


class EncoderBlock(nn.Module):
    """modules.py:125-157: MHA -> FFN -> pad rows zeroed."""

    def __init__(self, input_size: int, hidden_size: int, num_heads: int,
                 q_k_dim: int, v_dim: int, *, generator: torch.Generator,
                 dropout_rate: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        self.multihead_attention = MultiHeadAttention(
            input_size, q_k_dim, v_dim, num_heads, generator=generator,
            dropout_rate=dropout_rate, attention_dropout=attention_dropout)
        self.feed_forward = FeedForward(input_size, hidden_size,
                                        generator=generator,
                                        dropout_rate=dropout_rate)

    def forward(self, x, *, non_pad_mask=None, attention_mask=None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, need_weights: bool = True,
                kv: Optional[torch.Tensor] = None,
                slots: Optional[Part] = None):
        """``kv``: the keys' and values' input (``x`` when None);
        ``slots``: ``x``'s ``Part`` (``MultiHeadAttention.forward``)."""
        g1, g2 = split(generator, 2)
        kv = x if kv is None else kv
        out, attn = self.multihead_attention(
            x, kv, kv, attention_mask, generator=g1,
            deterministic=deterministic, need_weights=need_weights,
            slots=slots)
        out = self.feed_forward(out, generator=g2,
                                deterministic=deterministic, slots=slots)
        if non_pad_mask is not None:
            out = out * non_pad_mask.to(out.dtype)
        return out, attn


class DecoderBlock(nn.Module):
    """modules.py:160-206: masked self-MHA -> cross-MHA -> FFN -> pad rows
    zeroed."""

    def __init__(self, input_size: int, hidden_size: int, num_heads: int,
                 q_k_dim: int, v_dim: int, *, generator: torch.Generator,
                 dropout_rate: float = 0.0, attention_dropout: float = 0.0):
        super().__init__()
        rates = dict(dropout_rate=dropout_rate,
                     attention_dropout=attention_dropout)
        self.self_attention = MultiHeadAttention(
            input_size, q_k_dim, v_dim, num_heads, generator=generator,
            **rates)
        self.encode_attention = MultiHeadAttention(
            input_size, q_k_dim, v_dim, num_heads, generator=generator,
            **rates)
        self.feed_forward = FeedForward(input_size, hidden_size,
                                        generator=generator,
                                        dropout_rate=dropout_rate)

    def forward(self, x, encode_output, *, non_pad_mask=None,
                self_attention_mask=None, context_attention_mask=None,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = True, need_weights: bool = True):
        g1, g2, g3 = split(generator, 3)
        out, self_attn = self.self_attention(
            x, x, x, self_attention_mask, generator=g1,
            deterministic=deterministic, need_weights=need_weights)
        out, cross_attn = self.encode_attention(
            out, encode_output, encode_output, context_attention_mask,
            generator=g2, deterministic=deterministic,
            need_weights=need_weights)
        out = self.feed_forward(out, generator=g3,
                                deterministic=deterministic)
        if non_pad_mask is not None:
            out = out * non_pad_mask.to(out.dtype)
        return out, self_attn, cross_attn


# ---------------------------------------------------------------------------
# Sinusoidal positional encoding (model.py:489-517)
# ---------------------------------------------------------------------------

def sinusoid_table(num_positions: int, dim: int) -> torch.Tensor:
    """angle(pos, j) = pos / 10000^(2*(j//2)/dim); sin on even dims, cos on
    odd dims.  Built in float64, returned as f32 [num_positions, dim]."""
    positions = np.arange(num_positions)[:, None]
    j = np.arange(dim)[None, :]
    angles = positions / np.power(10000.0, 2 * (j // 2) / dim)
    table = np.zeros((num_positions, dim), dtype=np.float64)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    return torch.from_numpy(table.astype(np.float32))
