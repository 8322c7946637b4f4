"""Operations and bytes of the ``kimi_vl_a3b`` greedy decode, from the
configuration's sizes.

A product of [m, k] by [k, n] counts 2mkn.  The count is the published
forward with an expanded cache, whatever route the program takes: each
token's ``W_kv_b`` product once, and for each head q·k over nope + rope
dims and p·v over v dims for every key the causal mask lets through (pad
slots included: the products are computed and then masked).  An absorbed
decode step does other products for the same function and does not move
the count.  Routed experts count ``num_experts_per_tok`` a token, the
router, the shared experts and the dense layers every token, the
projector every slot, the head each of the ``max_length - 1`` logit
positions.  Norms, RoPE, softmax and the routing's sort are left out, so
a share reads low, never high.
"""

from __future__ import annotations

from typing import Dict

from . import ELEM_BYTES, PEAK_BYTES_PER_S, PEAK_FLOPS


def _z(c: Dict):
    cap = c["captioner"]
    return (c["hidden_size"], c["num_attention_heads"], c["qk_nope_head_dim"],
            c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"],
            cap["num_objects"] + 1, cap["max_length"] - 1)


def expert_matrix_flops(c: Dict) -> int:
    """One routed row through one expert: gate, up and down."""
    return 2 * 3 * c["hidden_size"] * c["moe_intermediate_size"]


def token_flops(c: Dict, keys: int) -> int:
    """One token through every layer, attending ``keys`` keys."""
    d, h, nope, rope, v, r, _, _ = _z(c)
    attn = 2 * (d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v)
                + h * v * d) + 2 * h * keys * (nope + rope + v)
    dense = 2 * 3 * d * c["intermediate_size"]
    moe = (2 * d * c["n_routed_experts"]
           + c["num_experts_per_tok"] * expert_matrix_flops(c)
           + 2 * 3 * d * c["n_shared_experts"] * c["moe_intermediate_size"])
    k = c["first_k_dense_replace"]
    return c["num_hidden_layers"] * attn + k * dense \
        + (c["num_hidden_layers"] - k) * moe


def greedy_per_image(c: Dict) -> int:
    """One image: the projector over the slots, the prefill over the slots
    and <START> (position i attends i + 1 keys), ``max_length - 2`` decode
    steps (the token at position p attends p + 1 keys), the head at each
    of the ``max_length - 1`` logit positions."""
    cap = c["captioner"]
    d, _, _, _, _, _, s, t = _z(c)
    n_in = cap["dim_features"] + cap["dim_positions"]
    ph = cap["projector_hidden_size"]
    out = s * 2 * (n_in * ph + ph * d)
    out += sum(token_flops(c, p + 1) for p in range(s + t))
    return out + t * 2 * d * c["vocab_size"]


def prefill_tokens(c: Dict) -> int:
    return c["captioner"]["num_objects"] + 2


def experts_bound_seconds(c: Dict, rows: float, touched: float,
                          dtype: str = "bf16") -> float:
    """The least time of one grouped expert call: ``rows`` routed rows in
    and out, ``touched`` experts' three matrices read once, at the card's
    bandwidth; or the rows' products at its peak; whichever is longer."""
    d, i = c["hidden_size"], c["moe_intermediate_size"]
    b = ELEM_BYTES[dtype]
    bytes_ = touched * 3 * d * i * b + rows * 2 * d * b
    return max(bytes_ / PEAK_BYTES_PER_S,
               rows * expert_matrix_flops(c) / PEAK_FLOPS[dtype])
