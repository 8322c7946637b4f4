"""KV-cached caption decoding: greedy and beam search.

The reference re-runs the whole decoder over the growing prefix at every
step (greedy: model.py:101-132; beam: model.py:135-200, a Python loop per
beam).  Here each step runs one token through the blocks against a KV
cache, the cross-attention K/V are projected once per sequence, and the
beams are a tensor dimension.  The decode rules are the reference's:

  * greedy: argmax of classifier(h_t) (model.py:125-128);
  * beam: scores accumulate softmax probabilities for the XE model
    (model.py:183) and log-probabilities for the RL policy
    (model_RL.py:72,182); no EOS exit; beam 0 is returned (model.py:200);
  * generated pad tokens are masked as keys and their rows zeroed
    (model.py:421,461-486).

The layout follows the JAX package's ``models/decoding.py`` so that both sum
the same entries in the same order: beams keep their K/V in their own cache
lane, and ``ancestry`` records which lane wrote each position of a
hypothesis.  The caches are updated in place; nothing else holds them.
Every top-k goes through ``topk_lowest_index``, the tie rule of
``jax.lax.top_k``.

``lm_greedy_decode`` is the greedy decode of the ``mla_moe`` captioner
(``models/lm.py``) under the same token contract: one prefill over the
slots and <START> writes every layer's latent cache (``decode.prefill``),
then each step feeds the last token through it (``decode.step``, on the
device; on CUDA its segments replay as captured graphs, so the host
enqueues a step in about a hundred launches).  While a profiler records it
counts the prefix's keys (``mla.prefix_keys``) and those a step may attend
(``mla.prefix_keys_visible``; the others are pad slots).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..config import END_IDX, NULL_IDX, START_IDX, ModelConfig
from ..ops.attention import masked_softmax
from ..utils.debug import annotate, count, recording
from ..utils.device import DeviceLike, resolve_device
from .captioner import Captioner
from .layers import MultiHeadAttention
from .lm import LMCaptioner


def topk_lowest_index(x: torch.Tensor,
                      k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the last axis, sorted descending, the lowest index first
    among equal values: the rule of ``jax.lax.top_k``.  ``torch.topk``
    promises no order for ties; a stable descending sort does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def beam_score_mode(caption_model: str) -> str:
    """The XE ``Transformer`` accumulates softmax probabilities
    (model.py:183), ``PolicyNetwork`` log-probs (model_RL.py:157,182).
    Unknown model names raise rather than decode in the wrong mode."""
    if caption_model not in ("Transformer", "RL_Transformer"):
        raise ValueError(
            f"unknown CAPTION_MODEL {caption_model!r} (core/config.py:13-14)")
    return "logprob" if caption_model == "RL_Transformer" else "prob"


def _inputs(model: Captioner, object_features, position_features,
            device: DeviceLike):
    if getattr(model, "tp", None) is not None:
        raise ValueError("decode runs on a full replica of a sharded model "
                         "(parallel.tensor.full_state_dict), not its shard")
    device = resolve_device(device)
    have = model.device
    if have.type != device.type or (device.index is not None
                                    and device.index != have.index):
        raise ValueError(f"model lies on {have}, decode asked for {device}")
    return (torch.as_tensor(object_features, device=have),
            torch.as_tensor(position_features, device=have))


class DecodeCache(NamedTuple):
    """Per-layer self-attention KV cache and key validity."""
    k: List[torch.Tensor]             # each [B, H, T, dh_k]
    v: List[torch.Tensor]             # each [B, H, T, dh_v]
    valid: torch.Tensor               # [B, T] bool: key was a non-pad token


def init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device: torch.device) -> DecodeCache:
    t = cfg.max_length - 1
    h = cfg.decode_num_heads
    shape_k = (batch, h, t, cfg.decode_q_k_dim // h)
    shape_v = (batch, h, t, cfg.decode_v_dim // h)
    n = cfg.decode_num_blocks
    return DecodeCache(
        k=[torch.zeros(shape_k, dtype=dtype, device=device) for _ in range(n)],
        v=[torch.zeros(shape_v, dtype=dtype, device=device) for _ in range(n)],
        valid=torch.zeros((batch, t), dtype=torch.bool, device=device))


def precompute_cross_kv(model: Captioner, encode_output: torch.Tensor):
    """Project the encoder output to every layer's cross K/V once."""
    h = model.cfg.decode_num_heads
    b, lk, _ = encode_output.shape
    ks, vs = [], []
    for block in model.decoder.decoder:
        p = block.encode_attention
        ks.append(p.k_linear(encode_output).reshape(b, lk, h, -1)
                  .transpose(1, 2))
        vs.append(p.v_linear(encode_output).reshape(b, lk, h, -1)
                  .transpose(1, 2))
    return ks, vs


def _attend(q, k, v, neg_mask, temperature):
    """q [B,H,1,dh] x k/v [B,H,T,dh]; neg_mask bool [B,1,T] True = masked.
    Returns (out [B,H,1,dh], weights [B,H,1,T])."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() / temperature,
                          k.float())
    scores = scores.masked_fill(neg_mask[:, None, :, :], float("-inf"))
    attn = masked_softmax(scores)
    out = torch.einsum("bhqk,bhkd->bhqd", attn, v.float()).to(q.dtype)
    return out, attn


def _mha_step_self(p: MultiHeadAttention, x, cache_k, cache_v, pos: int,
                   valid):
    """Single-query self-attention against the cache (post-norm residual);
    writes this step's K/V into the cache at ``pos``."""
    b, h = x.shape[0], p.num_heads
    q = p.q_linear(x).reshape(b, 1, h, -1).transpose(1, 2)
    cache_k[:, :, pos] = p.k_linear(x).reshape(b, h, -1)
    cache_v[:, :, pos] = p.v_linear(x).reshape(b, h, -1)
    t = cache_k.shape[2]
    # a key is masked if it is a pad token or beyond the current position
    later = torch.arange(t, device=x.device) > pos
    neg_mask = (~valid | later[None, :])[:, None, :]
    out, _ = _attend(q, cache_k, cache_v, neg_mask, math.sqrt(q.shape[-1]))
    out = p.joint_linear(out.transpose(1, 2).reshape(b, 1, -1))
    return p.layer_norm(out + x)


def _mha_step_cross(p: MultiHeadAttention, x, k, v, cross_neg_mask):
    b, h = x.shape[0], p.num_heads
    q = p.q_linear(x).reshape(b, 1, h, -1).transpose(1, 2)
    out, attn = _attend(q, k, v, cross_neg_mask, math.sqrt(q.shape[-1]))
    out = p.joint_linear(out.transpose(1, 2).reshape(b, 1, -1))
    return p.layer_norm(out + x), attn


def _embed_step(model: Captioner, flat_token, pos: int, dtype):
    dec = model.decoder
    x = dec.word_embedding(flat_token[:, None]).to(dtype)
    x = dec.word_embedding_linear(x)
    x = x + dec.pos_table[pos:pos + 1].to(dtype)
    return dec.norm(x)


def decoder_step(model: Captioner, token: torch.Tensor, pos: int,
                 cache: DecodeCache, cross_kv, cross_neg_mask,
                 encode_output: torch.Tensor):
    """One decode step, token [B].  Updates ``cache`` in place and returns
    (logits [B, V], cross_attn [B, H, Lk] of the last block)."""
    cfg = model.cfg
    is_word = token != cfg.pad_idx
    cache.valid[:, pos] = is_word
    x = _embed_step(model, token, pos, encode_output.dtype)
    nonpad = is_word[:, None, None].to(x.dtype)
    cross_k, cross_v = cross_kv
    cross_attn = None
    # a span a sub-layer: the card waits on the step's small launches, and
    # a trace names each idle gap after the span open at its middle (found
    # among the few hundred host events before it)
    for i, block in enumerate(model.decoder.decoder):
        with annotate("decode.self_attention"):
            x = _mha_step_self(block.self_attention, x, cache.k[i],
                               cache.v[i], pos, cache.valid)
        with annotate("decode.cross_attention"):
            x, cross_attn = _mha_step_cross(block.encode_attention, x,
                                            cross_k[i], cross_v[i],
                                            cross_neg_mask)
        with annotate("decode.feed_forward"):
            # non-pad zeroing of the current row (model.py:444,203-204)
            x = block.feed_forward(x) * nonpad
    with annotate("decode.classifier"):
        if cfg.move_first_image_feature:
            # the tail FFN is not pad-zeroed (model.py:451-457)
            x = model.decoder.move_first_image_feature(x, encode_output)
        logits = model.classifer(x[:, 0].float())
    return logits, cross_attn[:, :, 0, :]


def _encode(model: Captioner, object_features, position_features,
            use_kernel: bool):
    encode_output, _ = model.encoder(object_features, position_features,
                                     use_kernel=use_kernel)
    cross_kv = precompute_cross_kv(model, encode_output)
    cross_neg = (position_features == 0).all(dim=-1)[:, None, :]
    return encode_output, cross_kv, cross_neg


# ---------------------------------------------------------------------------
# Greedy decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def greedy_decode(model: Captioner, object_features, position_features, *,
                  use_kernel: bool = False, return_attention: bool = False,
                  device: DeviceLike = None):
    """Replaces model.py:101-132.  Returns (tokens [B, max_length+1] int64,
    attention [steps, B, S] or None), on the model's device.

    attention[t] is the mean over heads of the last block's cross-attention
    at step t (model.py:123), used by the demo overlay."""
    cfg = model.cfg
    with annotate("decode.greedy", device=True):
        feats, poss = _inputs(model, object_features, position_features,
                              device)
        encode_output, cross_kv, cross_neg = _encode(model, feats, poss,
                                                     use_kernel)
        b = encode_output.shape[0]
        tokens = torch.zeros((b, cfg.max_length + 1), dtype=torch.long,
                             device=feats.device)
        tokens[:, 0] = START_IDX
        cache = init_cache(cfg, b, feats.dtype, feats.device)
        attn = []
        for t in range(cfg.max_length - 1):
            with annotate("decode.step"):
                logits, cross_attn = decoder_step(model, tokens[:, t], t,
                                                  cache, cross_kv, cross_neg,
                                                  encode_output)
                # softmax -> argmax == argmax(logits), the first maximum on
                # ties
                tokens[:, t + 1] = logits.argmax(dim=-1)
                if return_attention:
                    attn.append(cross_attn.mean(dim=1))
    return tokens, (torch.stack(attn) if return_attention else None)


@torch.no_grad()
def lm_greedy_decode(model: LMCaptioner, object_features, position_features,
                     *, device: DeviceLike = None) -> torch.Tensor:
    """Greedy decode of the ``mla_moe`` captioner: tokens [B, max_length+1]
    int64 on the model's device, <START> first, then ``max_length - 1``
    argmax tokens (no early stop), the last column 0 as in
    ``greedy_decode``."""
    cfg = model.cfg
    with annotate("decode.greedy", device=True):
        feats, poss = _inputs(model, object_features, position_features,
                              device)
        b = feats.shape[0]
        tokens = torch.zeros((b, cfg.max_length + 1), dtype=torch.long,
                             device=feats.device)
        tokens[:, 0] = START_IDX
        st = model.step_state(b)
        with annotate("decode.prefill", device=True):
            logits = model.prefill(feats, poss, tokens[:, 0], st.cache)
            tokens[:, 1] = logits.argmax(dim=-1)
        if recording():
            count("mla.prefix_keys", b * model.prefix)
            count("mla.prefix_keys_visible",
                  st.cache.key_ok[:, :model.prefix])
        st.token.copy_(tokens[:, 1])
        st.pos.fill_(model.prefix)
        for t in range(2, cfg.max_length):
            with annotate("decode.step", device=True):
                model.run_step(st)
                tokens[:, t] = st.next
                st.token.copy_(st.next)
                st.pos.add_(1)
    return tokens


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

class BeamCache(NamedTuple):
    """Gather-free beam state: K/V stay in the lane that wrote them; a beam
    reorder touches only the small ancestry / validity / token arrays."""
    k: List[torch.Tensor]             # each [B, H, K, T, dh_k]
    v: List[torch.Tensor]             # each [B, H, K, T, dh_v]
    ancestry: torch.Tensor            # [B, K, T] int64: writing lane per pos
    valid: torch.Tensor               # [B, K, T] bool: non-pad token at pos


def _mha_step_self_beam(p: MultiHeadAttention, x, cache_k, cache_v,
                        pos: int, allowed, *, batch: int, k: int):
    """Beam self-attention against all lanes.  x [B*K, 1, D];
    cache_k/v [B, H, K, T, dh]; allowed [B, K, K, T] bool."""
    h = p.num_heads
    t_total = cache_k.shape[3]
    q = p.q_linear(x).reshape(batch, k, h, -1).transpose(1, 2)  # [B,H,K,dh]
    # every lane writes its own entry at `pos`
    cache_k[:, :, :, pos] = p.k_linear(x).reshape(batch, k, h, -1) \
        .transpose(1, 2)
    cache_v[:, :, :, pos] = p.v_linear(x).reshape(batch, k, h, -1) \
        .transpose(1, 2)
    keys = cache_k.reshape(batch, h, k * t_total, -1)
    vals = cache_v.reshape(batch, h, k * t_total, -1)
    scores = torch.einsum("bhnd,bhkd->bhnk",
                          q.float() / math.sqrt(q.shape[-1]), keys.float())
    mask = allowed.reshape(batch, 1, k, k * t_total)
    scores = scores.masked_fill(~mask, float("-inf"))
    attn = masked_softmax(scores)
    out = torch.einsum("bhnk,bhkd->bhnd", attn, vals.float()).to(x.dtype)
    out = p.joint_linear(out.transpose(1, 2).reshape(batch * k, 1, -1))
    return p.layer_norm(out + x)


def decoder_step_beam(model: Captioner, token: torch.Tensor, pos: int,
                      cache: BeamCache, cross_kv, cross_neg_mask,
                      encode_output: torch.Tensor) -> torch.Tensor:
    """One step over [B, K] beams without cache reordering; updates the
    cache in place and returns logits [B, K, V]."""
    cfg = model.cfg
    b, k = token.shape
    flat_token = token.reshape(b * k)
    is_word = flat_token != cfg.pad_idx
    lanes = torch.arange(k, device=token.device)
    # this step writes lane n at position `pos`
    cache.ancestry[:, :, pos] = lanes[None, :]
    cache.valid[:, :, pos] = is_word.reshape(b, k)

    t_total = cache.valid.shape[-1]
    upto = torch.arange(t_total, device=token.device) <= pos
    # beam n may attend lane m at τ iff m wrote τ for n, τ <= pos, non-pad
    allowed = (cache.ancestry[:, :, None, :] == lanes[None, None, :, None]) \
        & upto[None, None, None, :] & cache.valid[:, :, None, :]

    x = _embed_step(model, flat_token, pos, encode_output.dtype)
    nonpad = is_word[:, None, None].to(x.dtype)
    cross_k, cross_v = cross_kv
    for i, block in enumerate(model.decoder.decoder):
        x = _mha_step_self_beam(block.self_attention, x, cache.k[i],
                                cache.v[i], pos, allowed, batch=b, k=k)
        x, _ = _mha_step_cross(block.encode_attention, x, cross_k[i],
                               cross_v[i], cross_neg_mask)
        x = block.feed_forward(x) * nonpad
    if cfg.move_first_image_feature:
        x = model.decoder.move_first_image_feature(x, encode_output)
    logits = model.classifer(x[:, 0].float())
    return logits.reshape(b, k, -1)


def _reindex_small(x: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """Gather over the beam dim of the small per-beam state."""
    idx = beam_idx.reshape(*beam_idx.shape, *([1] * (x.dim() - 2)))
    return x.gather(1, idx.expand(-1, -1, *x.shape[2:]))


@torch.no_grad()
def beam_search(model: Captioner, object_features, position_features, *,
                beam_size: int, score_mode: str = "prob",
                use_kernel: bool = False, stop_at_end: bool = False,
                device: DeviceLike = None) -> torch.Tensor:
    """Replaces model.py:135-200 / model_RL.py:134-199.

    score_mode 'prob' sums softmax probabilities (XE model parity,
    model.py:183), 'logprob' sums log-probs (RL policy, model_RL.py:72,182).
    stop_at_end freezes a beam that emitted <END>: it proposes only <NULL>
    with certainty, so its score stops accumulating (off by default for
    reference parity).  Returns the best beam, tokens [B, max_length]."""
    if score_mode not in ("prob", "logprob"):
        raise ValueError(f"unknown score_mode {score_mode!r}")
    cfg = model.cfg
    feats, poss = _inputs(model, object_features, position_features, device)
    encode_output, cross_kv_b, cross_neg_b = _encode(model, feats, poss,
                                                     use_kernel)
    b = encode_output.shape[0]
    k = beam_size
    t_total = cfg.max_length - 1
    dev = feats.device

    # step 0 on the un-expanded batch (model.py:148-166)
    cache_b = init_cache(cfg, b, feats.dtype, dev)
    start = torch.full((b,), START_IDX, dtype=torch.long, device=dev)
    logits0, _ = decoder_step(model, start, 0, cache_b, cross_kv_b,
                              cross_neg_b, encode_output)
    p0 = (torch.softmax(logits0, dim=-1) if score_mode == "prob"
          else torch.log_softmax(logits0, dim=-1))
    scores, tok1 = topk_lowest_index(p0, k)            # [B, K] each

    def expand(x):
        return x.repeat_interleave(k, dim=0)

    enc_bk = expand(encode_output)
    cross_kv = ([expand(x) for x in cross_kv_b[0]],
                [expand(x) for x in cross_kv_b[1]])
    cross_neg = expand(cross_neg_b)
    cache = BeamCache(
        # greedy cache [B,H,T,dh] -> lane-replicated [B,H,K,T,dh]
        k=[x[:, :, None].repeat(1, 1, k, 1, 1) for x in cache_b.k],
        v=[x[:, :, None].repeat(1, 1, k, 1, 1) for x in cache_b.v],
        # position 0 was written identically to every lane; credit lane n
        ancestry=torch.arange(k, device=dev)[None, :, None]
        .repeat(b, 1, t_total),
        valid=cache_b.valid[:, None].repeat(1, k, 1))

    tokens = torch.zeros((b, k, cfg.max_length), dtype=torch.long,
                         device=dev)
    tokens[:, :, 0] = START_IDX
    tokens[:, :, 1] = tok1

    for t in range(1, cfg.max_length - 1):
        token_t = tokens[:, :, t]
        logits = decoder_step_beam(model, token_t, t, cache, cross_kv,
                                   cross_neg, enc_bk)
        # rank the logits directly (softmax is monotonic and the running
        # score is constant per row), then normalise only the top-k values
        local_l, local_i = topk_lowest_index(logits, k)   # [B, K, K]
        lse = torch.logsumexp(logits, dim=-1, keepdim=True)
        local_s = (torch.exp(local_l - lse) if score_mode == "prob"
                   else local_l - lse)
        if stop_at_end:
            finished = (token_t == END_IDX) | ((token_t == NULL_IDX) & (t > 1))
            # slot 0 adds nothing (freeze); the duplicate proposals in
            # slots 1.. must never be selected
            certain = torch.zeros_like(local_s)
            certain[..., 1:] = float("-inf")
            local_s = torch.where(finished[..., None], certain, local_s)
            local_i = torch.where(finished[..., None],
                                  torch.full_like(local_i, NULL_IDX), local_i)
        combined = local_s + scores[..., None]
        # two-stage top-k (exact): the global top-K over K*V can only use
        # each beam's own top-K tokens
        scores, idx = topk_lowest_index(combined.reshape(b, k * k), k)
        beam_idx = idx // k
        new_tok = local_i.reshape(b, k * k).gather(1, idx)
        # reorder only the small state; K/V lanes stay put
        tokens = _reindex_small(tokens, beam_idx)
        cache = cache._replace(
            ancestry=_reindex_small(cache.ancestry, beam_idx),
            valid=_reindex_small(cache.valid, beam_idx))
        tokens[:, :, t + 1] = new_tok
    # beam 0 = highest accumulated score (sorted top-k), model.py:200
    return tokens[:, 0]
