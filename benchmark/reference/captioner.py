"""Plain PyTorch reference of the caption Transformer, its XE loss, Adam,
greedy decoding's teacher-forced check and detokenisation.

The model is the reference repository's (shao-chi/Image-Caption,
``core/TRANSFORMER/model.py`` and ``modules.py``): post-norm residual
blocks, bias-free attention projections, sinusoidal positions over
``max_length - 1`` positions, LayerNorm eps 1e-6, pad rows zeroed after
each block, the whole-image/object pair block of ``split_image_objects``,
the causal encoder mask of ``encode_mask``.  Parameters are a state_dict
(``name -> tensor``) in that repository's names.

Dropout draws the masks by the streams the program documents for its
training step (``utils/rng.py``): a CUDA ``torch.Generator`` per site,
seeded by splitmix64 ``fold_in`` of its parent's seed with the child's
index, and ``torch.rand(shape) >= rate`` drawn once per site.  The same
seed on the same card gives the same masks, so the reference follows the
program's steps without reading anything the program made.

Everything runs in float32; callers switch TF32 off (or on, for the
control) around the calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

_MASK64 = (1 << 64) - 1
NULL, START, END = 0, 1, 2


# ---------------------------------------------------------------------------
# Dropout streams
# ---------------------------------------------------------------------------

def _mix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    return _mix(_mix(seed & _MASK64) ^ (data & _MASK64)) & ((1 << 63) - 1)


class Stream:
    """A dropout site's seed; ``split`` gives its children, ``dropout`` draws
    the site's keep mask once.  ``None`` seeds mean dropout off."""

    def __init__(self, seed: Optional[int], device):
        self.seed, self.device = seed, device

    def split(self, n: int) -> List["Stream"]:
        if self.seed is None:
            return [Stream(None, self.device) for _ in range(n)]
        return [Stream(fold_in(self.seed, i), self.device) for i in range(n)]

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.seed is None or rate == 0.0:
            return x
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# ---------------------------------------------------------------------------
# The parameters: names, shapes and initialisers
# ---------------------------------------------------------------------------

def spec(m: Dict):
    """``[(name, shape, init, fan_in)]`` of a configuration's state_dict.
    ``init``: "fan_sum" N(0, 2/(in+out)), "uniform" U(+-1/sqrt(fan_in)),
    "embedding" N(0, 1) with the pad row zero, "ones", "zeros"."""
    out = []

    def lin(pre, i, o, init="fan_sum", bias=False):
        out.append((pre + ".weight", (o, i), init, i))
        if bias:
            out.append((pre + ".bias", (o,), "uniform", i))

    def norm(pre, d):
        out.append((pre + ".weight", (d,), "ones", d))
        out.append((pre + ".bias", (d,), "zeros", d))

    def mha(pre, d, qk, v):
        for n, o in (("q_linear", qk), ("k_linear", qk), ("v_linear", v)):
            lin(f"{pre}.{n}", d, o)
        lin(pre + ".joint_linear", v, d)
        norm(pre + ".layer_norm", d)

    def ffn(pre, d, h):
        lin(pre + ".position_wise_1", d, h, bias=True)
        lin(pre + ".position_wise_2", h, d, bias=True)
        norm(pre + ".layer_norm", d)

    d, dd = m["encode_input_size"], m["decode_input_size"]
    lin("encoder.position_embedding", m["dim_positions"], d, "uniform")
    lin("encoder.feature_embedding", m["dim_features"], d, "uniform")
    enc = ["encoder.image_encoder"] if m["split_image_objects"] else []
    enc += [f"encoder.encoder.{i}" for i in range(m["encode_num_blocks"])]
    for pre in enc:
        mha(pre + ".multihead_attention", d, m["encode_q_k_dim"],
            m["encode_v_dim"])
        ffn(pre + ".feed_forward", d, m["encode_hidden_size"])
    norm("encoder.norm", d)
    out.append(("decoder.word_embedding.weight",
                (m["num_vocab"], m["dim_word_embedding"]), "embedding", 0))
    lin("decoder.word_embedding_linear", m["dim_word_embedding"], dd,
        "uniform")
    norm("decoder.norm", dd)
    for i in range(m["decode_num_blocks"]):
        pre = f"decoder.decoder.{i}"
        for a in ("self_attention", "encode_attention"):
            mha(f"{pre}.{a}", dd, m["decode_q_k_dim"], m["decode_v_dim"])
        ffn(pre + ".feed_forward", dd, m["decode_hidden_size"])
    lin("classifer", dd, m["num_vocab"], bias=True)
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def layer_norm(x, p, pre, eps=1e-6):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p[pre + ".weight"] \
        + p[pre + ".bias"]


def linear(x, p, pre):
    y = x @ p[pre + ".weight"].t()
    b = p.get(pre + ".bias")
    return y if b is None else y + b


def attention(p, pre, q_in, kv_in, masked, heads, rate, stream: Stream):
    """Post-norm multi-head attention; ``masked`` bool [B, Lq, Lk], True
    where a key is hidden (None: no mask)."""
    b, lq, _ = q_in.shape
    lk = kv_in.shape[1]
    q = linear(q_in, p, pre + ".q_linear").view(b, lq, heads, -1)
    k = linear(kv_in, p, pre + ".k_linear").view(b, lk, heads, -1)
    v = linear(kv_in, p, pre + ".v_linear").view(b, lk, heads, -1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    scores = (q / math.sqrt(q.shape[-1])) @ k.transpose(-1, -2)
    if masked is not None:
        scores = scores.masked_fill(masked[:, None], float("-inf"))
        top = scores.amax(-1, keepdim=True)
        top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
        e = torch.exp(scores - top)
        weights = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    else:
        weights = torch.softmax(scores, -1)
    s_attn, s_out = stream.split(2)
    weights = s_attn.dropout(weights, rate["attention"])
    out = (weights @ v).transpose(1, 2).reshape(b, lq, -1)
    out = s_out.dropout(linear(out, p, pre + ".joint_linear"), rate["residual"])
    return layer_norm(out + q_in, p, pre + ".layer_norm")


def feed_forward(p, pre, x, rate, stream: Stream):
    h = torch.relu(linear(x, p, pre + ".position_wise_1"))
    h = stream.dropout(linear(h, p, pre + ".position_wise_2"), rate["residual"])
    return layer_norm(h + x, p, pre + ".layer_norm")


def encoder_block(p, pre, x, kv, masked, non_pad, heads, rate, stream):
    s1, s2 = stream.split(2)
    out = attention(p, pre + ".multihead_attention", x, kv, masked, heads,
                    rate, s1)
    out = feed_forward(p, pre + ".feed_forward", out, rate, s2)
    return out if non_pad is None else out * non_pad


def sinusoid(n: int, d: int, device) -> torch.Tensor:
    pos = np.arange(n)[:, None]
    j = np.arange(d)[None, :]
    ang = pos / np.power(10000.0, 2 * (j // 2) / d)
    table = np.where(j % 2 == 0, np.sin(ang), np.cos(ang))
    return torch.tensor(table, dtype=torch.float32, device=device)


def _pad_rows(x):
    """[B, L, D] -> (key hidden bool [B, L], row kept float [B, L, 1])."""
    pad = (x == 0).all(-1)
    return pad, (~pad)[..., None].float()


def _causal(n, device):
    return torch.ones((n, n), dtype=torch.bool, device=device).triu(1)


def encode(p, m: Dict, feats, poss, stream: Stream) -> torch.Tensor:
    """[B, S, F] features and [B, S, P] positions -> [B, S, D]."""
    rate = {"attention": m["attention_dropout"], "residual": m["dropout"]}
    streams = stream.split(m["encode_num_blocks"] + 1)
    b, s, _ = feats.shape
    if m["split_image_objects"]:
        f2 = torch.stack([feats[:, :1].expand(b, s, -1), feats], 2)
        p2 = torch.stack([poss[:, :1].expand(b, s, -1), poss], 2)
        f2 = f2.reshape(b * s, 2, -1)
        p2 = p2.reshape(b * s, 2, -1)
        emb_p = linear(p2, p, "encoder.position_embedding")
        x = layer_norm(linear(f2, p, "encoder.feature_embedding") + emb_p, p,
                       "encoder.norm")
        pad, keep = _pad_rows(p2)
        hidden = pad[:, None, :] | _causal(2, x.device)[None]
        x = encoder_block(p, "encoder.image_encoder", x, x, hidden, keep,
                          m["encode_num_heads"], rate, streams[0])
        x = x[:, 1].reshape(b, s, -1) + emb_p[:, 1].reshape(b, s, -1)
    else:
        x = linear(feats, p, "encoder.feature_embedding") \
            + linear(poss, p, "encoder.position_embedding")
    x = layer_norm(x, p, "encoder.norm")
    pad, keep = _pad_rows(poss)
    hidden = pad[:, None, :] | _causal(s, x.device)[None]
    for i in range(m["encode_num_blocks"]):
        masks = (hidden, keep) if m["encode_mask"] else (None, None)
        x = encoder_block(p, f"encoder.encoder.{i}", x, x, *masks,
                          m["encode_num_heads"], rate, streams[1 + i])
    return x


def decode(p, m: Dict, tokens, enc, poss, stream: Stream) -> torch.Tensor:
    """Teacher-forced decoder over input tokens [B, T] -> [B, T, D]."""
    rate = {"attention": m["attention_dropout"], "residual": m["dropout"]}
    streams = stream.split(m["decode_num_blocks"] + 1)
    b, t = tokens.shape
    x = p["decoder.word_embedding.weight"][tokens]
    x = linear(x, p, "decoder.word_embedding_linear")
    x = x + sinusoid(m["max_length"] - 1, x.shape[-1], x.device)[:t]
    x = layer_norm(x, p, "decoder.norm")
    tok_pad = tokens == m["pad_idx"]
    self_hidden = tok_pad[:, None, :] | _causal(t, x.device)[None]
    keep = (~tok_pad)[..., None].float()
    enc_pad = (poss == 0).all(-1)
    cross_hidden = enc_pad[:, None, :].expand(b, t, enc_pad.shape[1])
    h = m["decode_num_heads"]
    for i in range(m["decode_num_blocks"]):
        pre = f"decoder.decoder.{i}"
        s1, s2, s3 = streams[i].split(3)
        x = attention(p, pre + ".self_attention", x, x, self_hidden, h, rate,
                      s1)
        x = attention(p, pre + ".encode_attention", x, enc, cross_hidden, h,
                      rate, s2)
        x = feed_forward(p, pre + ".feed_forward", x, rate, s3) * keep
    return x


def logits(p, m: Dict, feats, poss, caption, stream: Optional[Stream] = None
           ) -> torch.Tensor:
    """Teacher-forced logits over ``caption[:, :-1]``: [B, T-1, V]."""
    stream = stream or Stream(None, feats.device)
    s_enc, s_dec = stream.split(2)
    enc = encode(p, m, feats, poss, s_enc)
    dec = decode(p, m, caption[:, :-1], enc, poss, s_dec)
    return linear(dec, p, "classifer")


def xe_loss(p, m: Dict, feats, poss, caption, stream: Stream) -> torch.Tensor:
    """Mean token cross entropy over non-pad targets."""
    out = logits(p, m, feats, poss, caption, stream)
    tgt = caption[:, 1:].reshape(-1)
    logp = torch.log_softmax(out.reshape(-1, out.shape[-1]), -1)
    nll = -logp.gather(1, tgt[:, None])[:, 0]
    keep = (tgt != m["pad_idx"]).float()
    return (nll * keep).sum() / keep.sum()


# ---------------------------------------------------------------------------
# Training: XE steps with Adam
# ---------------------------------------------------------------------------

def train_steps(weights: Dict[str, torch.Tensor], m: Dict, batches,
                step_seeds: List[Optional[int]], lr: float,
                betas=(0.9, 0.999), eps=1e-8, drop_half: bool = False):
    """``len(batches)`` XE updates from ``weights`` (not changed), the pad
    row of the word embedding frozen, Adam at ``lr``.  Returns (losses,
    the first step's gradients, the parameters after the last step).
    ``drop_half`` is a planted fault: each step's loss is the mean over the
    first half of the batch."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in weights.items()}
    m1 = {k: torch.zeros_like(v) for k, v in params.items()}
    m2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    for step, ((f, ps, c), seed) in enumerate(zip(batches, step_seeds), 1):
        if drop_half:
            f, ps, c = f[:len(f) // 2], ps[:len(ps) // 2], c[:len(c) // 2]
        loss = xe_loss(params, m, f, ps, c, Stream(seed, f.device))
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = dict(zip(params, grads))
        grads["decoder.word_embedding.weight"][m["pad_idx"]] = 0.0
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in grads.items()}
        with torch.no_grad():
            for k, w in params.items():
                g = grads[k]
                m1[k].mul_(betas[0]).add_(g, alpha=1 - betas[0])
                m2[k].mul_(betas[1]).addcmul_(g, g, value=1 - betas[1])
                c1 = 1 - betas[0] ** step
                c2 = 1 - betas[1] ** step
                w.sub_(lr / c1 * m1[k] / (m2[k].sqrt() / math.sqrt(c2) + eps))
    return losses, first_grads, {k: v.detach() for k, v in params.items()}


# ---------------------------------------------------------------------------
# Serving: the gap of each served token, and detokenisation
# ---------------------------------------------------------------------------

@torch.no_grad()
def token_gaps(p, m: Dict, feats, poss, tokens, chosen=None,
               rows: int = 64) -> torch.Tensor:
    """Teacher-forced over served tokens [B, T+1] (START first): at each
    generated position, the reference's best logit minus the logit of the
    served token (or of ``chosen`` [B, T], the control's first choices),
    [B, T].  Rows go ``rows`` at a time."""
    tokens = tokens[:, :m["max_length"]]
    chosen = tokens[:, 1:] if chosen is None else chosen
    out = []
    for s in range(0, len(tokens), rows):
        lg = logits(p, m, feats[s:s + rows], poss[s:s + rows],
                    tokens[s:s + rows])
        pick = chosen[s:s + rows]
        out.append(lg.amax(-1) - lg.gather(-1, pick[..., None])[..., 0])
    return torch.cat(out)


@torch.no_grad()
def first_choices(p, m: Dict, feats, poss, tokens, rows: int = 64):
    """The token each position's logits put first, teacher-forced over
    ``tokens``: [B, T]."""
    tokens = tokens[:, :m["max_length"]]
    return torch.cat([logits(p, m, feats[s:s + rows], poss[s:s + rows],
                             tokens[s:s + rows]).argmax(-1)
                      for s in range(0, len(tokens), rows)])


def caption_string(row, idx_to_word: Dict[int, str]) -> str:
    """Skip START at t=0, END appends '.' and stops, NULL is skipped."""
    words = []
    for t, i in enumerate(int(x) for x in row):
        if t == 0 and i == START:
            continue
        if i == END:
            words.append(".")
            break
        if i != NULL:
            words.append(idx_to_word[i])
    return " ".join(words)
