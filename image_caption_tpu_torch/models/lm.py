"""A decoder-only captioner: DeepSeek-V3's text block (latent attention and
routed experts) at the sizes of ``Config.lm`` over the region slots.  The
``kimi_vl_a3b_regions`` preset gives it Kimi-VL-A3B-Instruct's text model
as published.

Sequence: the S = num_objects + 1 region slots, then <START>, then the
caption, causal throughout; a pad slot (all-zero positions) is hidden as a
key from every position but itself; RoPE positions are the sequence
indices.  A slot r = [features ‖ positions] enters through a projector in
the shape of Kimi-VL's ``KimiVLMultiModalProjector``:

    e = W_2 gelu(W_1 LayerNorm(r) + b_1) + b_2

and a token through an embedding table untied from the head.

Block l, pre-norm:

    h = x + MLA(RMSNorm(x)),    y = h + FFN_l(RMSNorm(h))

RMSNorm(x) = g ⊙ x / sqrt(mean(x²) + eps), computed in float32.
FFN_l is a SiLU-gated MLP ``down(silu(gate x) ⊙ up x)`` of width
``intermediate_size`` for l < ``first_k_dense_replace``, else the MoE below.
The logits are ``W_head RMSNorm(y)``, in float32.

MLA, without query LoRA, for each of H heads:

    q = W_q x,                   split into q_nope (qk_nope) ‖ q_pe (qk_rope)
    [c ‖ k_pe] = W_kv_a x,       c = RMSNorm(c) (kv_lora_rank wide),
                                 k_pe (qk_rope) shared by the heads
    [k_nope ‖ v] = W_kv_b c      (qk_nope + v_head_dim a head)
    q_pe, k_pe <- RoPE at the token's position
    a = softmax((q_nope·k_nope + q_pe·k_pe) · (qk_nope + qk_rope)^-1/2)
    out = W_o [Σ_j a_j v_j]_heads

RoPE in DeepSeek-V3's rotary layout (``modeling_deepseek.py``,
``apply_rotary_pos_emb``): the qk_rope dims are read as interleaved pairs,
de-interleaved to [even ‖ odd], then ``x cos + rotate_half(x) sin`` with
``inv_freq_i = theta^(-2i/qk_rope)`` over both halves; the output stays
de-interleaved.  The cache keeps, a layer and a token, ``c`` and the roped
``k_pe`` (kv_lora_rank + qk_rope wide).  Prefill runs the expanded form
above; a decode step absorbs ``W_kv_b``:
``q_nope·k_nope = (W_uk_hᵀ q_nope)·c`` and ``Σ a v = W_uv_h (Σ a c)``, with
the attention over the cache between the two products in
``ops/latent_attention`` (on the card one kernel, its scores in float32).

MoE (``noaux_tc`` with one group), over E routed experts:

    s = sigmoid(W_r x)           (float32)
    T = the top_k experts of s + b   (b, ``e_score_correction_bias``,
                                      steers the choice only)
    w_e = s_e / Σ_{e' in T} s_e' · routed_scaling_factor,   e in T
          (``norm_topk_prob`` as published: the chosen scores normalised)
    y = Σ_{e in T} w_e down_e(silu(gate_e x) ⊙ up_e x) + shared(x)

``shared`` is one SiLU-gated MLP of width n_shared_experts ·
moe_intermediate_size.  The routed experts run as one grouped computation
(``ops/experts.grouped_experts``).

Weights and activations are in bfloat16 (``WEIGHT_DTYPE``; ``.float()``
makes a float32 model of one); the router, RMSNorm's statistics, RoPE,
the softmax and the logits in float32.  The model is
built on the ``meta`` device and then filled, on the target device: from
a state_dict (``from_state_dict``, the tensors themselves when they are
already there in the dtype).

A decode step (``run_step``) runs over the static buffers of a
``StepState``: its shapes never change (it attends every cache row, the
unwritten ones masked), so on CUDA each of its segments (a layer's
attention, route, experts, shared experts; the embedding, the dense MLP,
the head) is captured once as a graph and replayed: the host enqueues a
step in about a hundred launches instead of thousands of kernels.

Spans (``utils/debug``), each on the device: ``mla.attention`` a layer,
``moe.route``, ``moe.experts`` and ``moe.shared`` a MoE layer, on every
call (prefill and each decode step, around each graph's replay); the
counters ``moe.rows_routed``, ``moe.experts_touched`` and, on CUDA,
``moe.rows_fused`` a MoE call.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, LMConfig, ModelConfig
from ..ops import _build
from ..ops.experts import grouped_experts
from ..ops.latent_attention import latent_attention
from ..utils.debug import annotate, count, recording
from ..utils.device import DeviceLike, resolve_device


# the projector's LayerNorm eps (Kimi-VL's)
PROJECTOR_LN_EPS = 1e-5
# every leaf but the router's correction bias, which stays in float32
WEIGHT_DTYPE = torch.bfloat16


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x32.to(x.dtype)


def rope_table(lm: LMConfig, n: int, device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """cos, sin [n, qk_rope] float32 for positions 0..n-1."""
    d = lm.qk_rope_head_dim
    inv = 1.0 / (lm.rope_theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                device=device) / d))
    freqs = torch.outer(torch.arange(n, dtype=torch.float32, device=device),
                        inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., P, d] with cos/sin broadcastable to it, in DeepSeek-V3's
    layout: de-interleave the pairs, then rotate half against half."""
    d = x.shape[-1]
    x32 = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    half = torch.cat([-x32[..., d // 2:], x32[..., :d // 2]], dim=-1)
    return (x32 * cos + half * sin).to(x.dtype)


class MLP(nn.Module):
    """down(silu(gate x) ⊙ up x)."""

    def __init__(self, dim: int, width: int):
        super().__init__()
        self.gate_proj = nn.Linear(dim, width, bias=False)
        self.up_proj = nn.Linear(dim, width, bias=False)
        self.down_proj = nn.Linear(width, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
    """x [N, D] -> (expert ids [N, k], weights [N, k] float32)."""

    def __init__(self, lm: LMConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(lm.n_routed_experts,
                                               lm.hidden_size))
        self.e_score_correction_bias = nn.Parameter(
            torch.empty(lm.n_routed_experts, dtype=torch.float32))
        self.top_k = lm.num_experts_per_tok
        self.scale = lm.routed_scaling_factor

    def forward(self, x: torch.Tensor):
        scores = torch.sigmoid(F.linear(x.float(), self.weight.float()))
        _, idx = torch.topk(scores + self.e_score_correction_bias.float(),
                            self.top_k, dim=-1, sorted=False)
        w = scores.gather(1, idx)
        return idx, w / (w.sum(-1, keepdim=True) + 1e-20) * self.scale


class RoutedExperts(nn.Module):
    """The E experts' weights, stacked: ``w13`` [E, 2I, D] (gate rows, then
    up rows) and ``w2`` [E, D, I]."""

    def __init__(self, lm: LMConfig):
        super().__init__()
        e, d, i = (lm.n_routed_experts, lm.hidden_size,
                   lm.moe_intermediate_size)
        self.w13 = nn.Parameter(torch.empty(e, 2 * i, d))
        self.w2 = nn.Parameter(torch.empty(e, d, i))

    def forward(self, x, idx, weights):
        """(the weighted sum [N, D], rows an expert [E])."""
        return grouped_experts(x, idx, weights, self.w13, self.w2)


class MoE(nn.Module):
    def __init__(self, lm: LMConfig):
        super().__init__()
        self.gate = Router(lm)
        self.experts = RoutedExperts(lm)
        self.shared_experts = MLP(lm.hidden_size,
                                  lm.n_shared_experts
                                  * lm.moe_intermediate_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        with annotate("moe.route", device=True):
            idx, w = self.gate(x)
        with annotate("moe.experts", device=True):
            y, counts = self.experts(x, idx, w)
        count_routed(idx.numel(), counts)
        with annotate("moe.shared", device=True):
            y = y + self.shared_experts(x)
        return y.view(shape)


def count_routed(rows: int, counts: torch.Tensor) -> None:
    """The counters ``moe.rows_routed``, ``moe.experts_touched`` (the
    experts with a row, kept on the device) and ``moe.rows_fused`` (the
    rows through kernel #6: on CUDA, all of them) while a profiler
    records."""
    if recording():
        count("moe.rows_routed", rows)
        count("moe.experts_touched", counts > 0)
        if counts.is_cuda:
            count("moe.rows_fused", rows)


class LatentCache(NamedTuple):
    """A layer's [B, T, kv_lora_rank + qk_rope] (c, then roped k_pe) for
    every layer, and which keys may be attended [B, T] (False: a pad
    slot)."""
    layers: List[torch.Tensor]
    key_ok: torch.Tensor


class MLA(nn.Module):
    def __init__(self, lm: LMConfig):
        super().__init__()
        self.lm = lm
        h, d = lm.num_attention_heads, lm.hidden_size
        self.q_proj = nn.Linear(d, h * lm.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(
            d, lm.kv_lora_rank + lm.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(lm.kv_lora_rank, lm.rms_norm_eps)
        self.kv_b_proj = nn.Linear(
            lm.kv_lora_rank, h * (lm.qk_nope_head_dim + lm.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(h * lm.v_head_dim, d, bias=False)
        self.scale = lm.qk_head_dim ** -0.5

    def _project(self, x, cos, sin):
        """x [B, P, D] -> q [B, H, P, qk] roped, and the latent row
        [B, P, kv_lora_rank + qk_rope] (c normed, k_pe roped)."""
        lm = self.lm
        b, p, _ = x.shape
        q = self.q_proj(x).view(b, p, lm.num_attention_heads,
                                lm.qk_head_dim).transpose(1, 2)
        q_nope, q_pe = q.split([lm.qk_nope_head_dim, lm.qk_rope_head_dim],
                               dim=-1)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split(
            [lm.kv_lora_rank, lm.qk_rope_head_dim], dim=-1)
        latent = torch.cat([self.kv_a_layernorm(c),
                            apply_rope(k_pe, cos, sin)], dim=-1)
        return q, latent

    def prefill(self, x, cos, sin, allowed, cache: Optional[torch.Tensor]):
        """The expanded form over P tokens: x [B, P, D], cos/sin [P, r],
        allowed [B, 1, P, P] bool; writes the latent rows into
        ``cache[:, :P]``."""
        lm = self.lm
        b, p, _ = x.shape
        q, latent = self._project(x, cos, sin)
        if cache is not None:
            cache[:, :p] = latent
        c, k_pe = latent.split([lm.kv_lora_rank, lm.qk_rope_head_dim], -1)
        kv = self.kv_b_proj(c).view(b, p, lm.num_attention_heads,
                                    -1).transpose(1, 2)
        k_nope, v = kv.split([lm.qk_nope_head_dim, lm.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_pe[:, None].expand(-1, k_nope.shape[1],
                                                      -1, -1)], dim=-1)
        scores = (q @ k.transpose(-1, -2)) * self.scale
        scores = scores.float().masked_fill(~allowed, float("-inf"))
        a = torch.softmax(scores, dim=-1).to(v.dtype)
        out = (a @ v).transpose(1, 2).reshape(b, p, -1)
        return self.o_proj(out)

    def step(self, x, pos: torch.Tensor, cos, sin, cache: torch.Tensor,
             visible: torch.Tensor):
        """The absorbed form for one token a row: x [B, D] at position
        ``pos`` (a device tensor [1]); writes its latent row into
        ``cache[:, pos]`` and attends every cached row where ``visible``
        [B, T] (the shapes never change, so a step can be captured)."""
        lm = self.lm
        b = x.shape[0]
        h, r = lm.num_attention_heads, lm.kv_lora_rank
        q, latent = self._project(x[:, None], cos, sin)
        cache.index_copy_(1, pos, latent)
        w = self.kv_b_proj.weight.view(h, lm.qk_nope_head_dim
                                       + lm.v_head_dim, r)
        w_uk, w_uv = w.split([lm.qk_nope_head_dim, lm.v_head_dim], dim=1)
        q_nope, q_pe = q[:, :, 0].split([lm.qk_nope_head_dim,
                                         lm.qk_rope_head_dim], dim=-1)
        q_lat = torch.einsum("bhd,hdc->bhc", q_nope, w_uk)
        out_lat = latent_attention(q_lat, q_pe, cache, visible, pos,
                                   self.scale)
        out = torch.einsum("bhc,hdc->bhd", out_lat, w_uv)
        return self.o_proj(out.reshape(b, -1))


class Block(nn.Module):
    def __init__(self, lm: LMConfig, dense: bool):
        super().__init__()
        self.input_layernorm = RMSNorm(lm.hidden_size, lm.rms_norm_eps)
        self.self_attn = MLA(lm)
        self.post_attention_layernorm = RMSNorm(lm.hidden_size,
                                                lm.rms_norm_eps)
        self.mlp = (MLP(lm.hidden_size, lm.intermediate_size) if dense
                    else MoE(lm))

    def ffn(self, h: torch.Tensor) -> torch.Tensor:
        return h + self.mlp(self.post_attention_layernorm(h))


class Projector(nn.Module):
    """A slot [.., dim_features + dim_positions] -> [.., hidden]."""

    def __init__(self, m: ModelConfig, lm: LMConfig):
        super().__init__()
        n = m.dim_features + m.dim_positions
        self.pre_norm = nn.LayerNorm(n, eps=PROJECTOR_LN_EPS)
        self.linear_1 = nn.Linear(n, lm.projector_hidden_size)
        self.linear_2 = nn.Linear(lm.projector_hidden_size, lm.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.gelu(self.linear_1(self.pre_norm(x))))


class Head(nn.Module):
    """[N, D] -> float32 logits [N, V]."""

    def __init__(self, dim: int, vocab: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and x.dtype != torch.float32:
            return torch.mm(x, self.weight.t(), out_dtype=torch.float32)
        return F.linear(x.float(), self.weight.float())


class LMCaptioner(nn.Module):
    """The ``mla_moe`` captioner of a ``Config`` (``cfg.model`` for the
    slots, vocabulary and caption length, ``cfg.lm`` for the text model),
    built on the ``meta`` device: ``from_state_dict`` fills it."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg, self.lm = cfg.model, cfg.lm
        m, lm = cfg.model, cfg.lm
        with torch.device("meta"):
            self.projector = Projector(m, lm)
            self.embed_tokens = nn.Embedding(m.num_vocab, lm.hidden_size)
            self.layers = nn.ModuleList(
                Block(lm, i < lm.first_k_dense_replace)
                for i in range(lm.num_hidden_layers))
            self.norm = RMSNorm(lm.hidden_size, lm.rms_norm_eps)
            self.lm_head = Head(lm.hidden_size, m.num_vocab)

    @classmethod
    def from_state_dict(cls, cfg: Config, state: Dict[str, torch.Tensor], *,
                        device: DeviceLike = None) -> "LMCaptioner":
        """The model over ``state`` moved to ``device`` in ``WEIGHT_DTYPE``
        (the router's correction bias in float32); tensors already there
        in that dtype are used as they are, not copied.  On CUDA the
        model's two kernels (#5 and #6) are built first, both at once."""
        model = cls(cfg)
        device = resolve_device(device)
        if device.type == "cuda":
            _build.build(("mla_decode", "experts_glue"))
        model.load_state_dict(
            {k: v.to(device, torch.float32 if k.endswith(
                "e_score_correction_bias") else WEIGHT_DTYPE)
             for k, v in state.items()}, assign=True)
        return model

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.lm_head.weight.dtype

    @property
    def prefix(self) -> int:
        """Slots and <START>: the tokens of the prefill."""
        return self.cfg.num_slots + 1

    @property
    def cache_length(self) -> int:
        """Slots, <START> and every fed token of a greedy decode."""
        return self.cfg.num_slots + self.cfg.max_length - 1

    def embed_slots(self, feats, poss) -> torch.Tensor:
        """[B, S, F] and [B, S, >= P] -> [B, S, D]."""
        poss = poss[..., :self.cfg.dim_positions]
        return self.projector(torch.cat([feats, poss], dim=-1)
                              .to(self.dtype))

    def _run(self, x, key_ok, cache: Optional[LatentCache]):
        """Every layer over x [B, P, D] from position 0, causal, keys
        hidden where ``key_ok`` [B, P] is False (each position sees
        itself); the latent rows go into ``cache``."""
        p = x.shape[1]
        cos, sin = rope_table(self.lm, p, x.device)
        causal = torch.ones(p, p, dtype=torch.bool,
                            device=x.device).tril()
        allowed = (causal & (key_ok[:, None, :]
                             | torch.eye(p, dtype=torch.bool,
                                         device=x.device)))[:, None]
        for i, layer in enumerate(self.layers):
            with annotate("mla.attention", device=True):
                x = x + layer.self_attn.prefill(
                    layer.input_layernorm(x), cos, sin, allowed,
                    None if cache is None else cache.layers[i])
            x = layer.ffn(x)
        return self.norm(x)

    def _sequence(self, feats, poss, tokens):
        """The slots' and ``tokens``' embeddings [B, S + T, D] and which
        keys may be attended [B, S + T]."""
        slots = self.embed_slots(feats, poss)
        x = torch.cat([slots, self.embed_tokens(tokens)], dim=1)
        pad = (poss == 0).all(dim=-1)
        key_ok = torch.cat([~pad, torch.ones_like(tokens, dtype=torch.bool)],
                           dim=1)
        return x, key_ok

    @torch.no_grad()
    def forward(self, feats, poss, tokens) -> torch.Tensor:
        """Teacher-forced logits over ``tokens`` [B, T] (each position
        predicting the next): float32 [B, T, V]."""
        x, key_ok = self._sequence(feats, poss, tokens)
        h = self._run(x, key_ok, None)[:, -tokens.shape[1]:]
        return self.lm_head(h.reshape(-1, h.shape[-1])).view(
            *tokens.shape, -1)

    def new_cache(self, batch: int) -> LatentCache:
        """Zeros: a step reads every row, the unwritten ones masked."""
        lm = self.lm
        shape = (batch, self.cache_length,
                 lm.kv_lora_rank + lm.qk_rope_head_dim)
        return LatentCache(
            [torch.zeros(shape, dtype=self.dtype, device=self.device)
             for _ in self.layers],
            torch.ones((batch, self.cache_length), dtype=torch.bool,
                       device=self.device))

    @torch.no_grad()
    def prefill(self, feats, poss, start: torch.Tensor,
                cache: LatentCache) -> torch.Tensor:
        """The slots and ``start`` [B] through every layer, their latent
        rows into ``cache``: the logits after <START>, float32 [B, V]."""
        x, key_ok = self._sequence(feats, poss, start[:, None])
        cache.key_ok[:, :x.shape[1]] = key_ok
        h = self._run(x, key_ok, cache)
        return self.lm_head(h[:, -1])

    def step_state(self, batch: int) -> "StepState":
        """The static buffers (and on CUDA the graphs) of greedy steps at
        ``batch`` rows; one batch size is kept."""
        st = self.__dict__.get("_step_state")
        if st is None or st.batch != batch:
            self.__dict__["_step_state"] = None
            st = self.__dict__["_step_state"] = StepState(self, batch)
        return st

    @torch.no_grad()
    def run_step(self, st: "StepState") -> torch.Tensor:
        """One greedy step: ``st.token`` at position ``st.pos`` through the
        cache, float32 logits into ``st.logits`` and their argmax into
        ``st.next``.  On CUDA the first step runs eagerly on a side stream
        and its segments are then captured, one graph each; later steps
        replay them, with the spans around each replay."""
        graphs = st.graphs
        side = (st.stream if graphs is None and st.stream is not None
                else None)
        if side is not None:
            side.wait_stream(torch.cuda.current_stream())
        with (torch.cuda.stream(side) if side is not None
              else contextlib.nullcontext()):
            for i, (name, fn, after) in enumerate(st.segments):
                with (annotate(name, device=True) if name
                      else contextlib.nullcontext()):
                    if graphs is None:
                        fn()
                    else:
                        graphs[i].replay()
                if after is not None:
                    after()
        if side is not None:
            torch.cuda.current_stream().wait_stream(side)
            st.capture()
        return st.logits


class StepState:
    """A greedy step at ``batch`` rows as segments over static buffers:
    the latent cache, the token fed and its position (device tensors), the
    residual stream, each MoE layer's choice of experts, weights and row
    counts, the logits and their argmax.  ``segments``: (span name or
    None, function, after-function or None), in order: the embedding, then
    a layer's ``mla.attention``, then ``moe.route``, ``moe.experts`` and
    ``moe.shared`` (or its dense MLP), then the head.  On CUDA each segment
    becomes a graph (``capture``), replayed in the same order over one
    memory pool."""

    def __init__(self, model: LMCaptioner, batch: int):
        lm, dev, dt = model.lm, model.device, model.dtype
        d, k = lm.hidden_size, lm.num_experts_per_tok
        self.batch = batch
        self.cache = model.new_cache(batch)
        t = model.cache_length
        self.token = torch.zeros(batch, dtype=torch.long, device=dev)
        self.pos = torch.zeros(1, dtype=torch.long, device=dev)
        self.x = torch.zeros(batch, d, dtype=dt, device=dev)
        self.hn = torch.zeros(batch, d, dtype=dt, device=dev)
        self.y = torch.zeros(batch, d, dtype=dt, device=dev)
        self.cos_table, self.sin_table = rope_table(lm, t, dev)
        self.cos = torch.zeros(1, lm.qk_rope_head_dim, device=dev)
        self.sin = torch.zeros_like(self.cos)
        self.order = torch.arange(t, device=dev)
        self.visible = torch.zeros(batch, t, dtype=torch.bool, device=dev)
        moe = [i for i, layer in enumerate(model.layers)
               if isinstance(layer.mlp, MoE)]
        self.idx = {i: torch.zeros(batch, k, dtype=torch.long, device=dev)
                    for i in moe}
        self.w = {i: torch.zeros(batch, k, device=dev) for i in moe}
        self.counts = {i: torch.zeros(lm.n_routed_experts, dtype=torch.int32,
                                      device=dev) for i in moe}
        self.logits = torch.zeros(batch, model.cfg.num_vocab, device=dev)
        self.next = torch.zeros(batch, dtype=torch.long, device=dev)
        self.graphs = None
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self.segments = self._segments(model)

    def _segments(self, model: LMCaptioner):
        def embed():
            self.x.copy_(model.embed_tokens(self.token))
            self.cos.copy_(self.cos_table.index_select(0, self.pos))
            self.sin.copy_(self.sin_table.index_select(0, self.pos))
            torch.logical_and(self.cache.key_ok, self.order <= self.pos,
                              out=self.visible)

        def attention(layer, i):
            def fn():
                self.x.add_(layer.self_attn.step(
                    layer.input_layernorm(self.x), self.pos, self.cos,
                    self.sin, self.cache.layers[i], self.visible))
            return fn

        def route(layer, i):
            def fn():
                self.hn.copy_(layer.post_attention_layernorm(self.x))
                idx, w = layer.mlp.gate(self.hn)
                self.idx[i].copy_(idx)
                self.w[i].copy_(w)
            return fn

        def experts(layer, i):
            def fn():
                y, counts = layer.mlp.experts(self.hn, self.idx[i],
                                              self.w[i])
                self.y.copy_(y)
                self.counts[i].copy_(counts)
            return fn

        def shared(layer):
            def fn():
                self.x.add_(self.y + layer.mlp.shared_experts(self.hn))
            return fn

        def dense(layer):
            def fn():
                self.x.add_(layer.mlp(layer.post_attention_layernorm(
                    self.x)))
            return fn

        def counted(i):
            return lambda: count_routed(self.idx[i].numel(), self.counts[i])

        def head():
            self.logits.copy_(model.lm_head(model.norm(self.x)))
            torch.argmax(self.logits, dim=-1, out=self.next)

        out = [(None, embed, None)]
        for i, layer in enumerate(model.layers):
            out.append(("mla.attention", attention(layer, i), None))
            if i in self.idx:
                out += [("moe.route", route(layer, i), None),
                        ("moe.experts", experts(layer, i), counted(i)),
                        ("moe.shared", shared(layer), None)]
            else:
                out.append((None, dense(layer), None))
        return out + [(None, head, None)]

    def capture(self) -> None:
        """Each segment into a graph on the side stream, one memory pool,
        in the order they replay (after one eager step there)."""
        pool = torch.cuda.graph_pool_handle()
        graphs = []
        for _, fn, _ in self.segments:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, pool=pool, stream=self.stream):
                fn()
            graphs.append(g)
        self.graphs = graphs


def restore_captioner(cfg: Config, state: Dict[str, torch.Tensor], *,
                      device: DeviceLike = None):
    """The captioner of ``cfg`` over a state_dict, on ``device``."""
    if cfg.model.architecture == "mla_moe":
        return LMCaptioner.from_state_dict(cfg, state, device=device)
    from .captioner import Captioner
    model = Captioner(cfg.model, device=device)
    model.load_state_dict(state)
    return model
