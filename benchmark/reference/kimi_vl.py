"""Plain PyTorch reference of the ``kimi_vl_a3b`` configuration: Kimi-VL-A3B's
text model (DeepSeek-V3's block: latent attention, sigmoid-routed experts
with a correction bias, shared experts) over the region slots, its
weights made from the seed leaf by leaf, and its teacher-forced forward.

The configuration is the ``benchmark/configs/kimi_vl_a3b.json`` dict:
the published ``config.json`` keys, and under ``captioner`` the slots,
the caption length and the projector.  The equations are DeepSeek-V3's
(``modeling_deepseek.py``), with the departures the configuration lists
under ``assumed``:

* sequence: the S region slots, <START>, the caption; causal; a pad slot
  (all-zero positions) is hidden as a key from every position but itself;
  RoPE positions are the sequence indices;
* a slot r = [features ‖ positions]: ``W_2 gelu(W_1 LayerNorm(r) + b_1) +
  b_2``; a token: its row of the embedding table;
* block: ``h = x + MLA(RMSNorm(x))``, ``y = h + FFN(RMSNorm(h))``; FFN a
  SiLU-gated MLP (``intermediate_size``) in the first
  ``first_k_dense_replace`` layers, else the routed experts and the shared
  ones;
* MLA (no query LoRA): ``q = W_q x`` split into nope and rope parts;
  ``[c ‖ k_pe] = W_kv_a x``, c RMS-normed; ``[k_nope ‖ v] = W_kv_b c``;
  RoPE on q_pe and k_pe in DeepSeek-V3's layout (pairs de-interleaved,
  then rotate-half); ``softmax((q·k) (nope + rope)^-1/2)``; ``W_o``;
* router: ``s = sigmoid(W_r x)``; the ``num_experts_per_tok`` experts of
  the largest ``s + b``; weights ``s / Σ s · routed_scaling_factor``;
* logits ``W_head RMSNorm(y)``.

It runs the whole teacher-forced forward in float32 (callers switch TF32
off), one layer at a time, remaking each layer's weights from the seed,
so that on the card it holds one layer's weights in float32 at a time.
No kernel, cache or batching of the program is used.

Weights: leaf ``i`` of ``leaves(c)`` is drawn by a ``torch.Generator`` on
the device seeded ``fold_in(seed, i)``, N(0, 1) in float32, times its
scale, and stored in the configuration's precision; the reference reads
the stored values back in float32.  Scales (assumed, see the
configuration): a matrix N(0, 1/fan_in); the output projection of each
residual branch (``o_proj``, the MLPs' ``down_proj``, the experts' ``w2``)
N(0, 1/(fan_in · layers)), so that the residual stays within a few units
over the depth; the embedding N(0, 1); the correction bias N(0, 0.1²);
norms 1, biases 0.

Controls and planted faults (``fault``), each computed here in the
program's place: ``control`` is the precision below the
configuration's: every matrix (the embedding, the projector, attention,
router, experts, MLPs, head) rounded through float8 e4m3 at a scale of
its own (one an expert), held in bfloat16, and the activations in
bfloat16, with float32 where the program keeps it (RMSNorm's and
LayerNorm's statistics, RoPE, the router's scores, the softmax, the
experts' weighted sum, the logits); ``fp8_experts`` rounds only the
routed experts' weights so and computes the rest in float32; ``top5``
routes to one expert fewer; ``no_bias`` chooses without the correction bias; ``no_rope`` skips
the rotary embedding; ``no_shared`` leaves out the shared experts.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .captioner import fold_in

CONTROLS = ("control", "fp8_experts", "top5", "no_bias", "no_rope",
            "no_shared")
BIAS_STD = 0.1


def _sizes(c: Dict):
    cap = c["captioner"]
    return dict(d=c["hidden_size"], h=c["num_attention_heads"],
                nope=c["qk_nope_head_dim"], rope=c["qk_rope_head_dim"],
                v=c["v_head_dim"], r=c["kv_lora_rank"],
                e=c["n_routed_experts"], k=c["num_experts_per_tok"],
                i=c["moe_intermediate_size"],
                shared=c["n_shared_experts"] * c["moe_intermediate_size"],
                dense=c["intermediate_size"], layers=c["num_hidden_layers"],
                first_dense=c["first_k_dense_replace"],
                vocab=c["vocab_size"], slots=cap["num_objects"] + 1,
                n_in=cap["dim_features"] + cap["dim_positions"],
                ph=cap["projector_hidden_size"])


def leaves(c: Dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``[(name, shape, init)]`` in the program's state_dict names; init
    "fan_in", "branch", "unit", "bias", "ones" or "zeros"."""
    z = _sizes(c)
    d, h = z["d"], z["h"]
    out = []

    def add(name, shape, init):
        out.append((name, tuple(shape), init))

    def mlp(pre, width):
        add(pre + "gate_proj.weight", (width, d), "fan_in")
        add(pre + "up_proj.weight", (width, d), "fan_in")
        add(pre + "down_proj.weight", (d, width), "branch")
    add("projector.pre_norm.weight", (z["n_in"],), "ones")
    add("projector.pre_norm.bias", (z["n_in"],), "zeros")
    add("projector.linear_1.weight", (z["ph"], z["n_in"]), "fan_in")
    add("projector.linear_1.bias", (z["ph"],), "zeros")
    add("projector.linear_2.weight", (d, z["ph"]), "fan_in")
    add("projector.linear_2.bias", (d,), "zeros")
    add("embed_tokens.weight", (z["vocab"], d), "unit")
    for layer in range(z["layers"]):
        pre = f"layers.{layer}."
        add(pre + "input_layernorm.weight", (d,), "ones")
        a = pre + "self_attn."
        add(a + "q_proj.weight", (h * (z["nope"] + z["rope"]), d), "fan_in")
        add(a + "kv_a_proj_with_mqa.weight", (z["r"] + z["rope"], d),
            "fan_in")
        add(a + "kv_a_layernorm.weight", (z["r"],), "ones")
        add(a + "kv_b_proj.weight", (h * (z["nope"] + z["v"]), z["r"]),
            "fan_in")
        add(a + "o_proj.weight", (d, h * z["v"]), "branch")
        add(pre + "post_attention_layernorm.weight", (d,), "ones")
        if layer < z["first_dense"]:
            mlp(pre + "mlp.", z["dense"])
        else:
            add(pre + "mlp.gate.weight", (z["e"], d), "fan_in")
            add(pre + "mlp.gate.e_score_correction_bias", (z["e"],), "bias")
            add(pre + "mlp.experts.w13", (z["e"], 2 * z["i"], d), "fan_in")
            add(pre + "mlp.experts.w2", (z["e"], d, z["i"]), "branch")
            mlp(pre + "mlp.shared_experts.", z["shared"])
    add("norm.weight", (d,), "ones")
    add("lm_head.weight", (z["vocab"], d), "fan_in")
    return out


def stored_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    """The correction bias stays in float32; every other leaf in the
    configuration's precision."""
    return torch.float32 if name.endswith("e_score_correction_bias") \
        else dtype


def make_leaf(c: Dict, seed: int, index: int, device,
              dtype: torch.dtype) -> torch.Tensor:
    """Leaf ``index`` of ``leaves(c)``, stored in ``dtype``."""
    name, shape, init = leaves(c)[index]
    if init in ("ones", "zeros"):
        x = (torch.ones if init == "ones" else torch.zeros)(shape,
                                                            device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(fold_in(seed, index))
        x = torch.randn(shape, generator=gen, device=device)
        if init == "fan_in":
            x *= shape[-1] ** -0.5
        elif init == "branch":
            x *= (shape[-1] * c["num_hidden_layers"]) ** -0.5
        elif init == "bias":
            x *= BIAS_STD
    return x.to(stored_dtype(name, dtype))


def precision(c: Dict) -> torch.dtype:
    return torch.bfloat16 if c["precision"]["weights"] == "bf16" \
        else torch.float32


def state_dict(c: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf as the program holds it."""
    dtype = precision(c)
    return {name: make_leaf(c, seed, i, device, dtype)
            for i, (name, _, _) in enumerate(leaves(c))}


def activations(fault: Optional[str]) -> torch.dtype:
    return torch.bfloat16 if fault == "control" else torch.float32


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """A matrix, or each matrix of a stack, through float8 e4m3 at a
    scale of its own, back in float32."""
    scale = t.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1e-30) / 448
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def weights(c: Dict, seed: int, prefix: str, device,
            fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """The leaves whose names start with ``prefix`` (one layer, say), as
    stored, read back in float32 and keyed by the rest of the name; for
    the ``control`` each matrix rounded through e4m3 and every leaf
    but the correction bias held in bfloat16, for ``fp8_experts`` the
    routed experts' matrices rounded."""
    dtype = precision(c)
    out = {}
    for i, (name, _, _) in enumerate(leaves(c)):
        if not name.startswith(prefix):
            continue
        x = make_leaf(c, seed, i, device, dtype).float()
        if x.dim() >= 2 and (fault == "control" or (
                fault == "fp8_experts" and ".experts." in name)):
            x = fp8_round(x)
        if fault == "control":
            x = x.to(stored_dtype(name, activations(fault)))
        out[name[len(prefix):]] = x
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def rms_norm(x, g, eps):
    """Statistics in float32, the result in x's dtype."""
    xf = x.float()
    return (g.float() * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True)
                                          + eps))).to(x.dtype)


def rope(x, positions, c):
    """DeepSeek-V3's ``apply_rotary_pos_emb``: x [..., L, d] at
    ``positions`` [L]."""
    d, dtype = x.shape[-1], x.dtype
    x = x.float()
    inv = 1.0 / (float(c["rope_theta"]) ** (
        torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d))
    freqs = positions.float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], -1)
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return (x * emb.cos() + rot * emb.sin()).to(dtype)


def silu_mlp(x, w, pre):
    return F.silu(x @ w[pre + "gate_proj.weight"].t()) \
        * (x @ w[pre + "up_proj.weight"].t()) @ w[pre + "down_proj.weight"].t()


def attention(x, w, c, allowed, fault):
    """x [B, L, D] (normed) -> [B, L, D]; ``allowed`` [B, L, L] bool."""
    z = _sizes(c)
    b, n, _ = x.shape
    h, nope, rp = z["h"], z["nope"], z["rope"]
    q = (x @ w["self_attn.q_proj.weight"].t()).view(b, n, h, nope + rp)
    q = q.transpose(1, 2)
    ckv = x @ w["self_attn.kv_a_proj_with_mqa.weight"].t()
    lat, k_pe = ckv[..., :z["r"]], ckv[..., z["r"]:]
    lat = rms_norm(lat, w["self_attn.kv_a_layernorm.weight"],
                   c["rms_norm_eps"])
    kv = (lat @ w["self_attn.kv_b_proj.weight"].t()).view(b, n, h, -1)
    kv = kv.transpose(1, 2)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    q_nope, q_pe = q[..., :nope], q[..., nope:]
    k_pe = k_pe[:, None]
    if fault != "no_rope":
        pos = torch.arange(n, device=x.device)
        q_pe, k_pe = rope(q_pe, pos, c), rope(k_pe, pos, c)
    scores = (q_nope @ k_nope.transpose(-1, -2)
              + q_pe @ k_pe.transpose(-1, -2)) * (nope + rp) ** -0.5
    scores = scores.float().masked_fill(~allowed[:, None], float("-inf"))
    out = (torch.softmax(scores, -1).to(v.dtype) @ v).transpose(1, 2)
    out = out.reshape(b, n, -1)
    return out @ w["self_attn.o_proj.weight"].t()


def route(x, w, c, fault, adopt=None):
    """x [N, D] -> (experts [N, k], weights [N, k], the chosen experts and
    the gap of ``adopt``).  ``adopt`` [N, k'] (another computation's
    choice): where it names ``num_experts_per_tok`` distinct experts it is
    taken in place of this one's, weighted by this one's scores, and its
    gap is how far its lowest ``s + b`` lies below this computation's
    ``k``-th largest (0 where the choice is this one's own); anything
    else gives an infinite gap and this computation's own choice."""
    k = c["num_experts_per_tok"] - (1 if fault == "top5" else 0)
    s = torch.sigmoid(x.float() @ w["mlp.gate.weight"].float().t())
    b = w["mlp.gate.e_score_correction_bias"]
    choice = s if fault == "no_bias" else s + b
    top_v, idx = torch.topk(choice, k, dim=-1)
    gap = None
    if adopt is not None:
        distinct = adopt.shape[-1] == k and bool(
            (adopt.sort(-1).values.diff(dim=-1) != 0).all())
        if distinct:
            gap = (top_v[:, -1] - (s + b).gather(1, adopt).amin(-1)
                   ).clamp_min(0.0)
            idx = adopt
        else:
            gap = torch.full((len(x),), float("inf"), device=x.device)
    wt = s.gather(1, idx)
    if c["norm_topk_prob"]:
        wt = wt / (wt.sum(-1, keepdim=True) + 1e-20)
    return idx, wt * c["routed_scaling_factor"], gap


def experts(x, idx, wt, w13, w2) -> torch.Tensor:
    """x [N, D], idx and wt [N, k] -> [N, D] float32: ``Σ_j wt[:, j] ·
    expert_{idx[:, j]}(x)``, a loop over the experts."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(w13.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gate, up = (x[tok] @ w13[e].t()).chunk(2, -1)
        y = (F.silu(gate) * up) @ w2[e].t()
        out.index_add_(0, tok, y.float() * wt[tok, slot, None].float())
    return out


def moe(x, w, c, fault, adopt=None):
    """x [B, L, D] (normed) -> ([B, L, D], experts [B, L, k], gap [B, L])."""
    b, n, d = x.shape
    flat = x.reshape(-1, d)
    idx, wt, gap = route(flat, w, c, fault,
                         None if adopt is None else adopt.reshape(b * n, -1))
    out = experts(flat, idx, wt, w["mlp.experts.w13"], w["mlp.experts.w2"])
    if fault != "no_shared":
        out = out + silu_mlp(flat, w, "mlp.shared_experts.").float()
    return (out.to(x.dtype).view(b, n, d), idx.view(b, n, -1),
            None if gap is None else gap.view(b, n))


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

def inputs(c: Dict, seed: int, feats, poss, tokens,
           fault: Optional[str] = None):
    """The sequence's embeddings [B, S + T, D] and which keys may be
    attended [B, S + T, S + T]."""
    cap = c["captioner"]
    dev, act = feats.device, activations(fault)
    p = weights(c, seed, "projector.", dev, fault)
    r = torch.cat([feats, poss[..., :cap["dim_positions"]]], -1).to(act)
    r = F.layer_norm(r.float(), (r.shape[-1],), p["pre_norm.weight"].float(),
                     p["pre_norm.bias"].float(), cap["projector_ln_eps"])
    h = F.gelu(r.to(act) @ p["linear_1.weight"].t() + p["linear_1.bias"])
    slots = h @ p["linear_2.weight"].t() + p["linear_2.bias"]
    emb = weights(c, seed, "embed_tokens.", dev, fault)["weight"]
    x = torch.cat([slots, emb[tokens]], 1)
    n = x.shape[1]
    key_ok = torch.cat([~(poss == 0).all(-1),
                        torch.ones_like(tokens, dtype=torch.bool)], 1)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    causal = torch.ones(n, n, dtype=torch.bool, device=dev).tril()
    return x, causal & (key_ok[:, None, :] | eye)


@torch.no_grad()
def hidden(c: Dict, seed: int, feats, poss, tokens, *,
           fault: Optional[str] = None,
           adopt: Optional[List[torch.Tensor]] = None):
    """Teacher-forced over ``tokens`` [B, T] (<START> first): the final
    normed hidden states at the T token positions [B, T, D] in float32,
    each MoE layer's experts [B, S + T, k], and with ``adopt`` (a list of
    [B, S + T, k'] choices, one a MoE layer) each MoE layer's gap
    [B, S + T]."""
    x, allowed = inputs(c, seed, feats, poss, tokens, fault)
    dev, eps = x.device, c["rms_norm_eps"]
    routes, gaps = [], []
    for layer in range(c["num_hidden_layers"]):
        w = weights(c, seed, f"layers.{layer}.", dev, fault)
        x = x + attention(rms_norm(x, w["input_layernorm.weight"], eps), w,
                          c, allowed, fault)
        hn = rms_norm(x, w["post_attention_layernorm.weight"], eps)
        if layer < c["first_k_dense_replace"]:
            x = x + silu_mlp(hn, w, "mlp.")
        else:
            j = layer - c["first_k_dense_replace"]
            y, idx, gap = moe(hn, w, c, fault,
                              None if adopt is None else adopt[j])
            x = x + y
            routes.append(idx)
            gaps.append(gap)
        del w
    g = weights(c, seed, "norm.", dev, fault)["weight"]
    out = rms_norm(x[:, -tokens.shape[1]:], g, eps).float()
    return out, routes, (gaps if adopt is not None else None)


def head(c: Dict, seed: int, device,
         fault: Optional[str] = None) -> torch.Tensor:
    """The head's weight [V, D] in float32 (``fault``'s values)."""
    return weights(c, seed, "lm_head.", device, fault)["weight"].float()


@torch.no_grad()
def logits(c: Dict, seed: int, feats, poss, tokens, **kw) -> torch.Tensor:
    """Teacher-forced float32 logits [B, T, V] over ``tokens``."""
    h, _, _ = hidden(c, seed, feats, poss, tokens, **kw)
    return h @ head(c, seed, feats.device, kw.get("fault")).t()
