"""Decoding a split of region features with the ``mla_moe`` captioner:
``serve.decode_split``, greedy.

The split holds ``max_images`` rows cycling through ``distinct`` seeded
region-feature sets (``data/split.make_split``: 1 to num_objects - 1
valid objects and the whole-image slot; row 5 all pad), so one
``decode_split`` call runs the set-up's last part (its first
``warm_batches`` batches) and the window.  A batch is complete when the
split is asked for the next one's features, after its captions are
made; the window opens at the first batch after the warm ones and closes
at the first batch completed after ``--seconds``.  After the window, one
more batch of the same traffic goes through the same entry with
pass-through taps (forward hooks on the routers and the head in the
prefill, a wrapper around ``LMCaptioner.run_step`` that reads the step's
buffers), which keep, for a seeded sample of its rows, each MoE layer's
choice of experts and the logits of every step.

The check (``benchmark/reference/kimi_vl.py`` in float32, TF32 off):

* ``decode.token_gap``: for ``check_rows`` seeded rows of every window
  batch, the served tokens teacher-forced through the reference: the
  widest gap by which a served token's logit lies below the reference's
  best; without bound where a served caption is not the reference's
  detokenisation of its tokens.  A bf16 near-tie in a router changes a
  token's experts at some layer (the reference keeps its own choice here),
  so this gap reads such flips as well as the arithmetic, and the
  precision control reads no higher than sound runs here: the number
  holds the timed path to what it served and catches gross faults;
* ``decode.logit_err``: for ``probe_rows`` rows of the extra batch, the
  program's own prefill-plus-cache logits against the reference's full
  forward over the same tokens, with the reference taking the program's
  choice of experts at each layer and token (weighted by its own scores):
  the largest relative RMS gap over the vocabulary at a logit position;
* ``moe.route_gap``: for those rows, the most by which an expert the
  program chose lies below the reference's own k-th largest ``s + b``
  (infinite where the program did not choose ``num_experts_per_tok``
  distinct experts).  A near-tie flips a choice by about the rounding of
  the scores; a choice made by another rule lies far below.

Controls and planted faults (``limits.py --controls``, ``harness.execute(
control=)``): ``control``, the reference at the precision below the
configuration's (every matrix through float8 e4m3, the activations in
bfloat16), ``fp8_experts`` (only the routed experts' weights so), and the
planted faults ``top5``, ``no_bias``, ``no_rope``, ``no_shared``, each
the reference with that change computed in the program's place (its
first choices over the served tokens, its logits and its choice of
experts).
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import torch

from .. import compare
from ..data.split import make_split
from ..flops import kimi_vl as FK
from ..harness import Window
from ..reference import captioner as RC
from ..reference import kimi_vl as RK
from .caption import vocabulary

# what the program's mla_moe captioner implements of the published keys
SUPPORTED = {"q_lora_rank": None, "topk_method": "noaux_tc",
             "scoring_func": "sigmoid", "hidden_act": "silu",
             "attention_bias": False, "tie_word_embeddings": False,
             "rope_scaling": None, "moe_layer_freq": 1, "n_group": 1,
             "topk_group": 1, "norm_topk_prob": True}


class WindowClosed(Exception):
    pass


class State:
    pass


def program_config(c: Dict):
    """The program's ``Config`` for configuration ``c``: its preset with
    every size the file gives."""
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.models.lm import PROJECTOR_LN_EPS
    odd = {k: c[k] for k, v in SUPPORTED.items() if c[k] != v}
    if c["captioner"]["projector_ln_eps"] != PROJECTOR_LN_EPS:
        odd["projector_ln_eps"] = c["captioner"]["projector_ln_eps"]
    if odd or c["num_key_value_heads"] != c["num_attention_heads"]:
        raise ValueError(f"the program does not implement {odd}")
    cap = c["captioner"]
    lm = {k: c[k] for k in (
        "hidden_size", "num_hidden_layers", "num_attention_heads",
        "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim", "intermediate_size", "first_k_dense_replace",
        "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok",
        "n_shared_experts", "routed_scaling_factor", "rms_norm_eps",
        "rope_theta")}
    lm.update(projector_hidden_size=cap["projector_hidden_size"])
    over = {"lm." + k: v for k, v in lm.items()}
    over.update({"model.num_vocab": c["vocab_size"],
                 "model.max_length": cap["max_length"],
                 "model.num_objects": cap["num_objects"],
                 "model.dim_features": cap["dim_features"],
                 "model.dim_positions": cap["dim_positions"]})
    over["lm.rope_theta"] = float(over["lm.rope_theta"])
    return get_preset(c["preset"]).with_overrides(**over)


class Cycled:
    """``n`` rows cycling through ``base``; each read of a batch-aligned
    slice calls ``on_read(start)`` first."""

    def __init__(self, base: np.ndarray, n: int, offset: int = 0,
                 on_read=None):
        self.base, self.n, self.offset, self.on_read = base, n, offset, on_read

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, sl: slice) -> np.ndarray:
        if self.on_read is not None:
            self.on_read(sl.start)
        a = (self.offset + sl.start) % len(self.base)
        b = a + (sl.stop - sl.start)
        if b <= len(self.base):
            return self.base[a:b]
        return self.base[np.arange(a, b) % len(self.base)]


def split_of(feats, poss, n: int, offset: int = 0, on_read=None):
    from image_caption_tpu_torch.data.dataset import CocoSplit
    return CocoSplit(features=Cycled(feats, n, offset, on_read),
                     positions=Cycled(poss, n, offset),
                     captions=np.zeros((0, 1), np.int32),
                     image_idxs=np.zeros(0, np.int64),
                     file_names=np.zeros(0, object))


def setup(ctx):
    from image_caption_tpu_torch.models.lm import LMCaptioner
    c, tr = ctx.cell.config, ctx.cell.traffic
    st = State()
    st.c, st.b = c, tr["batch"]
    st.cfg = program_config(c)
    m = st.cfg.model
    st.feats, st.poss, _, _ = make_split(
        {"num_objects": m.num_objects, "max_length": m.max_length,
         "dim_features": m.dim_features, "dim_positions": m.dim_positions,
         "num_vocab": m.num_vocab}, tr["distinct"], 1, ctx.seed(2),
        ctx.device)
    st.model = LMCaptioner.from_state_dict(
        st.cfg, RK.state_dict(c, ctx.seed(1), ctx.device), device=ctx.device)
    st.idx_to_word = vocabulary(m.num_vocab)
    st.rng = random.Random(ctx.seed(3))
    st.warm = tr["warm_batches"]
    st.kept: Dict[int, tuple] = {}
    st.window_batches: List[int] = []
    return st


def _keep_captions(st, serve, batch_of):
    """Wrap ``serve.decode_captions``: keep, for ``st.rows_per_batch``
    seeded rows of each batch (``batch_of()`` names it), the tokens and
    the strings it makes."""
    real = serve.decode_captions

    def keep(tokens, idx_to_word):
        strs = real(tokens, idx_to_word)
        k = batch_of()
        rows = sorted(st.rng.sample(range(len(tokens)),
                                    min(st.rows_per_batch, len(tokens))))
        st.kept[k] = (rows, np.array(tokens[rows]), [strs[i] for i in rows])
        return strs
    serve.decode_captions = keep
    return real


def window(ctx, st) -> Window:
    """The warm batches and the window in one ``decode_split`` call; the
    window opens when the last warm batch completes (``st.opened``).  Then
    the probe batch."""
    from image_caption_tpu_torch import serve
    tr = ctx.cell.traffic
    b = st.b
    st.rows_per_batch = tr["check_rows"]
    win = Window(flops_per_unit={"bf16": float(FK.greedy_per_image(st.c))
                                 * b})
    tracer = ctx.tracer
    seen = {"batch": -1, "t0": None, "last": None}

    def on_read(start):
        seen["batch"] = k = start // b
        if k == 0:
            return
        now = time.perf_counter()
        if seen["t0"] is None:
            if k == st.warm:
                ctx.sync()
                seen["t0"] = st.opened = time.perf_counter()
                if tracer:
                    tracer.open()
            return
        win.units += 1
        win.attempted += 1
        win.items += b
        st.window_batches.append(k - 1)
        seen["last"] = now
        if tracer and tracer.done < tracer.units:
            tracer.unit_done()
        if now - seen["t0"] >= ctx.seconds:
            raise WindowClosed
    real = _keep_captions(st, serve, lambda: seen["batch"])
    try:
        serve.decode_split(st.model, st.cfg,
                           split_of(st.feats, st.poss, tr["max_images"],
                                    on_read=on_read),
                           b, st.idx_to_word, device=ctx.device)
        raise RuntimeError("the split ran out before the window closed")
    except WindowClosed:
        pass
    finally:
        serve.decode_captions = real
    win.seconds = seen["last"] - seen["t0"]
    probe(ctx, st, (seen["batch"] + 1) * b)
    return win


def probe(ctx, st, offset: int) -> None:
    """One more batch of the traffic through ``decode_split``, the
    routers' choices and the head's logits of ``probe_rows`` seeded rows
    kept: in the prefill by forward hooks on the routers and the head, in
    each step from the step's buffers after ``run_step`` returns (its
    segments may replay as graphs, which call no hook)."""
    from image_caption_tpu_torch import serve
    b, model = st.b, st.model
    prefill = model.prefix
    rows = torch.tensor(sorted(st.rng.sample(
        range(b), ctx.cell.traffic["probe_rows"])), device=model.device)
    gates = [layer.mlp.gate for layer in model.layers
             if hasattr(layer.mlp, "gate")]
    routes: List[List[torch.Tensor]] = [[] for _ in gates]
    logits: List[torch.Tensor] = []
    real_prefill, real_step = model.prefill, model.run_step

    def on_route(store):
        def hook(_mod, _inp, out):
            store.append(out[0].view(b, prefill, -1)[rows].clone())
        return hook

    def tapped_prefill(*a, **k):
        hooks = [g.register_forward_hook(on_route(r))
                 for g, r in zip(gates, routes)]
        hooks.append(model.lm_head.register_forward_hook(
            lambda _m, _i, out: logits.append(out[rows].clone())))
        try:
            return real_prefill(*a, **k)
        finally:
            for h in hooks:
                h.remove()

    def tapped_step(state):
        out = real_step(state)
        for r, i in zip(routes, sorted(state.idx)):
            r.append(state.idx[i][rows][:, None].clone())
        logits.append(out[rows].clone())
        return out
    model.prefill, model.run_step = tapped_prefill, tapped_step
    st.rows_per_batch = b
    k = {"batch": None}
    real = _keep_captions(st, serve, lambda: k["batch"])
    try:
        serve.decode_split(model, st.cfg,
                           split_of(st.feats, st.poss, b, offset), b,
                           st.idx_to_word, device=ctx.device)
    finally:
        serve.decode_captions = real
        del model.prefill, model.run_step
    _, tokens, _ = st.kept.pop(None)
    st.probe = dict(offset=offset, rows=rows.cpu().numpy(),
                    tokens=tokens[rows.cpu().numpy()],
                    logits=torch.stack(logits, 1),
                    routes=[torch.cat(r, 1) for r in routes])


def free(st) -> None:
    """Drop the model; its step state (closures over the model, CUDA
    graphs) makes a cycle that only the collector frees, so collect
    before the next run in the same process allocates."""
    st.model = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _rows(st, dev, starts: np.ndarray, rows):
    """Features and positions of split rows ``starts + rows``."""
    at = (starts + rows) % len(st.feats)
    return (torch.as_tensor(st.feats[at], device=dev),
            torch.as_tensor(st.poss[at], device=dev))


def _gaps(h, w_head, chosen, rows: int = 8) -> torch.Tensor:
    """The reference's best logit minus its logit of ``chosen`` [B, T]."""
    out = []
    for s in range(0, len(h), rows):
        lg = h[s:s + rows] @ w_head.t()
        out.append(lg.amax(-1) - lg.gather(-1, chosen[s:s + rows, :, None])
                   [..., 0])
    return torch.cat(out)


def _first_choices(h, w_head, rows: int = 8) -> torch.Tensor:
    return torch.cat([(h[s:s + rows] @ w_head.t()).argmax(-1)
                      for s in range(0, len(h), rows)])


def check(ctx, st, control=None):
    """The window's sampled rows, then the probe batch; ``control``
    (a name of ``RK.CONTROLS``: "control", the precision control, or a
    planted fault) puts the reference with that change in the program's
    place."""
    if control is not None and control not in RK.CONTROLS:
        raise ValueError(f"no control {control!r}; the driver knows "
                         f"{RK.CONTROLS}")
    c, dev, b = st.c, ctx.device, st.b
    seed = ctx.seed(1)
    t = st.cfg.model.max_length - 1
    w_head = RK.head(c, seed, dev)
    w_control = None if control is None else RK.head(c, seed, dev, control)
    # the window's batches
    starts, rows, toks, strs = [], [], [], []
    for k in st.window_batches:
        r, tk, s = st.kept[k]
        starts += [k * b] * len(r)
        rows += r
        toks.append(tk)
        strs += s
    tokens = torch.as_tensor(np.concatenate(toks), device=dev)
    feats, poss = _rows(st, dev, np.array(starts), np.array(rows))
    h, _, _ = RK.hidden(c, seed, feats, poss, tokens[:, :t])
    chosen = tokens[:, 1:t + 1]
    if control is not None:
        hf, _, _ = RK.hidden(c, seed, feats, poss, tokens[:, :t],
                             fault=control)
        chosen = _first_choices(hf, w_control)
        differ = False
    else:
        want = [RC.caption_string(row, st.idx_to_word)
                for row in tokens.cpu().numpy()]
        differ = compare.strings_differ(strs, want)
    got = {"decode.token_gap": compare.token_gap(
        _gaps(h, w_head, chosen), differ)}
    # the probe batch
    p = st.probe
    tokens = torch.as_tensor(p["tokens"], device=dev)[:, :t]
    feats, poss = _rows(st, dev, np.full(len(p["rows"]), p["offset"]),
                        p["rows"])
    prog_logits, prog_routes = p["logits"], p["routes"]
    if control is not None:
        hf, prog_routes, _ = RK.hidden(c, seed, feats, poss, tokens,
                                       fault=control)
        prog_logits = hf @ w_control.t()
    h, _, gaps = RK.hidden(c, seed, feats, poss, tokens, adopt=prog_routes)
    ref = h @ w_head.t()
    err = ((prog_logits.float() - ref).pow(2).mean(-1).sqrt()
           / ref.pow(2).mean(-1).sqrt())
    got["decode.logit_err"] = compare.finite(float(err.max()))
    got["moe.route_gap"] = compare.finite(float(torch.stack(
        [g.max() for g in gaps]).max())) if gaps else 0.0
    lim = ctx.cell.config["limits"]
    return {k: (v, lim[k]) for k, v in got.items() if k in lim}
