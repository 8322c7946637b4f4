"""Captioning a folder of JPEGs: ``serve.caption_images``, greedy.

One call captions a long list that cycles through the seeded JPEG set, so
every image is decoded from its file each time; its first
``warm_batches`` batches are set-up, and the window opens at the next
batch and closes at the first batch completed after ``--seconds``.

The check judges the extraction of a seeded sample of ``check_batches``
of the window's batches as in the extraction cell, from the reference's
own decode of the same JPEGs; and the captioner on every batch of the
window, on the features the program extracted: teacher-forced over the
served tokens, the widest gap by which a served token's logit lies below
the reference's best, and the served strings against the reference's
detokenisation of those tokens.  Every batch, because a control in TF32
changes an argmax only at near-ties, a few in ten thousand tokens.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import compare
from ..data import images as I
from ..data import weights as W
from ..flops import captioner as FC
from ..flops.vision import extraction_flops
from ..harness import Window
from ..reference import captioner as RC
from ..reference import vision as RV
from . import _vision as V
from .train_xe import same_sizes


class WindowClosed(Exception):
    pass


class State:
    pass


def vocabulary(n: int):
    words = ["<NULL>", "<START>", "<END>", "<UNK>"]
    return {i: (words[i] if i < 4 else f"w{i}") for i in range(n)}


def setup(ctx):
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.models.captioner import Captioner
    cfg_j, tr = ctx.cell.config, ctx.cell.traffic
    m = cfg_j["model"]
    st = State()
    st.preset = get_preset(cfg_j["preset"])
    same_sizes(st.preset.model, m)
    st.m, st.b = m, tr["batch"]
    st.weights = W.captioner(m, ctx.seed(1), ctx.device)
    st.model = Captioner(st.preset.model, device=ctx.device)
    st.model.load_state_dict(st.weights)
    st.ex = V.Extractor(ctx)
    jpegs = os.path.join(ctx.workdir, "jpegs")
    os.makedirs(jpegs)
    files = I.write_jpegs(jpegs, st.b * tr["distinct_batches"], ctx.seed(7))
    st.paths = [files[i % len(files)] for i in range(tr["max_images"])]
    st.idx_to_word = vocabulary(m["num_vocab"])
    st.sample = V.Sample(tr["check_batches"], ctx.seed(8))
    st.decoded = []
    st.kw = dict(extractor_params=st.ex.params, beam_size=None,
                 batch_size=st.b, max_obj=st.ex.ex.get("max_obj"),
                 num_workers=tr["num_workers"], compute_dtype=st.ex.dtype,
                 device=ctx.device)
    st.warm = tr["warm_batches"]
    return st


def window(ctx, st) -> Window:
    """Set-up's last part (the warm batches) and the window run in one
    ``caption_images`` call; the window opens when the last warm batch
    completes (``st.opened``, where the harness ends ``setup_s``)."""
    from image_caption_tpu_torch import serve
    per_image = extraction_flops(ctx.cell.config, 1)
    flops = {k: v * st.b for k, v in per_image.items()}
    flops["f32"] = flops.get("f32", 0.0) + FC.greedy_per_image(st.m) * st.b
    win = Window(flops_per_unit=flops,
                 kernel4=(st.b * st.ex.ex["crops_per_image"],
                          st.ex.ex["precision"]))
    tracer = ctx.tracer
    det_tap = V.detector_tap(st.ex)
    real_decode = serve._decode
    seen = {"batches": 0, "t0": None, "last": None, "decode": None}

    def decode(model, cfg, feats, poss, *a, **k):
        tokens = real_decode(model, cfg, feats, poss, *a, **k)
        seen["decode"] = (feats, poss, tokens)
        return tokens

    def on_batch(start, caps):
        now = time.perf_counter()
        seen["batches"] += 1
        if seen["t0"] is None:
            if seen["batches"] == st.warm:
                ctx.sync()
                seen["t0"] = st.opened = time.perf_counter()
                if tracer:
                    tracer.open()
            return
        win.units += 1
        win.attempted += 1
        win.items += len(caps)
        win.failed += sum(c is None for c in caps)
        st.decoded.append((list(caps),) + seen["decode"])
        st.sample.offer((start, len(caps), det_tap.last,
                         len(st.decoded) - 1))
        seen["last"] = now
        if tracer and tracer.done < tracer.units:
            tracer.unit_done()
        if now - seen["t0"] >= ctx.seconds:
            raise WindowClosed
    serve._decode = decode
    try:
        serve.caption_images(st.preset, st.paths, st.model, st.idx_to_word,
                             on_batch=on_batch, **st.kw)
        raise RuntimeError("the JPEG list ran out before the window closed")
    except WindowClosed:
        pass
    finally:
        det_tap.remove()
        serve._decode = real_decode
    win.seconds = seen["last"] - seen["t0"]
    return win


def free(st) -> None:
    st.model = None
    V.free_cuda()


def check(ctx, st, control: bool = False):
    """The sampled batches' extraction against the reference, then the
    captioner on the program's features of every batch.  ``control`` puts
    the reference in the program's place at the configuration's control
    precisions: its extraction is judged as the program's is, and the
    captioner's gap is read for the token that the control's logits put
    first."""
    dev = ctx.device
    prec = ctx.cell.config["control"]
    worst = {}
    for start, n, det, k in st.sample.kept:
        _, feats, poss, _ = st.decoded[k]
        paths = st.paths[start:start + n]
        loaded = [RV.load_canvas(p, st.ex.ex["canvas"]) for p in paths]
        c, mt, sz = (torch.as_tensor(np.stack(x), device=dev)
                     for x in zip(*loaded))
        if control:
            picks, got_f, got_p = V.reference_extract(st.ex, c, mt, sz,
                                                      prec["extraction"])
            got_p = got_p[..., :poss.shape[-1]]
        else:
            picks = RV.Picks(*(t[:n] for t in V.program_picks(st.ex, det)))
            got_f, got_p = feats[:n], poss[:n]
        V.merge(worst, V.judge(st.ex, c, mt, sz, picks, got_f, got_p))
    for caps, feats, poss, tokens in st.decoded:
        n = len(caps)
        feats, poss, tokens = feats[:n], poss[:n], tokens[:n]
        chosen = None
        if control:
            with V.tf32(prec["captioner"] == "tf32"):
                chosen = RC.first_choices(st.weights, st.m, feats, poss,
                                          tokens)
        gaps = RC.token_gaps(st.weights, st.m, feats, poss, tokens, chosen)
        want = [RC.caption_string(row, st.idx_to_word)
                for row in tokens.cpu().numpy()]
        V.merge(worst, {"decode.token_gap": compare.token_gap(
            gaps, compare.strings_differ(caps, want))})
    return V.limits(ctx, worst)
