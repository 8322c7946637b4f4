"""XE training: ``Trainer.train_step_device`` fed as ``train()`` feeds it.

Set-up makes the captioner's weights and an in-memory split from the seed,
builds one ``Trainer``, and drives it through the check's first steps on
the window's own feed (``CaptionBatches`` reshuffled each epoch, then
``Prefetcher(transform=Trainer.to_device)``); that same trainer and feed
then run the window.  The check follows those first steps with the
reference: each step's loss, the first gradient (read from Adam's first
moment after one step) and the parameters' change after the last, leaf by
leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare
from ..data import split as S
from ..data import weights as W
from ..flops import captioner as FC
from ..harness import Window
from ..harness import tf32 as TF32
from ..reference import captioner as RC

CHECK_STEPS = 3


def same_sizes(model_cfg, sizes: dict) -> None:
    """The program's preset must have the configuration file's sizes."""
    diff = {k: (getattr(model_cfg, k), v) for k, v in sizes.items()
            if getattr(model_cfg, k) != v}
    if diff:
        raise ValueError(f"the program's preset differs from the "
                         f"configuration file: {diff}")


class State:
    pass


def setup(ctx):
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.data.dataset import CaptionBatches, CocoSplit
    from image_caption_tpu_torch.data.prefetch import Prefetcher
    from image_caption_tpu_torch.train.loop import Trainer
    cfg_j, tr = ctx.cell.config, ctx.cell.traffic
    m, b = cfg_j["model"], tr["batch"]
    preset = get_preset(cfg_j["train_preset"])
    same_sizes(preset.model, m)
    st = State()
    st.m, st.b, st.lr = m, b, preset.train.learning_rate
    st.weights = W.captioner(m, ctx.seed(1), ctx.device)
    feats, pos, caps, idxs = S.make_split(m, tr["images"],
                                          tr["captions_per_image"],
                                          ctx.seed(2), ctx.device)
    split = CocoSplit(features=feats, positions=pos, captions=caps,
                      image_idxs=idxs,
                      file_names=np.asarray([f"{i}.jpg"
                                             for i in range(len(feats))]))
    st.trainer_seed = ctx.seed(3)
    trainer = Trainer(preset.with_overrides(**{"train.batch_size": b}),
                      device=ctx.device, seed=st.trainer_seed)
    trainer.load_state_dict(st.weights)
    batches = CaptionBatches(split, b, shuffle=True,
                             seed=ctx.seed(4) % 2 ** 31)
    st.first, st.stop = [], False

    def epochs():
        e = 0
        while not st.stop:
            for item in batches.epoch(e):
                if len(st.first) < CHECK_STEPS:
                    st.first.append(tuple(item[:3]))
                yield item
                if st.stop:
                    return
            e += 1
    st.feed = iter(Prefetcher(epochs(), transform=trainer.to_device))
    model, opt = trainer.state.model, trainer.state.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    losses, grad = [], None
    for step in range(CHECK_STEPS):
        losses.append(trainer.train_step_device(next(st.feed))["loss"])
        if step == 0:
            # a parameter Adam never stepped has no moment: no gradient
            grad = {n: opt.state[p]["exp_avg"] / (1 - beta1)
                    if "exp_avg" in opt.state.get(p, {})
                    else torch.zeros_like(p)
                    for n, p in model.named_parameters()}
            grad = compare.leaf_norms(grad)
    st.prog = {"losses": [float(x) for x in losses], "grad": grad,
               "change": compare.leaf_norms(
                   {n: p.detach() - st.weights[n]
                    for n, p in model.named_parameters()})}
    st.trainer = trainer
    return st


def window(ctx, st) -> Window:
    win = Window(flops_per_unit={"f32": st.b * FC.train_step_per_item(st.m)})
    tracer = ctx.tracer
    t0 = time.perf_counter()
    if tracer:
        tracer.open()
    while True:
        t = time.perf_counter()
        batch = next(st.feed)
        win.span("train.input_wait", time.perf_counter() - t)
        t = time.perf_counter()
        st.trainer.train_step_device(batch)
        win.span("train.step", time.perf_counter() - t)
        win.units += 1
        if tracer and tracer.done < tracer.units:
            tracer.unit_done()
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    ctx.sync()
    win.seconds = time.perf_counter() - t0
    win.attempted, win.items = win.units, win.units * st.b
    return win


def free(st) -> None:
    """End the feed (its thread joins once its queue drains) and drop the
    trainer."""
    st.stop = True
    for _ in st.feed:
        pass
    st.trainer = st.feed = None
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def reference(ctx, st, tf32: bool = False, drop_half: bool = False):
    """The reference's readings of the check's steps."""
    dev = ctx.device
    batches = [(torch.as_tensor(f, device=dev).float(),
                torch.as_tensor(p, device=dev).float(),
                torch.as_tensor(c, device=dev).long()) for f, p, c in st.first]
    seeds = [RC.fold_in(RC.fold_in(st.trainer_seed, 1), s)
             for s in range(CHECK_STEPS)]
    with TF32(tf32):
        losses, grads, params = RC.train_steps(st.weights, st.m, batches,
                                               seeds, st.lr,
                                               drop_half=drop_half)
    return {"losses": losses, "grad": compare.leaf_norms(grads),
            "change": compare.leaf_norms({n: params[n] - st.weights[n]
                                          for n in params})}


def check(ctx, st, control: str = None):
    """The program's first steps against the reference's.  ``control``
    puts in the program's place the reference at the configuration's
    control precision ("control", TF32) or with a planted fault
    ("drop_half": each step's loss the mean over half the batch)."""
    prog = {None: lambda: st.prog,
            "control": lambda: reference(ctx, st, tf32=True),
            "drop_half": lambda: reference(ctx, st, drop_half=True)}[
        control]()
    got = compare.training(prog, reference(ctx, st))
    limits = ctx.cell.config["limits"]
    return {k: (v, limits[k]) for k, v in got.items()}
