"""Dataset build: ``vision.pipeline.extract_features_batch`` on seeded
letterboxed canvases, drained to the host one batch behind as
``vision/etl.extract_split_features`` drains them (batch k-1 is copied
while the card runs batch k).  Shards are not written.

The check takes a seeded sample of the window's batches and judges each
against the float32 reference (``_vision.judge``): the detector's picks,
the position rows and the features as drained.
"""

from __future__ import annotations

import time

import torch

from ..flops.vision import extraction_flops
from ..data import images as I
from ..harness import Window
from . import _vision as V


class State:
    pass


def setup(ctx):
    from image_caption_tpu_torch.vision.pipeline import extract_features_batch
    tr = ctx.cell.traffic
    st = State()
    st.ex = V.Extractor(ctx)
    e = st.ex.ex
    st.b = tr["batch"]
    c, metas, sizes = I.canvases(st.b * tr["distinct_batches"], ctx.seed(7),
                                 e["canvas"], ctx.device)
    host = c.cpu().numpy()
    st.batches = [(host[i:i + st.b], metas[i:i + st.b], sizes[i:i + st.b])
                  for i in range(0, len(host), st.b)]
    st.kw = dict(num_objects=e["num_objects"], max_obj=e["max_obj"],
                 compute_dtype=st.ex.dtype, use_kernel=True,
                 device=ctx.device)
    st.extract = extract_features_batch
    for canv, mt, sz in st.batches[:tr["warm_batches"]]:
        f, p, _ = st.extract(st.ex.params, canv, mt, sz, **st.kw)
        f.cpu(), p.cpu()
    st.sample = V.Sample(tr["check_batches"], ctx.seed(8))
    return st


def window(ctx, st) -> Window:
    win = Window(flops_per_unit=extraction_flops(ctx.cell.config, st.b),
                 kernel4=(st.b * st.ex.ex["crops_per_image"],
                          st.ex.ex["precision"]))
    tap = V.detector_tap(st.ex)
    tracer = ctx.tracer
    pending, j = None, 0

    def drain(item):
        k, f, p, det = item
        feats, poss = f.cpu().numpy(), p.cpu().numpy()
        win.units += 1
        win.items += st.b
        st.sample.offer((k, feats, poss, det))
    t0 = time.perf_counter()
    if tracer:
        tracer.open()
    try:
        while True:
            canv, mt, sz = st.batches[j % len(st.batches)]
            f, p, _ = st.extract(st.ex.params, canv, mt, sz, **st.kw)
            win.attempted += 1
            if tracer and tracer.done < tracer.units:
                tracer.unit_done()
            if pending is not None:
                drain(pending)
            pending = (j % len(st.batches), f, p, tap.last)
            j += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        drain(pending)
    finally:
        tap.remove()
    win.seconds = time.perf_counter() - t0
    return win


def free(st) -> None:
    st.extract = None
    V.free_cuda()


def check(ctx, st, control: bool = False):
    """The sampled batches against the reference; ``control`` puts the
    reference at the configuration's control precision in the program's
    place."""
    dev = ctx.device
    worst = {}
    for k, feats, poss, det in st.sample.kept:
        canv, mt, sz = st.batches[k]
        c = torch.as_tensor(canv, device=dev)
        mt, sz = (torch.as_tensor(x, device=dev) for x in (mt, sz))
        if control:
            picks, feats, poss = V.reference_extract(
                st.ex, c, mt, sz, ctx.cell.config["control"]["extraction"])
        else:
            picks = V.program_picks(st.ex, det)
            feats = torch.as_tensor(feats, device=dev)
            poss = torch.as_tensor(poss, device=dev)
        V.merge(worst, V.judge(st.ex, c, mt, sz, picks, feats, poss))
    return V.limits(ctx, worst)
