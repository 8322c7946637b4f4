"""The port's spans and counters (``utils/debug.annotate``, ``count``,
``records``) on the CPU, and the benchmark's readers of them.

With no profiler recording a span costs one flag read: nothing is entered,
timed or allocated.  Under a profiler the main thread's spans enter the
Chrome trace (and name its idle gaps), a worker thread's are kept but not
traced, and the readers under ``benchmark/metrics`` take the last
``trace_units`` top-level spans and what lies under them.
"""

import threading
import time

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import trace as BT
from benchmark.metrics import _spans
from image_caption_tpu_torch.data.prefetch import Prefetcher
from image_caption_tpu_torch.models.captioner import Captioner
from image_caption_tpu_torch.models.decoding import greedy_decode
from image_caption_tpu_torch.train.loop import Trainer
from image_caption_tpu_torch.utils import debug
from image_caption_tpu_torch.vision import pipeline as TP
from image_caption_tpu_torch.vision.frcnn import init_frcnn
from image_caption_tpu_torch.vision.resnet import init_resnet
from image_caption_tpu_torch.vision.yolov5 import init_yolov5

from conftest import make_fake_batch

CANVAS = 128


@pytest.fixture(autouse=True)
def empty_store():
    debug.clear()
    yield
    debug.clear()


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def canvases(seed=0, n=2):
    rng = np.random.RandomState(seed)
    c = (rng.rand(n, CANVAS, CANVAS, 3) * 255).astype(np.float32)
    metas = np.tile(np.asarray([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    sizes = np.full((n, 2), CANVAS, np.float32)
    return c, metas, sizes


def tiny_extractor():
    gen = torch.Generator().manual_seed(0)
    return TP.ExtractorParams(
        yolo=init_yolov5(gen, depth_multiple=0.33, width_multiple=0.25),
        resnet=init_resnet(gen, (1, 1, 1, 1)))


def tiny_frcnn_extractor():
    gen = torch.Generator().manual_seed(0)
    frcnn = init_frcnn(gen)
    frcnn["backbone"] = init_resnet(gen, stages=(1, 1, 1, 1))
    return TP.FrcnnExtractorParams(frcnn=frcnn,
                                   resnet=init_resnet(gen, (1, 1, 1, 1)))


def run_path(path, cfg):
    if path == "train":
        tr = Trainer(cfg, device="cpu", seed=0)
        batch = tr.to_device(make_fake_batch(cfg, batch=2))
        assert torch.isfinite(tr.train_step_device(batch)["loss"])
    elif path == "decode":
        model = Captioner(cfg.model, device="cpu")
        f, p, _ = make_fake_batch(cfg, batch=2)
        tokens, _ = greedy_decode(model, f, p, device="cpu")
        assert tokens.shape == (2, cfg.model.max_length + 1)
    else:
        f, p, _ = TP.extract_features_batch(
            tiny_extractor(), *canvases(), num_objects=6,
            compute_dtype=torch.float32, device="cpu")
        assert f.shape == (2, 7, 2048)


def raise_(*a, **k):
    raise AssertionError("a span did work while no profiler records")


@pytest.mark.parametrize("path", ["train", "decode", "extract"])
def test_spans_cost_one_flag_read_while_no_profiler_records(
        path, tiny_cfg, monkeypatch):
    # the module's own names: torch's optimizer enters record_function too
    monkeypatch.setattr(debug, "record_function", raise_)
    monkeypatch.setattr(time, "perf_counter_ns", raise_)
    monkeypatch.setattr(torch.cuda, "Event", raise_)
    assert not torch.autograd.profiler._is_profiler_enabled
    run_path(path, tiny_cfg)
    assert debug.records() == {"spans": [], "counters": {}, "dropped": 0}


def test_spans_under_a_profiler_keep_parents_threads_and_counters():
    with cpu_profile() as prof:
        assert torch.autograd.profiler._is_profiler_enabled
        with debug.annotate("outer"):
            with debug.annotate("inner", device=True):
                torch.ones(3).sum()
            debug.count("n", 3)
            debug.count("n", torch.tensor([True, False, True]))

        def worker():
            with debug.annotate("worker.outer"):
                with debug.annotate("worker.inner"):
                    pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    assert not torch.autograd.profiler._is_profiler_enabled
    with debug.annotate("after"):          # the profiler stopped
        pass
    recs = debug.records()
    spans = recs["spans"]
    assert [s["name"] for s in spans] == ["outer", "inner", "worker.outer",
                                          "worker.inner"]
    assert [s["parent"] for s in spans] == [None, 0, None, 2]
    assert [s["main"] for s in spans] == [True, True, False, False]
    assert all(s["host_ms"] >= 0 for s in spans)
    assert spans[0]["host_ms"] >= spans[1]["host_ms"]
    # no card: a device span has no device time
    assert spans[1]["device_start_ms"] is None
    assert recs["counters"] == {"n": 5} and recs["dropped"] == 0
    names = {e.name for e in prof.events()}
    assert {"outer", "inner"} <= names
    assert not {"worker.outer", "worker.inner"} & names


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(debug, "SPAN_LIMIT", 3)
    with cpu_profile():
        for _ in range(5):
            with debug.annotate("s"):
                pass
    recs = debug.records()
    assert len(recs["spans"]) == 3 and recs["dropped"] == 2
    debug.clear()
    assert debug.records() == {"spans": [], "counters": {}, "dropped": 0}


def test_a_trace_gap_inside_a_span_carries_its_name(tmp_path):
    path = str(tmp_path / "trace.json")
    with cpu_profile() as prof:
        with torch.profiler.record_function(BT.WINDOW):
            torch.ones(3).sum()
            with debug.annotate("x"):
                time.sleep(0.05)
            torch.ones(3).sum()
    prof.export_chrome_trace(path)
    got = BT.read(path)
    assert got.idle_gaps[0][0] == "x"
    assert got.idle_gaps[0][1] >= 0.04


def test_train_steps_fed_by_the_prefetcher_under_a_profiler(tiny_cfg):
    """The train cell's spans as its driver drives them: the steps on the
    main thread, the feed's on its own."""
    tr = Trainer(tiny_cfg, device="cpu", seed=0)
    feed = iter(Prefetcher((make_fake_batch(tiny_cfg, batch=2, seed=s)
                            for s in range(3)), transform=tr.to_device))
    with cpu_profile():
        for batch in feed:
            tr.train_step_device(batch)
    spans = debug.records()["spans"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "train.step"]
    assert len(steps) == 3 and all(spans[i]["main"] for i in steps)
    for phase in ("train.forward", "train.backward", "train.adam"):
        assert sorted(s["parent"] for s in spans
                      if s["name"] == phase) == steps
    # the feed asks once more, for the end of its iterable
    for name, n in (("prefetch.assemble", 4), ("train.to_device", 3)):
        assert [s["main"] for s in spans if s["name"] == name
                and s["host_ms"] is not None] == [False] * n
    run = harness.Run(cell(3), harness.Window(), None)
    for metric in ("train.assemble_ms", "train.to_device_ms"):
        assert harness.metric_reader(metric)(run) > 0
    for metric in ("train.forward_ms", "train.backward_ms", "train.adam_ms"):
        assert harness.metric_reader(metric)(run) is None     # no card


def test_greedy_decode_spans_each_step_and_sub_layer(tiny_cfg):
    model = Captioner(tiny_cfg.model, device="cpu")
    f, p, _ = make_fake_batch(tiny_cfg, batch=2)
    with cpu_profile():
        greedy_decode(model, f, p, device="cpu")
    spans = debug.records()["spans"]
    assert spans[0]["name"] == "decode.greedy" and spans[0]["parent"] is None
    steps = [i for i, s in enumerate(spans) if s["name"] == "decode.step"]
    assert len(steps) == tiny_cfg.model.max_length - 1
    assert {spans[i]["parent"] for i in steps} == {0}
    blocks = len(model.decoder.decoder)
    for name, n in (("decode.self_attention", blocks),
                    ("decode.cross_attention", blocks),
                    ("decode.feed_forward", blocks),
                    ("decode.classifier", 1)):
        under = [s["parent"] for s in spans if s["name"] == name]
        assert sorted(under) == sorted(steps * n)


def test_frcnn_extraction_counts_its_crops():
    with cpu_profile():
        TP.extract_features_frcnn(tiny_frcnn_extractor(), *canvases(1),
                                  num_objects=4, canvas=CANVAS,
                                  device="cpu")
    recs = debug.records()
    assert recs["counters"]["extract.crops"] == 2 * 5
    assert 2 <= recs["counters"]["extract.crops_valid"] <= 10
    spans = recs["spans"]
    assert [s["name"] for s in spans if s["name"] != "nms.step"] == [
        "extract.batch", "extract.detect", "extract.crops", "extract.resnet"]
    # a span a pick of the RPN's NMS (256 proposals) and the final one's
    picks = [s for s in spans if s["name"] == "nms.step"]
    assert len(picks) == 256 + 4
    assert {spans[s["parent"]]["name"] for s in picks} == {"extract.detect"}
    share = harness.metric_reader("caption.valid_crop_share")(
        harness.Run(cell(1), harness.Window(), None))
    assert share == 100 * recs["counters"]["extract.crops_valid"] / 10


# -- the readers on hand-built records ------------------------------------

def cell(trace_units):
    return harness.Cell("c", 1, {}, {"trace_units": trace_units}, {})


def span(name, parent, host, dev=None, main=True):
    return {"name": name, "thread": 1 if main else 2, "main": main,
            "parent": parent, "host_ms": host,
            "device_start_ms": dev and dev[0], "device_end_ms": dev and dev[1]}


def train_records():
    """A warm step, then two traced ones; the feed's copy of the next batch
    lands inside the second traced step's forward on the card."""
    s = []
    for k, t in enumerate((0.0, 100.0, 200.0)):
        root = len(s)
        s.append(span("train.step", None, 50.0 + k))
        s.append(span("train.forward", root, 5.0, (t, t + 40.0)))
        s.append(span("train.backward", root, 5.0, (t + 40.0, t + 80.0)))
        s.append(span("train.adam", root, 1.0, (t + 80.0, t + 90.0)))
    s.append(span("prefetch.assemble", None, 30.0, main=False))
    s.append(span("prefetch.assemble", None, 50.0, main=False))
    s.append(span("train.to_device", None, 8.0, (210.0, 220.0), main=False))
    s.append(span("train.to_device", None, 12.0, (300.0, 305.0),
                  main=False))
    return {"spans": s, "counters": {"train.copies": 4,
                                     "train.copies_pinned": 3},
            "dropped": 0}


def caption_records():
    s = []
    for k in range(3):
        root = len(s)
        s.append(span("serve.batch", None, 1000.0))
        s.append(span("serve.load_wait", root, 100.0 * (k + 1)))
        ex = len(s)
        s.append(span("extract.batch", root, 400.0, (0.0, 800.0)))
        s.append(span("extract.detect", ex, 10.0, (0.0, 300.0 + k)))
        s.append(span("extract.crops", ex, 10.0, (300.0, 400.0)))
        s.append(span("extract.resnet", ex, 10.0, (400.0, 800.0)))
        dec = len(s)
        s.append(span("decode.greedy", root, 300.0, (800.0, 860.0)))
        for _ in range(4):
            s.append(span("decode.step", dec, 5.0 + k))
        s.append(span("serve.tokens_to_host", root, 150.0))
    return {"spans": s, "counters": {"extract.crops": 74,
                                     "extract.crops_valid": 37},
            "dropped": 0}


READINGS = [
    # metric, records, trace_units, value
    ("train.assemble_ms", train_records, 2, 40.0),
    ("train.to_device_ms", train_records, 2, 10.0),
    ("train.forward_ms", train_records, 2, (40.0 + 30.0) / 2),
    ("train.backward_ms", train_records, 2, 40.0),
    ("train.adam_ms", train_records, 2, 10.0),
    ("train.pinned_copy_share", train_records, 2, 75.0),
    ("caption.load_wait_ms", caption_records, 2, 250.0),
    ("caption.extract_host_ms", caption_records, 2, 400.0),
    ("caption.detect_ms", caption_records, 2, 301.5),
    ("caption.crops_ms", caption_records, 2, 100.0),
    ("caption.resnet_ms", caption_records, 2, 400.0),
    ("caption.decode_ms", caption_records, 2, 60.0),
    ("caption.decode_step_host_ms", caption_records, 2, 6.5),
    ("caption.tokens_wait_ms", caption_records, 2, 150.0),
    ("caption.valid_crop_share", caption_records, 2, 50.0),
    ("extract.detect_ms", caption_records, 3, None),
]


@pytest.mark.parametrize("metric,recs,units,want", READINGS,
                         ids=[r[0] for r in READINGS])
def test_reader_takes_the_last_traced_units(metric, recs, units, want,
                                            monkeypatch):
    monkeypatch.setattr(_spans, "records", recs)
    got = harness.metric_reader(metric)(
        harness.Run(cell(units), harness.Window(), None))
    assert got == pytest.approx(want) if want is not None else got is None


def test_extraction_readers_take_extract_batch_as_the_unit(monkeypatch):
    """In the extraction cell ``extract.batch`` is the top-level span."""
    recs = caption_records()
    spans = [dict(s) for s in recs["spans"] if s["name"].startswith(
        "extract.")]
    for i, s in enumerate(spans):
        s["parent"] = None if s["name"] == "extract.batch" else \
            max(j for j in range(i) if spans[j]["name"] == "extract.batch")
    monkeypatch.setattr(_spans, "records", lambda: {
        "spans": spans, "counters": {}, "dropped": 0})
    run = harness.Run(cell(2), harness.Window(), None)
    got = [harness.metric_reader(f"extract.{s}_ms")(run)
           for s in ("detect", "crops", "resnet")]
    assert got == pytest.approx([301.5, 100.0, 400.0])


def test_readers_read_nothing_where_the_program_keeps_no_spans(monkeypatch):
    """A checkout without ``records`` (the parent of this change): every
    reader returns None and raises nothing; so does a CPU run's device
    time."""
    records = debug.records
    monkeypatch.delattr(debug, "records")
    run = harness.Run(cell(3), harness.Window(), None)
    for metric, *_ in READINGS:
        assert harness.metric_reader(metric)(run) is None
    monkeypatch.setattr(debug, "records", records, raising=False)
    monkeypatch.setattr(_spans, "records", lambda: {
        "spans": [span("serve.batch", None, 1.0),
                  span("decode.greedy", 0, 1.0)],
        "counters": {}, "dropped": 0})
    assert harness.metric_reader("caption.decode_ms")(run) is None
