"""The train feed: ``train/step.to_device``, ``Trainer.to_device``,
``data/prefetch.Prefetcher`` and, on the card, ``PinnedCopier``.

On the CPU ``to_device`` is the plain ``.to`` it always was, the
prefetched batches arrive in order and equal to their host arrays, the
arrays ``CaptionBatches`` yields stay its own, and the feed's counters
count only while a profiler records.  The tests marked ``card`` hold the
pinned copy on its own stream to the plain copy, bit for bit, against a
consumer that lags far behind the feed:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_feed.py        # on a machine with a card

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine lacks; this file imports neither it nor JAX.)
"""

import threading

import numpy as np
import pytest
import torch

from benchmark import harness
from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.data.dataset import CaptionBatches, CocoSplit
from image_caption_tpu_torch.data.prefetch import (SLOTS, Prefetcher,
                                                   on_handoff)
from image_caption_tpu_torch.train import step as TSTEP
from image_caption_tpu_torch.train.loop import Trainer
from image_caption_tpu_torch.utils import debug


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def empty_store():
    debug.clear()
    yield
    debug.clear()


def tiny_cfg():
    return get_preset("maxlen49_64").with_overrides(**{
        "model.num_vocab": 50, "model.max_length": 13,
        "model.num_objects": 6})


def host_batch(cfg, batch, seed):
    """(features f32, positions f32, captions int32) numpy arrays."""
    rng = np.random.RandomState(seed)
    m = cfg.model
    feats = rng.randn(batch, m.num_slots, m.dim_features).astype(np.float32)
    pos = rng.rand(batch, m.num_slots, m.dim_positions).astype(np.float32)
    caps = rng.randint(4, m.num_vocab, (batch, m.max_length)).astype(np.int32)
    caps[:, 0] = 1
    caps[:, -1] = 2
    return feats, pos, caps


def small_split(cfg, n_images=7, captions=5):
    feats, pos, _ = host_batch(cfg, n_images, 0)
    caps = host_batch(cfg, n_images * captions, 1)[2]
    return CocoSplit(features=feats, positions=pos, captions=caps,
                     image_idxs=np.repeat(np.arange(n_images), captions),
                     file_names=np.asarray([f"{i}.jpg"
                                            for i in range(n_images)]))


def plain(batch, device):
    """What ``to_device`` did before the pinned copy: a ``.to`` a leaf."""
    def put(x, dtype):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=device, dtype=dtype)
    f, p, c = batch[:3]
    return put(f, torch.float32), put(p, torch.float32), put(c, torch.int64)


def same(got, want):
    return all(g.dtype == w.dtype and g.device == w.device
               and g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


def cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


# -- the CPU: the plain path ---------------------------------------------

def ragged_last_batch(cfg):
    """The last batch of an epoch, padded to the batch by ``CaptionBatches``
    (35 captions at batch 4: 3 real rows)."""
    *_, last = CaptionBatches(small_split(cfg), 4, shuffle=False).epoch(0)
    assert last[3] == 3
    return last


INPUTS = {
    "numpy": lambda cfg: host_batch(cfg, 3, 0),
    "float64": lambda cfg: tuple(x.astype(np.float64) if x.dtype ==
                                 np.float32 else x
                                 for x in host_batch(cfg, 3, 0)),
    "tensors": lambda cfg: tuple(torch.from_numpy(x)
                                 for x in host_batch(cfg, 3, 0)),
    "ragged": ragged_last_batch,
}


@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_to_device_on_the_cpu_is_the_plain_copy(kind):
    cfg = tiny_cfg()
    batch = INPUTS[kind](cfg)
    tr = Trainer(cfg, device="cpu", seed=0)
    assert tr._copier is None          # no card, no pinned path
    want = plain(batch, "cpu")
    assert [w.dtype for w in want] == [torch.float32, torch.float32,
                                       torch.int64]
    assert same(TSTEP.to_device(batch, "cpu"), want)
    assert same(tr.to_device(batch), want)


def epochs(batches, n):
    """``n`` batches over as many epochs as it takes, as
    ``benchmark/drivers/train_xe.py`` feeds them."""
    e = 0
    while True:
        for item in batches.epoch(e):
            yield item
            n -= 1
            if n == 0:
                return
        e += 1


def test_twelve_prefetched_batches_arrive_in_order():
    cfg = tiny_cfg()
    batches = CaptionBatches(small_split(cfg), 4, seed=3)
    want = [plain(b, "cpu") for b in epochs(batches, 12)]
    tr = Trainer(cfg, device="cpu", seed=0)
    got = list(Prefetcher(epochs(batches, 12), transform=tr.to_device))
    assert len(got) == 12 == len(want)
    assert all(same(g, w) for g, w in zip(got, want))


def test_caption_batches_yields_arrays_of_its_own():
    """The benchmark's train cell keeps the first items' host arrays for
    its reference after the window: later batches must not write into
    them."""
    cfg = tiny_cfg()
    batches = CaptionBatches(small_split(cfg), 4, seed=3)
    tr = Trainer(cfg, device="cpu", seed=0)
    first, copies = [], []

    def keep(items):
        for item in items:
            if len(first) < 3:
                first.append(tuple(item[:3]))
                copies.append(tuple(x.copy() for x in item[:3]))
            yield item

    seen = list(Prefetcher(keep(epochs(batches, 12)),
                           transform=tr.to_device))
    assert len(seen) == 12
    for kept, copy in zip(first, copies):
        assert all(np.array_equal(k, c) for k, c in zip(kept, copy))
    flat = [x for item in first for x in item]
    assert not any(np.shares_memory(a, b) for i, a in enumerate(flat)
                   for b in flat[i + 1:])


def test_feed_counters_count_only_under_a_profiler():
    cfg = tiny_cfg()
    tr = Trainer(cfg, device="cpu", seed=0)
    batches = [host_batch(cfg, 2, s) for s in range(4)]
    for b in batches[:2]:
        tr.to_device(b)
    assert debug.records()["counters"] == {}
    with cpu_profile():
        for _ in Prefetcher(batches, transform=tr.to_device):
            pass
        tr.shard_stacked(batches[:2])
    counters = debug.records()["counters"]
    # a batch a call; on the CPU nothing goes through a pinned slot
    assert counters == {"train.copies": 5}
    share = harness.metric_reader("train.pinned_copy_share")(
        harness.Run(harness.Cell("c", 1, {}, {"trace_units": 1}, {}),
                    harness.Window(), None))
    assert share == 0.0


def test_handoff_work_runs_on_the_consumer_before_its_item():
    log = []

    def transform(item):
        assert on_handoff(lambda: log.append(
            ("hook", item, threading.get_ident())))
        log.append(("made", item, threading.get_ident()))
        return item

    me = threading.get_ident()
    for item in Prefetcher(range(5), transform=transform):
        log.append(("seen", item, threading.get_ident()))
    producer = {t for what, _, t in log if what == "made"}
    assert len(producer) == 1 and me not in producer
    assert [(w, i) for w, i, t in log if t == me] == [
        (w, i) for i in range(5) for w in ("hook", "seen")]
    assert on_handoff(lambda: None) is False     # no transform running


# -- the card: the pinned copy on the copier's stream --------------------

STEP_CYCLES = 200_000_000      # about 0.1 s of the card a batch
COPY_CYCLES = 20_000_000       # the copy stream lags a tenth of that


@pytest.mark.card
def test_pinned_feed_behind_a_slow_consumer_is_the_plain_copy(card):
    """The consumer's stream runs far behind the feed, and the copy stream
    behind the producer, over three times the ring: a slot refilled before
    its copy ran, or device memory handed back before the step read it,
    would change a batch."""
    cfg = tiny_cfg()
    tr = Trainer(cfg, device=card, seed=0)
    batches = [host_batch(cfg, 64, s) for s in range(3 * SLOTS + 1)]
    want = [plain(b, card) for b in batches]
    torch.cuda.synchronize()

    def slow_copy(batch):
        with torch.cuda.stream(tr._copier.stream):
            torch.cuda._sleep(COPY_CYCLES)
        return tr.to_device(batch)

    equal = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for got, ref in zip(Prefetcher(batches, transform=slow_copy), want):
            torch.cuda._sleep(STEP_CYCLES)
            equal.append(torch.stack([
                (g.dtype == r.dtype) & (g == r).all()
                for g, r in zip(got, ref)]).all())
            del got
        ok = torch.stack(equal).cpu()
    assert ok.all() and len(equal) == len(batches)
    counters = debug.records()["counters"]
    assert counters["train.copies"] == counters["train.copies_pinned"] == \
        len(batches)
    assert counters.get("train.slot_waits", 0) >= 1


def twins(cfg, device):
    """Two trainers of one seed: the first copies through its pinned
    slots, the second as plain ``.to`` calls on the compute stream."""
    a = Trainer(cfg, device=device, seed=0)
    b = Trainer(cfg, device=device, seed=0)
    b._copier = None
    return a, b


def same_state(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        a.state.model.parameters(), b.state.model.parameters()))


@pytest.mark.card
def test_a_step_on_a_pinned_batch_is_bitwise_a_plain_one(card):
    cfg = tiny_cfg()
    a, b = twins(cfg, card)
    for s in range(2):
        batch = host_batch(cfg, 32, s)
        la = a.train_step_device(a.to_device(batch))["loss"]
        lb = b.train_step_device(b.to_device(batch))["loss"]
        assert torch.equal(la, lb)
    assert same_state(a, b)


@pytest.mark.card
def test_stacked_pinned_batches_step_bitwise_as_plain_ones(card):
    cfg = tiny_cfg()
    a, b = twins(cfg, card)
    batches = [host_batch(cfg, 32, s) for s in range(3)]
    la = a.train_steps_device(a.shard_stacked(batches))["loss"]
    lb = b.train_steps_device(b.shard_stacked(batches))["loss"]
    assert la.shape == (3,) and torch.equal(la, lb)
    assert same_state(a, b)
