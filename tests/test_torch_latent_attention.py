"""The absorbed latent attention of the ``mla_moe`` decode step
(``ops/latent_attention.py``, ``csrc/mla_decode.cu``) and the reader of
its roofline share (``benchmark/metrics/kimi.mla_decode.roofline.py``).

On the CPU the plain version is the core that ``MLA.step`` computed
inline before the kernel (copied below as ``inline_core``): bit for bit
in float32, and in bfloat16 with the scores in float32, at the first
step's position, a middle one and the last, with pad slots, an all-pad
row and q read through strided views.  The wrapper's checks refuse what
the kernel does not take.  The tests marked ``card`` hold the kernel to
the plain version at the published sizes:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_latent_attention.py    # on a machine with a card

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine lacks; this file imports neither it nor JAX.)

The card's tolerance: both sides take the scores and the softmax in
float32 and round the weights P to bfloat16; the sums run in other orders,
so a weight may round to the neighbouring bfloat16 (at most 2^-7 of it)
and the output, rounded to bfloat16 once on each side, may differ by an
ulp.  So |kernel - plain| <= max|c| / 128 + |plain| / 64: the first term
bounds every weight off by an ulp at once (sum_t 2^-7 P_t |c_t|), the
second two ulps of the output.
"""

import importlib.util
import os

import pytest
import torch

from benchmark import harness
from benchmark.trace import Trace
from image_caption_tpu_torch.ops import latent_attention as LA
from image_caption_tpu_torch.utils import debug

PREFIX = 38            # the first step's position: 37 slots and <START>
SLOTS = 37
T = 87                 # 37 slots + 51 tokens - 1


def inline_core(q_lat, q_pe, cache, visible, scale, f32_scores=False):
    """``MLA.step``'s attention before the kernel, as it was written; with
    ``f32_scores`` its products taken in float32."""
    r = q_lat.shape[-1]
    q = torch.cat([q_lat, q_pe], dim=-1)
    k = cache.transpose(1, 2)
    if f32_scores:
        q, k = q.float(), k.float()
    scores = torch.bmm(q, k) * scale
    scores = scores.float().masked_fill(~visible[:, None], float("-inf"))
    a = torch.softmax(scores, dim=-1).to(cache.dtype)
    return torch.bmm(a, cache[..., :r])


def case(b, h, r, e, t, pos, dtype, device="cpu", seed=0, slots=SLOTS,
         keep=0.8):
    """q_lat as the einsum leaves it ([H, B, r] underneath), q_pe a slice
    of the projection's output, a cache whose rows after ``pos`` were never
    written (zeros), the step's ``visible`` over ``slots`` region slots
    and the tokens after them: row 0 pads slots 5.., row 1 every slot (the
    traffic's all-pad row), the others each slot with chance ``keep``."""
    gen = torch.Generator().manual_seed(seed)
    q_lat = torch.randn(h, b, r, generator=gen).to(dtype)
    q = torch.randn(b, h, 1, 64 + e, generator=gen).to(dtype)
    cache = torch.randn(b, t, r + e, generator=gen).to(dtype)
    cache[:, pos + 1:] = 0
    key_ok = torch.rand(b, t, generator=gen) > 1 - keep
    key_ok[:, slots:] = True
    key_ok[0, 5:slots] = False
    key_ok[1, :slots] = False
    visible = key_ok & (torch.arange(t) <= pos)
    return (q_lat.to(device).transpose(0, 1), q.to(device)[:, :, 0, 64:],
            cache.to(device), visible.to(device),
            torch.tensor([pos], device=device), 192 ** -0.5)


# -- the plain version, on the CPU -----------------------------------------

SIZES = {"tiny": (3, 4, 32, 8, 13), "published": (3, 16, 512, 64, T)}


@pytest.mark.parametrize("at", ["prefix", "middle", "last"])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_version_is_the_inline_core(dtype, size, at):
    b, h, r, e, t = SIZES[size]
    prefix = min(PREFIX, t - 4)
    pos = {"prefix": prefix, "middle": (prefix + t - 1) // 2,
           "last": t - 1}[at]
    q_lat, q_pe, cache, visible, pos_t, scale = case(
        b, h, r, e, t, pos, dtype, slots=prefix - 1)
    assert not q_lat.is_contiguous() and not q_pe.is_contiguous()
    got = LA.latent_attention(q_lat, q_pe, cache, visible, pos_t, scale)
    assert got.shape == (b, h, r) and got.dtype == dtype
    want = inline_core(q_lat, q_pe, cache, visible, scale,
                       f32_scores=dtype != torch.float32)
    assert torch.equal(got, want)
    assert torch.isfinite(got).all()        # the all-pad row included
    if dtype == torch.bfloat16:
        # only the scores' rounding moved: the old bf16 scores are near
        old = inline_core(q_lat, q_pe, cache, visible, scale)
        assert float((got.float() - old.float()).abs().max()) <= \
            float(cache[..., :r].float().abs().max()) / 16


def test_plain_version_attends_no_row_after_pos():
    """Rows after ``pos`` are attended by no batch row, whatever
    ``visible`` says of them."""
    q_lat, q_pe, cache, visible, pos_t, scale = case(
        2, 4, 32, 8, 13, 6, torch.float32, slots=4)
    everything = torch.ones_like(visible)
    got = LA.latent_attention(q_lat, q_pe, cache, everything, pos_t, scale)
    want = inline_core(q_lat, q_pe, cache,
                       everything & (torch.arange(13) <= 6), scale)
    assert torch.equal(got, want)


def good(b=2):
    q_lat, q_pe, cache, visible, pos_t, _ = case(
        b, LA.HEADS, LA.LATENT, LA.ROPE, T, 50, torch.bfloat16)
    return dict(q_lat=q_lat, q_pe=q_pe, cache=cache, visible=visible,
                pos=pos_t)


def test_the_kernel_takes_the_steps_inputs():
    LA.check(**good(), kernel=True)


BAD = {
    "float32": (lambda a: {k: v.float() if v.is_floating_point() else v
                           for k, v in a.items()}, TypeError, "bfloat16"),
    "eight_heads": (lambda a: dict(a, q_lat=a["q_lat"][:, :8],
                                   q_pe=a["q_pe"][:, :8]),
                    ValueError, "16 heads"),
    "latent_256": (lambda a: dict(a, q_lat=a["q_lat"][..., :256],
                                  cache=a["cache"][..., 256:].contiguous()),
                   ValueError, "latent 512"),
    "rows_97": (lambda a: dict(
        a, cache=torch.zeros(2, 97, 576, dtype=torch.bfloat16),
        visible=torch.ones(2, 97, dtype=torch.bool)), ValueError, "96"),
    "strided_cache": (lambda a: dict(
        a, cache=torch.zeros(2, 2 * T, 576, dtype=torch.bfloat16)[:, ::2]),
        ValueError, "contiguous"),
    "odd_q_stride": (lambda a: dict(
        a, q_lat=torch.zeros(2, 16, 513, dtype=torch.bfloat16)[..., 1:]),
        ValueError, "4-byte"),
    "q_pe_last_dim_strided": (lambda a: dict(
        a, q_pe=torch.zeros(2, 16, 128, dtype=torch.bfloat16)[..., ::2]),
        ValueError, "contiguous last dim"),
    "visible_int8": (lambda a: dict(a, visible=a["visible"].to(torch.int8)),
                     ValueError, "bool"),
    "pos_int32": (lambda a: dict(a, pos=a["pos"].int()), ValueError,
                  "long"),
    "pos_two": (lambda a: dict(a, pos=torch.tensor([1, 2])), ValueError,
                "long"),
    "cache_width": (lambda a: dict(a, cache=a["cache"][..., :575]),
                    ValueError, "mismatch"),
    "another_device": (lambda a: dict(a, pos=a["pos"].to("meta")),
                       ValueError, "one device"),
}


@pytest.mark.parametrize("name", sorted(BAD))
def test_the_kernels_checks_refuse(name):
    change, error, match = BAD[name]
    with pytest.raises(error, match=match):
        LA.check(**change(good()), kernel=True)


def test_the_wrapper_refuses_another_device():
    args = {k: v.to("meta") for k, v in good().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        LA.latent_attention(**args, scale=0.1)


def test_the_kernel_source_is_built_with_the_others():
    from image_caption_tpu_torch.ops import _build
    assert "mla_decode" in _build.KERNELS
    src = (_build.CSRC / "mla_decode.cu").read_text()
    assert 'extern "C" int mla_decode(' in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "cp.async.cg.shared.global" in src
    assert "Replaces no TPU kernel" in src


# -- the reader of kimi.mla_decode.roofline --------------------------------

def fake_run(steps_per_unit, launches, units=2, counters=None):
    """A run whose program kept ``steps_per_unit`` (one entry a
    ``serve.decode_batch``) and ``counters`` (by default 20 of each batch
    row's 38 prefix keys visible) and whose trace holds ``launches``
    launches of the kernel, 1 us each, in time order."""
    cell = harness.resolve("kimi_vl_a3b.decode_greedy")
    cell.traffic = dict(cell.traffic, trace_units=units)
    spans = []
    for n in steps_per_unit:
        root = len(spans)
        spans.append({"name": "serve.decode_batch", "parent": None,
                      "main": True, "host_ms": 1.0})
        greedy = len(spans)
        spans.append({"name": "decode.greedy", "parent": root,
                      "main": True, "host_ms": 1.0})
        spans += [{"name": "decode.step", "parent": greedy, "main": True,
                   "host_ms": 1.0} for _ in range(n)]
    trace = Trace(window_s=1.0, busy_s=1.0, kernels={
        "void (anonymous namespace)::mla_decode_kernel(...)":
            [(1e-3 * i, 1e-6) for i in range(launches)],
        "other_kernel": [(0.0, 1.0)]})
    if counters is None:
        rows = 1024 * len(steps_per_unit)
        counters = {"mla.prefix_keys": rows * PREFIX,
                    "mla.prefix_keys_visible": rows * 20}
    recs = {"spans": spans, "counters": counters, "dropped": 0}
    return harness.Run(cell, None, trace), recs


def read_roofline(monkeypatch, run, recs):
    monkeypatch.setattr(debug, "records", lambda: recs)
    return harness.metric_reader("kimi.mla_decode.roofline")(run)


def roofline_module():
    spec = importlib.util.spec_from_file_location(
        "kimi_mla_decode_roofline",
        os.path.join(harness.HERE, "metrics", "kimi.mla_decode.roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_roofline_reader_maps_each_launch_to_its_position(monkeypatch):
    c = harness.resolve("kimi_vl_a3b.decode_greedy").config
    layers, steps = c["num_hidden_layers"], c["captioner"]["max_length"] - 2
    # a warm unit before the traced two, and launches of an earlier,
    # partly traced batch before theirs
    run, recs = fake_run([steps] * 3, 2 * steps * layers + 5)
    got = read_roofline(monkeypatch, run, recs)
    mod = roofline_module()
    # the pad slots count as no work: 20 visible prefix keys, then s + 1
    # tokens at step s
    bound = 2 * layers * sum(mod.launch_bound_seconds(c, 1024, 20 + s + 1)
                             for s in range(steps))
    assert got == pytest.approx(100 * bound / (2 * steps * layers * 1e-6))
    # a window that opened after the first traced unit's first 100
    # launches: the launches it holds map from the end
    run, recs = fake_run([steps] * 3, 2 * steps * layers - 100)
    poss = [PREFIX + s for _ in range(2) for s in range(steps)
            for _ in range(layers)][100:]
    assert read_roofline(monkeypatch, run, recs) == pytest.approx(
        100 * sum(mod.launch_bound_seconds(
            c, 1024, mod.visible_rows(c, p, 20 / PREFIX)) for p in poss)
        / (len(poss) * 1e-6))
    # the last step's launch with no pad slot: all 87 rows, 1024 rows;
    # the first step's, its prefix half padded
    assert mod.visible_rows(c, 86, 1.0) == T
    assert mod.visible_rows(c, 38, 0.5) == 20
    assert mod.launch_bound_seconds(c, 1024, 87) == pytest.approx(
        2 * 1024 * (87 * 576 + 16 * 1088) / 3.35e12)
    assert mod.launch_bound_seconds(c, 1024, 20) < \
        mod.launch_bound_seconds(c, 1024, 87)


def test_the_roofline_reader_reads_nothing_without_the_kernel(monkeypatch):
    run, recs = fake_run([49, 49], 0)
    assert read_roofline(monkeypatch, run, recs) is None
    run, _ = fake_run([49, 49], 10)
    assert read_roofline(monkeypatch, run, None) is None
    run, recs = fake_run([49, 49], 10, counters={})
    assert read_roofline(monkeypatch, run, recs) is None


# -- the kernel, on the card ------------------------------------------------

@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def plain_on_the_cpu(args):
    cpu = [x.cpu() if isinstance(x, torch.Tensor) else x for x in args]
    return LA.latent_attention_reference(*cpu)


def assert_close_to_plain(got, want, cache):
    r = want.shape[-1]
    bound = float(cache[..., :r].float().abs().max()) / 128 + \
        want.float().abs() / 64
    err = (got.cpu().float() - want.float()).abs()
    assert bool((err <= bound).all()), float(err.max())


@pytest.mark.card
@pytest.mark.parametrize("pos", [38, 62, 86])
def test_the_kernel_matches_the_plain_version(card, pos):
    args = case(1024, LA.HEADS, LA.LATENT, LA.ROPE, T, pos, torch.bfloat16,
                device=card, seed=pos)
    got = LA.latent_attention(*args)
    torch.cuda.synchronize()
    assert got.shape == (1024, 16, 512) and got.dtype == torch.bfloat16
    assert_close_to_plain(got, plain_on_the_cpu(args), args[2])


@pytest.mark.card
def test_the_kernel_in_a_graph_reads_pos_and_no_later_row(card):
    """One capture, replayed at two positions: each equals the plain
    version, though every row after pos holds NaN (the kernel loads none
    of them), and two replays at one position give the same bits."""
    q_lat, q_pe, cache, visible, pos_t, scale = case(
        1024, LA.HEADS, LA.LATENT, LA.ROPE, T, T - 1, torch.bfloat16,
        device=card, seed=5)
    key_ok = visible.clone()
    pos_t.fill_(40)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        LA.latent_attention(q_lat, q_pe, cache, visible, pos_t, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = LA.latent_attention(q_lat, q_pe, cache, visible, pos_t, scale)
    for pos in (40, 71):
        pos_t.fill_(pos)
        torch.logical_and(key_ok, torch.arange(T, device=card) <= pos,
                          out=visible)
        clean = cache.clone()
        clean[:, pos + 1:] = 0
        cache[:, pos + 1:] = float("nan")
        graph.replay()
        first = out.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first, out)
        assert torch.isfinite(first).all()
        assert_close_to_plain(first, plain_on_the_cpu(
            (q_lat, q_pe, clean, visible, pos_t, scale)), clean)
        cache.copy_(clean)


@pytest.mark.card
def test_the_launch_counter_counts_launches_not_replays(card):
    args = case(8, LA.HEADS, LA.LATENT, LA.ROPE, T, 50, torch.bfloat16,
                device=card)
    before = LA.latent_attention.launches
    LA.latent_attention(*args)
    LA.latent_attention(*args)
    assert LA.latent_attention.launches == before + 2
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        LA.latent_attention(*args)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert LA.latent_attention.launches == before + 3
    with pytest.raises(TypeError, match="bfloat16"):
        LA.latent_attention(*[x.float() if isinstance(x, torch.Tensor)
                              and x.is_floating_point() else x
                              for x in args])
    assert LA.latent_attention.launches == before + 3
