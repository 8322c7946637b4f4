"""The routed experts' glue (``ops/experts.py``: ``silu_up``, ``combine``;
``csrc/experts_glue.cu``, kernel #6) and the reader of its counter share
(``benchmark/metrics/kimi.experts.fused_row_share.py``).

On the CPU the two plain versions, composed in ``grouped_experts``, are
the chain ``grouped_experts`` ran before the kernel (copied below as
``parent_grouped_experts``), bit for bit, in float32 and bfloat16, at one
choice a token and at six, on a tiny shape and on a block of the
published widths.  The wrappers' checks refuse what the kernels do not
take, naming the argument.  The tests marked ``card`` hold the kernels to
the plain versions on the card at the decode step's shape and at the
prefill's:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_experts_glue.py    # on a machine with a card

(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine lacks; this file imports neither it nor JAX.)

The card's tolerances: ``silu_up`` rounds where ``F.silu(gate) * up``
rounds (SiLU in float32 to the dtype, the product in float32 to the
dtype), so it gives the same bits.  ``combine`` sums the k weighted rows
in float32 in another order than cuBLAS's batched product, and each side
rounds its sum to the dtype once: the two lie within one ulp of the
output's dtype at the larger of them, plus the float32 sums' own
difference where the terms cancel (2k float32 roundings of
``Σ_j |w_j y_j|``), which a result near zero can show.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from benchmark import harness
from image_caption_tpu_torch.models.lm import count_routed
from image_caption_tpu_torch.ops import _build
from image_caption_tpu_torch.ops import experts as EX
from image_caption_tpu_torch.utils import debug

# the kimi_vl_a3b cell: hidden 2,048, expert width 1,408, 64 experts, top 6
D, I, E, K = 2048, 1408, 64, 6
STEP_TOKENS = 1024                   # a decode step's batch
PREFILL_TOKENS = 1024 * 38           # the prefill's: 37 slots and <START>
SCALE = 2.446                        # routed_scaling_factor


def parent_grouped_experts(x, idx, weights, w13, w2):
    """``grouped_experts`` before kernel #6, as it was written."""
    n, k = idx.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(w13.shape[0], dtype=torch.int32, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    offs = torch.cumsum(counts, 0, dtype=torch.int32)
    rows = x.index_select(0, order // k)
    h = torch._grouped_mm(rows, w13.transpose(1, 2), offs=offs)
    gate, up = h.chunk(2, dim=-1)
    y = torch._grouped_mm(F.silu(gate) * up, w2.transpose(1, 2),
                          offs=offs)
    out = torch.empty_like(y).index_copy_(0, order, y)
    return torch.bmm(weights.float()[:, None, :],
                     out.view(n, k, -1).float())[:, 0].to(x.dtype), counts


def parent_combine(y, order, weights):
    """The parent's chain after the second product: the rows back in
    token order by ``index_copy_``, a float32 copy, the float32 batched
    product and the cast."""
    n, k = weights.shape
    out = torch.empty_like(y).index_copy_(0, order, y)
    return torch.bmm(weights.float()[:, None, :],
                     out.view(n, k, -1).float())[:, 0].to(y.dtype)


def routing(n, k, e, gen, device="cpu"):
    """Each token's k distinct experts of e, and router-like weights: the
    chosen sigmoid scores normalised, times the scaling factor."""
    idx = torch.rand(n, e, generator=gen).argsort(-1)[:, :k]
    w = torch.rand(n, k, generator=gen) + 0.05
    w = w / w.sum(-1, keepdim=True) * SCALE
    return idx.to(device), w.to(device)


# -- the plain versions, on the CPU ----------------------------------------

SHAPES = {"tiny": (16, 8, 8, 40), "kimi_widths": (D, I, 6, 48)}


@pytest.mark.parametrize("k", [1, 6])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grouped_experts_are_the_parents_chain(dtype, shape, k):
    """(D, I, experts, routed rows): the rows a token times k."""
    d, i, e, rows = SHAPES[shape]
    gen = torch.Generator().manual_seed(k)
    n = rows // k
    x = torch.randn(n, d, generator=gen).to(dtype)
    idx, w = routing(n, k, e, gen)
    w13 = (torch.randn(e, 2 * i, d, generator=gen) / d ** 0.5).to(dtype)
    w2 = (torch.randn(e, d, i, generator=gen) / i ** 0.5).to(dtype)
    got, counts = EX.grouped_experts(x, idx, w, w13, w2)
    want, want_counts = parent_grouped_experts(x, idx, w, w13, w2)
    assert got.dtype == dtype and got.shape == (n, d)
    assert torch.equal(got, want)
    assert torch.equal(counts, want_counts)


def test_inv_inverts_the_order():
    gen = torch.Generator().manual_seed(3)
    idx, _ = routing(50, K, E, gen)
    order, inv, counts, offs = EX.sort_rows(idx, E)
    assert inv.dtype == torch.int32 and inv.shape == (50 * K,)
    every = torch.arange(50 * K)
    assert torch.equal(order[inv.long()], every)
    assert torch.equal(inv[order].long(), every)
    assert int(offs[-1]) == 50 * K and int(counts.sum()) == 50 * K


def test_combine_reference_is_the_parents_chain():
    gen = torch.Generator().manual_seed(5)
    idx, w = routing(12, K, E, gen)
    order, inv, _, _ = EX.sort_rows(idx, E)
    y = torch.randn(12 * K, 64, generator=gen).to(torch.bfloat16)
    assert torch.equal(EX.combine(y, inv, w), parent_combine(y, order, w))
    h = torch.randn(12, 2 * 64, generator=gen).to(torch.bfloat16)
    gate, up = h.chunk(2, dim=-1)
    assert torch.equal(EX.silu_up(h), F.silu(gate) * up)


def bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


def good_combine(n=4, k=K, d=64):
    gen = torch.Generator().manual_seed(0)
    idx, w = routing(n, k, E, gen)
    return dict(y=bf16(n * k, d), inv=EX.sort_rows(idx, E)[1], weights=w)


BAD_SILU_UP = {
    "float16": (torch.zeros(4, 32, dtype=torch.float16), TypeError, "h"),
    "odd_width": (bf16(4, 33), ValueError, "h must be"),
    "three_dims": (bf16(2, 4, 32), ValueError, "h must be"),
    "width_not_of_8": (bf16(4, 2 * 12), ValueError, "h's width 12"),
    "strided": (bf16(4, 64)[:, :32], ValueError, "h must be contiguous"),
    "unaligned": (bf16(4 * 32 + 1)[1:].view(4, 32), ValueError,
                  "h must be contiguous"),
}


@pytest.mark.parametrize("name", sorted(BAD_SILU_UP))
def test_silu_up_refuses(name):
    h, error, match = BAD_SILU_UP[name]
    with pytest.raises(error, match=match):
        EX.silu_up(h)


BAD_COMBINE = {
    "k_9": (lambda a: good_combine(k=9), ValueError, "k"),
    "y_float16": (lambda a: dict(a, y=a["y"].half()), TypeError, "y"),
    "y_rows": (lambda a: dict(a, y=a["y"][:-1]), ValueError, "y must be"),
    "y_width": (lambda a: dict(a, y=bf16(a["y"].shape[0], 60)), ValueError,
                "y's width 60"),
    "y_strided": (lambda a: dict(a, y=bf16(a["y"].shape[0], 128)[:, ::2]),
                  ValueError, "y must be contiguous"),
    "inv_int64": (lambda a: dict(a, inv=a["inv"].long()), ValueError,
                  "inv"),
    "inv_short": (lambda a: dict(a, inv=a["inv"][:-1]), ValueError, "inv"),
    "weights_bf16": (lambda a: dict(a, weights=a["weights"].bfloat16()),
                     ValueError, "weights"),
    "weights_flat": (lambda a: dict(a, weights=a["weights"].reshape(-1)),
                     ValueError, "weights"),
    "weights_strided": (lambda a: dict(
        a, weights=torch.zeros(4, 2 * K)[:, ::2]), ValueError, "weights"),
}


@pytest.mark.parametrize("name", sorted(BAD_COMBINE))
def test_combine_refuses(name):
    change, error, match = BAD_COMBINE[name]
    with pytest.raises(error, match=match):
        EX.combine(**change(good_combine()))


def test_the_wrappers_refuse_another_device_and_launch_nothing():
    before = (EX.silu_up.launches, EX.combine.launches)
    with pytest.raises(ValueError, match="cuda or cpu"):
        EX.silu_up(bf16(4, 64).to("meta"))
    args = {k: v.to("meta") for k, v in good_combine().items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        EX.combine(**args)
    with pytest.raises(ValueError, match="one device"):
        EX.combine(**dict(good_combine(), inv=args["inv"]))
    EX.silu_up(bf16(4, 64))
    EX.combine(**good_combine())
    assert (EX.silu_up.launches, EX.combine.launches) == before


def test_the_kernel_source_is_built_with_the_others():
    assert "experts_glue" in _build.KERNELS
    src = (_build.CSRC / "experts_glue.cu").read_text()
    assert 'extern "C" int silu_up(' in src
    assert 'extern "C" int combine(' in src
    assert "Replaces no TPU kernel" in src


def test_rows_fused_is_counted_on_the_card_only():
    """On CPU tensors the rows take the plain versions: ``moe.rows_fused``
    stays out of the counters; a CUDA tensor's rows (the kernel's route)
    count, while a profiler records."""

    class Cuda:
        is_cuda = True

        def __gt__(self, other):
            return 3
    debug.clear()
    count_routed(12, torch.tensor([1, 0, 2]))
    assert debug.records()["counters"] == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        count_routed(12, torch.tensor([1, 0, 2]))
        count_routed(6, Cuda())
    counters = debug.records()["counters"]
    debug.clear()
    assert counters["moe.rows_routed"] == 18
    assert counters["moe.rows_fused"] == 6


# -- the reader of kimi.experts.fused_row_share ----------------------------

def read_share(monkeypatch, recs):
    monkeypatch.setattr(debug, "records", lambda: recs)
    return harness.metric_reader("kimi.experts.fused_row_share")(None)


def test_the_share_reader_reads_the_counters(monkeypatch):
    def recs(counters):
        return {"spans": [], "counters": counters, "dropped": 0}
    assert read_share(monkeypatch, recs(
        {"moe.rows_routed": 600, "moe.rows_fused": 600,
         "moe.experts_touched": 9})) == pytest.approx(100.0)
    assert read_share(monkeypatch, recs(
        {"moe.rows_routed": 600, "moe.rows_fused": 150})) == \
        pytest.approx(25.0)
    # a program without the counter (the parent), or without records
    assert read_share(monkeypatch, recs({"moe.rows_routed": 600})) is None
    assert read_share(monkeypatch, recs({})) is None
    assert read_share(monkeypatch, None) is None


def test_the_share_is_listed_for_the_kimi_cell():
    spec = harness.resolve("kimi_vl_a3b.decode_greedy").spec
    m = {x["name"]: x for x in spec["per_layer"]}["kimi.experts.fused_row_share"]
    assert m["workloads"] == ["kimi_vl_a3b.decode_greedy"]
    assert m["source"] == "program_counter" and m["layer"] == "routed experts"
    assert os.path.exists(os.path.join(
        harness.HERE, "metrics", "kimi.experts.fused_row_share.py"))


# -- the kernels, on the card ------------------------------------------------

@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def silu_case(rows, width, dtype, device, seed=0):
    """h [rows, 2 width] of the grouped product's scale, with a few values
    at SiLU's extremes (exp over- and underflow, zeros of both signs)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    h = torch.randn(rows, 2 * width, generator=gen, device=device) * 3
    h[0, :8] = torch.tensor([-100.0, -88.0, -20.0, -0.0, 0.0, 20.0, 88.0,
                             100.0], device=device)
    h[1, :4] = torch.tensor([1e-30, -1e-30, 1e-40, -1e-40], device=device)
    return h.to(dtype)


def combine_case(tokens, k, width, dtype, device, seed=0):
    """(y [tokens·k, width], inv, weights, order): y of the second
    product's scale, the rows routed over the 64 experts."""
    gen = torch.Generator().manual_seed(seed)
    idx, w = routing(tokens, k, E, gen, device)
    order, inv, _, _ = EX.sort_rows(idx, E)
    gen = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn(tokens * k, width, generator=gen, device=device)
    return y.to(dtype), inv, w, order


def ulp(v, dtype):
    """One unit in the last place of ``dtype`` at |v| (0 at 0)."""
    _, e = torch.frexp(v.float().abs())
    bits = 8 if dtype == torch.bfloat16 else 24
    return torch.where(v == 0, 0.0,
                       torch.ldexp(torch.ones_like(v, dtype=torch.float32),
                                   e - bits))


def combine_error(got, want, y, inv, w):
    """(the largest |got - want| over the tolerance, elements that
    differ): the tolerance is one ulp of the dtype at the larger of the
    two, plus 2k float32 roundings of Σ_j |w_j y_j|."""
    n, k = w.shape
    mags = torch.zeros_like(want, dtype=torch.float32)
    for j in range(k):
        mags += w[:, j:j + 1].abs() * y.index_select(
            0, inv[j::k]).float().abs()
    tol = torch.maximum(ulp(got, got.dtype), ulp(want, want.dtype)) \
        + 2 * k * 2.0 ** -24 * mags
    err = (got.float() - want.float()).abs()
    return float((err / tol.clamp_min(1e-38)).max()), int((err > 0).sum())


@pytest.mark.card
@pytest.mark.parametrize("tokens", [STEP_TOKENS, PREFILL_TOKENS],
                         ids=["step", "prefill"])
def test_silu_up_gives_the_plain_versions_bits(card, tokens):
    h = silu_case(tokens * K, I, torch.bfloat16, card, seed=tokens)
    got = EX.silu_up(h)
    want = EX.silu_up_reference(h)
    torch.cuda.synchronize()
    assert got.shape == (tokens * K, I) and got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.card
def test_silu_up_in_float32_gives_the_plain_versions_bits(card):
    h = silu_case(300, I, torch.float32, card, seed=1)
    assert torch.equal(EX.silu_up(h), EX.silu_up_reference(h))


@pytest.mark.card
@pytest.mark.parametrize("tokens", [STEP_TOKENS, PREFILL_TOKENS],
                         ids=["step", "prefill"])
def test_combine_matches_the_parents_chain(card, tokens):
    y, inv, w, order = combine_case(tokens, K, D, torch.bfloat16, card,
                                    seed=tokens)
    got = EX.combine(y, inv, w)
    want = parent_combine(y, order, w)
    torch.cuda.synchronize()
    assert got.shape == (tokens, D) and got.dtype == torch.bfloat16
    worst, _ = combine_error(got, want, y, inv, w)
    assert worst <= 1.0, worst
    assert torch.equal(want, EX.combine_reference(y, inv, w))


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 3, 8])
def test_combine_in_float32_and_other_k(card, k):
    y, inv, w, order = combine_case(200, k, 96, torch.float32, card, seed=k)
    worst, _ = combine_error(EX.combine(y, inv, w),
                             parent_combine(y, order, w), y, inv, w)
    assert worst <= 1.0, worst


@pytest.mark.card
def test_both_replay_in_a_graph_on_new_inputs(card):
    """One capture of both entries over static buffers; new inputs copied
    into them, each replay equals the plain versions on those inputs, and
    two replays give the same bits."""
    h = silu_case(STEP_TOKENS * K, I, torch.bfloat16, card, seed=1)
    y, inv, w, _ = combine_case(STEP_TOKENS, K, D, torch.bfloat16, card,
                                seed=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        EX.silu_up(h)
        EX.combine(y, inv, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a = EX.silu_up(h)
        b = EX.combine(y, inv, w)
    for seed in (2, 3):
        h.copy_(silu_case(STEP_TOKENS * K, I, torch.bfloat16, card, seed))
        y2, inv2, w2, order2 = combine_case(STEP_TOKENS, K, D,
                                            torch.bfloat16, card, seed)
        y.copy_(y2)
        inv.copy_(inv2)
        w.copy_(w2)
        graph.replay()
        first = (a.clone(), b.clone())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(first[0], a) and torch.equal(first[1], b)
        assert torch.equal(a, EX.silu_up_reference(h))
        worst, _ = combine_error(b, parent_combine(y, order2, w), y, inv, w)
        assert worst <= 1.0, worst


@pytest.mark.card
def test_the_launch_counters_count_launches_not_replays(card):
    h = silu_case(64, I, torch.bfloat16, card)
    y, inv, w, _ = combine_case(16, K, D, torch.bfloat16, card)
    before = (EX.silu_up.launches, EX.combine.launches)
    EX.silu_up(h)
    EX.combine(y, inv, w)
    EX.combine(y, inv, w)
    assert (EX.silu_up.launches, EX.combine.launches) == \
        (before[0] + 1, before[1] + 2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        EX.silu_up(h)
        EX.combine(y, inv, w)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert (EX.silu_up.launches, EX.combine.launches) == \
        (before[0] + 2, before[1] + 3)
    with pytest.raises(TypeError, match="h"):
        EX.silu_up(h.half())
    with pytest.raises(ValueError, match="k"):
        EX.combine(y, inv, torch.ones(16, 9, device=card))
    assert (EX.silu_up.launches, EX.combine.launches) == \
        (before[0] + 2, before[1] + 3)
