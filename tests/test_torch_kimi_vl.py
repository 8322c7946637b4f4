"""The ``mla_moe`` captioner (``models/lm.py``, ``ops/experts.py``,
``models/decoding.lm_greedy_decode``) against the benchmark's plain
reference (``benchmark/reference/kimi_vl.py``) on the CPU, in float32, on
a tiny configuration of Kimi-VL-A3B's shape: hidden 64, 4 heads, latent
32, rope 8, nope 16, v 16, 8 experts of which 2 a token and 1 shared,
layer 0 dense, 3 layers, 128 words.

The weights are stored in bfloat16, as the configuration states; the
reference reads them in float32 and the port's model, built in bfloat16,
is cast with ``.float()``, so both hold the same values.

Tolerances: both sides compute in float32 over the same weights, with
products at most 96 wide in other orders (the port's absorbed decode
step, its grouped experts); their differences are float32 rounding, a few
1e-7 of logits of order 1: 2e-5 absolute leaves two orders of room and
catches any change of the mathematics.  A router choice within rounding
of a tie could flip between the two sides, so the comparisons of logits
give the reference the port's own choice of experts (``adopt``) and
hold the choice to 1e-6 of the reference's scores.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.drivers import decode_features as DF
from benchmark.reference import kimi_vl as RK
from image_caption_tpu_torch import serve
from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.data.dataset import CocoSplit
from image_caption_tpu_torch.data.vocab import decode_captions
from image_caption_tpu_torch.models.decoding import lm_greedy_decode
from image_caption_tpu_torch.models.lm import WEIGHT_DTYPE, LMCaptioner, \
    Router, restore_captioner
from image_caption_tpu_torch.ops.experts import grouped_experts, sort_rows
from image_caption_tpu_torch.train.loop import Trainer
from image_caption_tpu_torch.utils import debug

TOL = 2e-5
SEED = 2 ** 31 + 7
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 32, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
        "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
        "n_shared_experts": 1, "moe_intermediate_size": 32,
        "intermediate_size": 96, "first_k_dense_replace": 1,
        "num_hidden_layers": 3, "vocab_size": 128}


def tiny_json(**captioner):
    c = dict(harness.resolve("kimi_vl_a3b.decode_greedy").config, **TINY)
    c["captioner"] = dict(c["captioner"], dim_features=16, num_objects=5,
                          max_length=9, projector_hidden_size=48)
    c["captioner"].update(captioner)
    return c


@pytest.fixture(autouse=True)
def empty_store():
    debug.clear()
    yield
    debug.clear()


@pytest.fixture(scope="module")
def tiny():
    """(configuration dict, the port's Config, the model on its weights)."""
    c = tiny_json()
    cfg = DF.program_config(c)
    model = LMCaptioner.from_state_dict(cfg, RK.state_dict(c, SEED, "cpu"),
                                        device="cpu").float()
    return c, cfg, model


def inputs(cfg, batch=3, seed=0):
    """Slots with 1..S-1 valid objects, row 1 partly padded, row 2 all pad."""
    m = cfg.model
    gen = torch.Generator().manual_seed(seed)
    s = m.num_slots
    f = torch.randn(batch, s, m.dim_features, generator=gen)
    p = torch.rand(batch, s, m.dim_positions, generator=gen)
    for row, keep in ((1, 3), (2, 0)):
        f[row, keep:] = 0.0
        p[row, keep:] = 0.0
    return f, p


class Taps:
    """Forward hooks keeping the routers' choices (per MoE layer, over the
    calls: [B, positions, k]) and the head's logits (calls stacked)."""

    def __init__(self, model, batch):
        self.routes, self.logits, self.hooks = [], [], []
        for layer in model.layers:
            if hasattr(layer.mlp, "gate"):
                store = []
                self.routes.append(store)
                self.hooks.append(layer.mlp.gate.register_forward_hook(
                    lambda _m, _i, out, store=store: store.append(
                        out[0].view(batch, -1, out[0].shape[-1]))))
        self.hooks.append(model.lm_head.register_forward_hook(
            lambda _m, _i, out: self.logits.append(out.view(batch, -1,
                                                            out.shape[-1]))))

    def remove(self):
        for h in self.hooks:
            h.remove()
        return ([torch.cat(r, 1) for r in self.routes],
                torch.cat(self.logits, 1))


def max_gap(gaps):
    return max(float(g.max()) for g in gaps)


def test_state_dict_names_and_shapes_are_the_references(tiny):
    c, _, model = tiny
    want = {n: s for n, s, _ in RK.leaves(c)}
    got = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert got == want


def test_teacher_forced_logits_match_the_reference(tiny):
    c, cfg, model = tiny
    f, p = inputs(cfg)
    tokens = torch.randint(4, 128, (3, cfg.model.max_length - 1),
                           generator=torch.Generator().manual_seed(1))
    tokens[:, 0] = 1
    taps = Taps(model, 3)
    got = model(f, p, tokens)
    routes, _ = taps.remove()
    h, _, gaps = RK.hidden(c, SEED, f, p, tokens, adopt=routes)
    want = h @ RK.head(c, SEED, "cpu").t()
    assert got.shape == want.shape == (3, cfg.model.max_length - 1, 128)
    assert max_gap(gaps) <= 1e-6
    assert float((got - want).abs().max()) <= TOL
    # the reference left to its own choices agrees as well here
    assert float((got - RK.logits(c, SEED, f, p, tokens)).abs().max()) <= TOL


def test_greedy_decode_through_the_latent_cache(tiny):
    """Each step's logits (prefill, then the cache) against the reference's
    full forward over the served tokens; every served token its argmax."""
    c, cfg, model = tiny
    f, p = inputs(cfg, seed=3)
    taps = Taps(model, 3)
    tokens = lm_greedy_decode(model, f, p, device="cpu")
    routes, step_logits = taps.remove()
    t = cfg.model.max_length - 1
    assert tokens.shape == (3, cfg.model.max_length + 1)
    assert tokens.dtype == torch.int64
    assert (tokens[:, 0] == 1).all() and (tokens[:, -1] == 0).all()
    h, _, gaps = RK.hidden(c, SEED, f, p, tokens[:, :t], adopt=routes)
    ref = h @ RK.head(c, SEED, "cpu").t()
    assert step_logits.shape == ref.shape
    assert max_gap(gaps) <= 1e-6
    assert float((step_logits - ref).abs().max()) <= TOL
    served = ref.gather(-1, tokens[:, 1:t + 1, None])[..., 0]
    assert float((ref.amax(-1) - served).max()) <= TOL


def test_grouped_experts_equal_the_per_expert_loop():
    gen = torch.Generator().manual_seed(4)
    n, k, e, d, i = 40, 3, 8, 16, 8
    x = torch.randn(n, d, generator=gen)
    idx = torch.stack([torch.randperm(e, generator=gen)[:k]
                       for _ in range(n)])
    idx[idx == 5] = 6          # expert 5 gets no rows
    idx[:, 1] = torch.where(idx[:, 1] == idx[:, 0], 7, idx[:, 1])
    w = torch.rand(n, k, generator=gen)
    w13 = torch.randn(e, 2 * i, d, generator=gen)
    w2 = torch.randn(e, d, i, generator=gen)
    order, counts, offs = sort_rows(idx, e)
    assert counts.dtype == torch.int32 and int(counts[5]) == 0
    assert offs.tolist() == torch.cumsum(counts, 0).tolist()
    assert (idx.reshape(-1)[order].diff() >= 0).all()
    got, rows = grouped_experts(x, idx, w, w13, w2)
    assert torch.equal(rows, counts)
    assert torch.allclose(got, RK.experts(x, idx, w, w13, w2), atol=1e-4,
                          rtol=1e-5)


@torch.no_grad()
def test_correction_bias_steers_the_choice_not_the_weights():
    lm = dataclasses.replace(get_preset("kimi_vl_a3b_regions").lm,
                             hidden_size=4, n_routed_experts=4,
                             num_experts_per_tok=2)
    r = Router(lm)
    r.weight.copy_(torch.eye(4))
    r.e_score_correction_bias.zero_()
    x = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    idx, w = r(x)
    s = torch.sigmoid(x[0])
    assert sorted(idx[0].tolist()) == [0, 1]
    want = s[[0, 1]] / s[[0, 1]].sum() * 2.446
    assert torch.allclose(w[0].sort().values, want.sort().values)
    assert abs(float(w.sum()) - lm.routed_scaling_factor) < 1e-6
    r.e_score_correction_bias.copy_(torch.tensor([0.0, 0.0, 0.0, 1.0]))
    idx, w = r(x)
    assert sorted(idx[0].tolist()) == [0, 3]
    # the weights are the scores' (s), not the biased ones'
    want = s[[0, 3]] / s[[0, 3]].sum() * 2.446
    got = dict(zip(idx[0].tolist(), w[0].tolist()))
    assert got[0] == pytest.approx(float(want[0]), rel=1e-6)
    assert got[3] == pytest.approx(float(want[1]), rel=1e-6)


def test_pad_slots_are_hidden_and_an_all_pad_row_decodes(tiny):
    c, cfg, model = tiny
    f, p = inputs(cfg, seed=5)
    tokens = lm_greedy_decode(model, f, p, device="cpu")
    t = cfg.model.max_length - 1
    # what a pad slot holds (its features; its positions stay zero) is
    # never read by the text
    f2 = f.clone()
    f2[1, 4:] = 7.0
    f2[2] = 3.0
    a = model(f, p, tokens[:, :t])
    b = model(f2, p, tokens[:, :t])
    assert torch.isfinite(a).all()
    assert float((a[1:] - b[1:]).abs().max()) == 0.0
    # the all-pad row decodes from <START> alone: its slots change nothing
    alone = model(f[2:3, :0], p[2:3, :0], tokens[2:3, :t])
    assert float((a[2:3] - alone).abs().max()) <= TOL
    assert torch.equal(lm_greedy_decode(model, f2, p, device="cpu")[2],
                       tokens[2])
    ref = RK.logits(c, SEED, f[2:3], p[2:3], tokens[2:3, :t])
    assert float((a[2:3] - ref).abs().max()) <= TOL


def test_decode_split_end_to_end(tiny):
    c, cfg, model = tiny
    f, p = inputs(cfg, batch=5, seed=6)
    split = CocoSplit(features=f.numpy(), positions=p.numpy(),
                      captions=np.zeros((0, 1), np.int32),
                      image_idxs=np.zeros(0, np.int64),
                      file_names=np.zeros(0, object))
    idx_to_word = {i: (["<NULL>", "<START>", "<END>", "<UNK>"][i] if i < 4
                       else f"w{i}") for i in range(128)}
    got = serve.decode_split(model, cfg, split, 2, idx_to_word, device="cpu")
    tokens = lm_greedy_decode(model, f, p, device="cpu").numpy()
    assert got == decode_captions(tokens, idx_to_word)
    with pytest.raises(ValueError, match="greedily"):
        serve.decode_split(model, cfg, split, 2, idx_to_word, beam_size=2,
                           device="cpu")


def test_caption_images_end_to_end(tmp_path, monkeypatch):
    """JPEGs through the YOLOv5 extraction into the mla_moe captioner: the
    served tokens are the reference's argmax at every step."""
    from PIL import Image
    from image_caption_tpu_torch.vision import pipeline as TP
    from image_caption_tpu_torch.vision.resnet import init_resnet
    from image_caption_tpu_torch.vision.yolov5 import init_yolov5
    c = tiny_json(dim_features=2048, num_objects=36)
    cfg = DF.program_config(c)
    model = LMCaptioner.from_state_dict(cfg, RK.state_dict(c, SEED, "cpu"),
                                        device="cpu").float()
    rng = np.random.RandomState(0)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"im{i}.jpg"))
        Image.fromarray((rng.rand(64 + 8 * i, 80, 3) * 255).astype(np.uint8)
                        ).save(paths[-1])
    gen = torch.Generator().manual_seed(0)
    ex = TP.ExtractorParams(
        yolo=init_yolov5(gen, depth_multiple=0.33, width_multiple=0.25),
        resnet=init_resnet(gen, (1, 1, 1, 1)))
    seen = []
    real = serve._decode

    def tap(*a, **k):
        out = real(*a, **k)
        seen.append((a[2], a[3], out))
        return out
    monkeypatch.setattr(serve, "_decode", tap)
    idx_to_word = {i: f"w{i}" for i in range(128)}
    idx_to_word.update({0: "<NULL>", 1: "<START>", 2: "<END>", 3: "<UNK>"})
    caps = serve.caption_images(cfg, paths, model, idx_to_word,
                                extractor_params=ex, batch_size=2,
                                num_workers=1, compute_dtype=torch.float32,
                                device="cpu")
    assert len(caps) == 3 and len(seen) == 2
    t = cfg.model.max_length - 1
    for feats, poss, tokens in seen:
        ref = RK.logits(c, SEED, feats, poss, tokens[:, :t])
        served = ref.gather(-1, tokens[:, 1:t + 1, None])[..., 0]
        assert float((ref.amax(-1) - served).max()) <= TOL
    assert caps[:2] == decode_captions(seen[0][2].numpy(), idx_to_word)


def test_trainer_refuses_the_preset():
    with pytest.raises(ValueError, match="serves only"):
        Trainer(get_preset("kimi_vl_a3b_regions"), device="cpu")


def test_preset_sizes_equal_the_benchmark_configuration():
    root = harness.ROOT
    with open(os.path.join(root, "benchmark", "configs",
                           "kimi_vl_a3b.json")) as fh:
        c = json.load(fh)
    preset = get_preset("kimi_vl_a3b_regions")
    assert DF.program_config(c) == preset
    assert c["reduced"] == []
    assert preset.model.architecture == "mla_moe"
    assert c["precision"]["weights"] == "bf16"
    assert WEIGHT_DTYPE == torch.bfloat16


def test_restore_builds_no_weights_on_the_host_first(tiny):
    c, cfg, _ = tiny
    state = RK.state_dict(c, SEED, "cpu")
    model = restore_captioner(cfg, state, device="cpu")
    # the state's own storage, not a copy
    assert model.lm_head.weight.data_ptr() == \
        state["lm_head.weight"].data_ptr()
    meta = LMCaptioner(cfg)
    assert all(t.is_meta for t in meta.state_dict().values())


def test_spans_and_counters_only_while_a_profiler_records(tiny):
    c, cfg, model = tiny
    f, p = inputs(cfg, seed=8)
    lm_greedy_decode(model, f, p, device="cpu")
    assert debug.records()["spans"] == []
    assert debug.records()["counters"] == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        lm_greedy_decode(model, f, p, device="cpu")
    recs = debug.records()
    names = [s["name"] for s in recs["spans"]]
    steps = cfg.model.max_length - 2
    moe_layers = TINY["num_hidden_layers"] - 1
    calls = 1 + steps
    assert names.count("decode.greedy") == 1
    assert names.count("decode.prefill") == 1
    assert names.count("decode.step") == steps
    assert names.count("mla.attention") == TINY["num_hidden_layers"] * calls
    for name in ("moe.route", "moe.experts", "moe.shared"):
        assert names.count(name) == moe_layers * calls
    k = TINY["num_experts_per_tok"]
    rows = moe_layers * 3 * k * (model.prefix + steps)
    assert recs["counters"]["moe.rows_routed"] == rows
    touched = recs["counters"]["moe.experts_touched"]
    assert moe_layers * calls <= touched <= TINY["n_routed_experts"] \
        * moe_layers * calls
