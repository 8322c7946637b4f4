"""The ``kimi_vl_a3b.decode_greedy`` cell cut to a tiny configuration of
its shape on the CPU: the same driver, reference and check, in float32
(the model built in bfloat16 from the same bfloat16-stored weights as the
reference reads, then ``.float()``).  A sound run is correct, the
precision control and every planted fault read above the sound run on at
least one number, and the readers of the new per-layer metrics find the
program's spans and counters.  On a card, the experts-only control and
each fault come out not correct at the cell's own sizes and limits."""

from unittest import mock

import pytest
import torch

from benchmark import harness
from benchmark.reference import kimi_vl as RK
from image_caption_tpu_torch.models.lm import LMCaptioner

TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 4,
        "kv_lora_rank": 32, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
        "v_head_dim": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
        "n_shared_experts": 1, "moe_intermediate_size": 32,
        "intermediate_size": 96, "first_k_dense_replace": 1,
        "num_hidden_layers": 3, "vocab_size": 128}
SEED = 2 ** 31 + 99
# a tiny float32 run's own readings lie near float32 rounding; these
# limits sit far above them and far below a changed computation's
LIMITS = {"decode.token_gap": 1e-4, "decode.logit_err": 1e-4,
          "moe.route_gap": 1e-4}


def cell() -> harness.Cell:
    c = harness.resolve("kimi_vl_a3b.decode_greedy")
    cfg = dict(c.config, **TINY)
    cfg["captioner"] = dict(cfg["captioner"], dim_features=16,
                            projector_hidden_size=48)
    cfg["limits"] = dict(LIMITS)
    c.config = cfg
    c.traffic = dict(c.traffic, batch=4, distinct=16, check_rows=2,
                     probe_rows=2)
    return c


def run(control=None, trace=False):
    torch.manual_seed(0)
    build = LMCaptioner.from_state_dict.__func__
    in_f32 = classmethod(lambda cls, *a, **k: build(cls, *a, **k).float())
    with mock.patch.object(LMCaptioner, "from_state_dict", in_f32):
        return harness.execute(cell(), SEED, 1.0, trace, device="cpu",
                               control=control)


@pytest.fixture(scope="module")
def sound():
    return run()


def test_a_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert set(sound["checks"]) == set(LIMITS)
    assert sound["metrics"]["caption_images_per_s"]["value"] > 0
    assert sound["attempted"] >= 1 and sound["failed"] == 0


@pytest.mark.parametrize("fault", RK.CONTROLS)
def test_every_control_and_fault_fails_a_limit(fault, sound):
    got = run(control=fault)
    assert not got["correct"], (fault, got["checks"])
    assert any(got["checks"][k]["value"] > 100 * max(
        sound["checks"][k]["value"], 1e-7) for k in LIMITS), got["checks"]


def test_a_token_altered_is_caught(monkeypatch):
    from image_caption_tpu_torch import serve
    real = serve._decode

    def altered(*a, **k):
        tokens = real(*a, **k).clone()
        tokens[0, 3] = (tokens[0, 3] + 1) % TINY["vocab_size"]
        return tokens
    monkeypatch.setattr(serve, "_decode", altered)
    got = run()
    assert not got["correct"], got["checks"]


def test_the_new_readers_read_the_programs_spans(monkeypatch):
    """On the CPU the device spans have no device times and there is no
    device trace: the readers of host spans and counters read, the others
    return None, none raises."""
    from benchmark import trace as BT
    from benchmark.metrics import _spans
    from image_caption_tpu_torch.utils import debug

    class CpuTracer(BT.Tracer):
        def __init__(self, units, directory):
            self.units, self.done = units, 0
            self.prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU])
            self.mark = torch.profiler.record_function(BT.WINDOW)
            self.prof.start()

        def unit_done(self):
            self.done += 1
            if self.done == self.units:
                self.mark.__exit__(None, None, None)
                self.prof.stop()

        def close(self):
            if self.done < self.units:      # the window closed first
                self.done = self.units - 1
                self.unit_done()
            return BT.Trace(window_s=1.0, busy_s=0.5)
    monkeypatch.setattr(BT, "Tracer", CpuTracer)
    debug.clear()
    line = run(trace=True)
    m = line["metrics"]
    assert m["kimi.decode_step_host_ms"]["value"] > 0
    assert m["idle.kimi_decode"]["value"] == pytest.approx(50.0)
    assert 0 < m["mfu.kimi_decode"]["value"]
    for name in ("kimi.prefill_ms", "kimi.decode_step_ms",
                 "kimi.experts_ms", "kimi.attention_ms",
                 "kimi.experts.roofline"):
        assert name not in m
    recs = _spans.records()
    assert recs["counters"]["moe.rows_routed"] > 0
    assert recs["counters"]["moe.experts_touched"] > 0
    debug.clear()


@pytest.mark.card
@pytest.mark.parametrize("fault", RK.CONTROLS[1:])
def test_planted_faults_fail_the_cells_own_limits(card, fault):
    """The whole cell on the card, a short window, the committed limits:
    the experts-only fp8 control and each planted fault are not correct
    (``test_control.py`` runs the precision control so)."""
    line = harness.execute(harness.resolve("kimi_vl_a3b.decode_greedy"),
                           3_200_000_000, 2.0, False, control=fault)
    assert not line["correct"], (fault, line["checks"])
