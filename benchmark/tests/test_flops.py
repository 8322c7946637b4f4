"""The operation counts against ``torch.utils.flop_counter``, and the
shares reading 100% at their bounds."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness
from benchmark.data import split as S
from benchmark.data import weights as W
from benchmark.flops import PEAK_FLOPS, captioner as FC
from benchmark.flops.vision import (IDENTITY_RUNS, identity_run_bound,
                                    kernel4_batch_bound)
from benchmark.metrics import _shares
from benchmark.reference import captioner as RC
from benchmark.trace import Trace

TINY = dict(num_vocab=50, max_length=9, num_objects=5, dim_features=32,
            dim_positions=12, pad_idx=0, dropout=0.3, attention_dropout=0.1,
            encode_input_size=16, encode_q_k_dim=16, encode_v_dim=24,
            encode_hidden_size=20, encode_num_blocks=2, encode_num_heads=2,
            dim_word_embedding=12, decode_input_size=16, decode_q_k_dim=16,
            decode_v_dim=24, decode_hidden_size=20, decode_num_blocks=3,
            decode_num_heads=2, move_first_image_feature=False,
            split_position=False, encode_mask=True, split_image_objects=True)


@pytest.mark.parametrize("split_objects", [True, False])
def test_captioner_forward_count(split_objects):
    m = dict(TINY, split_image_objects=split_objects)
    w = W.captioner(m, 0, "cpu")
    f, p, c, _ = S.make_split(m, 7, 1, 1, "cpu")
    f, p, c = torch.tensor(f), torch.tensor(p), torch.tensor(c).long()
    with FlopCounterMode(display=False) as counter:
        RC.logits(w, m, f, p, c)
    assert counter.get_total_flops() == 7 * FC.forward(m)
    assert FC.train_step_per_item(m) == 3 * FC.forward(m)


def test_greedy_count_is_the_encoder_and_one_token_a_step():
    m = dict(TINY, num_vocab=1000)
    big = dict(m, num_vocab=2000)
    steps = m["max_length"] - 1
    assert FC.greedy_per_image(big) - FC.greedy_per_image(m) == \
        steps * 2 * m["decode_input_size"] * 1000


def trace(kernel_s, window_s, busy_s):
    return Trace(window_s=window_s, busy_s=busy_s,
                 kernels={"void stack_kernel<float>": [(0.0, k)
                                                       for k in kernel_s]})


def test_kernel4_roofline_reads_100_at_its_bound():
    crops = 384
    times = [identity_run_bound(IDENTITY_RUNS[i % 4], crops, "bf16")
             for i in range(8)]
    win = harness.Window(kernel4=(crops, "bf16"))
    run = harness.Run(None, win, trace(times, 1.0, 1.0))
    assert _shares.kernel4_roofline(run) == pytest.approx(100.0)
    assert sum(times) == pytest.approx(2 * kernel4_batch_bound(crops,
                                                               "bf16"))


def test_mfu_reads_100_at_the_peak():
    cell = harness.resolve("flagship.train_xe")
    units = cell.traffic["trace_units"]
    win = harness.Window(flops_per_unit={"f32": 1e12, "bf16": 2e12})
    least = units * (1e12 / PEAK_FLOPS["f32"] + 2e12 / PEAK_FLOPS["bf16"])
    run = harness.Run(cell, win, trace([], least, least))
    assert _shares.mfu(run) == pytest.approx(100.0)
    assert _shares.idle(run) == pytest.approx(0.0)
