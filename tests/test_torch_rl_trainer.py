"""The port's ``RLTrainer`` against the JAX package's (two-phase, serial
schedule, dropout off, the JAX weights carried over); the pipelined
schedule against the serial one; ``make_trainer``; and the ``train`` and
``evaluation`` verbs on an ``RL_`` preset on the CPU."""

import re

import jax
import numpy as np
import pytest
import torch

from image_caption_tpu import main as JMAIN
from image_caption_tpu.train.loop import RLTrainer as JRLTrainer
from image_caption_tpu_torch import main as TMAIN
from image_caption_tpu_torch.data.synthetic import generate_synthetic_dataset
from image_caption_tpu_torch.train import loop as TLOOP
from image_caption_tpu_torch.utils.io import load_pickle
from image_caption_tpu_torch.utils.weights import state_dict_from_jax_params

from conftest import make_fake_batch

NO_DROPOUT = {"model.dropout": 0.0, "model.attention_dropout": 0.0}
KEYS = ("loss", "language_model_loss", "structure_loss", "reward")
RL_PRESET = "RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
SIZES = {"train": 10, "valid": 4, "test": 2}


def _vocab(n):
    vocab = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
    vocab.update({f"w{i}": i for i in range(4, n)})
    return vocab


def test_rl_trainer_matches_jax(flagship_tiny_cfg, capsys):
    cfg = flagship_tiny_cfg.with_overrides(**NO_DROPOUT,
                                           **{"rl.pipeline_depth": 0})
    vocab = _vocab(cfg.model.num_vocab)
    batches = [make_fake_batch(cfg, batch=8, seed=s) for s in range(3)]

    ref = JRLTrainer(cfg, vocab, rng=jax.random.PRNGKey(0), two_phase=True)
    assert ref._two_phase and not ref._pipeline
    capsys.readouterr()
    port = TLOOP.RLTrainer(cfg, vocab, device="cpu")
    # no coco-val-df.p under the data path: corpus df, said as JAX says it
    assert "[rl] WARNING: frozen CIDEr df not found" in \
        capsys.readouterr().out
    assert not port.reward_computer.uses_frozen_df
    port.state.model.load_state_dict(state_dict_from_jax_params(
        jax.device_get(ref.state.params), cfg.model))

    want = ref.compute_loss(*batches[0])
    got = port.compute_loss(*batches[0])
    assert set(got) == set(port.metric_keys) == set(KEYS)
    for key in KEYS:
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=2e-4,
                                   err_msg=key)
    for i, b in enumerate(batches):
        want, got = ref.train_step(*b), port.train_step(*b)
        for key in KEYS:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=2e-4, err_msg=f"step {i} {key}")
    assert port.state.step == 3
    final = state_dict_from_jax_params(jax.device_get(ref.state.params),
                                       cfg.model)
    for name, value in port.state.model.state_dict().items():
        w = final[name]
        rel = ((value - w).norm() / w.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-4, (name, rel)


def test_pipelined_equals_serial_bitwise_with_dropout(flagship_tiny_cfg):
    cfg = flagship_tiny_cfg
    assert cfg.model.dropout > 0 and cfg.model.attention_dropout > 0
    vocab = _vocab(cfg.model.num_vocab)
    serial = TLOOP.RLTrainer(cfg.with_overrides(**{"rl.pipeline_depth": 0}),
                             vocab, device="cpu", seed=3)
    piped = TLOOP.RLTrainer(cfg.with_overrides(**{"rl.pipeline_depth": 1}),
                            vocab, device="cpu", seed=3)
    batches = [serial.to_device(make_fake_batch(cfg, batch=4, seed=s))
               for s in range(5)]
    want = [serial.train_step_device(b) for b in batches]
    got = [piped.train_step_device(b) for b in batches]
    assert got[0] is None and piped.state.step == 4
    got = got[1:] + [piped.flush()]
    assert piped.flush() is None and piped.state.step == serial.state.step
    for i, (a, b) in enumerate(zip(want, got)):
        for key in KEYS:
            assert torch.equal(a[key], b[key]), (i, key)
    sa, sb = serial.state.model.state_dict(), piped.state.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # K steps in one call: the same updates, drained
    k_steps = TLOOP.RLTrainer(cfg, vocab, device="cpu", seed=3)
    stacked = k_steps.train_steps_device(k_steps.shard_stacked(
        [make_fake_batch(cfg, batch=4, seed=s) for s in range(5)]))
    assert stacked["loss"].shape == (5,) and k_steps.state.step == 5
    assert torch.equal(stacked["loss"],
                       torch.stack([m["loss"] for m in want]))


def test_make_trainer_dispatches_on_the_caption_model(flagship_tiny_cfg,
                                                      tiny_cfg, monkeypatch):
    vocab = _vocab(flagship_tiny_cfg.model.num_vocab)
    rl = TLOOP.make_trainer(flagship_tiny_cfg, vocab, device="cpu")
    assert isinstance(rl, TLOOP.RLTrainer)
    xe = TLOOP.make_trainer(tiny_cfg, device="cpu")
    assert type(xe) is TLOOP.Trainer and xe.metric_keys == ["loss"]
    with pytest.raises(ValueError, match="vocabulary"):
        TLOOP.make_trainer(flagship_tiny_cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TLOOP.make_trainer(flagship_tiny_cfg, vocab)


def test_parsers_share_the_default_preset():
    assert TMAIN.build_parser().get_default("preset") == \
        JMAIN.build_parser().get_default("preset") == RL_PRESET


@pytest.fixture(scope="module")
def rl_data(tmp_path_factory, flagship_tiny_cfg):
    """A synthetic dataset shaped for ``flagship_tiny_cfg`` and the CLI
    flags that size the RL preset to it."""
    root = tmp_path_factory.mktemp("rl_data")
    m = flagship_tiny_cfg.model
    vocab = generate_synthetic_dataset(
        str(root), num_images=SIZES, num_slots=m.num_slots,
        max_length=m.max_length - 2, seed=2)
    sets = {"model.num_vocab": len(vocab), "train.batch_size": 8,
            "train.log_every": 2, "train.sample_every": 3}
    for key in ("max_length", "num_objects", "encode_input_size",
                "encode_q_k_dim", "encode_v_dim", "encode_hidden_size",
                "encode_num_heads", "encode_num_blocks",
                "dim_word_embedding", "decode_input_size", "decode_q_k_dim",
                "decode_v_dim", "decode_hidden_size", "decode_num_heads",
                "decode_num_blocks"):
        sets[f"model.{key}"] = getattr(m, key)
    flags = ["--device", "cpu", "--data-path", str(root)]
    for key, value in sets.items():
        flags += ["--set", f"{key}={value}"]
    return flags


def test_train_and_evaluation_verbs_run_scst(rl_data, tmp_path, capsys):
    out_flags = rl_data + ["--output-path", str(tmp_path)]
    TMAIN.main(out_flags + ["train", "--epochs", "1"])
    out = capsys.readouterr().out
    # the synthetic dataset carries its frozen CIDEr df
    assert "frozen CIDEr df not found" not in out
    lines = re.findall(r"^\[it (\d+)\] (.*)$", out, re.M)
    assert [int(n) for n, _ in lines] == [2, 4, 6]
    for _, metrics in lines:
        assert re.fullmatch(r"loss=\S+ language_model_loss=\S+ "
                            r"structure_loss=\S+ reward=\S+", metrics)
    assert "[sample it 3]" in out and "[epoch 1] train_loss=" in out
    assert (tmp_path / "model" / "train_state_1.pt").exists()
    assert (tmp_path / "valid_scores.txt").read_text().count("Epoch 1") == 1

    # a resumed run counts its iterations from 0, as the JAX package does
    TMAIN.main(out_flags + ["train", "--epochs", "2"])
    out = capsys.readouterr().out
    assert "[train] resumed from epoch 1" in out
    first = re.search(r"^\[it (\d+)\]", out, re.M)
    assert int(first.group(1)) == 2                     # == log_every
    assert (tmp_path / "model" / "train_state_2.pt").exists()

    TMAIN.main(out_flags + ["evaluation", "--epoch", "1", "--beam-size",
                            "2"])
    out = capsys.readouterr().out
    assert re.search(r"^CIDEr:\t\S+$", out, re.M)
    caps = load_pickle(str(tmp_path / "candidates" /
                           "test.candidate.captions.pkl"))
    assert len(caps) == SIZES["test"] and all(isinstance(c, str)
                                              for c in caps)
    scores = (tmp_path / "test_scores.txt").read_text()
    assert scores.startswith("Epoch 1\n") and "test_CIDEr:" in scores
    TMAIN.main(out_flags + ["evaluation", "--split", "valid"])
    # the latest checkpoint by default: epoch 2, scored a second time
    assert (tmp_path / "valid_scores.txt").read_text().count("Epoch 2") == 2
    with pytest.raises(SystemExit, match="no checkpoint of epoch 7"):
        TMAIN.main(out_flags + ["evaluation", "--epoch", "7"])


def test_evaluation_needs_cuda_unless_told_cpu(rl_data, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [f for f in rl_data if f not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        TMAIN.main(flags + ["--output-path", str(tmp_path), "evaluation"])
