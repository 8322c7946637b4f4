"""The port's training loop on a tiny synthetic dataset on the CPU: the
files it writes, resume from the latest checkpoint, the checkpoint
manager, the Trainer's API and the ``train`` verb."""

import os

import numpy as np
import pytest
import torch

from image_caption_tpu_torch.data.synthetic import generate_synthetic_dataset
from image_caption_tpu_torch.main import main as cli_main
from image_caption_tpu_torch.train import loop as TLOOP
from image_caption_tpu_torch.train.checkpoint import CheckpointManager
from image_caption_tpu_torch.train.state import create_train_state
from image_caption_tpu_torch.train.step import to_device, train_step
from image_caption_tpu_torch.utils.io import load_pickle

from conftest import make_fake_batch

SIZES = {"train": 10, "valid": 4, "test": 2}


@pytest.fixture(scope="module")
def data(tmp_path_factory, tiny_cfg):
    """A synthetic dataset shaped for ``tiny_cfg`` (7 slots, captions of
    at most 11 tokens), and the config sized to its vocabulary."""
    root = tmp_path_factory.mktemp("data")
    m = tiny_cfg.model
    vocab = generate_synthetic_dataset(
        str(root), num_images=SIZES, num_slots=m.num_slots,
        max_length=m.max_length - 2, seed=1)
    cfg = tiny_cfg.with_overrides(**{
        "model.num_vocab": len(vocab), "data.data_path": str(root),
        "train.batch_size": 8, "train.log_every": 3,
        "train.sample_every": 4, "train.keep_checkpoints": 2})
    return cfg


def _run(cfg, out, epochs, **kw):
    cfg = cfg.with_overrides(**{"data.output_path": str(out)}, **kw)
    return TLOOP.train(cfg, num_epochs=epochs, device="cpu", verbose=True)


def test_train_writes_scores_candidates_and_checkpoints(data, tmp_path,
                                                        capsys):
    state = _run(data, tmp_path, 2)
    steps_per_epoch = -(-SIZES["train"] * 5 // 8)
    assert state.step == 2 * steps_per_epoch
    scores = (tmp_path / "valid_scores.txt").read_text()
    assert scores.count("Epoch ") == 2 and "valid_CIDEr:" in scores
    caps = load_pickle(str(tmp_path / "candidates" /
                           "valid.candidate.captions.pkl"))
    assert len(caps) == SIZES["valid"] and all(isinstance(c, str)
                                               for c in caps)
    assert CheckpointManager(str(tmp_path / "model")).all_epochs() == [1, 2]
    assert not any(n.endswith(".tmp") or n.startswith("model_")
                   for n in os.listdir(tmp_path / "model"))
    out = capsys.readouterr().out
    assert "[it 3] loss=" in out and "[sample it 4]" in out
    assert "[epoch 2] train_loss=" in out


def test_resume_continues_from_the_latest_epoch(data, tmp_path, capsys):
    first = _run(data, tmp_path, 1)
    saved = {k: v.clone() for k, v in first.model.state_dict().items()}
    capsys.readouterr()
    second = _run(data, tmp_path, 3)
    out = capsys.readouterr().out
    assert "[train] resumed from epoch 1" in out
    assert "[epoch 1]" not in out and "[epoch 3]" in out
    steps_per_epoch = -(-SIZES["train"] * 5 // 8)
    assert second.step == 3 * steps_per_epoch
    # keep_checkpoints = 2: epoch 1 rotated out
    assert CheckpointManager(str(tmp_path / "model")).all_epochs() == [2, 3]
    assert (tmp_path / "valid_scores.txt").read_text().count("Epoch ") == 3
    # the resumed run started from epoch 1's weights, not fresh ones
    ckpt = CheckpointManager(str(tmp_path / "model"))
    fresh = create_train_state(data, device="cpu", seed=99)
    restored = ckpt.restore(2, fresh)
    assert restored.step == 2 * steps_per_epoch
    assert any(not torch.equal(saved[k], v)
               for k, v in restored.model.state_dict().items())
    # resume=False (--no-resume) starts over from fresh weights
    fresh_run = TLOOP.train(data.with_overrides(
        **{"data.output_path": str(tmp_path)}), num_epochs=1,
        resume=False, device="cpu", verbose=False)
    assert fresh_run.step == steps_per_epoch


def test_checkpoint_round_trip_and_keep_n(tiny_cfg, tmp_path):
    a = create_train_state(tiny_cfg, device="cpu", seed=1)
    f, p, c = make_fake_batch(tiny_cfg, batch=4)
    train_step(a, to_device((f, p, c), "cpu"), seed=0)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    assert mgr.latest_epoch() is None
    for epoch in (1, 2, 3, 4, 5):
        mgr.save(epoch, a)
    assert mgr.all_epochs() == [3, 4, 5] and mgr.latest_epoch() == 5
    assert os.path.basename(mgr.path(5)) == "train_state_5.pt"
    b = mgr.restore(5, create_train_state(tiny_cfg, device="cpu", seed=2))
    assert b.step == a.step == 1
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    # the optimizer's moments came back: the next updates agree exactly
    la = train_step(a, to_device((f, p, c), "cpu"), seed=0)["loss"]
    lb = train_step(b, to_device((f, p, c), "cpu"), seed=0)["loss"]
    assert torch.equal(la, lb)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path), keep=0)


def test_trainer_api(tiny_cfg):
    tr = TLOOP.Trainer(tiny_cfg, device="cpu")
    f, p, c = make_fake_batch(tiny_cfg, batch=4)
    before = tr.compute_loss(f, p, c)
    assert set(before) == set(tr.metric_keys) == {"loss"}
    m = tr.train_step(f, p, c)
    assert isinstance(m["loss"], float) and np.isfinite(m["loss"])
    ms = tr.train_steps_device([tr.to_device((f, p, c))] * 2)
    assert ms["loss"].shape == (2,) and tr.state.step == 3
    assert tr.flush() is None
    idx_to_word = {i: f"w{i}" for i in range(tiny_cfg.model.num_vocab)}
    idx_to_word.update({0: "<NULL>", 1: "<START>", 2: "<END>"})
    for beam in (None, 2):
        caps, attn = tr.generate_caption(f[:2], p[:2], idx_to_word,
                                         beam_size=beam)
        assert len(caps) == 2 and all(isinstance(x, str) for x in caps)
    _, attn = tr.generate_caption(f[:1], p[:1], idx_to_word,
                                  return_attention=True)
    assert attn is not None
    with pytest.raises(ValueError):
        tr.generate_caption(f, p, idx_to_word, beam_size=0)
    # the same seed gives the same trainer
    a = TLOOP.Trainer(tiny_cfg, device="cpu", seed=4).state.model
    b = TLOOP.Trainer(tiny_cfg, device="cpu", seed=4).state.model
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_make_trainer_names_the_scst_slice_for_rl(flagship_tiny_cfg,
                                                  tiny_cfg):
    assert flagship_tiny_cfg.caption_model == "RL_Transformer"
    with pytest.raises(NotImplementedError, match="SCST"):
        TLOOP.make_trainer(flagship_tiny_cfg, device="cpu")
    assert isinstance(TLOOP.make_trainer(tiny_cfg, device="cpu"),
                      TLOOP.Trainer)


def test_train_entry_points_need_cuda_unless_told_cpu(data, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TLOOP.Trainer(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        TLOOP.train(data.with_overrides(
            **{"data.output_path": str(tmp_path)}), num_epochs=1,
            verbose=False)


def test_train_verb(data, tmp_path, capsys):
    m = data.model
    cli_main(["--device", "cpu", "--preset", "maxlen49_64",
              "--set", f"model.num_vocab={m.num_vocab}",
              "--set", f"model.max_length={m.max_length}",
              "--set", f"model.num_objects={m.num_objects}",
              "--set", "train.batch_size=16", "--set", "train.log_every=2",
              "--data-path", data.data.data_path,
              "--output-path", str(tmp_path), "train", "--epochs", "1"])
    out = capsys.readouterr().out
    assert "[epoch 1] train_loss=" in out
    assert (tmp_path / "model" / "train_state_1.pt").exists()
    cli_main(["--device", "cpu", "--preset", "maxlen49_64",
              "--set", f"model.num_vocab={m.num_vocab}",
              "--set", f"model.max_length={m.max_length}",
              "--set", f"model.num_objects={m.num_objects}",
              "--set", "train.batch_size=16",
              "--data-path", data.data.data_path,
              "--output-path", str(tmp_path), "train", "--epochs", "2"])
    assert "[train] resumed from epoch 1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cli_main(["--set", "oops", "train"])
