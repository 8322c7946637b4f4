"""The CLI over two gloo processes on the CPU:
``python -m image_caption_tpu_torch.main --distributed ... train`` writes
from rank 0 only and resumes on every rank, and ``evaluation`` over two
processes writes the candidates of one process."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from image_caption_tpu_torch.data.synthetic import generate_synthetic_dataset
from image_caption_tpu_torch.utils.io import load_pickle

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
SIZES = {"train": 8, "valid": 6, "test": 2}
BATCH = 8


def _start(argv, cwd, log):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env["OMP_NUM_THREADS"] = "2"      # five processes share the cores
    with open(log, "w") as f:          # the child keeps its own handle
        return subprocess.Popen(
            [sys.executable, "-m", "image_caption_tpu_torch.main"] + argv,
            cwd=cwd, env=env, stdout=f, stderr=subprocess.STDOUT)


def _dp(flags, args, work, name):
    """Start the ranks of one two-process launch; returns their
    processes and log paths."""
    rendezvous = work / f"{name}.rendezvous"
    procs, logs = [], []
    for r in range(WORLD):
        logs.append(work / f"{name}.rank{r}.log")
        procs.append(_start(
            ["--distributed", "--coordinator", f"file://{rendezvous}",
             "--num-processes", str(WORLD), "--process-id", str(r)]
            + flags + args, work, logs[-1]))
    return procs, logs


def _wait(procs, logs):
    outs = []
    for p, log in zip(procs, logs):
        p.wait(timeout=300)
        outs.append(Path(log).read_text())
        assert p.returncode == 0, outs[-1][-3000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Epoch 1 over two processes; then, side by side, epoch 2 resumed
    over two processes, and ``evaluation`` of epoch 1 over two processes
    and over one on a copy of the outputs."""
    work = tmp_path_factory.mktemp("dp_cli")
    vocab = generate_synthetic_dataset(
        str(work / "data"), num_images=SIZES, num_slots=7, max_length=11,
        seed=5, feature_format="npy")
    flags = ["--device", "cpu", "--preset", "maxlen49_64",
             "--set", f"model.num_vocab={len(vocab)}",
             "--set", "model.max_length=13", "--set", "model.num_objects=6",
             "--set", f"train.batch_size={BATCH}",
             "--set", "train.log_every=2", "--set", "train.sample_every=3",
             "--data-path", str(work / "data")]
    out = work / "out"
    first = _wait(*_dp(flags + ["--output-path", str(out)],
                       ["train", "--epochs", "1"], work, "epoch1"))
    first_scores = (out / "valid_scores.txt").read_text()
    single_out = work / "single"
    shutil.copytree(out, single_out)
    eval_out = work / "eval"
    shutil.copytree(out, eval_out)

    evaluation = ["evaluation", "--split", "valid", "--epoch", "1",
                  "--beam-size", "2"]
    resumed = _dp(flags + ["--output-path", str(out)],
                  ["train", "--epochs", "2"], work, "epoch2")
    dp_eval = _dp(flags + ["--output-path", str(eval_out)], evaluation,
                  work, "eval")
    single = _start(flags + ["--output-path", str(single_out)] + evaluation,
                    work, work / "single.log")
    second = _wait(*resumed)
    eval_logs = _wait(*dp_eval)
    _wait([single], [work / "single.log"])
    return {"out": out, "first": first, "first_scores": first_scores,
            "second": second, "eval": eval_logs,
            "eval_out": eval_out, "single_out": single_out}


def test_dp_train_writes_from_rank_0_only(runs):
    rank0, rank1 = runs["first"]
    steps = -(-SIZES["train"] * 5 // BATCH)
    its = re.findall(r"^\[it (\d+)\] loss=", rank0, re.M)
    assert [int(n) for n in its] == list(range(2, steps + 1, 2))
    assert "[sample it 3]" in rank0 and "[epoch 1] train_loss=" in rank0
    assert not re.search(r"^\[(it|sample|epoch|data|train)", rank1, re.M), \
        rank1[-2000:]
    assert runs["first_scores"].count("Epoch 1") == 1
    payload = torch.load(runs["out"] / "model" / "train_state_1.pt",
                         weights_only=True)
    assert payload["step"] == steps
    caps = load_pickle(str(runs["out"] / "candidates" /
                           "valid.candidate.captions.pkl"))
    assert len(caps) == SIZES["valid"]


def test_dp_train_resumes_on_every_rank(runs):
    rank0, rank1 = runs["second"]
    assert "[train] resumed from epoch 1" in rank0
    assert "[epoch 2] train_loss=" in rank0 and "[epoch 1]" not in rank0
    assert not re.search(r"^\[", rank1, re.M)
    steps = -(-SIZES["train"] * 5 // BATCH)
    payload = torch.load(runs["out"] / "model" / "train_state_2.pt",
                         weights_only=True)
    assert payload["step"] == 2 * steps
    assert (runs["out"] / "valid_scores.txt").read_text().count(
        "Epoch ") == 2


def test_dp_evaluation_equals_one_process(runs):
    name = os.path.join("candidates", "valid.candidate.captions.pkl")
    got = load_pickle(str(runs["eval_out"] / name))
    want = load_pickle(str(runs["single_out"] / name))
    assert got == want and len(got) == SIZES["valid"]
    rank0, rank1 = runs["eval"]
    assert re.search(r"^CIDEr:\t\S+$", rank0, re.M)
    assert "CIDEr" not in rank1
    scores = (runs["eval_out"] / "valid_scores.txt").read_text()
    assert scores.count("Epoch 1") == 2       # training's and evaluation's
