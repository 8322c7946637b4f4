"""The port's data parallelism over two gloo processes on the CPU, against
the JAX package on a 2-device mesh and against the port's single process.

One module-scoped run starts two ranks (``tests/torch_dp_worker.py``)
with the same exported JAX weights and global batches; while they run,
the JAX trainers step on a 2-device mesh and the port steps in one
process.  Each case is its own test: an XE step whose ranks hold different
pad counts, a focal step, pipelined SCST with a frozen CIDEr df and serial
SCST in corpus-df mode, greedy and beam-2 ``decode_split``, the ranks'
weights bitwise equal, and the df check across ranks.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from image_caption_tpu.config import get_preset as jax_preset
from image_caption_tpu.data.dataset import CocoSplit as JCocoSplit
from image_caption_tpu.parallel.mesh import make_mesh as jax_mesh
from image_caption_tpu.train.loop import RLTrainer as JRLTrainer
from image_caption_tpu.train.loop import Trainer as JTrainer
from image_caption_tpu.train.loop import decode_split as jax_decode_split
from image_caption_tpu_torch.config import get_preset
from image_caption_tpu_torch.data.dataset import CocoSplit
from image_caption_tpu_torch.data.vocab import decode_captions
from image_caption_tpu_torch.metrics.cider import (build_doc_frequency,
                                                   save_doc_frequency)
from image_caption_tpu_torch.models.captioner import Captioner
from image_caption_tpu_torch.serve import decode_split
from image_caption_tpu_torch.train.loop import make_trainer
from image_caption_tpu_torch.utils.weights import state_dict_from_jax_params

from conftest import make_fake_batch

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "torch_dp_worker.py"
WORLD = 2
NO_DROPOUT = {"model.dropout": 0.0, "model.attention_dropout": 0.0}
TINY = {"model.num_vocab": 50, "model.max_length": 13,
        "model.num_objects": 6}
NARROW = dict(TINY, **{f"model.{k}": 32 for k in (
    "encode_input_size", "encode_q_k_dim", "encode_v_dim",
    "encode_hidden_size", "dim_word_embedding", "decode_input_size",
    "decode_q_k_dim", "decode_v_dim", "decode_hidden_size")},
    **{"model.encode_num_heads": 4, "model.encode_num_blocks": 2,
       "model.decode_num_heads": 4, "model.decode_num_blocks": 2})
RL = "RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
FOCAL = "maxlen49_36obj_1wordCount_256_25b_32h_FocalLoss"
# caption lengths of the global batch's 8 rows: rank 0 holds short
# captions, rank 1 long ones, so the ranks' non-pad target counts differ
LENGTHS = (3, 4, 3, 5, 9, 10, 8, 10)
STEPS = 2
KEYS = ("loss", "language_model_loss", "structure_loss", "reward")


def _cfgs(preset, over):
    """The same configuration in both packages."""
    return (jax_preset(preset).with_overrides(**over),
            get_preset(preset).with_overrides(**over))


def _vocab(n):
    vocab = {"<NULL>": 0, "<START>": 1, "<END>": 2, "<UNK>": 3}
    vocab.update({f"w{i}": i for i in range(4, n)})
    return vocab


def _batch(cfg, seed):
    """A global batch of 8 whose rows have the caption lengths LENGTHS."""
    f, p, c = make_fake_batch(cfg, batch=len(LENGTHS), seed=seed)
    rng = np.random.RandomState(seed)
    c[:, 1:] = rng.randint(4, cfg.model.num_vocab, c[:, 1:].shape)
    for i, n in enumerate(LENGTHS):
        c[i, n] = 2
        c[i, n + 1:] = 0
    return f, p, c


def _weights(trainer, cfg):
    return state_dict_from_jax_params(
        jax.device_get(trainer.state.params), cfg.model)


def _single(case):
    """The port in one process on the global batches."""
    trainer = make_trainer(case["cfg"], case.get("vocab"), device="cpu",
                           seed=0)
    trainer.state.model.load_state_dict(case["weights"])
    out = {"eval": trainer.compute_loss(*case["batches"][0]),
           "metrics": []}
    for i, b in enumerate(case["batches"]):
        out["metrics"].append(trainer.train_step(*b))
        if i == 0:
            out["grads"] = {n: p.grad.clone() for n, p in
                            trainer.state.model.named_parameters()}
    out["weights"] = trainer.state.model.state_dict()
    return out


def _jax_steps(trainer, batches):
    want = [trainer.train_step(*b) for b in batches]
    return want, jax.device_get(trainer.state.params)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    jmesh = jax_mesh(jax.devices()[:WORLD])
    rng = jax.random.PRNGKey(0)
    inputs, jax_runs = {}, {}

    for name, preset, over in (
            ("xe", "maxlen49_64", dict(TINY, **NO_DROPOUT)),
            ("focal", FOCAL, dict(NARROW, **NO_DROPOUT))):
        jcfg, tcfg = _cfgs(preset, over)
        ref = JTrainer(jcfg, mesh=jmesh, rng=rng)
        inputs[name] = {"kind": "steps", "cfg": tcfg,
                        "weights": _weights(ref, jcfg),
                        "batches": [_batch(jcfg, 10 + s)
                                    for s in range(STEPS)]}
        jax_runs[name] = (ref, jcfg)

    vocab = _vocab(NARROW["model.num_vocab"])
    df_dir, empty_dir = work / "df", work / "empty"
    df_dir.mkdir()
    empty_dir.mkdir()
    for name, path, depth in (("scst_frozen", df_dir, 1),
                              ("scst_corpus", empty_dir, 0)):
        over = dict(NARROW, **NO_DROPOUT, **{
            "data.data_path": str(path), "rl.pipeline_depth": depth})
        jcfg, tcfg = _cfgs(RL, over)
        batches = [_batch(jcfg, 20 + s) for s in range(STEPS)]
        if name == "scst_frozen":
            caps = decode_captions(np.concatenate([b[2] for b in batches]),
                                   {i: w for w, i in vocab.items()})
            save_doc_frequency(build_doc_frequency([c] for c in caps),
                               str(df_dir / "coco-val-df.p"))
        ref = JRLTrainer(jcfg, vocab, mesh=jmesh, rng=rng, two_phase=True)
        inputs[name] = {"kind": "steps", "cfg": tcfg, "vocab": vocab,
                        "weights": _weights(ref, jcfg), "batches": batches}
        jax_runs[name] = (ref, jcfg)
    jax_initial = jax.device_get(jax_runs["scst_frozen"][0].state.params)
    assert jax_runs["scst_frozen"][0].reward_computer.uses_frozen_df
    assert not jax_runs["scst_corpus"][0].reward_computer.uses_frozen_df

    inputs["df_disagreement"] = {
        "kind": "df_disagreement", "cfg": inputs["scst_frozen"]["cfg"],
        "vocab": vocab, "paths": [str(df_dir), str(empty_dir)]}
    f, p, _ = make_fake_batch(jax_runs["scst_frozen"][1], batch=6, seed=30)
    split = (f, p, np.zeros((6, 13), np.int32), np.arange(6),
             np.array([f"im{i}" for i in range(6)]))
    idx_to_word = {i: w for w, i in vocab.items()}
    inputs["decode"] = {"kind": "decode",
                        "cfg": inputs["scst_frozen"]["cfg"],
                        "weights": inputs["scst_frozen"]["weights"],
                        "split": split, "batch_size": 4,
                        "idx_to_word": idx_to_word, "beams": (None, 2)}
    torch.save(inputs, work / "inputs.pt")

    # the ranks import torch and the port only; no JAX-site path leaks in
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD), str(work)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        # the JAX references trace and compile in threads, side by side
        with ThreadPoolExecutor(len(jax_runs) + 1) as pool:
            futures = {name: pool.submit(_jax_steps, ref,
                                         inputs[name]["batches"])
                       for name, (ref, _) in jax_runs.items()}
            futures["decode"] = pool.submit(lambda: {
                beam: jax_decode_split(
                    jax_initial, jax_runs["scst_frozen"][1],
                    JCocoSplit(*split), 4, idx_to_word, beam_size=beam,
                    mesh=jmesh)
                for beam in (None, 2)})
            jax_out = {name: f.result() for name, f in futures.items()}
        single = {name: _single(inputs[name])
                  for name in ("xe", "focal", "scst_frozen", "scst_corpus")}
        model = Captioner(inputs["decode"]["cfg"].model, device="cpu")
        model.load_state_dict(inputs["decode"]["weights"])
        single["decode"] = {
            beam: decode_split(model, inputs["decode"]["cfg"],
                               CocoSplit(*split), 4, idx_to_word,
                               beam_size=beam, device="cpu")
            for beam in (None, 2)}
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"inputs": inputs, "jax": jax_out, "single": single,
            "ranks": ranks}


def _rel(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _check_steps(dp, name, keys):
    """Each rank's losses within 2e-4 of the JAX mesh's and the single
    process's, its weights within 1e-5 norm-relative per tensor of both,
    its step-1 gradients (summed over the ranks) within 1e-5 of the single
    process's, and its deterministic metrics the single process's."""
    want, jparams = dp["jax"][name]
    single = dp["single"][name]
    jw = state_dict_from_jax_params(jparams, dp["inputs"][name]["cfg"].model)
    for rank, out in enumerate(dp["ranks"]):
        got = out[name]
        assert len(got["metrics"]) == STEPS, (rank, got["metrics"])
        for i, m in enumerate(got["metrics"]):
            for k in keys:
                assert abs(m[k] - want[i][k]) <= 2e-4, (rank, i, k)
                assert abs(m[k] - single["metrics"][i][k]) <= 2e-4, \
                    (rank, i, k)
        for k in keys:
            assert abs(got["eval"][k] - single["eval"][k]) <= 2e-4, k
        for n, v in got["weights"].items():
            assert _rel(v, jw[n]) <= 1e-5, (rank, n, _rel(v, jw[n]))
            assert _rel(v, single["weights"][n]) <= 1e-5, (rank, n)
        for n, g in got["grads"].items():
            assert _rel(g, single["grads"][n]) <= 1e-5, (rank, n)


def test_dp_xe_steps_with_different_pad_counts(dp):
    rows = [out["xe"]["rows"] for out in dp["ranks"]]
    counts = [int((r[:, 1:] != 0).sum()) for r in rows]
    assert counts[0] != counts[1], counts
    # the ranks hold the global batch's contiguous halves
    glob = dp["inputs"]["xe"]["batches"][0][2]
    np.testing.assert_array_equal(np.concatenate(rows), glob)
    _check_steps(dp, "xe", ("loss",))


def test_dp_focal_steps(dp):
    assert dp["inputs"]["focal"]["cfg"].model.xe_loss == "focal"
    _check_steps(dp, "focal", ("loss",))


def test_dp_scst_frozen_df_pipelined(dp):
    assert dp["inputs"]["scst_frozen"]["cfg"].rl.pipeline_depth == 1
    _check_steps(dp, "scst_frozen", KEYS)


def test_dp_scst_corpus_df_serial(dp):
    assert dp["inputs"]["scst_corpus"]["cfg"].rl.pipeline_depth == 0
    _check_steps(dp, "scst_corpus", KEYS)


@pytest.mark.parametrize("name", ["xe", "focal", "scst_frozen",
                                  "scst_corpus"])
def test_dp_ranks_hold_bitwise_equal_weights(dp, name):
    a, b = (out[name]["weights"] for out in dp["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("beam", [None, 2])
def test_dp_decode_split_matches_jax_mesh(dp, beam):
    want = dp["jax"]["decode"][beam]
    assert dp["single"]["decode"][beam] == want
    for out in dp["ranks"]:
        assert out["decode"][beam] == want


def test_dp_df_on_one_rank_raises_on_every_rank(dp):
    for out in dp["ranks"]:
        assert out["df_disagreement"] is not None
        assert "exists on some ranks but not others" in \
            out["df_disagreement"]
