"""The port's data and tensor parallelism over two gloo processes on the
CPU, against the JAX package on a 2-device mesh and against the port's
single process.

One module-scoped run starts two ranks (``tests/torch_dp_worker.py``)
with the same exported JAX weights and global batches; while they run,
the JAX trainers step on 2-device meshes and the port steps in one
process.  Each case is its own test.  Data parallel (data 2): an XE step
whose ranks hold different pad counts, a focal step, pipelined SCST with a
frozen CIDEr df and serial SCST in corpus-df mode, greedy and beam-2
``decode_split``, the ranks' weights bitwise equal, and the df check
across ranks.  Tensor parallel (model 2, the JAX mesh ``data=1,
model=2``): XE, focal (with the decoder's tail FFN) and pipelined argmax
SCST against the JAX package's sharded steps (losses 2e-4, full-layout
gradients and weights 1e-4) and one process (1e-5), the pad row frozen,
a focal run at the presets' dropout against one process (1e-5), greedy
and beam-2 ``decode_split``, and a checkpoint that crosses model axes.  Sequence parallel (sequence 2,
the JAX mesh ``data=1, sequence=2``): XE on the flagship family at 8
slots (the pair block and the encoder mask cross the shards), focal with
the decoder's tail FFN, the fallback at 7 slots, pipelined argmax SCST,
a scanned dispatch of 2 steps on slot-sharded stacked batches, each
against the JAX package's mesh (losses 2e-4, weights 1e-4) and one
process (1e-5); the presets' dropout against one process (1e-5);
``decode_split`` greedy and beam 2; a checkpoint that crosses sequence
axes.  ``tests/test_torch_tensor_parallel.py`` runs data 2 x model 2,
data 2 x sequence 2 and model 2 x sequence 2.
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
from image_caption_tpu.train.state import create_train_state as jax_state
from image_caption_tpu.train.state import \
    zero_pad_embedding_grad as jax_zero_pad
from image_caption_tpu.train.step import eval_step as jax_eval_step
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
from image_caption_tpu_torch.train.checkpoint import CheckpointManager
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
# the flagship's XE counterpart: the pair block and the encoder mask
SPLIT = "maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
FOCAL = "maxlen49_36obj_1wordCount_256_25b_32h_FocalLoss"
# caption lengths of the global batch's 8 rows: rank 0 holds short
# captions, rank 1 long ones, so the ranks' non-pad target counts differ
LENGTHS = (3, 4, 3, 5, 9, 10, 8, 10)
STEPS = 2
TP_STEPS = 3
# the tensor-parallel cases' depth: one block of each kind (the flagship's
# pair block too), the layers' sharding checked at the least compile time
SHALLOW = {"model.encode_num_blocks": 1, "model.decode_num_blocks": 1}
# 8 slots, which a sequence axis of 2 divides (NARROW's 7 do not)
SP_SLOTS = {"model.num_objects": 7}
SP = (1, 1, WORLD)
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
    trainer.load_state_dict(case["weights"])
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


def _jax_grads(cfg, params, batch):
    """The JAX step's gradients at ``params`` on ``batch``, dropout off,
    the pad row zeroed, as the port's state_dict."""
    grads = jax.jit(jax.grad(lambda p: jax_eval_step(
        p, tuple(map(jax.numpy.asarray, batch)), cfg=cfg)["loss"]))(params)
    return state_dict_from_jax_params(
        jax.device_get(jax_zero_pad(grads, cfg.model.pad_idx)), cfg.model)


def _jax_tp(cfg, mesh, batches, vocab=None):
    """A JAX trainer on the tensor-parallel ``mesh``, stepped on
    ``batches`` (an RL one two-phase, its scored samples recorded)."""
    rng = jax.random.PRNGKey(0)
    if vocab is None:
        return _jax_steps(JTrainer(cfg, mesh=mesh, rng=rng), batches)
    ref = JRLTrainer(cfg, vocab, mesh=mesh, rng=rng, two_phase=True)
    scored = _record_scores(ref)
    return _jax_steps(ref, batches) + (scored,)


def _jax_scan(cfg, mesh, batches):
    """One scanned dispatch of ``batches`` by a JAX trainer on ``mesh``:
    the losses [K], the weights after, and the stacked features'
    partition spec."""
    trainer = JTrainer(cfg, mesh=mesh, rng=jax.random.PRNGKey(0))
    stacked = trainer.shard_stacked(batches)
    losses = np.asarray(trainer.train_steps_device(stacked)["loss"])
    return (losses, jax.device_get(trainer.state.params),
            str(stacked[0].sharding.spec))


def _record_scores(trainer):
    """The sampled sequences and rewards a JAX trainer scores on the
    host, in order."""
    seen, score = [], trainer._host_rewards

    def kept(sample_seq, captions):
        rewards = score(sample_seq, captions)
        seen.append((np.asarray(sample_seq), np.asarray(rewards[0])))
        return rewards
    trainer._host_rewards = kept
    return seen


def _tp_case(preset, over, seed, mesh, vocab=None, df_dir=None):
    """A tensor-parallel case of ``TP_STEPS`` global batches on the
    (data, model) ``mesh``, shallow, dropout off, from the JAX package's
    initial weights for ``PRNGKey(0)`` (what its trainers start from): the
    JAX config, the case, and those weights.  An RL case writes its frozen
    CIDEr df over its batches' captions to ``df_dir``."""
    over = {**over, **NO_DROPOUT, **SHALLOW}
    if df_dir is not None:
        over.update({"data.data_path": str(df_dir), "rl.pipeline_depth": 1})
    jcfg, tcfg = _cfgs(preset, over)
    batches = [_batch(jcfg, seed + s) for s in range(TP_STEPS)]
    if df_dir is not None:
        df_dir.mkdir()
        caps = decode_captions(np.concatenate([b[2] for b in batches]),
                               {i: w for w, i in vocab.items()})
        save_doc_frequency(build_doc_frequency([c] for c in caps),
                           str(df_dir / "coco-val-df.p"))
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    params = jax.device_get(jax_state(jcfg, init_rng).params)
    case = {"kind": "steps", "cfg": tcfg, "mesh": mesh, "batches": batches,
            "weights": state_dict_from_jax_params(params, jcfg.model)}
    if vocab is not None:
        case["vocab"] = vocab
    return jcfg, case, params


def _tp_checkpoint(case, path):
    """Epoch 1 written by one process after one update on ``batch``."""
    trainer = make_trainer(case["cfg"], device="cpu", seed=0)
    trainer.load_state_dict(case["weights"])
    trainer.train_step(*case["first"])
    CheckpointManager(str(path)).save(1, trainer.state)


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    work = tmp_path_factory.mktemp("dp")
    jmesh = jax_mesh(jax.devices()[:WORLD])
    rng = jax.random.PRNGKey(0)
    inputs, jax_runs, initial = {}, {}, {}

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
    # tensor parallel, data 1 x model 2; the JAX package's sharded
    # trainers are built and stepped in the threads below
    jmesh_tp = jax_mesh(jax.devices()[:WORLD], data=1, model=2)
    tp_cfgs = {}
    for name, preset, over, extra in (
            ("tp_xe", "maxlen49_64", TINY, {}),
            ("tp_focal", FOCAL, NARROW, {}),
            ("tp_scst", RL, NARROW, {"vocab": vocab,
                                     "df_dir": work / "df_tp"})):
        tp_cfgs[name], inputs[name], initial[name] = _tp_case(
            preset, over, 40, (1, WORLD), **extra)
    # the presets' dropout (0.3, attention 0.1): against one process only
    inputs["tp_dropout"] = dict(inputs["tp_focal"],
                                cfg=get_preset(FOCAL).with_overrides(
                                    **{**NARROW, **SHALLOW}))
    # sequence parallel, data 1 x sequence 2 (the JAX mesh data=1,
    # sequence=2); sp_fallback's 7 slots do not divide
    jmesh_sp = jax_mesh(jax.devices()[:WORLD], data=1, sequence=WORLD)
    sp_cfgs = {}
    for name, preset, over, extra in (
            ("sp_xe", SPLIT, {**NARROW, **SP_SLOTS}, {}),
            ("sp_focal", FOCAL, {**NARROW, **SP_SLOTS}, {}),
            ("sp_fallback", SPLIT, NARROW, {}),
            ("sp_scst", RL, {**NARROW, **SP_SLOTS},
             {"vocab": vocab, "df_dir": work / "df_sp"})):
        sp_cfgs[name], inputs[name], initial[name] = _tp_case(
            preset, over, 60, SP, **extra)
    scan_over = {"train.scan_steps": 2}
    sp_cfgs["sp_scan"] = sp_cfgs["sp_xe"].with_overrides(**scan_over)
    inputs["sp_scan"] = dict(
        inputs["sp_xe"], kind="scan",
        cfg=inputs["sp_xe"]["cfg"].with_overrides(**scan_over),
        batches=inputs["sp_xe"]["batches"][:2])
    inputs["sp_dropout"] = dict(inputs["sp_xe"],
                                cfg=get_preset(SPLIT).with_overrides(
                                    **{**NARROW, **SP_SLOTS, **SHALLOW}))
    ckpt_dir = work / "ckpt"
    inputs["tp_checkpoint"] = {
        "kind": "checkpoint", "cfg": inputs["tp_focal"]["cfg"],
        "mesh": (1, WORLD), "weights": inputs["tp_focal"]["weights"],
        "first": inputs["tp_focal"]["batches"][0],
        "batch": inputs["tp_focal"]["batches"][1], "dir": str(ckpt_dir)}
    _tp_checkpoint(inputs["tp_checkpoint"], ckpt_dir)
    inputs["sp_checkpoint"] = dict(
        inputs["tp_checkpoint"], cfg=inputs["sp_xe"]["cfg"], mesh=SP,
        weights=inputs["sp_xe"]["weights"],
        first=inputs["sp_xe"]["batches"][0],
        batch=inputs["sp_xe"]["batches"][1], dir=str(work / "ckpt_sp"))
    _tp_checkpoint(inputs["sp_checkpoint"], work / "ckpt_sp")

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
    inputs["tp_decode"] = dict(inputs["decode"], mesh=(1, WORLD))
    inputs["sp_decode"] = dict(inputs["decode"], mesh=SP)
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
        # the JAX references trace and compile in threads, side by side,
        # while the port runs in one process here
        with ThreadPoolExecutor(16) as pool:
            futures = {name: pool.submit(_jax_steps, ref,
                                         inputs[name]["batches"])
                       for name, (ref, _) in jax_runs.items()}
            for cfgs, mesh in ((tp_cfgs, jmesh_tp), (sp_cfgs, jmesh_sp)):
                for name, cfg in cfgs.items():
                    if name == "sp_scan":
                        futures[name] = pool.submit(
                            _jax_scan, cfg, mesh, inputs[name]["batches"])
                        continue
                    futures[name] = pool.submit(
                        _jax_tp, cfg, mesh, inputs[name]["batches"],
                        inputs[name].get("vocab"))
            for name, mesh in (("decode", jmesh), ("tp_decode", jmesh_tp),
                               ("sp_decode", jmesh_sp)):
                futures[name] = pool.submit(lambda mesh: {
                    beam: jax_decode_split(
                        jax_initial, jax_runs["scst_frozen"][1],
                        JCocoSplit(*split), 4, idx_to_word, beam_size=beam,
                        mesh=mesh)
                    for beam in (None, 2)}, mesh)
            grads = {name: pool.submit(
                _jax_grads, tp_cfgs[name], initial[name],
                inputs[name]["batches"][0]) for name in ("tp_xe", "tp_focal")}
            threads = torch.get_num_threads()
            torch.set_num_threads(1)       # beside the JAX threads
            try:
                single = {name: _single(inputs[name])
                          for name in ("xe", "focal", "scst_frozen",
                                       "scst_corpus", "tp_xe", "tp_focal",
                                       "tp_scst", "tp_dropout", "sp_xe",
                                       "sp_focal", "sp_fallback", "sp_scst",
                                       "sp_scan", "sp_dropout")}
            finally:
                torch.set_num_threads(threads)
            jax_out = {name: f.result() for name, f in futures.items()}
            jax_out["grads"] = {n: f.result() for n, f in grads.items()}
        jax_out["tp_scst_scored"] = jax_out["tp_scst"][2]
        jax_out["sp_scst_scored"] = jax_out["sp_scst"][2]
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
    single["tp_checkpoint"] = _after_checkpoint(inputs["tp_checkpoint"],
                                                ckpt_dir)
    single["sp_checkpoint"] = _after_checkpoint(inputs["sp_checkpoint"],
                                                work / "ckpt_sp")
    return {"inputs": inputs, "jax": jax_out, "single": single,
            "ranks": ranks}


def _after_checkpoint(case, path):
    """One process from the checkpoint of epoch 1, one update on the
    ranks' batch; then epoch 2 (the ranks') restored in one process."""
    ckpt = CheckpointManager(str(path))
    trainer = make_trainer(case["cfg"], device="cpu", seed=1)
    trainer.restore(ckpt, 1)
    loss = trainer.train_step(*case["batch"])["loss"]
    mine = trainer.state.optimizer.state_dict()["state"]
    again = make_trainer(case["cfg"], device="cpu", seed=2)
    again.restore(ckpt, 2)
    saved = torch.load(ckpt.path(2), weights_only=True)
    return {"loss": loss, "weights": trainer.state.model.state_dict(),
            "moments": mine, "epoch1": torch.load(
                ckpt.path(1), weights_only=True)["model"],
            "saved": saved, "restored2": again.state.model.state_dict(),
            "step2": again.state.step}


def _rel(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _check_steps(dp, name, keys, jax_tol=1e-5):
    """Each rank's losses within 2e-4 of the JAX mesh's and the single
    process's, its weights within ``jax_tol`` norm-relative per tensor of
    the JAX mesh's and 1e-5 of the single process's, its step-1 gradients
    (summed over the ranks, in the full layout) within 1e-5 of the single
    process's, and its deterministic metrics the single process's."""
    want, jparams = dp["jax"][name][:2]
    single = dp["single"][name]
    jw = state_dict_from_jax_params(jparams, dp["inputs"][name]["cfg"].model)
    steps = len(dp["inputs"][name]["batches"])
    for rank, out in enumerate(dp["ranks"]):
        got = out[name]
        assert len(got["metrics"]) == steps, (rank, got["metrics"])
        for i, m in enumerate(got["metrics"]):
            for k in keys:
                assert abs(m[k] - want[i][k]) <= 2e-4, (rank, i, k)
                assert abs(m[k] - single["metrics"][i][k]) <= 2e-4, \
                    (rank, i, k)
        for k in keys:
            assert abs(got["eval"][k] - single["eval"][k]) <= 2e-4, k
        for n, v in got["weights"].items():
            assert _rel(v, jw[n]) <= jax_tol, (rank, n, _rel(v, jw[n]))
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


# ---------------------------------------------------------------------------
# Tensor parallelism: model 2, the JAX package's mesh data=1, model=2
# ---------------------------------------------------------------------------

def _check_tp_grads(dp, name):
    """Step-1 gradients in the full layout within 1e-4 norm-relative per
    tensor of the JAX package's."""
    want = dp["jax"]["grads"][name]
    for rank, out in enumerate(dp["ranks"]):
        for n, g in out[name]["grads"].items():
            assert _rel(g, want[n]) <= 1e-4, (rank, n, _rel(g, want[n]))


@pytest.mark.parametrize("name", ["tp_xe", "tp_focal"])
def test_tp_steps_match_jax_sharded_step(dp, name):
    cfg = dp["inputs"][name]["cfg"].model
    assert dp["inputs"][name]["mesh"] == (1, WORLD)
    assert (cfg.xe_loss == "focal") == (name == "tp_focal")
    assert cfg.move_first_image_feature == (name == "tp_focal")
    _check_steps(dp, name, ("loss",), jax_tol=1e-4)
    _check_tp_grads(dp, name)
    # the pad row of the word embedding stays frozen
    pad = cfg.pad_idx
    start = dp["inputs"][name]["weights"]["decoder.word_embedding.weight"]
    for out in dp["ranks"]:
        got = out[name]["weights"]["decoder.word_embedding.weight"]
        assert torch.equal(got[pad], start[pad])


def test_tp_scst_samples_and_rewards_match_jax(dp):
    """Pipelined argmax SCST on the JAX mesh's sharded steps: every
    sampled sequence and reward equal, the metrics within the bars."""
    assert dp["inputs"]["tp_scst"]["cfg"].rl.sample_mode == "argmax"
    want = dp["jax"]["tp_scst_scored"]
    assert len(want) == TP_STEPS
    for out in dp["ranks"]:
        got = out["tp_scst"]["scored"]
        assert len(got) == len(want)
        for (seq, rew), (wseq, wrew) in zip(got, want):
            np.testing.assert_array_equal(seq, wseq)
            np.testing.assert_array_equal(rew, wrew)
        assert any(r.any() for _, r in got)
    _check_steps(dp, "tp_scst", KEYS, jax_tol=1e-4)


def test_tp_follows_one_process_at_the_presets_dropout(dp):
    """At dropout 0.3 and attention dropout 0.1 the ranks draw one
    process's masks (the attention's head by head): losses and gathered
    weights within 1e-5 relative of one process's."""
    m = dp["inputs"]["tp_dropout"]["cfg"].model
    assert (m.dropout, m.attention_dropout) == (0.3, 0.1)
    single = dp["single"]["tp_dropout"]
    for out in dp["ranks"]:
        got = out["tp_dropout"]
        for a, b in zip(got["metrics"], single["metrics"]):
            assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        for n, v in got["weights"].items():
            assert _rel(v, single["weights"][n]) <= 1e-5, n
    # dropout changed the trajectory: not the run without it
    off = dp["single"]["tp_focal"]["metrics"][1]["loss"]
    assert single["metrics"][1]["loss"] != off


@pytest.mark.parametrize("name", ["tp_xe", "tp_focal", "tp_scst",
                                  "tp_dropout"])
def test_tp_ranks_hold_bitwise_equal_full_weights(dp, name):
    a, b = (out[name]["weights"] for out in dp["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("beam", [None, 2])
def test_tp_decode_split_matches_jax_mesh(dp, beam):
    want = dp["jax"]["tp_decode"][beam]
    assert want == dp["jax"]["decode"][beam]
    for out in dp["ranks"]:
        assert out["tp_decode"][beam] == want


def test_tp_checkpoint_crosses_model_axes(dp):
    """A checkpoint written by one process restores at model 2 bit for
    bit; the ranks' update from it, saved at model 2 in the full layout,
    is one process's update within 1e-5 (weights and Adam's moments), and
    restores in one process as it was saved."""
    _check_checkpoint(dp, "tp_checkpoint")


def _check_checkpoint(dp, name):
    after = dp["single"][name]
    for out in dp["ranks"]:
        got = out[name]
        assert all(torch.equal(got["restored"][k], after["epoch1"][k])
                   for k in after["epoch1"])
        assert abs(got["loss"] - after["loss"]) <= 1e-5 * after["loss"]
    saved = after["saved"]
    assert saved["step"] == after["step2"] == 2
    for n, v in saved["model"].items():
        assert _rel(v, after["weights"][n]) <= 1e-5, n
        assert torch.equal(after["restored2"][n], v), n
    moments = saved["optimizer"]["state"]
    assert moments.keys() == after["moments"].keys()
    for i, st in moments.items():
        for key in ("exp_avg", "exp_avg_sq"):
            want = after["moments"][i][key]
            assert st[key].shape == want.shape
            assert _rel(st[key], want) <= 1e-5, (i, key)


# ---------------------------------------------------------------------------
# Sequence parallelism: sequence 2, the JAX package's mesh data=1,
# sequence=2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sp_xe", "sp_focal", "sp_fallback"])
def test_sp_steps_match_jax_mesh(dp, name):
    """XE on the flagship family (the pair block and the causal encoder
    mask across the two slot blocks), focal with the decoder's tail FFN,
    and the fallback whose 7 slots the axis does not divide: the ranks
    hold the same rows, slot block r (every slot in the fallback), and
    take the JAX mesh's steps (losses 2e-4, weights 1e-4) and one
    process's (1e-5, gradients too)."""
    case = dp["inputs"][name]
    m = case["cfg"].model
    assert case["mesh"] == SP
    assert (m.encode_mask and m.split_image_objects) == (name != "sp_focal")
    assert m.move_first_image_feature == (name == "sp_focal")
    slots = case["batches"][0][0][..., 0]
    for r, out in enumerate(dp["ranks"]):
        np.testing.assert_array_equal(out[name]["rows"],
                                      case["batches"][0][2])
        want = (slots if name == "sp_fallback"
                else slots[:, 4 * r:4 * (r + 1)])
        np.testing.assert_array_equal(out[name]["slots"], want)
    assert m.num_slots == (7 if name == "sp_fallback" else 8)
    _check_steps(dp, name, ("loss",), jax_tol=1e-4)


def test_sp_scst_samples_and_rewards_match_jax(dp):
    """Pipelined argmax SCST at 8 slots on sequence 2: both ranks sample
    and score every row as the JAX mesh does, the metrics within the
    bars."""
    assert dp["inputs"]["sp_scst"]["cfg"].rl.sample_mode == "argmax"
    want = dp["jax"]["sp_scst_scored"]
    assert len(want) == TP_STEPS
    for out in dp["ranks"]:
        got = out["sp_scst"]["scored"]
        assert len(got) == len(want)
        for (seq, rew), (wseq, wrew) in zip(got, want):
            np.testing.assert_array_equal(seq, wseq)
            np.testing.assert_array_equal(rew, wrew)
        assert any(r.any() for _, r in got)
    _check_steps(dp, "sp_scst", KEYS, jax_tol=1e-4)


def test_sp_scan_matches_jax_scanned_dispatch(dp):
    """``train.scan_steps`` 2: one scanned dispatch on stacked batches
    whose slots are sharded (in the JAX package too), the JAX dispatch's
    losses within 2e-4 and weights 1e-4, one process's 1e-5."""
    case = dp["inputs"]["sp_scan"]
    losses, jparams, spec = dp["jax"]["sp_scan"]
    assert "sequence" in spec
    jw = state_dict_from_jax_params(jparams, case["cfg"].model)
    single = dp["single"]["sp_scan"]
    slots = np.stack([b[0] for b in case["batches"]])[..., 0]
    for r, out in enumerate(dp["ranks"]):
        got = out["sp_scan"]
        np.testing.assert_array_equal(got["features"][..., 0],
                                      slots[:, :, 4 * r:4 * (r + 1)])
        assert len(got["losses"]) == 2
        for a, b, c in zip(got["losses"], losses, single["metrics"]):
            assert abs(a - float(b)) <= 2e-4 and abs(a - c["loss"]) <= 2e-4
        for n, v in got["weights"].items():
            assert _rel(v, jw[n]) <= 1e-4, n
            assert _rel(v, single["weights"][n]) <= 1e-5, n


def test_sp_follows_one_process_at_the_presets_dropout(dp):
    """At dropout 0.3 and attention dropout 0.1 each rank draws one
    process's masks and keeps its slots' part (the pair block's rows,
    the encoder's query rows): losses and weights within 1e-5 relative
    of one process's."""
    m = dp["inputs"]["sp_dropout"]["cfg"].model
    assert (m.dropout, m.attention_dropout) == (0.3, 0.1)
    assert m.split_image_objects and m.encode_mask
    single = dp["single"]["sp_dropout"]
    for out in dp["ranks"]:
        got = out["sp_dropout"]
        for a, b in zip(got["metrics"], single["metrics"]):
            assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        for n, v in got["weights"].items():
            assert _rel(v, single["weights"][n]) <= 1e-5, n
    off = dp["single"]["sp_xe"]["metrics"][1]["loss"]
    assert single["metrics"][1]["loss"] != off


@pytest.mark.parametrize("name", ["sp_xe", "sp_focal", "sp_fallback",
                                  "sp_scst", "sp_scan", "sp_dropout"])
def test_sp_ranks_hold_bitwise_equal_weights(dp, name):
    a, b = (out[name]["weights"] for out in dp["ranks"])
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("beam", [None, 2])
def test_sp_decode_split_matches_jax_mesh(dp, beam):
    """Decode over data only on a sequence mesh: each rank decodes every
    row on every slot, as the JAX package's sequence mesh does."""
    want = dp["jax"]["sp_decode"][beam]
    assert want == dp["jax"]["decode"][beam]
    for out in dp["ranks"]:
        assert out["sp_decode"][beam] == want


def test_sp_checkpoint_crosses_sequence_axes(dp):
    """A checkpoint written by one process restores at sequence 2 bit for
    bit; the ranks' update, saved by sequence index 0, is one process's
    within 1e-5 and restores in one process as it was saved."""
    _check_checkpoint(dp, "sp_checkpoint")
