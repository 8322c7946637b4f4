"""The port's data 2 x model 2 mesh over four gloo processes on the CPU,
against the JAX package's sharded steps on its 2 x 2 mesh and the port's
single process.

One module-scoped run starts four ranks (``tests/torch_dp_worker.py``):
rank ``r`` holds data index ``r // 2`` and model index ``r % 2``.  The
cases: XE and focal steps whose data indices hold different pad counts
(losses 2e-4, full-layout gradients and weights 1e-4 of the JAX
package's, 1e-5 of one process's), pipelined argmax SCST with a frozen CIDEr df (every
sample and reward the JAX package's), and greedy ``decode_split``; the
ranks of a model group hold the same rows, and all four the same full
weights.  The same spawn runs XE with a sequence axis: data 2 x
sequence 2 and model 2 x sequence 2 on the flagship family at 8 slots,
against the JAX package's meshes of those shapes and one process.  Model
2 and sequence 2 alone are in ``tests/test_torch_distributed.py``.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from image_caption_tpu.data.dataset import CocoSplit as JCocoSplit
from image_caption_tpu.parallel.mesh import make_mesh as jax_mesh
from image_caption_tpu.train.loop import decode_split as jax_decode_split
from image_caption_tpu_torch.utils.weights import state_dict_from_jax_params

from conftest import make_fake_batch
from test_torch_distributed import (FOCAL, KEYS, NARROW, RL, ROOT, SP_SLOTS,
                                    SPLIT, TINY, TP_STEPS as STEPS, WORKER,
                                    _jax_grads, _jax_tp, _rel, _single,
                                    _tp_case, _vocab)

WORLD, MESH = 4, (2, 2)
# (data, model, sequence) meshes with a sequence axis of 2
SP_MESHES = {"dp_sp": (2, 1, 2), "mp_sp": (1, 2, 2)}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    work = tmp_path_factory.mktemp("tp22")
    jmesh = jax_mesh(jax.devices()[:WORLD], data=MESH[0], model=MESH[1])
    inputs, cfgs, initial = {}, {}, {}
    vocab = _vocab(NARROW["model.num_vocab"])
    for name, preset, over, extra in (
            ("xe", "maxlen49_64", TINY, {}),
            ("focal", FOCAL, NARROW, {}),
            ("scst", RL, NARROW, {"vocab": vocab, "df_dir": work / "df"})):
        cfgs[name], inputs[name], initial[name] = _tp_case(
            preset, over, 50, MESH, **extra)
    jmeshes = {}
    for name, shape in SP_MESHES.items():
        cfgs[name], inputs[name], _ = _tp_case(
            SPLIT, {**NARROW, **SP_SLOTS}, 80, shape)
        jmeshes[name] = jax_mesh(jax.devices()[:WORLD], *shape)
    jcfg, params = cfgs["scst"], initial["scst"]

    f, p, _ = make_fake_batch(jcfg, batch=8, seed=70)
    split = (f, p, np.zeros((8, 13), np.int32), np.arange(8),
             np.array([f"im{i}" for i in range(8)]))
    idx_to_word = {i: w for w, i in vocab.items()}
    inputs["decode"] = {"kind": "decode", "cfg": inputs["scst"]["cfg"],
                        "mesh": MESH,
                        "weights": inputs["scst"]["weights"],
                        "split": split, "batch_size": 4,
                        "idx_to_word": idx_to_word, "beams": (None,)}
    torch.save(inputs, work / "inputs.pt")

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD), str(work)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(WORLD)]
    try:
        with ThreadPoolExecutor(8) as pool:
            futures = {
                name: pool.submit(_jax_tp, cfgs[name], jmesh,
                                  inputs[name]["batches"],
                                  inputs[name].get("vocab"))
                for name in ("xe", "focal", "scst")}
            futures.update({
                name: pool.submit(_jax_tp, cfgs[name], jmeshes[name],
                                  inputs[name]["batches"])
                for name in SP_MESHES})
            futures.update({
                f"grads_{name}": pool.submit(
                    _jax_grads, cfgs[name], initial[name],
                    inputs[name]["batches"][0]) for name in ("xe", "focal")})
            futures["decode"] = pool.submit(
                jax_decode_split, params, cfgs["scst"], JCocoSplit(*split),
                4, idx_to_word, mesh=jmesh)
            threads = torch.get_num_threads()
            torch.set_num_threads(1)       # beside the JAX threads
            try:
                single = {name: _single(inputs[name])
                          for name in ("xe", "focal", "scst",
                                       *SP_MESHES)}
            finally:
                torch.set_num_threads(threads)
            jax_out = {name: f.result() for name, f in futures.items()}
    finally:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return {"inputs": inputs, "jax": jax_out, "single": single,
            "ranks": ranks}


def _check(tp, name, keys):
    """Every rank's losses within 2e-4 of the JAX mesh's and one
    process's, its full weights within 1e-4 of the JAX mesh's and 1e-5 of
    one process's."""
    want, jparams = tp["jax"][name][:2]
    single = tp["single"][name]
    jw = state_dict_from_jax_params(jparams,
                                    tp["inputs"][name]["cfg"].model)
    for rank, out in enumerate(tp["ranks"]):
        got = out[name]
        assert len(got["metrics"]) == STEPS
        for i, m in enumerate(got["metrics"]):
            for k in keys:
                assert abs(m[k] - want[i][k]) <= 2e-4, (rank, i, k)
                assert abs(m[k] - single["metrics"][i][k]) <= 2e-4
        for n, v in got["weights"].items():
            assert _rel(v, jw[n]) <= 1e-4, (rank, n)
            assert _rel(v, single["weights"][n]) <= 1e-5, (rank, n)
        for n, g in got["grads"].items():
            assert _rel(g, single["grads"][n]) <= 1e-5, (rank, n)


@pytest.mark.parametrize("name", ["xe", "focal"])
def test_tp22_steps_match_jax_mesh(tp, name):
    """XE, and focal with the decoder's tail FFN: the steps of the JAX
    package's 2 x 2 mesh, and its step-1 gradients in the full layout."""
    assert (tp["inputs"][name]["cfg"].model.xe_loss == "focal") == \
        (name == "focal")
    rows = [out[name]["rows"] for out in tp["ranks"]]
    glob = tp["inputs"][name]["batches"][0][2]
    # data index r // 2 holds the global batch's half r // 2
    for r, block in enumerate(rows):
        np.testing.assert_array_equal(block, glob[4 * (r // 2):
                                                  4 * (r // 2 + 1)])
    assert (rows[0][:, 1:] != 0).sum() != (rows[2][:, 1:] != 0).sum()
    _check(tp, name, ("loss",))
    want = tp["jax"][f"grads_{name}"]
    for out in tp["ranks"]:
        for n, g in out[name]["grads"].items():
            assert _rel(g, want[n]) <= 1e-4, n


def test_tp22_scst_samples_and_rewards_match_jax_mesh(tp):
    want = tp["jax"]["scst"][2]
    assert len(want) == STEPS
    for r, out in enumerate(tp["ranks"]):
        rows = slice(4 * (r // 2), 4 * (r // 2 + 1))
        got = out["scst"]["scored"]
        assert len(got) == STEPS
        for (seq, rew), (wseq, wrew) in zip(got, want):
            np.testing.assert_array_equal(seq, wseq[rows])
            np.testing.assert_array_equal(rew, wrew[rows])
    _check(tp, "scst", KEYS)


def test_tp22_ranks_hold_bitwise_equal_full_weights(tp):
    for name in ("xe", "focal", "scst"):
        first = tp["ranks"][0][name]["weights"]
        for out in tp["ranks"][1:]:
            assert all(torch.equal(out[name]["weights"][k], first[k])
                       for k in first), name


def test_tp22_decode_split_matches_jax_mesh(tp):
    want = tp["jax"]["decode"]
    for out in tp["ranks"]:
        assert out["decode"][None] == want


@pytest.mark.parametrize("name", sorted(SP_MESHES))
def test_sp22_steps_match_jax_mesh(tp, name):
    """XE with the slots split over a sequence axis of 2, beside a data
    axis or a model axis of 2: rank r holds data index r // 2 (dp_sp; all
    rows at mp_sp) and slot block r % 2, and takes the steps of the JAX
    package's mesh of the same shape (losses 2e-4, weights 1e-4) and one
    process's (1e-5, gradients in the full layout too)."""
    data, model, seq = SP_MESHES[name]
    case = tp["inputs"][name]
    assert case["mesh"] == SP_MESHES[name]
    assert case["cfg"].model.num_slots == 8
    rows = 8 // data
    glob, slots = case["batches"][0][2], case["batches"][0][0][..., 0]
    for r, out in enumerate(tp["ranks"]):
        d, s = r // (model * seq), r % seq
        block = slice(rows * d, rows * (d + 1))
        np.testing.assert_array_equal(out[name]["rows"], glob[block])
        np.testing.assert_array_equal(out[name]["slots"],
                                      slots[block, 4 * s:4 * (s + 1)])
    _check(tp, name, ("loss",))
    first = tp["ranks"][0][name]["weights"]
    for out in tp["ranks"][1:]:
        assert all(torch.equal(out[name]["weights"][k], first[k])
                   for k in first)
