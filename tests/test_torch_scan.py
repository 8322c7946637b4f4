"""``train.scan_steps`` in the port against the JAX package's scanned
dispatch: K updates over one stacked batch, the chunked ``train()`` loop
(its final weights and the iterations its losses are logged at), and the
``RLTrainer``, which steps one batch at a time whatever K is."""

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from image_caption_tpu.parallel import mesh as JM
from image_caption_tpu.train import loop as JLOOP
from image_caption_tpu.train import state as JS
from image_caption_tpu.train import step as JSTEP
from image_caption_tpu_torch.data.synthetic import generate_synthetic_dataset
from image_caption_tpu_torch.train import loop as TLOOP
from image_caption_tpu_torch.train import state as TS
from image_caption_tpu_torch.utils.weights import state_dict_from_jax_params

from conftest import make_fake_batch

# dropout off, one decoder block (of the preset's three): the schedule
# and the updates are what is checked, at the least compile time
NO_DROPOUT = {"model.dropout": 0.0, "model.attention_dropout": 0.0,
              "model.decode_num_blocks": 1}
# 7 train images x 5 captions at batch 8: 5 steps an epoch, so K = 2 and 3
# both leave a remainder
SIZES = {"train": 7, "valid": 4, "test": 2}


def _rel(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _port_trainer(cfg, params=None, seed=7):
    tr = TLOOP.Trainer(cfg, device="cpu", seed=seed)
    if params is not None:
        tr.load_state_dict(state_dict_from_jax_params(params, cfg.model))
    return tr


def _jax_scan(cfg, batches):
    """The JAX package's K-step scanned dispatch from its initial weights:
    (initial params, the K losses, the params after)."""
    mesh = JM.make_mesh(jax.devices()[:1])
    state = JS.create_train_state(cfg, jax.random.PRNGKey(0))
    initial = jax.device_get(state.params)
    scan = JSTEP.compile_train_step_scan(cfg, mesh, state, donate=False)
    state, metrics = scan(state, JM.shard_batch_stacked(mesh, batches),
                          jax.random.PRNGKey(1))
    return initial, np.asarray(metrics["loss"]), jax.device_get(state.params)


def test_scanned_steps_match_sequential(runs, tiny_cfg):
    """K=4 updates over one stacked batch equal 4 single steps in the port
    (bitwise) and the JAX package's scanned dispatch (losses rtol 1e-5,
    parameters 1e-4 norm-relative per tensor)."""
    cfg = tiny_cfg.with_overrides(**NO_DROPOUT)
    batches = _scan_batches(cfg)
    initial, want_losses, params = runs["jax_scan"]
    want = state_dict_from_jax_params(params, cfg.model)
    scanned = _port_trainer(cfg, initial)
    stacked = scanned.shard_stacked(batches)
    assert stacked[0].shape[:2] == (4, 8) and stacked[2].dtype == torch.int64
    losses = scanned.train_steps_device(stacked)["loss"]
    single = _port_trainer(cfg, initial)
    ones = [single.train_step(*b)["loss"] for b in batches]
    assert scanned.state.step == single.state.step == 4
    assert losses.tolist() == ones
    np.testing.assert_allclose(losses.numpy(), want_losses, rtol=1e-5)
    got = scanned.state.model.state_dict()
    seq = single.state.model.state_dict()
    for n, w in want.items():
        assert torch.equal(got[n], seq[n]), n
        assert _rel(got[n], w) <= 1e-4, (n, _rel(got[n], w))


def _scan_batches(cfg):
    return [make_fake_batch(cfg, batch=8, seed=s) for s in range(4)]


def test_scanned_loop_matches_single_loop(tiny_cfg):
    """K=2 over 5 batches (the remainder one step) reaches the weights of
    K=1, bit for bit."""
    cfg = tiny_cfg.with_overrides(**NO_DROPOUT)
    batches = [make_fake_batch(cfg, batch=8, seed=s) for s in range(5)]

    def run(k):
        tr = _port_trainer(cfg.with_overrides(**{"train.scan_steps": k}))
        i = 0
        while i < len(batches):
            n = min(k, len(batches) - i)
            if n > 1:
                tr.train_steps_device(tr.shard_stacked(batches[i:i + n]))
            else:
                tr.train_step_device(tr.to_device(batches[i]))
            i += n
        return tr.state

    s1, s2 = run(1), run(2)
    assert s1.step == s2.step == 5
    a, b = s1.model.state_dict(), s2.model.state_dict()
    assert all(torch.equal(a[n], b[n]) for n in a)


class _Recorder:
    """A TensorBoard writer that keeps the loss pairs and the sample steps
    it is given; the runs below need no TensorBoard files."""

    def __init__(self, log_dir, enabled=True):
        self.batches, self.samples = [], []

    def write_batch(self, key, train_value, valid_value, step):
        self.batches.append((step, key, float(train_value)))

    def write_text(self, tag, text, step):
        self.samples.append(step)

    def __getattr__(self, name):
        return lambda *a, **k: None


@pytest.fixture(scope="module")
def data(tmp_path_factory, tiny_cfg):
    """A synthetic dataset of 7 train images for ``tiny_cfg``'s slots and
    caption length, and the settings of the runs on it (loss lines every 2
    iterations, samples every 3)."""
    root = tmp_path_factory.mktemp("scan")
    m = tiny_cfg.model
    vocab = generate_synthetic_dataset(
        str(root / "data"), num_images=SIZES, num_slots=m.num_slots,
        max_length=m.max_length - 2, seed=1)
    return root, {"model.num_vocab": len(vocab),
                  "data.data_path": str(root / "data"),
                  "train.batch_size": 8, "train.log_every": 2,
                  "train.sample_every": 3,
                  "train.checkpoint_every_epochs": 100}


@pytest.fixture(scope="module")
def runs(data, tiny_cfg):
    """``train()`` of both packages at K = 2 and 3 (JAX, one after the
    other, in a thread beside its K=4 scanned dispatch) and of the port at
    K = 1, 2 and 3, two epochs on the synthetic dataset, all dropout off,
    from the JAX package's initial weights: each run's writer and its
    final state."""
    root, over = data
    base = tiny_cfg.with_overrides(**NO_DROPOUT, **over)

    def cfg(k, pkg):
        return base.with_overrides(**{
            "train.scan_steps": k,
            "data.output_path": str(root / f"{pkg}{k}")})

    init_rng, _ = jax.random.split(jax.random.PRNGKey(base.train.seed))
    state = jax.device_get(JS.create_train_state(base, init_rng))
    initial = state_dict_from_jax_params(state.params, base.model)
    writers = {}

    def recorder(tag):
        def make(log_dir, enabled=True):
            writers[tag] = _Recorder(log_dir, enabled)
            return writers[tag]
        return make

    def jax_runs():
        out = {}
        for k in (2, 3):
            mp.setattr(JLOOP, "TensorBoardWriter", recorder(f"jax{k}"))
            out[k] = JLOOP.train(cfg(k, "jax"), num_epochs=2, verbose=False)
        return out

    def made_once(compile_fn):
        """The two JAX runs step the same function (their configurations
        differ only in ``scan_steps`` and the output path): compile it
        once."""
        made = []

        def get(*args, **kw):
            if not made:
                made.append(compile_fn(*args, **kw))
            return made[0]
        return get

    def initial_state(cfg_, rng):
        assert (np.asarray(rng) == np.asarray(init_rng)).all()
        return jax.tree_util.tree_map(jax.numpy.asarray, state)

    mesh = JM.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                   JM.MESH_AXES)
    mp = pytest.MonkeyPatch()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)               # beside the JAX threads
    try:
        # one device: the same function as the 8-device mesh, compiled
        # faster
        mp.setattr(JLOOP.pmesh, "make_mesh", lambda *a, **kw: mesh)
        mp.setattr(JLOOP, "create_train_state", initial_state)
        for name in ("compile_train_step", "compile_eval_step"):
            mp.setattr(JLOOP, name, made_once(getattr(JLOOP, name)))
        create = TS.create_train_state

        def from_jax(cfg_, **kw):
            state = create(cfg_, **kw)
            state.model.load_state_dict(initial)
            return state
        mp.setattr(TLOOP, "create_train_state", from_jax)
        with ThreadPoolExecutor(2) as pool:
            jax_states = pool.submit(jax_runs)
            scan = pool.submit(_jax_scan, tiny_cfg.with_overrides(
                **NO_DROPOUT), _scan_batches(tiny_cfg))
            port = {}
            for k in (1, 2, 3):
                mp.setattr(TLOOP, "TensorBoardWriter", recorder(f"port{k}"))
                port[k] = TLOOP.train(cfg(k, "port"), num_epochs=2,
                                      device="cpu")
            jax_states = jax_states.result()
            scan = scan.result()
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return {"writers": writers, "port": port, "jax": jax_states,
            "jax_scan": scan, "cfg": base}


@pytest.mark.parametrize("k", [2, 3])
def test_train_logs_at_the_jax_iterations(runs, k):
    """The loss lines and samples of ``train()`` at K fire at the JAX
    package's iterations (the first chunk boundary past each multiple of
    ``log_every`` and ``sample_every``), with the same losses within
    2e-4."""
    want = runs["writers"][f"jax{k}"].batches
    got = runs["writers"][f"port{k}"].batches
    assert runs["writers"][f"port{k}"].samples == \
        runs["writers"][f"jax{k}"].samples != []
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    every = runs["cfg"].train.log_every
    steps = sorted({s for s, _, _ in want})
    assert steps and any(s % every for s in steps), steps
    for (s, key, a), (_, _, b) in zip(got, want):
        assert key == "loss" and abs(a - b) <= 2e-4, (s, a, b)


def test_train_loop_scan_steps_matches_single(runs, capsys):
    """``train()`` at K = 2 and 3 ends at K = 1's weights, bit for bit,
    and at the JAX package's within 1e-4 norm-relative per tensor."""
    states = runs["port"]
    assert states[1].step == states[2].step == states[3].step == 10
    ref = states[1].model.state_dict()
    for k in (2, 3):
        got = states[k].model.state_dict()
        assert all(torch.equal(got[n], ref[n]) for n in ref), k
        want = state_dict_from_jax_params(
            jax.device_get(runs["jax"][k].params), runs["cfg"].model)
        for n, w in want.items():
            assert _rel(got[n], w) <= 1e-4, (k, n)


def test_rl_trainer_ignores_scan_steps(data, flagship_tiny_cfg,
                                       monkeypatch, capsys):
    """The RL trainer steps one batch a dispatch whatever K is, as the
    JAX package's loop does (its rewards are scored on the host
    mid-step): ``train()`` at K = 4 never stacks a batch, dispatches each
    of the epoch's 5 batches alone and logs at every multiple of 2."""
    root, over = data
    cfg = flagship_tiny_cfg.with_overrides(**over, **{
        "train.scan_steps": 4, "data.output_path": str(root / "rl")})
    stacked, single = [], []
    monkeypatch.setattr(TLOOP, "TensorBoardWriter", _Recorder)
    monkeypatch.setattr(TLOOP.Trainer, "shard_stacked",
                        lambda self, b: stacked.append(b))
    step = TLOOP.RLTrainer.train_step_device
    monkeypatch.setattr(TLOOP.RLTrainer, "train_step_device",
                        lambda self, b: single.append(b[0].shape[0])
                        or step(self, b))
    state = TLOOP.train(cfg, num_epochs=1, device="cpu")
    lines = [ln.split()[1] for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[it ")]
    assert stacked == [] and state.step == 5
    assert single == [8] * 5 and lines == ["2]", "4]"]
