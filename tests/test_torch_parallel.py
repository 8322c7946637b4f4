"""The port's mesh against the JAX package's on its 8 virtual CPU devices
(axis arithmetic, row blocks, the slot blocks of ``activation_sharding``,
the replica cache, the decode placement rule), a slot block's mask rows
and dropout, joining a process group, and ``train --profile`` /
``--debug-nans``.  Two-process runs are in ``test_torch_distributed.py``
and ``test_torch_distributed_cli.py``; sharded extraction in
``test_torch_sharded_extract.py``."""

import json
import shutil
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from image_caption_tpu.parallel import mesh as JM
from image_caption_tpu_torch.data.synthetic import generate_synthetic_dataset
from image_caption_tpu_torch.main import main as cli_main
from image_caption_tpu_torch.ops import masks as M
from image_caption_tpu_torch.parallel import distributed as TD
from image_caption_tpu_torch.parallel import mesh as TM

CPU = torch.device("cpu")


@pytest.mark.parametrize("n,data,model,sequence", [
    (8, -1, 1, 1), (8, 8, 1, 1), (4, -1, 1, 1), (1, -1, 1, 1),
    (8, 4, 1, 1), (8, 3, 1, 1), (2, 1, 1, 1), (8, -1, 1, 2),
    (8, 2, 2, 2), (4, 1, 1, 4), (8, 3, 1, 2), (6, -1, 2, 2)])
def test_make_mesh_axis_arithmetic_matches_jax(n, data, model, sequence):
    try:
        want = JM.make_mesh(jax.devices()[:n], data, model, sequence)
    except AssertionError:
        with pytest.raises(ValueError):
            TM.make_mesh(["cpu"] * n, data, model, sequence)
        return
    got = TM.make_mesh(["cpu"] * n, data, model, sequence)
    assert got.shape == dict(want.shape)
    assert got.devices == (CPU,) * n and got.group is None
    assert got.is_main and got.offset == 0


def _data_rows(jmesh, rows):
    """The rows ``data_sharding`` places on each device of ``jmesh``, in
    the order of ``jmesh.devices.ravel()``."""
    indices = NamedSharding(jmesh, PartitionSpec(JM.DATA_AXIS)) \
        .devices_indices_map((rows, 3))
    return [slice(r.start or 0, r.stop or rows) for r in
            (indices[d][0] for d in jmesh.devices.ravel())]


@pytest.mark.parametrize("axis", ["model", "sequence"])
def test_model_and_sequence_axes_raise_naming_the_roadmap(axis):
    """A model or a sequence axis builds the JAX package's mesh shape; in
    one process each device holds the rows of its data index, as
    ``data_sharding`` places them on the JAX mesh, and the slots of its
    sequence index, as ``activation_sharding`` places them; decode runs
    each data index once.  One process cannot build the axis over one
    device and names the launch that can."""
    for n, data, size in ((2, 1, 2), (8, 2, 4), (8, -1, 2), (4, 2, 2)):
        want = JM.make_mesh(jax.devices()[:n], data, **{axis: size})
        got = TM.make_mesh(["cpu"] * n, data, **{axis: size})
        assert got.shape == dict(want.shape)
        rows = _data_rows(want, 16)
        assert got.row_blocks(16) == rows
        assert len(got.over_data.devices) == got.shape["data"]
        assert got.over_data.row_blocks(16) == rows[::size]
        assert got.over_data.shape["model"] == 1
        assert got.over_data.shape["sequence"] == 1
        slots = JM.activation_sharding(want, 8).devices_indices_map(
            (16, 8, 3))
        blocks = got.slot_blocks(8)
        if axis == "model":
            assert blocks is None
            continue
        assert blocks == [slice(i.start or 0, i.stop or 8) for i in
                          (slots[d][1] for d in want.devices.ravel())]
        assert got.slot_blocks(7) is None
    with pytest.raises(ValueError, match="torchrun"):
        TM.make_mesh(["cpu"], **{axis: 2})


def test_trainer_refuses_a_one_process_sequence_mesh():
    """In one process a sequence axis only replicates; a trainer given
    such a mesh raises, naming the launch that runs it."""
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.train.loop import Trainer
    mesh = TM.make_mesh(["cpu"] * 2, data=1, sequence=2)
    assert mesh.shape == {"data": 1, "model": 1, "sequence": 2}
    with pytest.raises(ValueError, match="torchrun"):
        Trainer(get_preset("maxlen49_64"), mesh=mesh)


def _coords_mesh(data, model, sequence, d, m, s):
    """The mesh of the process-group rank at (d, m, s), without a group."""
    return TM.Mesh((CPU,), data, d, model=model, model_index=m,
                   sequence=sequence, sequence_index=s)


def _placed(arrays):
    """Each leaf's index tuple on every device of its JAX placement."""
    return [{sh.device: sh.index for sh in a.addressable_shards}
            for a in arrays]


@pytest.mark.parametrize("n,data,model,sequence", [
    (2, 1, 1, 2), (4, 2, 1, 2), (4, 1, 2, 2), (8, 2, 2, 2), (8, 2, 1, 4),
    (8, 4, 2, 1)])
@pytest.mark.parametrize("num_slots", [8, 7, None])
@pytest.mark.parametrize("stacked", [False, True])
def test_shard_batch_num_slots_matches_activation_sharding(
        n, data, model, sequence, num_slots, stacked):
    """``shard_batch`` and ``shard_batch_stacked`` with ``num_slots``
    give every device of a one-process mesh, and every rank of a process
    group at the same coordinates, exactly the block the JAX package
    places there: the slot dim split where the axis divides it, every
    slot where it does not (7 slots), data only for leaves of lower rank,
    another slot count, or ``num_slots=None``."""
    jmesh = JM.make_mesh(jax.devices()[:n], data, model, sequence)
    shapes = [(16, 8, 5), (16, 8, 3), (16, 13), (16, 6, 2), (16, 7, 3)]
    batch = [np.arange(np.prod(sh)).reshape(sh) for sh in shapes]
    if stacked:
        batches = [[x + 1000 * k for x in batch] for k in range(3)]
        full = [np.stack(xs) for xs in zip(*batches)]
        want = _placed(JM.shard_batch_stacked(jmesh, batches, num_slots))
    else:
        full = batch
        want = _placed(JM.shard_batch(jmesh, batch, num_slots))
    if num_slots == 8 and sequence > 1:
        # the JAX package does split the 8-slot leaves
        d = jmesh.devices.ravel()[0]
        assert want[0][d][1 + stacked] != slice(None)

    def shard(mesh):
        if stacked:
            return TM.shard_batch_stacked(mesh, batches, num_slots)
        return TM.shard_batch(mesh, batch, num_slots)

    single = shard(TM.make_mesh(["cpu"] * n, data, model, sequence))
    for j, (dev, (dd, m, s)) in enumerate(zip(
            jmesh.devices.ravel(),
            np.ndindex(data, model, sequence))):
        (rank,) = shard(_coords_mesh(data, model, sequence, dd, m, s))
        for leaf, x, placed in zip(range(len(shapes)), full, want):
            np.testing.assert_array_equal(single[j][leaf], x[placed[dev]])
            np.testing.assert_array_equal(rank[leaf], x[placed[dev]])


def test_mask_rows_of_a_slot_block_are_the_full_masks():
    """A rank's encoder mask (key-pad over every slot OR causal, its rows
    at the block's global offsets) is the rows of the one-process mask,
    and the cross mask of the full positions is the one-process one."""
    rng = np.random.RandomState(0)
    pos = torch.from_numpy(rng.rand(3, 12, 5).astype(np.float32))
    pos[0, 7:] = 0
    pos[2, 3:] = 0
    full = M.combine_masks(M.key_pad_mask_from_features(pos, 12),
                           M.subsequent_mask(3, 12))
    for n in (2, 3, 4):
        per = 12 // n
        for r in range(n):
            rows = slice(r * per, (r + 1) * per)
            got = M.combine_masks(M.key_pad_mask_from_features(pos, per),
                                  M.subsequent_mask(3, 12, rows=rows))
            assert got.shape == (3, per, 12)
            assert torch.equal(got, full[:, rows])


def test_dropout_parts_keep_one_process_draw():
    """``dropout(parts=)`` on a part of a tensor keeps exactly that part
    of the mask one process draws for the whole: heads (dim 1), slots
    (dim 1 of [B, S, D], dim 2 of the weights) and rows folded with the
    slots (dim 0 of the pair block's [B*S, 2, D]), alone and together."""
    from image_caption_tpu_torch.ops.attention import dropout
    x = torch.rand(2, 4, 6, 6) + 0.5

    def drop(t, parts=()):
        return dropout(t, 0.5, torch.Generator().manual_seed(7), False,
                       parts)
    full = drop(x)
    assert (full == 0).any() and (full != 0).any()
    heads, rows = slice(2, 4), slice(3, 6)
    got = drop(x[:, heads, rows].contiguous(),
               [(1, 2, 2, 4), (2, 3, 3, 6)])
    assert torch.equal(got, full[:, heads, rows])
    pair = torch.rand(3 * 6, 2, 5) + 0.5
    want = drop(pair).reshape(3, 6, 2, 5)[:, 2:4].reshape(6, 2, 5)
    local = pair.reshape(3, 6, 2, 5)[:, 2:4].reshape(6, 2, 5)
    assert torch.equal(drop(local, [(0, 2, 2, 6)]), want)


def test_model_axis_raises_through_the_cli(tmp_path):
    """Tensor parallelism needs one process per device: one process with
    train.model_axis=2 raises, naming the launch that runs it."""
    with pytest.raises(ValueError, match="torchrun"):
        cli_main(["--device", "cpu", "--set", "train.model_axis=2",
                  "--data-path", str(tmp_path), "--output-path",
                  str(tmp_path), "train"])


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_shard_batch_rows_match_data_sharding(n):
    rows = 16
    jmesh = JM.make_mesh(jax.devices()[:n])
    indices = NamedSharding(jmesh, PartitionSpec(JM.DATA_AXIS)) \
        .devices_indices_map((rows, 3))
    want = [np.arange(rows)[indices[d][0]] for d in jmesh.devices.ravel()]
    batch = (np.arange(rows * 3).reshape(rows, 3), torch.arange(rows))
    single = TM.shard_batch(TM.make_mesh(["cpu"] * n), batch)
    assert len(single) == n
    for i, (a, b) in enumerate(single):
        np.testing.assert_array_equal(a[:, 0] // 3, want[i])
        np.testing.assert_array_equal(b.numpy(), want[i])
    # a process-group rank holds its data index's rows
    for r in range(n):
        (block,) = TM.shard_batch(TM.Mesh((CPU,), n, r), batch)
        np.testing.assert_array_equal(block[1].numpy(), want[r])
    if n > 1:
        with pytest.raises(ValueError, match="not divisible"):
            TM.shard_batch(TM.make_mesh(["cpu"] * n), (np.zeros(rows + 1),))


def test_replicate_cached_keeps_the_jax_cache_behaviour(monkeypatch):
    """The same call sequence through both caches: the same hits, and the
    same entries in the same (LRU) order after every call."""
    monkeypatch.setattr(JM, "_REPLICATED_CACHE", {})
    monkeypatch.setattr(TM, "_REPLICATED_CACHE", {})
    jmesh = JM.make_mesh(jax.devices()[:2])
    tmesh = TM.make_mesh(["cpu"] * 2)
    jax_sets = {k: {"w": jnp.full((2,), i, jnp.float32)}
                for i, k in enumerate("abc")}
    port_sets = {k: torch.nn.Linear(2, 2) for k in "abc"}

    def trace(cache, module, mesh, sets):
        names = {id(v): k for k, v in sets.items()}
        seen, out = {}, []
        for k in "abacbab":
            got = module.replicate_cached(mesh, sets[k])
            out.append((k, seen.get(k) is got,
                        [names[key[0]] for key in cache()]))
            seen[k] = got
        return out

    want = trace(lambda: JM._REPLICATED_CACHE, JM, jmesh, jax_sets)
    got = trace(lambda: TM._REPLICATED_CACHE, TM, tmesh, port_sets)
    assert got == want
    # a, b, a (a hit refreshes a), c evicts b, b evicts a, a evicts c, b
    assert [h for _, h, _ in got] == [False, False, True, False, False,
                                      False, True]
    # one copy per device; a module already on the device is itself
    reps = TM.replicate_cached(tmesh, port_sets["a"])
    assert reps == [port_sets["a"]] * 2


@pytest.mark.parametrize("n,batch", [(0, 4), (1, 4), (2, 3), (2, 4),
                                     (8, 16), (8, 12)])
def test_decode_placement_rule_matches_jax(n, batch):
    params = {"w": np.zeros(2, np.float32)}
    jmesh = JM.make_mesh(jax.devices()[:n]) if n else None
    tmesh = TM.make_mesh(["cpu"] * n) if n else None
    _, jplace = JM.decode_placement(jmesh, params, batch)
    model = torch.nn.Linear(2, 2)
    replicas, place = TM.decode_placement(tmesh, model, batch)
    assert (place is None) == (jplace is None)
    if place is None:
        assert replicas is model
        return
    assert len(replicas) == n
    x = np.arange(batch)
    blocks = place(x)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), x)
    assert all(len(b) == batch // n for b in blocks)


def test_global_mean_without_a_group_is_the_local_mean():
    total, count = torch.tensor(6.0), torch.tensor(4.0)
    assert TM.global_mean(total, count).item() == 1.5
    assert TM.global_mean(total, torch.tensor(0.0)).item() == 6.0
    assert TM.gather_rows(None, np.arange(3)).tolist() == [0, 1, 2]


def test_initialize_noops_when_a_group_exists(monkeypatch):
    calls = []
    monkeypatch.setattr(TD, "_initialized", False)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    TD.initialize()
    TD.initialize("localhost:1", 2, 0)
    assert calls == [] and TD.is_initialized()


def test_initialize_needs_a_launcher_or_all_three_arguments(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        TD.initialize()
    with pytest.raises(ValueError, match="all of"):
        TD.initialize("localhost:1", 2)
    assert not TD.is_initialized()


def test_unreachable_coordinator_raises():
    """No silent single-process fallback: rank 1 of 2 with no rank 0
    listening times out and raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError):
        TD.initialize(f"127.0.0.1:{port}", 2, 1, backend="gloo", timeout=2)
    assert not TD.is_initialized()
    assert TD.rank() == 0 and TD.world_size() == 1


def test_rank_device_is_cuda_local_rank_unless_named(monkeypatch):
    assert TD.device("cpu") == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert TD.device() == TD.device("cuda") == torch.device("cuda", 1)
    assert TD.device("cuda:0") == torch.device("cuda", 0)
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(RuntimeError, match="no card"):
        TD.device()


@pytest.fixture(scope="module")
def tiny_data(tmp_path_factory):
    """A synthetic dataset for the maxlen49_64 preset cut to 7 slots, and
    the CLI flags that size the preset to it."""
    root = tmp_path_factory.mktemp("tiny_data")
    vocab = generate_synthetic_dataset(
        str(root), num_images={"train": 6, "valid": 4, "test": 2},
        num_slots=7, max_length=11, seed=3, feature_format="npy")
    flags = ["--device", "cpu", "--preset", "maxlen49_64",
             "--set", f"model.num_vocab={len(vocab)}",
             "--set", "model.max_length=13", "--set", "model.num_objects=6",
             "--set", "train.batch_size=8", "--data-path", str(root)]
    return root, flags


def test_train_profile_writes_a_chrome_trace(tiny_data, tmp_path):
    _, flags = tiny_data
    cli_main(flags + ["--output-path", str(tmp_path), "train", "--profile",
                      "--epochs", "1"])
    path = tmp_path / "profile" / "trace_rank0.json"
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train_step" in names and "epoch_eval" in names
    assert (tmp_path / "model" / "train_state_1.pt").exists()


def test_trace_keeps_a_bounded_window_of_a_long_run(tmp_path):
    """Over a run of many steps the trace holds the window's steps only,
    and is written when the window ends; a run that ends sooner is
    written at its end, without the warm-up step."""
    from image_caption_tpu_torch.utils import debug
    x = torch.ones(4)
    written_at = None
    with debug.trace(str(tmp_path / "long")):
        for i in range(400):
            with debug.annotate("train_step"):
                x = x * 1.0001
            debug.trace_step()
            if written_at is None and (tmp_path / "long"
                                       / "trace_rank0.json").exists():
                written_at = i
    assert written_at == debug.TRACE_WARMUP_STEPS + debug.TRACE_STEPS - 1
    with open(tmp_path / "long" / "trace_rank0.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e.get("name") == "train_step"]
    assert len(steps) == debug.TRACE_STEPS
    with debug.trace(str(tmp_path / "one")):
        with debug.annotate("train_step"):
            x = x * 1.0001
        debug.trace_step()
        with debug.annotate("epoch_eval"):
            x = x * 1.0001
    with open(tmp_path / "one" / "trace_rank0.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert "epoch_eval" in names and "train_step" not in names


def test_train_debug_nans_raises_on_a_nan_feature(tiny_data, tmp_path):
    root, flags = tiny_data
    cli_main(flags + ["--output-path", str(tmp_path / "clean"), "train",
                      "--debug-nans", "--epochs", "1"])
    assert not torch.is_anomaly_enabled()
    bad = tmp_path / "bad"
    shutil.copytree(root, bad)
    feats = np.load(bad / "train" / "train.features.npy")
    feats[1, 0, 0] = np.nan
    np.save(bad / "train" / "train.features.npy", feats)
    bad_flags = [f if f != str(root) else str(bad) for f in flags]
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        cli_main(bad_flags + ["--output-path", str(tmp_path / "bad_out"),
                              "train", "--debug-nans", "--epochs", "1"])
    assert not torch.is_anomaly_enabled()
