"""The training loop, ``main.py train``, on one device, data or tensor
parallel.

The counterpart of the JAX package's ``train/loop.py``, reproducing the
reference loop (``main.py:25-153``): per-``log_every`` loss lines on fixed
train and valid batches, per-``sample_every`` sample captions, and per
epoch the valid loss, the valid decode (``serve.decode_split``, with the
fused attention kernel), the coco metrics, the scores file, TensorBoard and
a checkpoint with resume from the latest.  ``make_trainer`` gives the XE
or focal ``Trainer``, or the self-critical ``RLTrainer`` for
``RL_Transformer``.

``train.scan_steps`` K > 1 runs the XE or focal ``Trainer``'s updates K
at a time, as the JAX package's scanned dispatch does: K batches are
stacked and copied to the device at once (``shard_stacked``), K updates
step over views of them, and the epoch's remainder runs as single steps;
the ``[it N]`` lines, TensorBoard steps and samples fire at the first
chunk boundary past each multiple of their period.  The ``RLTrainer``
steps one batch at a time whatever K is, as in the JAX package (its
rewards are scored on the host mid-step).

Data parallelism (``train.data_axis``; ``parallel.mesh``): every process
runs the loop in lockstep on the same global batches and steps on its
data index's rows, one device each; the losses it reports are global.
Tensor parallelism (``train.model_axis`` k > 1, ``parallel.tensor``): the
k ranks of a model group hold one slice each of the sharded parameters and
run the same rows and the same dropout; decode (samples, the epoch's valid
decode, the RL eval) runs on a full replica gathered from the shards once
per update.  Sequence parallelism (a mesh of ``make_mesh(sequence=n)``,
``parallel.sequence``; no config field names it, as in the JAX package):
the n ranks of a sequence group hold the same rows, one block each of the
object slots, and whole parameters; decode runs on every slot.  Only the main process (rank 0) writes: log lines,
TensorBoard, sample captions, the candidates pickle and the scores file;
it saves the checkpoint, in the full layout, behind a barrier, and every
rank restores it.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import Config
from ..data.dataset import CaptionBatches, load_split
from ..data.prefetch import PinnedCopier, Prefetcher
from ..data.vocab import decode_captions, invert_vocab
from ..metrics.evaluate import is_scalar_score, score_captions
from ..models.captioner import Captioner
from ..models.decoding import beam_score_mode, beam_search, greedy_decode
from ..parallel.mesh import (Mesh, gather_rows, make_mesh, shard_batch,
                             shard_batch_stacked)
from ..parallel.tensor import full_state_dict, load_full_state_dict
from ..rl.rewards import RewardComputer
from ..rl.step import (RLSample, rl_eval_step, rl_sample, rl_train_step,
                       rl_update)
from ..serve import decode_split
from ..utils.debug import StepTimer, annotate, trace_step
from ..utils.device import DeviceLike, resolve_device
from ..utils.io import save_pickle
from ..utils.rng import fold_in
from ..utils.tree import tree_stack
from .checkpoint import CheckpointManager
from .logging import TensorBoardWriter, format_sample, write_scores
from .state import TrainState, create_train_state
from .step import eval_step, to_device, train_step, train_steps, unstack


class Trainer:
    """XE/focal trainer (the ``TRANSFORMER`` wrapper, core/models.py:81-135)
    on one device: the card unless ``device`` says otherwise.  The model's
    weights come from seed ``fold_in(seed, 0)`` and the dropout keys from
    ``fold_in(seed, 1)``; ``seed`` defaults to ``cfg.train.seed``.

    ``mesh`` (``parallel.mesh.make_mesh``): data, tensor and sequence
    parallelism over a process group, one device per process, which the
    trainer runs on.  Rank 0's weights are broadcast at construction, then
    sharded over the model axis; every host batch the trainer is given is
    the global batch, of which it steps on its data index's rows (and its
    sequence index's slots); data index ``d > 0`` draws its dropout from
    ``fold_in(key, d)``, so data index 0 keeps the single-process stream,
    and the ranks of a model or sequence group draw the same masks."""

    def __init__(self, cfg: Config, *, mesh: Optional[Mesh] = None,
                 device: DeviceLike = None, seed: Optional[int] = None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if len(mesh.devices) != 1:
                raise ValueError(
                    "a trainer drives one device per process: launch one "
                    "process per card (torchrun ... --distributed train)")
            device = mesh.devices[0] if device is None else device
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        self.step_seed = fold_in(seed, 1)
        if mesh is not None and mesh.offset:
            self.step_seed = fold_in(self.step_seed, mesh.offset)
        self.state: TrainState = create_train_state(
            cfg, device=self.device, seed=fold_in(seed, 0), mesh=mesh)
        self._replica: Optional[tuple] = None     # (step, full model)
        # the batches' copies to the card, off its compute stream
        self._copier = (PinnedCopier(self.device)
                        if self.device.type == "cuda" else None)

    def shard(self, batch):
        """This rank's block of a global host batch's (features, positions,
        captions): the rows of its data index, and the features' and
        positions' slots of its sequence index where the axis divides
        them, as the JAX package's ``Trainer.shard`` places them; all of
        it without a mesh."""
        batch = tuple(batch[:3])
        if self.mesh is None:
            return batch
        return shard_batch(self.mesh, batch,
                           num_slots=self.cfg.model.num_slots)[0]

    def _copy_span(self):
        """The span of a batch's copy: on the card its device interval is
        the copy on the copier's stream."""
        return annotate("train.to_device", device=True,
                        stream=self._copier and self._copier.stream)

    def to_device(self, batch):
        """This rank's rows of a global host batch (numpy or tensors) on
        the trainer's device; on the card through its ``PinnedCopier``."""
        with self._copy_span():
            return to_device(self.shard(batch), self.device, self._copier)

    def shard_stacked(self, batches):
        """K global host batches -> this rank's rows of them stacked
        [K, B, ...] on the device, one copy a leaf for the K steps of
        ``train_steps_device``."""
        with self._copy_span():
            batches = [tuple(b[:3]) for b in batches]
            stacked = (tree_stack(batches) if self.mesh is None
                       else shard_batch_stacked(
                           self.mesh, batches,
                           num_slots=self.cfg.model.num_slots)[0])
            return to_device(stacked, self.device, self._copier)

    def load_state_dict(self, state) -> None:
        """Weights of the reference layout (a full model's state_dict);
        this rank's slices of them under tensor parallelism."""
        load_full_state_dict(self.state.model, state)
        self._replica = None

    def restore(self, ckpt: CheckpointManager, epoch: int) -> None:
        """The train state of checkpoint ``epoch``."""
        ckpt.restore(epoch, self.state)
        self._replica = None

    def decode_model(self) -> Captioner:
        """The model that decodes: the trained one, or under tensor
        parallelism a full replica gathered from the shards (a collective:
        every rank of the model group calls it), made once per update and
        reused.  Decoding runs the encoder on every slot; the replica's
        teacher-forced forward (the RL eval) takes this rank's slots, as
        the trained model's does."""
        model = self.state.model
        if model.tp is None:
            return model
        if self._replica is None or self._replica[0] != self.state.step:
            replica = (Captioner(self.cfg.model, device=self.device)
                       if self._replica is None else self._replica[1])
            replica.load_state_dict(full_state_dict(model))
            replica.sp = model.sp
            self._replica = (self.state.step, replica)
        return self._replica[1]

    # -- single-step API (MODEL.train_step / compute_loss parity) ---------
    def train_step(self, features, positions, captions) -> Dict[str, float]:
        metrics = self.train_step_device(
            self.to_device((features, positions, captions)))
        return {k: float(v) for k, v in metrics.items()}

    def train_step_device(self, batch) -> Dict[str, torch.Tensor]:
        """Step on a batch already on the device; returns the metrics as
        device tensors, without waiting for them."""
        with annotate("train.step"):
            return train_step(self.state, batch, seed=self.step_seed,
                              mesh=self.mesh)

    def train_steps_device(self, stacked) -> Dict[str, torch.Tensor]:
        """K updates over a stacked device batch (``shard_stacked``), one
        per view along dim 0; metrics stacked [K] per key, equal to K
        ``train_step_device`` calls."""
        with annotate("train.step"):
            return train_steps(self.state, unstack(stacked),
                               seed=self.step_seed, mesh=self.mesh)

    def compute_loss(self, features, positions, captions
                     ) -> Dict[str, float]:
        metrics = eval_step(self.state.model,
                            self.to_device((features, positions, captions)),
                            mesh=self.mesh)
        return {k: float(v) for k, v in metrics.items()}

    def flush(self):
        """Nothing is in flight for the XE trainer; kept for the JAX
        package's interface.  Returns None."""
        return None

    def generate_caption(self, features, positions,
                         idx_to_word: Dict[int, str], *,
                         beam_size: Optional[int] = None,
                         return_attention: bool = False):
        """MODEL_init.generate_caption parity (core/models.py:34-60):
        greedy for beam_size None or 1, beam search above; returns
        (caption strings, attention or None)."""
        if beam_size is not None and beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {beam_size}")
        model = self.decode_model()
        if beam_size is None or beam_size == 1:
            tokens, attention = greedy_decode(
                model, features, positions,
                return_attention=return_attention, device=self.device)
        else:
            tokens = beam_search(model, features, positions,
                                 beam_size=beam_size,
                                 score_mode=beam_score_mode(
                                     self.cfg.caption_model),
                                 device=self.device)
            attention = None
        return decode_captions(tokens.cpu().numpy(), idx_to_word), attention

    @property
    def metric_keys(self) -> List[str]:
        return ["loss"]          # WRITE_LOG for XE (core/config.py:65-66)


class RLTrainer(Trainer):
    """Self-critical trainer (``SelfCriticNetwork``, core/models.py:
    138-211): the JAX package's two-phase schedule, sample -> score on the
    host -> update (``rl/step.py``), on one device or over a ``mesh`` as
    ``Trainer`` is.

    ``rl.pipeline_depth`` 0 is the serial schedule.  Depth 1 pipelines it:
    the first ``train_step_device`` call samples its batch and returns
    None; every later call scores the pending sample, updates with it, then
    samples its own batch from the updated weights, and returns the
    previous update's metrics.  Every sample sees the weights of the update
    before it, as in the serial schedule, so the two give the same
    trajectory; ``flush`` drains the pending update."""

    def __init__(self, cfg: Config, word_to_idx: Dict[str, int], *,
                 mesh: Optional[Mesh] = None, device: DeviceLike = None,
                 seed: Optional[int] = None):
        super().__init__(cfg, mesh=mesh, device=device, seed=seed)
        # the frozen CIDEr df (loss.py:112-116, df='coco-val'): the table
        # next to the splits, else metrics.cider's own resolution
        df_path = os.path.join(cfg.data.data_path, "coco-val-df.p")
        self.reward_computer = RewardComputer(
            word_to_idx,
            cider_reward_weight=cfg.rl.cider_reward_weight,
            bleu_reward_weight=cfg.rl.bleu_reward_weight,
            self_cider_reward_weight=cfg.rl.self_cider_reward_weight,
            cider_df=df_path if os.path.exists(df_path) else "coco-val")
        if mesh is not None and mesh.group is not None:
            # the df mode picks _host_rewards' branch (own rows, or an
            # all-gather): ranks that disagree would deadlock at the first
            # step, so fail before it
            flags = gather_rows(mesh, np.asarray(
                [self.reward_computer.uses_frozen_df], np.int32), world=True)
            if flags.min() != flags.max():
                raise RuntimeError(
                    f"frozen CIDEr df ({df_path}) exists on some ranks but "
                    "not others: the reward-scoring mode must agree. "
                    "Distribute coco-val-df.p to every host (or remove it "
                    "everywhere).")
        if (self.reward_computer.ciderD.df_fallback
                and (mesh is None or mesh.is_main)):
            print("[rl] WARNING: frozen CIDEr df not found "
                  f"({df_path}); RL rewards fall back to per-batch corpus "
                  "df — a DIFFERENT reward scale than the reference "
                  "(loss.py:112-116).  Run the 'features' ETL or "
                  "scripts/build_cider_df.py to generate it.")
        self._pipeline = cfg.rl.pipeline_depth > 0
        self._pending: Optional[RLSample] = None

    def _host_rewards(self, sample_seq: np.ndarray, captions: np.ndarray):
        """Score sampled sequences [B, N, T] against their captions on the
        host -> ([B, N] rewards, [B, N] self-CIDEr).

        Over a process group the rows are this data index's.  With a frozen
        CIDEr df (the production configuration, coco-val-df.p) a row's
        reward depends on that row alone, so each rank scores its own
        rows.  In corpus-df mode CIDEr's idf and reference length come from
        the scored set itself, so the ranks all-gather their rows, every
        rank scores the identical global corpus, and keeps its rows."""
        mesh = self.mesh
        if (mesh is None or mesh.group is None
                or self.reward_computer.uses_frozen_df):
            return self._score(sample_seq, captions)
        rewards, self_cider = self._score(gather_rows(mesh, sample_seq),
                                          gather_rows(mesh, captions))
        b = sample_seq.shape[0]
        rows = slice(mesh.offset * b, (mesh.offset + 1) * b)
        return rewards[rows], self_cider[rows]

    def _score(self, sample_seq: np.ndarray, captions: np.ndarray):
        b, n, t = sample_seq.shape
        flat = sample_seq.reshape(-1, t)
        target = np.repeat(captions[:, 1:], n, axis=0)
        rewards = self.reward_computer.structure_scores(flat, target)
        self_cider = self.reward_computer.self_cider_scores(flat,
                                                            group_size=n)
        return rewards.reshape(b, n), self_cider.reshape(b, n)

    def train_step_device(self, batch):
        """One SCST update on a device batch; metrics as device tensors.
        Pipelined: the previous update's metrics, None on the first call."""
        if not self._pipeline:
            return rl_train_step(self.state, batch, self.cfg,
                                 seed=self.step_seed,
                                 score=self._host_rewards, mesh=self.mesh)
        metrics = self.flush()
        self._pending = rl_sample(self.state, batch, self.cfg,
                                  seed=self.step_seed)
        return metrics

    def train_steps_device(self, stacked):
        """K updates over a stacked device batch and the drain of the
        pending one; metrics stacked [K] per key."""
        done = ([self.train_step_device(b) for b in unstack(stacked)]
                + [self.flush()])
        done = [m for m in done if m is not None]
        return {k: torch.stack([m[k] for m in done])
                for k in self.metric_keys}

    def flush(self):
        """Apply the pending pipelined update, if any, so that ``state`` is
        current: call before reading the weights.  Returns its metrics or
        None."""
        if self._pending is None:
            return None
        pending, self._pending = self._pending, None
        rewards, self_cider = self._host_rewards(*pending.host())
        return rl_update(self.state, pending, rewards, self_cider, self.cfg,
                         self.mesh)

    def train_step(self, features, positions, captions) -> Dict[str, float]:
        """One update, drained: this batch's metrics under either
        schedule."""
        metrics = self.train_step_device(
            self.to_device((features, positions, captions)))
        metrics = self.flush() or metrics
        return {k: float(v) for k, v in metrics.items()}

    def compute_loss(self, features, positions, captions
                     ) -> Dict[str, float]:
        self.flush()
        metrics = rl_eval_step(self.decode_model(), self.cfg,
                               self.to_device((features, positions,
                                               captions)),
                               score=self._host_rewards, mesh=self.mesh)
        return {k: float(v) for k, v in metrics.items()}

    @property
    def metric_keys(self) -> List[str]:
        # WRITE_LOG for RL (core/config.py:67-68)
        return ["loss", "language_model_loss", "structure_loss", "reward"]


def make_trainer(cfg: Config, word_to_idx: Optional[Dict[str, int]] = None,
                 **kw) -> Trainer:
    """CAPTION_MODEL dispatch (main.py:19-22): ``RLTrainer`` (which needs
    the vocabulary) for ``RL_Transformer``, else ``Trainer``."""
    if cfg.caption_model == "RL_Transformer":
        if word_to_idx is None:
            raise ValueError("the RL trainer scores captions: pass the "
                             "vocabulary (word_to_idx)")
        return RLTrainer(cfg, word_to_idx, **kw)
    return Trainer(cfg, **kw)


def train(cfg: Config, *, num_epochs: Optional[int] = None,
          resume: bool = True, verbose: bool = True,
          device: DeviceLike = None,
          mesh: Optional[Mesh] = None) -> TrainState:
    """Full training run (main.py:25-153 behaviour) on ``device`` (the card
    when None).  ``mesh`` None makes one from ``train.data_axis`` and
    ``train.model_axis``: over the process group when this process belongs
    to one (``parallel.distributed.initialize``), else over ``device``
    alone."""
    t = cfg.train
    d = cfg.data
    num_epochs = num_epochs or t.num_epochs
    if mesh is None:
        mesh = make_mesh([device], data=t.data_axis, model=t.model_axis)
    is_main = mesh.is_main
    verbose = verbose and is_main

    train_split = load_split(d.data_path, "train", verbose=verbose,
                             streaming=d.stream_features)
    valid_split = load_split(d.data_path, "valid", verbose=verbose,
                             streaming=d.stream_features,
                             load_references=True)
    word_to_idx = train_split.word_to_idx
    if word_to_idx is None:
        raise ValueError(f"{d.data_path}/train has no word_index.pkl")
    idx_to_word = invert_vocab(word_to_idx)

    trainer = make_trainer(cfg, word_to_idx, mesh=mesh)
    writer = TensorBoardWriter(os.path.join(d.output_path, "log"),
                               enabled=is_main)
    ckpt = CheckpointManager(os.path.join(d.output_path, "model"),
                             keep=t.keep_checkpoints)

    start_epoch = 1
    last = ckpt.latest_epoch() if resume else None
    seen = gather_rows(mesh, np.asarray([-1 if last is None else last]),
                       world=True)
    if seen.min() != seen.max():
        raise RuntimeError(f"the ranks see different latest checkpoints "
                           f"{seen.tolist()} under {ckpt.directory}: give "
                           "every rank the same output path")
    if last is not None:
        trainer.restore(ckpt, last)
        start_epoch = last + 1
        if verbose:
            print(f"[train] resumed from epoch {last}")

    train_batches = CaptionBatches(train_split, t.batch_size, seed=t.seed)
    valid_batches = CaptionBatches(valid_split, t.batch_size, shuffle=False)

    # fixed logging batches (main.py:45-55)
    fixed_train = next(train_batches.epoch(0))[:3]
    fixed_valid = next(iter(valid_batches))[:3]

    # train.scan_steps: K updates a dispatch, XE and focal only (the
    # RLTrainer scores its rewards on the host mid-step)
    scan_k = 1 if isinstance(trainer, RLTrainer) else max(1, t.scan_steps)

    def chunks(batches):
        """K batches at a time; the epoch's remainder one at a time."""
        buf = []
        for item in batches:
            buf.append(item)
            if len(buf) == scan_k:
                yield buf
                buf = []
        for item in buf:
            yield [item]

    def prepare(items):
        if len(items) == 1:
            return 1, trainer.to_device(items[0])
        return len(items), trainer.shard_stacked(items)

    global_it = 0               # per run, as the JAX package counts
    for epoch in range(start_epoch, num_epochs + 1):
        t0 = time.time()
        timer = StepTimer()
        # a background thread assembles the next chunks on the host
        prefetched = Prefetcher(chunks(train_batches.epoch(epoch)),
                                transform=prepare)
        for k, batch in prefetched:
            with annotate("train_step"):
                if k == 1:
                    trainer.train_step_device(batch)
                else:
                    trainer.train_steps_device(batch)
            timer.step(k)
            trace_step()
            prev_it, global_it = global_it, global_it + k

            # every rank evaluates (the losses are collectives); the main
            # one writes
            if global_it // t.log_every > prev_it // t.log_every:
                m_train = trainer.compute_loss(*fixed_train)
                m_valid = trainer.compute_loss(*fixed_valid)
                for key in trainer.metric_keys:
                    writer.write_batch(key, m_train[key], m_valid[key],
                                       global_it)
                if verbose:
                    print(f"[it {global_it}] "
                          + " ".join(f"{k}={m_train[k]:.4f}"
                                     for k in trainer.metric_keys))

            if global_it // t.sample_every > prev_it // t.sample_every:
                trainer.flush()       # the weights must be current
                trainer.decode_model()   # a collective under TP
                if is_main:
                    cap = trainer.generate_caption(
                        fixed_train[0][:1], fixed_train[1][:1],
                        idx_to_word)[0][0]
                    gts = decode_captions(fixed_train[2][:1], idx_to_word)
                    writer.write_text("sample", format_sample(cap, gts),
                                      global_it)
                    if verbose:
                        print(f"[sample it {global_it}] {cap}")

        # ---- per-epoch evaluation (main.py:104-149) ----
        with annotate("epoch_eval"):
            trainer.flush()           # drain the pipelined RL tail
            train_loss = _epoch_loss(trainer, train_batches,
                                     limit=len(valid_batches))
            valid_loss = _epoch_loss(trainer, valid_batches)
            for key in trainer.metric_keys:
                writer.write_epoch(key, train_loss[key], valid_loss[key],
                                   epoch)
            candidates = decode_split(trainer.decode_model(), cfg,
                                      valid_split, t.batch_size,
                                      idx_to_word, device=trainer.device,
                                      mesh=mesh)

        if is_main:
            save_pickle(candidates, os.path.join(
                d.output_path, "candidates", "valid.candidate.captions.pkl"))
            if valid_split.references is not None:
                hypo = {i: [c] for i, c in enumerate(candidates)}
                scores = score_captions(valid_split.references, hypo,
                                        verbose=verbose)
                write_scores(d.output_path, "valid", epoch, scores)
                for name, value in scores.items():
                    if is_scalar_score(value):
                        writer.write_scalar(f"metrics/valid_{name}", value,
                                            epoch)

        if epoch % t.checkpoint_every_epochs == 0:
            ckpt.save(epoch, trainer.state, mesh)
        if verbose:
            sps = timer.steps_per_sec
            print(f"[epoch {epoch}] train_loss={train_loss['loss']:.4f} "
                  f"valid_loss={valid_loss['loss']:.4f} "
                  f"({time.time() - t0:.1f}s"
                  + (f", {sps:.1f} steps/s" if sps else "") + ")")
        writer.flush()

    writer.close()
    return trainer.state


def _epoch_loss(trainer: Trainer, batches: CaptionBatches,
                limit: Optional[int] = None) -> Dict[str, float]:
    """Mean metrics over (up to ``limit``) batches.  The reference zips
    the train and valid loaders, cutting to the shorter (main.py:108-110);
    ``limit`` gives the same sample counts."""
    sums: Dict[str, float] = {}
    n = 0
    for i, (feats, poss, caps, _) in enumerate(batches):
        if limit is not None and i >= limit:
            break
        m = trainer.compute_loss(feats, poss, caps)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + v
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()}
