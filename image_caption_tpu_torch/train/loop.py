"""The training loop, ``main.py train``, on one device.

The counterpart of the JAX package's ``train/loop.py``, reproducing the
reference loop (``main.py:25-153``): per-``log_every`` loss lines on fixed
train and valid batches, per-``sample_every`` sample captions, and per
epoch the valid loss, the valid decode (``serve.decode_split``, with the
fused attention kernel), the coco metrics, the scores file, TensorBoard and
a checkpoint with resume from the latest.  One GPU: the JAX package's
``data_axis``/``model_axis`` are not used.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import torch

from ..config import Config
from ..data.dataset import CaptionBatches, load_split
from ..data.prefetch import Prefetcher
from ..data.vocab import decode_captions, invert_vocab
from ..metrics.evaluate import is_scalar_score, score_captions
from ..models.decoding import beam_score_mode, beam_search, greedy_decode
from ..serve import decode_split
from ..utils.debug import StepTimer
from ..utils.device import DeviceLike, resolve_device
from ..utils.io import save_pickle
from ..utils.rng import fold_in
from .checkpoint import CheckpointManager
from .logging import TensorBoardWriter, format_sample, write_scores
from .state import TrainState, create_train_state
from .step import eval_step, to_device, train_step, train_steps


class Trainer:
    """XE/focal trainer (the ``TRANSFORMER`` wrapper, core/models.py:81-135)
    on one device: the card unless ``device`` says otherwise.  The model's
    weights come from seed ``fold_in(seed, 0)`` and the dropout keys from
    ``fold_in(seed, 1)``; ``seed`` defaults to ``cfg.train.seed``."""

    def __init__(self, cfg: Config, *, device: DeviceLike = None,
                 seed: Optional[int] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        seed = cfg.train.seed if seed is None else seed
        self.step_seed = fold_in(seed, 1)
        self.state: TrainState = create_train_state(
            cfg, device=self.device, seed=fold_in(seed, 0))

    def to_device(self, batch):
        """A host batch (numpy or tensors) onto the trainer's device."""
        return to_device(batch, self.device)

    # -- single-step API (MODEL.train_step / compute_loss parity) ---------
    def train_step(self, features, positions, captions) -> Dict[str, float]:
        metrics = self.train_step_device(
            self.to_device((features, positions, captions)))
        return {k: float(v) for k, v in metrics.items()}

    def train_step_device(self, batch) -> Dict[str, torch.Tensor]:
        """Step on a batch already on the device; returns the metrics as
        device tensors, without waiting for them."""
        return train_step(self.state, batch, seed=self.step_seed)

    def train_steps_device(self, batches) -> Dict[str, torch.Tensor]:
        """K updates over K device batches; metrics stacked [K] per key,
        equal to K ``train_step_device`` calls."""
        return train_steps(self.state, batches, seed=self.step_seed)

    def compute_loss(self, features, positions, captions
                     ) -> Dict[str, float]:
        metrics = eval_step(self.state.model,
                            self.to_device((features, positions, captions)))
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
        model = self.state.model
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


def make_trainer(cfg: Config, **kw) -> Trainer:
    """CAPTION_MODEL dispatch (main.py:19-22)."""
    if cfg.caption_model == "RL_Transformer":
        raise NotImplementedError(
            "self-critical (SCST) training of RL_Transformer is not ported "
            "yet: it comes with the port's SCST slice.  Train an XE preset "
            "(caption_model 'Transformer') instead.")
    return Trainer(cfg, **kw)


def train(cfg: Config, *, num_epochs: Optional[int] = None,
          resume: bool = True, verbose: bool = True,
          device: DeviceLike = None) -> TrainState:
    """Full training run (main.py:25-153 behaviour) on ``device`` (the card
    when None)."""
    t = cfg.train
    d = cfg.data
    num_epochs = num_epochs or t.num_epochs

    train_split = load_split(d.data_path, "train", verbose=verbose,
                             streaming=d.stream_features)
    valid_split = load_split(d.data_path, "valid", verbose=verbose,
                             streaming=d.stream_features,
                             load_references=True)
    word_to_idx = train_split.word_to_idx
    if word_to_idx is None:
        raise ValueError(f"{d.data_path}/train has no word_index.pkl")
    idx_to_word = invert_vocab(word_to_idx)

    trainer = make_trainer(cfg, device=device)
    writer = TensorBoardWriter(os.path.join(d.output_path, "log"))
    ckpt = CheckpointManager(os.path.join(d.output_path, "model"),
                             keep=t.keep_checkpoints)

    start_epoch = 1
    last = ckpt.latest_epoch() if resume else None
    if last is not None:
        trainer.state = ckpt.restore(last, trainer.state)
        start_epoch = last + 1
        if verbose:
            print(f"[train] resumed from epoch {last}")

    train_batches = CaptionBatches(train_split, t.batch_size, seed=t.seed)
    valid_batches = CaptionBatches(valid_split, t.batch_size, shuffle=False)

    # fixed logging batches (main.py:45-55)
    fixed_train = next(train_batches.epoch(0))[:3]
    fixed_valid = next(iter(valid_batches))[:3]

    global_it = trainer.state.step
    for epoch in range(start_epoch, num_epochs + 1):
        t0 = time.time()
        timer = StepTimer()
        # a background thread assembles the next batches on the host
        prefetched = Prefetcher(train_batches.epoch(epoch),
                                transform=trainer.to_device)
        for batch in prefetched:
            trainer.train_step_device(batch)
            timer.step()
            prev_it, global_it = global_it, global_it + 1

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
                cap = trainer.generate_caption(
                    fixed_train[0][:1], fixed_train[1][:1], idx_to_word)[0][0]
                gts = decode_captions(fixed_train[2][:1], idx_to_word)
                writer.write_text("sample", format_sample(cap, gts),
                                  global_it)
                if verbose:
                    print(f"[sample it {global_it}] {cap}")

        # ---- per-epoch evaluation (main.py:104-149) ----
        train_loss = _epoch_loss(trainer, train_batches,
                                 limit=len(valid_batches))
        valid_loss = _epoch_loss(trainer, valid_batches)
        for key in trainer.metric_keys:
            writer.write_epoch(key, train_loss[key], valid_loss[key], epoch)

        candidates = decode_split(trainer.state.model, cfg, valid_split,
                                  t.batch_size, idx_to_word,
                                  device=trainer.device)
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
            ckpt.save(epoch, trainer.state)
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
