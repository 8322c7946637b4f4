"""Self-critical train and eval steps, on one device, data or tensor
parallel.

The counterpart of the JAX package's ``rl/step.py`` (the two-phase
sample -> host score -> update schedule).  A step makes ONE teacher-forced
forward with gradient, under the dropout half of its key
``step_generator(seed, state.step)``; samples from its detached log-probs
with the other half; copies the [B, N, T] sequences (and the captions) to
the host; scores them there; forms ``rl_loss_from_logits`` from the same
logits with the rewards as constants; and takes one Adam step with the pad
row's gradient zeroed.  The JAX package runs two forwards with the same
params and key, whose samples are bit-identical (its ``rl/loss.py``), so
the update is the same.

Attention takes ``sdp_attention``'s route, as in ``train/step.py``: at
``model.attention_dropout=0.0``, and in the deterministic eval, kernels #1
and #2 carry it on the card (13 launches of each a train step, 13 of #1
an eval); at the presets' 0.1 the plain path runs.

With a process-group ``mesh`` each rank samples, scores and updates its
data index's rows of the global batch; the loss is normalised over the
global batch and the gradients are summed over the reduce group
(``train.step.apply_update``).  The sample stream folds the data index in
with the dropout stream (the caller's ``seed``); the deterministic eval's
categorical draws fold it into seed 0.  So the ranks of a model or
sequence group, which sample from the same whole logits, draw and score
the same sequences.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.captioner import Captioner
from ..train.state import TrainState
from ..train.step import Batch, apply_update, step_generator
from ..utils.rng import fold_in, generator
from .loss import (Metrics, rl_forward, rl_loss_from_logits,
                   sample_from_logits)

# (sample_seq [B, N, T], captions [B, T + 1]) on the host -> (rewards
# [B, N], self-CIDEr [B, N])
Scorer = Callable[[np.ndarray, np.ndarray], Tuple[np.ndarray, np.ndarray]]


@dataclass
class RLSample:
    """A sampled batch awaiting its update: the batch, its teacher-forced
    logits (with their autograd graph when sampled for training), the
    sequences on the device, and their host copies with the captions,
    ready once ``ready`` (a CUDA event, or None on the CPU) has passed."""
    batch: Batch
    logits: torch.Tensor
    seq: torch.Tensor
    host_seq: torch.Tensor
    host_captions: torch.Tensor
    ready: Optional[torch.cuda.Event]

    def host(self) -> Tuple[np.ndarray, np.ndarray]:
        """(sample_seq, captions) as numpy, waiting for their copy."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.host_seq.numpy(), self.host_captions.numpy()


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``x``: pinned and not waited for when ``x`` lies on
    the card."""
    if x.device.type != "cuda":
        return x.detach()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x, non_blocking=True)


def rl_sample(state: TrainState, batch: Batch, cfg, *,
              seed: int) -> RLSample:
    """The forward of update ``state.step`` with gradient and dropout, and
    its sample; the copy to the host is started, not waited for."""
    model = state.model
    logits, sample_gen = rl_forward(
        model, batch, step_generator(seed, state.step, model.device),
        False)
    seq, _ = sample_from_logits(logits.detach(), sample_gen,
                                cfg.rl.sample_mode, cfg.rl.num_samples)
    host_seq, host_caps = _to_host(seq), _to_host(batch[2])
    ready = None
    if seq.device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
    return RLSample(batch, logits, seq, host_seq, host_caps, ready)


def rl_update(state: TrainState, sample: RLSample, rewards: np.ndarray,
              self_cider: np.ndarray, cfg, mesh=None) -> Metrics:
    """The update of ``sample`` with its host-scored rewards: loss,
    backward, the gradients summed over the mesh's ranks, the pad row's
    gradient zeroed, one Adam step.  Returns the four metrics as device
    tensors, without waiting for them."""
    loss, metrics = rl_loss_from_logits(
        sample.logits, sample.batch[2], cfg,
        rewards=torch.from_numpy(np.asarray(rewards, np.float32)),
        self_cider=torch.from_numpy(np.asarray(self_cider, np.float32)),
        sample_seq=sample.seq, mesh=mesh)
    apply_update(state, loss, mesh)
    return {k: v.detach() for k, v in metrics.items()}


def rl_train_step(state: TrainState, batch: Batch, cfg, *, seed: int,
                  score: Scorer, mesh=None) -> Metrics:
    """One serial SCST update of ``state`` in place (core/models.py:
    184-195): sample, score on the host with ``score``, update."""
    sample = rl_sample(state, batch, cfg, seed=seed)
    rewards, self_cider = score(*sample.host())
    return rl_update(state, sample, rewards, self_cider, cfg, mesh)


@torch.no_grad()
def rl_eval_step(model: Captioner, cfg, batch: Batch, *, score: Scorer,
                 mesh=None) -> Metrics:
    """The deterministic RL metrics (no dropout; a categorical sample
    draws from the fixed seed-0 generator, with the data index folded in
    past data index 0)."""
    logits, _ = rl_forward(model, batch, None, True)
    gen = (generator(fold_in(0, mesh.offset), logits.device)
           if mesh is not None and mesh.offset else None)
    seq, _ = sample_from_logits(logits, gen, cfg.rl.sample_mode,
                                cfg.rl.num_samples)
    rewards, self_cider = score(seq.cpu().numpy(), batch[2].cpu().numpy())
    return rl_loss_from_logits(
        logits, batch[2], cfg,
        rewards=torch.from_numpy(np.asarray(rewards, np.float32)),
        self_cider=torch.from_numpy(np.asarray(self_cider, np.float32)),
        sample_seq=seq, mesh=mesh)[1]
