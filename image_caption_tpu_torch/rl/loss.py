"""Self-critical (SCST) composite loss on tensors.

The counterpart of the JAX package's ``rl/loss.py``, reproducing
``ReinforcementLearningLoss`` + ``StructureCriterion``
(``core/TRANSFORMER/loss.py:31-155``) with the reference's quirks:

  * the sample is the argmax of the teacher-forced log-probs
    (model_RL.py:93-97, ``sample_mode='argmax'``), or N categorical draws;
  * the mask is ``sequence > 0`` shifted right one step behind a leading
    1 column (loss.py:124-125);
  * the entropy bonus takes softmax and log-softmax OF THE LOG-PROBS
    (loss.py:132) and is detached;
  * the baseline ``(sum - s) / N`` is 0 for one sample (loss.py:140-141)
    and a leave-in mean above one;
  * the self-CIDEr term is added after the baseline (loss.py:144-148);
  * structure loss = -sum(logp[sample] * mask * score) / sum(mask);
  * total = (1 - w) * XE + w * structure, with the WRITE_LOG keys.

The rewards are host-scored constants: the scoring is a plain host call
between the forward and the loss (``rl/step.py``), where the JAX package
crosses to the host with ``jax.pure_callback``.  Under data parallelism
each rank holds its rows, and the loss and the mean reward are normalised
over the global batch, as the JAX step computes them.  Under tensor
parallelism ``rl_forward`` all-gathers the vocabulary-sharded logits over
the model group (``parallel.tensor.gather_vocab``: a [B, T, V] float32
gather a step, 76.8 MB at the flagship's batch 32, 50 tokens and 12,000
words), so sampling, the entropy term and the log-probs run on full rows,
as in one process.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.captioner import Captioner, cross_entropy_ignore_pad
from ..parallel.mesh import global_mean
from ..parallel.tensor import gather_vocab
from ..utils.rng import split

Metrics = Dict[str, torch.Tensor]


def sample_from_logits(logits: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       mode: str = "argmax", num_samples: int = 1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sequences [B, N, T] int64, log-probs [B, T, V]) from teacher-forced
    logits [B, T, V].  'argmax' forces N to 1 (repeated argmax samples are
    equal) and takes the first maximum, as ``jnp.argmax`` does;
    'categorical' draws N times from the softmax with ``generator``, or
    with a generator seeded 0 when none is given (the JAX package's
    ``PRNGKey(0)`` for the eval paths)."""
    logprobs = torch.log_softmax(logits, dim=-1)
    if mode == "argmax":
        seq = torch.argmax(logprobs, dim=-1)[:, None]
    elif mode == "categorical":
        if generator is None:
            generator = torch.Generator(device=logits.device).manual_seed(0)
        b, t, v = logits.shape
        probs = torch.softmax(logits.detach(), dim=-1).reshape(b * t, v)
        seq = torch.multinomial(probs, num_samples, replacement=True,
                                generator=generator)
        seq = seq.reshape(b, t, num_samples).permute(0, 2, 1)
    else:
        raise ValueError(f"sample mode is 'argmax' or 'categorical', not "
                         f"{mode!r}")
    return seq.long(), logprobs


def structure_loss(logprobs: torch.Tensor, sample_seq: torch.Tensor,
                   rewards: torch.Tensor, self_cider: torch.Tensor, *,
                   entropy_weight: float, self_cider_weight: float,
                   mesh=None) -> Metrics:
    """loss.py:121-155 over N samples an item: logprobs [B, T, V],
    sample_seq [B, N, T] (or [B, T]), rewards and self_cider [B, N] (or
    [B]).  Returns the loss and the mean raw reward; with a process-group
    ``mesh`` both are over every rank's rows (the loss divides by the
    global ``sum(mask)``)."""
    if sample_seq.dim() == 2:
        sample_seq = sample_seq[:, None]
        rewards = rewards[:, None] if rewards.dim() == 1 else rewards
        self_cider = (self_cider[:, None] if self_cider.dim() == 1
                      else self_cider)
    mask = (sample_seq > 0).to(logprobs.dtype)                 # [B, N, T]
    mask = torch.cat([torch.ones_like(mask[:, :, :1]), mask[:, :, :-1]],
                     dim=2)
    scores = rewards.to(logprobs.dtype)
    reward_out = scores

    if entropy_weight > 0:
        lp = logprobs.detach()
        entropy = -(torch.softmax(lp, dim=2)
                    * torch.log_softmax(lp, dim=2)).sum(dim=2)   # [B, T]
        entropy = (entropy[:, None] * mask).sum(dim=2) / mask.sum(dim=2)
        scores = scores + entropy_weight * entropy

    n = sample_seq.shape[1]
    gathered = torch.gather(
        logprobs[:, None].expand(-1, n, -1, -1), 3,
        sample_seq[..., None])[..., 0]                          # [B, N, T]
    baseline = (scores.sum(dim=1, keepdim=True) - scores) / n
    scores = scores - baseline
    if self_cider_weight > 0:
        scores = scores + self_cider_weight * self_cider.to(logprobs.dtype)

    loss = global_mean(-(gathered * mask * scores[..., None]).sum(),
                       mask.sum(), mesh)
    reward = global_mean(reward_out.sum(), reward_out.numel(), mesh)
    return {"loss": loss, "reward": reward}


def rl_loss_from_logits(logits: torch.Tensor, captions: torch.Tensor, cfg,
                        *, rewards: torch.Tensor, self_cider: torch.Tensor,
                        sample_seq: Optional[torch.Tensor] = None,
                        sample_generator: Optional[torch.Generator] = None,
                        mesh=None) -> Tuple[torch.Tensor, Metrics]:
    """The composite loss of ``cfg`` (a ``Config``: its ``rl`` and
    ``model.pad_idx``) from teacher-forced logits [B, T, V] and the
    captions [B, T + 1].  ``sample_seq`` are the sequences ``rewards`` and
    ``self_cider`` [B, N] were scored on; without it the sample is drawn
    again from these logits with ``sample_generator``.  The rewards are
    constants: no gradient flows into them.  With a process-group ``mesh``
    every term is normalised over the global batch (``structure_loss``,
    ``cross_entropy_ignore_pad``), and the rows are this rank's."""
    target = captions[:, 1:].long()
    w = cfg.rl.structure_loss_weight
    zero = logits.new_zeros(())
    lm_loss = (cross_entropy_ignore_pad(logits, target, cfg.model.pad_idx,
                                        mesh) if w < 1 else zero)
    if w > 0:
        if sample_seq is None:
            sample_seq, logprobs = sample_from_logits(
                logits, sample_generator, cfg.rl.sample_mode,
                cfg.rl.num_samples)
        else:
            logprobs = torch.log_softmax(logits, dim=-1)
        st = structure_loss(
            logprobs, sample_seq.to(logits.device),
            torch.as_tensor(rewards, device=logits.device).detach(),
            torch.as_tensor(self_cider, device=logits.device).detach(),
            entropy_weight=cfg.rl.entropy_reward_weight,
            self_cider_weight=cfg.rl.self_cider_reward_weight, mesh=mesh)
        st_loss, reward = st["loss"], st["reward"]
    else:
        st_loss, reward = zero, zero
    loss = (1.0 - w) * lm_loss + w * st_loss
    return loss, {"loss": loss, "language_model_loss": lm_loss,
                  "structure_loss": st_loss, "reward": reward}


def rl_forward(model: Captioner, batch, generator, deterministic: bool):
    """Split the step's key as the JAX package does (dropout, sample) and
    run the teacher-forced forward on the dropout half; a sharded model's
    logits come back whole, gathered over its model group."""
    drop_gen, sample_gen = split(generator, 2)
    logits = model(*batch, generator=drop_gen, deterministic=deterministic)
    return gather_vocab(logits, model.tp), sample_gen


@torch.no_grad()
def rl_sample_sequence(model: Captioner, cfg, batch, *,
                       generator: Optional[torch.Generator] = None,
                       deterministic: bool = True) -> torch.Tensor:
    """The sampled sequences [B, N, T] alone.  With the same generator the
    sample equals the one ``rl_composite_loss`` draws."""
    logits, sample_gen = rl_forward(model, batch, generator, deterministic)
    return sample_from_logits(logits, sample_gen, cfg.rl.sample_mode,
                              cfg.rl.num_samples)[0]


def rl_composite_loss(model: Captioner, cfg, batch, *,
                      rewards: torch.Tensor, self_cider: torch.Tensor,
                      sample_seq: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = True
                      ) -> Tuple[torch.Tensor, Metrics]:
    """The full RL loss (loss.py:52-76) of ``model`` on ``batch``
    (features, positions, captions), differentiable: the forward under
    ``generator``'s dropout half, then ``rl_loss_from_logits`` with its
    sample half.  Returns (loss, the four WRITE_LOG metrics)."""
    logits, sample_gen = rl_forward(model, batch, generator, deterministic)
    captions = torch.as_tensor(batch[2], device=model.device)
    return rl_loss_from_logits(logits, captions, cfg, rewards=rewards,
                               self_cider=self_cider, sample_seq=sample_seq,
                               sample_generator=sample_gen)
