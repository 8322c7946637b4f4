"""One rank of the port's data- and tensor-parallel checks on the CPU
(``tests/test_torch_distributed.py`` starts two, and
``tests/test_torch_tensor_parallel.py`` four):

    python tests/torch_dp_worker.py RANK WORLD WORKDIR

It joins a gloo group through ``file://WORKDIR/rendezvous``, runs every
case of ``WORKDIR/inputs.pt`` over a mesh of one CPU device per process,
of the case's (data, model) or (data, model, sequence) shape (data
parallel over every rank when it names none), and writes what it saw to
``WORKDIR/rank{RANK}.pt``: weights and gradients in the full layout.  It
imports torch and the port only.
"""

import os
import sys

import torch

from image_caption_tpu_torch.data.dataset import CocoSplit
from image_caption_tpu_torch.models.captioner import Captioner
from image_caption_tpu_torch.parallel import distributed
from image_caption_tpu_torch.parallel.mesh import make_mesh
from image_caption_tpu_torch.parallel.tensor import (full_state_dict,
                                                     gather_full)
from image_caption_tpu_torch.serve import decode_split
from image_caption_tpu_torch.train.checkpoint import CheckpointManager
from image_caption_tpu_torch.train.loop import RLTrainer, make_trainer


def run_steps(case, mesh):
    """The case's updates on global batches through ``train_step_device``
    (the pipelined RL schedule drains at the end): the metrics of each
    update, the gradients of the first, the deterministic metrics of batch
    0 before training, the weights after, this rank's block of batch 0,
    and an RL trainer's sampled sequences and rewards (this rank's
    rows)."""
    cfg = case["cfg"]
    trainer = make_trainer(cfg, case.get("vocab"), mesh=mesh, seed=0)
    trainer.load_state_dict(case["weights"])
    model = trainer.state.model
    block = trainer.shard(case["batches"][0])
    # the rank's captions, and its features' first column [rows, slots]
    out = {"eval": trainer.compute_loss(*case["batches"][0]),
           "rows": block[2], "slots": block[0][..., 0], "scored": []}
    if isinstance(trainer, RLTrainer):
        score = trainer._host_rewards

        def kept(sample_seq, captions):
            rewards = score(sample_seq, captions)
            out["scored"].append((sample_seq.copy(), rewards[0].copy()))
            return rewards
        trainer._host_rewards = kept
    metrics, grads = [], None
    for batch in case["batches"]:
        metrics.append(trainer.train_step_device(trainer.to_device(batch)))
        if grads is None and trainer.state.step == 1:
            grads = gather_full(model, {n: p.grad.clone() for n, p in
                                        model.named_parameters()})
    metrics.append(trainer.flush())
    out["metrics"] = [{k: float(v) for k, v in m.items()}
                      for m in metrics if m is not None]
    out["grads"] = grads
    out["weights"] = full_state_dict(model)
    return out


def scan(case, mesh):
    """The case's batches as one scanned dispatch (``shard_stacked`` and
    ``train_steps_device``): the losses [K], this rank's block of the
    stacked features, and the weights after."""
    trainer = make_trainer(case["cfg"], mesh=mesh, seed=0)
    trainer.load_state_dict(case["weights"])
    stacked = trainer.shard_stacked(case["batches"])
    losses = trainer.train_steps_device(stacked)["loss"]
    return {"losses": losses.tolist(), "features": stacked[0],
            "weights": full_state_dict(trainer.state.model)}


def df_disagreement(case, mesh):
    """An RL trainer whose data path holds the frozen df on rank 0 only."""
    cfg = case["cfg"].with_overrides(
        **{"data.data_path": case["paths"][mesh.offset]})
    try:
        make_trainer(cfg, case["vocab"], mesh=mesh)
    except RuntimeError as e:
        return str(e)
    return None


def checkpoint(case, mesh):
    """Restore the checkpoint of epoch 1 (written by one process), take
    one update, and save it as epoch 2 in the full layout."""
    trainer = make_trainer(case["cfg"], mesh=mesh, seed=0)
    ckpt = CheckpointManager(case["dir"])
    trainer.restore(ckpt, 1)
    restored = {k: v.clone()
                for k, v in full_state_dict(trainer.state.model).items()}
    loss = trainer.train_step(*case["batch"])["loss"]
    ckpt.save(2, trainer.state, mesh)
    return {"restored": restored, "loss": loss}


def decode(case, mesh):
    model = Captioner(case["cfg"].model, device="cpu")
    model.load_state_dict(case["weights"])
    split = CocoSplit(*case["split"])
    return {beam: decode_split(model, case["cfg"], split,
                               case["batch_size"], case["idx_to_word"],
                               beam_size=beam, device="cpu", mesh=mesh)
            for beam in case["beams"]}


CASES = {"steps": run_steps, "df_disagreement": df_disagreement,
         "decode": decode, "checkpoint": checkpoint, "scan": scan}


def main(rank: int, world: int, workdir: str) -> None:
    # the ranks share the machine with each other and the JAX references
    torch.set_num_threads(1)
    distributed.initialize(
        "file://" + os.path.join(workdir, "rendezvous"), world, rank,
        backend="gloo", timeout=120)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            weights_only=False)
        out = {name: CASES[case["kind"]](case, make_mesh(
            ["cpu"], *case.get("mesh", (-1, 1)))) for name, case in
            inputs.items()}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
