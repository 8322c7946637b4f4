"""One rank of the port's data-parallel checks on the CPU
(``tests/test_torch_distributed.py`` starts two):

    python tests/torch_dp_worker.py RANK WORLD WORKDIR

It joins a gloo group through ``file://WORKDIR/rendezvous``, runs every
case of ``WORKDIR/inputs.pt`` over a mesh of one CPU device per process,
and writes what it saw to ``WORKDIR/rank{RANK}.pt``.  It imports torch and
the port only.
"""

import os
import sys

import torch

from image_caption_tpu_torch.data.dataset import CocoSplit
from image_caption_tpu_torch.models.captioner import Captioner
from image_caption_tpu_torch.parallel import distributed
from image_caption_tpu_torch.parallel.mesh import make_mesh
from image_caption_tpu_torch.serve import decode_split
from image_caption_tpu_torch.train.loop import make_trainer


def run_steps(case, mesh):
    """The case's updates on global batches through ``train_step_device``
    (the pipelined RL schedule drains at the end): the metrics of each
    update, the gradients of the first, the deterministic metrics of batch
    0 before training, and the weights after."""
    cfg = case["cfg"]
    trainer = make_trainer(cfg, case.get("vocab"), mesh=mesh, seed=0)
    trainer.state.model.load_state_dict(case["weights"])
    out = {"eval": trainer.compute_loss(*case["batches"][0]),
           "rows": trainer.shard(case["batches"][0])[2]}
    metrics, grads = [], None
    for batch in case["batches"]:
        metrics.append(trainer.train_step_device(trainer.to_device(batch)))
        if grads is None and trainer.state.step == 1:
            grads = {n: p.grad.clone() for n, p in
                     trainer.state.model.named_parameters()}
    metrics.append(trainer.flush())
    out["metrics"] = [{k: float(v) for k, v in m.items()}
                      for m in metrics if m is not None]
    out["grads"] = grads
    out["weights"] = trainer.state.model.state_dict()
    return out


def df_disagreement(case, mesh):
    """An RL trainer whose data path holds the frozen df on rank 0 only."""
    cfg = case["cfg"].with_overrides(
        **{"data.data_path": case["paths"][mesh.offset]})
    try:
        make_trainer(cfg, case["vocab"], mesh=mesh)
    except RuntimeError as e:
        return str(e)
    return None


def decode(case, mesh):
    model = Captioner(case["cfg"].model, device="cpu")
    model.load_state_dict(case["weights"])
    split = CocoSplit(*case["split"])
    return {beam: decode_split(model, case["cfg"], split,
                               case["batch_size"], case["idx_to_word"],
                               beam_size=beam, device="cpu", mesh=mesh)
            for beam in case["beams"]}


CASES = {"steps": run_steps, "df_disagreement": df_disagreement,
         "decode": decode}


def main(rank: int, world: int, workdir: str) -> None:
    distributed.initialize(
        "file://" + os.path.join(workdir, "rendezvous"), world, rank,
        backend="gloo", timeout=120)
    try:
        mesh = make_mesh(["cpu"])
        inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                            weights_only=False)
        out = {name: CASES[case["kind"]](case, mesh)
               for name, case in inputs.items()}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
