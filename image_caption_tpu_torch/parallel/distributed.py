"""Joining a multi-process run: one process per card over torch.distributed.

The counterpart of the JAX package's ``parallel/distributed.py``.  Every
process runs the same program; ``initialize`` wires them into one process
group, and ``parallel.mesh.make_mesh`` then lays the data axis over the
processes, one device each.

With no arguments ``initialize`` takes torchrun's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; ``LOCAL_RANK``
picks the card), so the documented launch is

    torchrun --nproc-per-node N -m image_caption_tpu_torch.main \\
        --distributed train

Elsewhere pass the coordinator (``host:port``, or an init-method URL such
as ``file:///shared/rendezvous``), the number of processes and this
process's id.  There is no single-process fallback: a coordinator that
cannot be reached raises, so a misconfigured launch never trains on 1/N
of the data.

The backend is NCCL for the card and gloo for the CPU (the CLI picks gloo
for ``--device cpu``).  NCCL refuses two ranks on one card;
``backend="gloo"`` runs them there (gloo reduces and broadcasts CUDA
tensors through the host).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..utils.device import DeviceLike

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None,
               timeout: float = 600.0) -> None:
    """Join this process to the process group (idempotent: a no-op when a
    group exists, made here or by the caller).

    ``backend`` None is NCCL, on the card ``cuda:{LOCAL_RANK}``, which
    becomes the process's current card; without a card that raises, and
    ``backend="gloo"`` joins on the CPU (or two ranks on one card).
    ``timeout`` (seconds) bounds the rendezvous and every collective."""
    global _initialized
    if is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if all(v is None for v in explicit):
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"distributed run without {', '.join(missing)} in the "
                "environment: launch with torchrun, or pass the "
                "coordinator address, the number of processes and the "
                "process id")
        init_method, world, rank_ = "env://", None, None
    elif any(v is None for v in explicit):
        raise ValueError("pass all of coordinator_address, num_processes "
                         "and process_id, or none (torchrun's environment)")
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        world, rank_ = int(num_processes), int(process_id)
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(device(None, rank_))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world is None else world,
                            rank=-1 if rank_ is None else rank_,
                            timeout=datetime.timedelta(seconds=timeout))
    _initialized = True


def is_initialized() -> bool:
    """True when this process belongs to a process group, made by
    ``initialize`` or directly through ``init_process_group``."""
    return _initialized or (dist.is_available() and dist.is_initialized())


def shutdown() -> None:
    """Leave the process group made by ``initialize`` (a no-op otherwise)."""
    global _initialized
    if _initialized and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def rank() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    """The number of processes; 1 outside a process group."""
    return dist.get_world_size() if is_initialized() else 1


def local_rank(default: Optional[int] = None) -> int:
    """``LOCAL_RANK`` from the environment, else ``default``, else this
    process's rank (a single-host launch without torchrun)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank() if default is None else default


def device(name: DeviceLike = None,
           rank_: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for ``None`` or
    ``"cuda"``, else ``name`` as given ("cpu", "cuda:1").  A local rank
    without a card of its own raises; it never wraps to another card."""
    if name is not None and torch.device(name).type != "cuda":
        return torch.device(name)
    if name is not None and torch.device(name).index is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    local = local_rank(rank_)
    if not 0 <= local < torch.cuda.device_count():
        raise RuntimeError(
            f"local rank {local} has no card: {torch.cuda.device_count()} "
            "visible; launch at most one process per card")
    return torch.device("cuda", local)
