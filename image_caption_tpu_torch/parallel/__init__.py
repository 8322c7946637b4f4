"""Parallelism: the device mesh (data parallelism over torch.distributed),
tensor parallelism over its model axis, and joining a multi-process run."""

from .mesh import (DATA_AXIS, MODEL_AXIS, SEQUENCE_AXIS,  # noqa: F401
                   Mesh, gather_rows, make_mesh, shard_batch,
                   shard_batch_stacked)
