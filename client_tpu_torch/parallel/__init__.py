"""Parallelism for the port's serving runtime.

The reference's server-side compute path is SPMD over a ``jax.sharding.Mesh``
of the process's devices, with XLA inserting the collectives. The port's
counterpart is a mesh of ``torch.device`` s that one process owns, with
explicit collectives between the shards:

- :func:`create_mesh` — the ``(dp, sp, tp)`` device grid, tp innermost;
- :mod:`client_tpu_torch.parallel.sharding` — the declare-and-validate
  layer serving models use (``model.mesh`` dict -> :class:`MeshSpec` ->
  :class:`MeshPlan` with per-tensor shard slices);
- :mod:`client_tpu_torch.parallel.collectives` — all-reduce, all-gather
  and ppermute between shards (the seam a multi-process mesh swaps for
  ``torch.distributed``);
- :mod:`client_tpu_torch.parallel.executor` — :class:`ShardedExecutor`,
  the place/run/gather seam the server executes sharded models through;
- :mod:`client_tpu_torch.parallel.ring_attention` — ring attention over
  the sequence-parallel axis (long-context prefill).
"""

from typing import Optional, Sequence

import numpy as np
import torch

from client_tpu_torch.parallel.executor import ShardedExecutor  # noqa: F401
from client_tpu_torch.parallel.ring_attention import ring_attention  # noqa: F401
from client_tpu_torch.parallel.sharding import (  # noqa: F401
    MeshDeclarationError,
    MeshPlan,
    MeshSpec,
    MeshUnavailableError,
    host_devices,
    plan_for_model,
)

DP_AXIS = "dp"  # data parallel (batch)
TP_AXIS = "tp"  # tensor parallel (heads / hidden)
SP_AXIS = "sp"  # sequence parallel (context length)


def create_mesh(
    dp: int = 1,
    tp: int = 1,
    sp: int = 1,
    devices: Optional[Sequence] = None,
) -> np.ndarray:
    """The ``[dp, sp, tp]`` grid of ``devices`` (default: every card of
    the process), as an object array of ``torch.device``.

    ``dp*tp*sp`` must equal the device count. Axis order puts tp
    innermost, as the reference's does, so a tensor-parallel group is a
    run of adjacent devices.
    """
    if devices is None:
        devices = host_devices()
    n = len(devices)
    if dp * tp * sp != n:
        raise ValueError(
            f"mesh {dp}x{sp}x{tp} (dp*sp*tp={dp * sp * tp}) does not match "
            f"device count {n}"
        )
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices]
    return grid.reshape(dp, sp, tp)
