"""Multi-host bring-up.

There is no NCCL/MPI layer to manage: XLA is the communication backend and
compiles collectives onto ICI (intra-slice) / DCN (inter-slice) from the
shardings alone.  The only host-side coordination is the JAX distributed
service -- this module wraps it and builds process-spanning meshes.

Typical multi-host launch (same script on every host)::

    from linprog_tpu.parallel import distributed
    distributed.initialize()                  # no-op on single process
    mesh = distributed.global_batch_mesh()    # all devices on all hosts
    res = sharded_two_phase_solve(mesh, c, A, b)
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Start the JAX distributed service (idempotent, single-process safe).

    With no arguments, relies on the environment (cluster runtimes set the
    coordinator automatically); on a single process this is a no-op.

    NB: must not touch ``jax.devices()``/``jax.process_count()`` before
    initializing -- any backend-initializing call makes
    ``jax.distributed.initialize`` unusable afterwards.
    """
    if coordinator_address is None and num_processes is None:
        return  # single-process: nothing to do
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized by the runtime
        if "already" not in str(e).lower():
            raise


def global_batch_mesh(axis: str = "batch") -> Mesh:
    """1-D mesh over every device of every process."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def global_2d_mesh(model_size: int, batch_axis: str = "batch",
                   model_axis: str = "model") -> Mesh:
    """2-D (batch, model) mesh: DP across, TP within.

    ``model_size`` devices per model group (must divide the device count);
    lay the model axis innermost so TP collectives ride the fastest links.
    """
    devices = np.asarray(jax.devices())
    if devices.size % model_size != 0:
        raise ValueError(
            f"{devices.size} devices not divisible by model_size={model_size}"
        )
    grid = devices.reshape(devices.size // model_size, model_size)
    return Mesh(grid, (batch_axis, model_axis))


def process_summary() -> dict:
    """Host-side view of the distributed topology (observability)."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
    }
