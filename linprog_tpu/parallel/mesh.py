"""Device-mesh data parallelism for batched LP solving.

The reference is a single-process, single-thread library (SURVEY.md section
2.2: every parallelism row is "absent").  The scaling axis here is data
parallelism over independent LP instances: a 1-D ``Mesh`` over axis
``"batch"``, the batch dimension of every array sharded across it, and XLA
compiling the whole two-phase solve SPMD; on GPUs its collectives (the
batched while-loops' "any lane running" reductions) run over NCCL.
Batch-level aggregate metrics (solved counts, total pivots) are computed
with ``jax.lax`` reductions on device.

Multi-host bring-up is ``jax.distributed.initialize()`` + the same code --
XLA drives the collectives; there is no MPI layer to port.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..batch import solve_batch_two_phase
from ..config import DEFAULT_CONFIG, SolverConfig
from ..results import BatchResult


def make_batch_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D device mesh over axis ``"batch"``."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("batch",))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard the leading (batch) dim over the mesh; replicate the rest."""
    return NamedSharding(mesh, P("batch", *([None] * (ndim - 1))))


def shard_batch(mesh: Mesh, *arrays):
    """Place arrays with their batch dim sharded over the mesh."""
    out = tuple(
        jax.device_put(a, batch_sharding(mesh, np.ndim(a))) for a in arrays
    )
    return out if len(out) > 1 else out[0]


def sharded_two_phase_solve(
    mesh: Mesh,
    c,
    A,
    b,
    maxiters1: int = 1000,
    maxiters2: int = 1000,
    cfg: SolverConfig = DEFAULT_CONFIG,
) -> BatchResult:
    """Two-phase batched solve with the batch dim sharded over ``mesh``.

    The batch size must be divisible by the mesh size.  Every lane's solve is
    independent, so XLA compiles this to per-device compute; the only
    cross-device traffic is the loops' termination reduction and result
    gathers.
    """
    B = c.shape[0]
    n_dev = mesh.devices.size
    if B % n_dev != 0:
        raise ValueError(f"batch size {B} not divisible by mesh size {n_dev}")
    c, A, b = shard_batch(mesh, c, A, b)
    return solve_batch_two_phase(
        c, A, b, maxiters1=maxiters1, maxiters2=maxiters2, cfg=cfg
    )


def sharded_pdhg_batch_canonical(mesh: Mesh, c, G, h,
                                 maxiters: int = 100_000, cfg=None):
    """Batched first-order solve with the batch dim sharded over ``mesh``.

    The PDHG counterpart of :func:`sharded_two_phase_solve`: lanes are
    independent (matvecs + projections per lane), so the iteration is
    pure per-device compute; only result gathers cross devices.  Returns
    ``(x, cost, status, iters)`` in the original scaling
    (:func:`linprog_tpu.pdhg.pdhg_solve_batch_canonical`).
    """
    from ..pdhg import DEFAULT_PDHG_CONFIG, pdhg_solve_batch_canonical

    cfg = cfg or DEFAULT_PDHG_CONFIG
    B = c.shape[0]
    n_dev = mesh.devices.size
    if B % n_dev != 0:
        raise ValueError(f"batch size {B} not divisible by mesh size {n_dev}")
    c, G, h = shard_batch(mesh, c, G, h)
    return pdhg_solve_batch_canonical(c, G, h, maxiters=maxiters, cfg=cfg)


def sharded_ipm_batch_canonical(mesh: Mesh, c, G, h, cfg=None) -> BatchResult:
    """Batched interior-point solve with the batch dim sharded over ``mesh``.

    The IPM counterpart of :func:`sharded_two_phase_solve` /
    :func:`sharded_pdhg_batch_canonical`: every per-iteration op (batched
    matmuls, batched Cholesky, triangular solves) carries the leading batch
    dim, so DP sharding is pure per-device compute; only the while-loop
    termination reduction (``jnp.any`` over lane statuses) crosses
    devices.
    """
    from ..ipm import DEFAULT_IPM_CONFIG, ipm_solve_batch_canonical

    cfg = cfg or DEFAULT_IPM_CONFIG
    B = c.shape[0]
    n_dev = mesh.devices.size
    if B % n_dev != 0:
        raise ValueError(f"batch size {B} not divisible by mesh size {n_dev}")
    c, G, h = shard_batch(mesh, c, G, h)
    return ipm_solve_batch_canonical(c, G, h, cfg)
