"""Multi-device scale-out: data-parallel sharding of the pair batch.

Pairs are independent, so a launch shards its batch axis over a flat
``jax.sharding.Mesh`` with ``shard_map`` and every device runs the same
forward and traceback on its slice; no collective is needed until the
results are gathered.  The devices of one host are joined all to all, so
the mesh follows the batch alone (:func:`make_mesh`).

Multi-host: call :func:`init_distributed` first (``jax.distributed``),
then build the mesh over all devices; each host feeds its local shard.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def init_distributed(coordinator: Optional[str] = None, **kw) -> None:
    """Initialize multi-host JAX (no-op when single-process)."""
    if jax.process_count() > 1 or coordinator:
        jax.distributed.initialize(coordinator_address=coordinator, **kw)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(mesh: Mesh, fn, n_sharded: int, n_replicated: int = 2):
    """Jit ``fn`` with its first ``n_sharded`` arguments and every output
    split along the batch axis over ``mesh``; the ``n_replicated``
    arguments after them (the scoring matrix and parameters) are
    replicated."""
    axis = mesh.axis_names[0]
    return jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(axis),) * n_sharded
        + (P(),) * n_replicated, out_specs=P(axis), check_vma=False))


__all__ = ["init_distributed", "make_mesh", "shard_batch"]
