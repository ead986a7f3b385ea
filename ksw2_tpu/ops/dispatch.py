"""The one place that chooses an engine for the current platform.

Every batch of the device path runs a *forward* (the anti-diagonal DP,
scores and, in CIGAR mode, direction bytes) followed by the device
traceback.  :func:`select_forward` returns the forward of the platform:

* ``gpu``: the hand-written CUDA kernel (:mod:`ksw2_tpu.ops.cuda_ext`);
* ``cpu``: the plain-XLA engine (:mod:`ksw2_tpu.ops.batch_xla`), only when
  the process asked for the CPU explicitly (``JAX_PLATFORMS=cpu``), as the
  tests do;
* anything else, including a machine where JAX found no GPU and nobody
  asked for the CPU: an error naming the platform.

Both forwards take ``(spec, query, target, qlen, tlen, w, mat)`` and
return the same ``(records, direction rows)``; they are byte-equal.
"""
from __future__ import annotations

import os
from typing import Callable, Optional

import jax

from .batch_xla import forward as xla_forward


def cpu_requested() -> bool:
    """True when the process asked JAX for the CPU by name."""
    plats = str(jax.config.jax_platforms or os.environ.get("JAX_PLATFORMS",
                                                           ""))
    return "cpu" in [p.strip().lower() for p in plats.split(",")]


def select_forward(platform: Optional[str] = None) -> Callable:
    """Forward engine on ``platform`` (default: JAX's backend).  Every
    bucket (gap model, output, shape) runs on the same engine; the bucket
    is a static argument of the forward."""
    plat = platform or jax.default_backend()
    if plat == "gpu":
        from .cuda_ext import forward as cuda_forward
        return cuda_forward
    if plat == "cpu":
        if not cpu_requested():
            raise RuntimeError(
                "JAX found no GPU (platform 'cpu'); set JAX_PLATFORMS=cpu "
                "to run the XLA engine on the CPU")
        return xla_forward
    raise RuntimeError(f"no alignment engine for platform {plat!r}")


def walk_unroll() -> int:
    """Traceback steps per loop iteration of the device walk.

    On a GPU every loop iteration costs kernel launches and a host check
    of the loop condition, so the walk takes 16 steps per iteration; on
    the CPU an iteration is cheap and unrolling only multiplies compile
    time, so it takes one."""
    return 16 if jax.default_backend() == "gpu" else 1


__all__ = ["cpu_requested", "select_forward", "walk_unroll"]
