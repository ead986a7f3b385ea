"""Multi-host worker: jax.distributed over N CPU processes.

Each process owns 4 virtual CPU devices; the global mesh spans all
processes (DCN analogue), the pair batch shards over it, and every process
feeds its local shard. Run directly (spawned by test_multihost.py):

    python tests/multihost_demo.py <proc_id> <n_procs> <coord_addr>

Prints one line: ``OK <proc_id> <checksum>`` where the checksum is the sum
of all pair scores (identical on every process after the gather).
"""
import os
import sys

proc_id, n_procs, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4")

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.distributed.initialize(coordinator_address=coord, num_processes=n_procs,
                           process_id=proc_id)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from ksw2_tpu.core.flags import Flag  # noqa: E402
from ksw2_tpu.core.matrix import simple_mat  # noqa: E402
from ksw2_tpu.ops.batch_xla import BatchSpec, make_params  # noqa: E402
from ksw2_tpu.batch.scheduler import launch_program  # noqa: E402

rng = np.random.default_rng(0)          # same data on every process
B, L = 16, 64
Q = rng.integers(0, 4, size=(B, L)).astype(np.int8)
T = np.where(rng.random((B, L)) < 0.15,
             rng.integers(0, 4, size=(B, L)), Q).astype(np.int8)
qlen = np.full(B, L, np.int32)
tlen = np.full(B, L, np.int32)
w = np.full(B, L, np.int32)
spec = BatchSpec(Lq=L, Lt=L, two=False, flag=int(Flag.SCORE_ONLY), nc=0)
mat = simple_mat(5, 2, 4)
prm = make_params(5, mat, 4, 2, zdrop=100)

mesh = Mesh(np.array(jax.devices()), ("data",))
shard = NamedSharding(mesh, P("data"))
n_dev = len(jax.devices())
per = B // n_dev


def to_global(x):
    """Assemble a globally-sharded array from this process's local rows."""
    local = jax.local_devices()
    arrs = []
    for d in local:
        gi = jax.devices().index(d)
        arrs.append(jax.device_put(x[gi * per:(gi + 1) * per], d))
    return jax.make_array_from_single_device_arrays(
        x.shape, shard, arrs)


args = tuple(to_global(a) for a in (Q, T, qlen, tlen, w))
rec, = launch_program(spec, mesh)(*args, mat, prm)
# reduce to a replicated scalar so every process can read it (the gather
# itself is the ICI/DCN collective under test)
total = jax.jit(lambda r: jnp.sum(r[:, 7]),
                out_shardings=NamedSharding(mesh, P()))(rec)
checksum = int(jax.device_get(total))
print(f"OK {proc_id} {checksum}", flush=True)

# jax's coordination service can hang in background WatchJobState retries
# after the peer exits; the work is done and verified, so leave hard
try:
    jax.distributed.shutdown()
except Exception:
    pass
sys.stdout.flush()
os._exit(0)
