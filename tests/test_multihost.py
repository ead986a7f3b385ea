"""Two-process jax.distributed run (the DCN analogue on CPU devices).

Spawns two worker processes that form an 8-device global mesh (4 virtual
CPU devices each), shard the pair batch across it, and reduce a checksum.
Verifies both workers agree and match the single-process engine.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_workers():
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(HERE, "multihost_demo.py"),
             str(i), "2", coord],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=450)
            # assert on the computed checksum line: jax's coordination
            # error-poller can abort the process during teardown after
            # the peer leaves, which is noise, not a wrong result
            oks = [l for l in out.strip().splitlines()
                   if l.startswith("OK ")]
            assert oks, (p.returncode, out, err[-2000:])
            outs.append(oks[-1])
    finally:
        for p in procs:          # kill our own exact children on failure
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


@pytest.mark.skipif(os.environ.get("KSW2_SKIP_MULTIHOST") == "1",
                    reason="multi-process test skipped by env")
def test_two_process_distributed():
    # the coordination-service startup is sensitive to host load; one
    # retry on a fresh port keeps the test honest without flaking
    try:
        outs = _spawn_workers()
    except (subprocess.TimeoutExpired, AssertionError):
        outs = _spawn_workers()
    sums = [int(o.split()[-1]) for o in outs]
    assert sums[0] == sums[1], outs

    # cross-check against the single-process engine
    from ksw2_tpu.core.flags import Flag
    from ksw2_tpu.core.matrix import simple_mat
    from ksw2_tpu.ops.batch_xla import BatchSpec, ext_batch, make_params

    rng = np.random.default_rng(0)
    B, L = 16, 64
    Q = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    T = np.where(rng.random((B, L)) < 0.15,
                 rng.integers(0, 4, size=(B, L)), Q).astype(np.int8)
    spec = BatchSpec(Lq=L, Lt=L, two=False, flag=int(Flag.SCORE_ONLY), nc=0)
    mat = simple_mat(5, 2, 4)
    full = np.full((B,), L, np.int32)
    rec, _ = ext_batch(spec, Q, T, full, full, full, mat,
                       make_params(5, mat, 4, 2, zdrop=100))
    assert sums[0] == int(np.asarray(rec)[:, 7].sum()), (sums, rec)
