"""Multi-device (8 virtual CPU devices) sharded batches == one device."""
import numpy as np
import pytest

import __graft_entry__ as graft
import refcmp
from ksw2_tpu.batch.scheduler import AlignJob, align_batch, launch_program
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.ops.batch_xla import ext_batch
from ksw2_tpu.parallel.mesh import make_mesh


def test_entry_compiles_and_runs():
    import jax

    fn, args = graft.entry()
    rec, p = jax.jit(fn)(*args)
    assert np.asarray(rec).shape == (args[0].shape[0], 9) and p is None


def test_dryrun_multichip():
    graft.dryrun_multichip(8)


def test_sharded_equals_unsharded():
    args = graft._example_batch(B=16, Lq=128, Lt=128, seed=3)
    spec = graft._spec(Lq=128, Lt=128)
    o1, = launch_program(spec, make_mesh(8))(*args, *graft._costs())
    o2, _ = ext_batch(spec, *args, *graft._costs())
    assert np.array_equal(np.asarray(o1), np.asarray(o2))


def _jobs(seed, n, lo, hi, w=-1):
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(n):
        tlen = int(rng.integers(lo, hi))
        t, q = refcmp.random_pair(rng, tlen, divergence=0.25, indel=0.1)
        jobs.append(AlignJob(encode_dna(q), encode_dna(t), w=w))
    return jobs


@pytest.mark.parametrize("two,flag,zdrop,w", [
    (False, Flag.SCORE_ONLY, 50, -1),
    (True, Flag.SCORE_ONLY, 50, -1),
    (False, Flag.SCORE_ONLY, 60, 30),
    (False, Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP, 40, -1),
    (False, Flag.NONE, 100, -1),
    (False, Flag.EXTZ_ONLY | Flag.EQX, 100, -1),
    (True, Flag.NONE, 100, 40),
    (True, Flag.RIGHT | Flag.EQX, 100, -1),
])
def test_sharded_scheduler_matches_local(two, flag, zdrop, w):
    """Every launch sharded over the mesh gives the one-device results,
    with an odd job count that forces padding."""
    jobs = _jobs(int(flag) + 2 * two + 7, 21, 70, 120, w=w)
    mat = simple_mat(5, 2, 4)
    kw = dict(q2=13, e2=1) if two else {}
    sh = align_batch(jobs, 5, mat, 4, 2, zdrop=zdrop, end_bonus=5,
                     flag=flag, mesh=make_mesh(8), **kw)
    lo = align_batch(jobs, 5, mat, 4, 2, zdrop=zdrop, end_bonus=5,
                     flag=flag, **kw)
    assert len(sh) == len(jobs)
    assert sh == lo
