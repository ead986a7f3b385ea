"""Mesh-width invariance and compile reuse of the scheduler path.

Runs on the suite's virtual 8-device CPU mesh (conftest).  The same batch
over 1, 2, 4 and 8 devices must give identical results: pairs are
independent, so the shard count may only change where they run.  A repeated
call, with a freshly built mesh, must reuse every compiled launch program:
retracing or recompiling per call once made each sharded call about 45x
slower.  (Speed across devices is a chip measurement, not a CPU one.)
"""
import numpy as np
import pytest

from ksw2_tpu.batch import scheduler
from ksw2_tpu.batch.scheduler import AlignJob, align_batch, align_batch_scores
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.parallel.mesh import make_mesh


def _jobs():
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(37):                      # odd count forces padding
        L = int(rng.integers(40, 200))
        q = rng.integers(0, 4, size=L).astype(np.int8)
        t = np.where(rng.random(L) < 0.15,
                     rng.integers(0, 4, size=L), q).astype(np.int8)
        jobs.append(AlignJob(query=q, target=t))
    return jobs


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_mesh_width_invariance(n_devices):
    jobs = _jobs()
    mat = simple_mat(5, 2, -4)
    local = align_batch_scores(jobs, 5, mat, 4, 2, zdrop=100,
                               flag=Flag.SCORE_ONLY)
    sharded = align_batch_scores(jobs, 5, mat, 4, 2, zdrop=100,
                                 flag=Flag.SCORE_ONLY,
                                 mesh=make_mesh(n_devices))
    assert sharded == local


def _programs(jobs, mat, flag, mesh):
    """The jitted launch programs a batch runs (looked up, not built)."""
    launches, _ = scheduler.plan_launches(
        jobs, 5, mat, 4, 2, zdrop=100, flag=flag,
        n_shards=1 if mesh is None else mesh.size)
    return [scheduler.launch_program(ln.spec, mesh) for ln in launches]


TREND = [(None, Flag.SCORE_ONLY), (1, Flag.SCORE_ONLY), (2, Flag.SCORE_ONLY),
         (4, Flag.SCORE_ONLY), (8, Flag.SCORE_ONLY), (None, Flag.NONE),
         (8, Flag.NONE)]


@pytest.mark.parametrize("n_devices,flag", TREND, ids=[
    f"{'unsharded' if n is None else f'mesh{n}'}-"
    f"{'scores' if f & Flag.SCORE_ONLY else 'cigars'}" for n, f in TREND])
def test_scaling_trend_1_2_4_8(n_devices, flag):
    """A second call of the same batch, on a newly built mesh of the same
    width (or none), neither builds nor retraces a launch program."""
    jobs = _jobs()
    mat = simple_mat(5, 2, -4)

    def mesh():
        return None if n_devices is None else make_mesh(n_devices)

    first = align_batch(jobs, 5, mat, 4, 2, zdrop=100, flag=flag,
                        mesh=mesh())
    progs = _programs(jobs, mat, flag, mesh())
    misses = scheduler._compiled.cache_info().misses
    traced = [p._cache_size() for p in progs]
    again = align_batch(jobs, 5, mat, 4, 2, zdrop=100, flag=flag,
                        mesh=mesh())
    assert again == first
    assert scheduler._compiled.cache_info().misses == misses
    assert [p._cache_size() for p in progs] == traced
