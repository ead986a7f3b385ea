"""GENERIC_SC (full scoring matrix) through the device path vs the spec.

The engine gathers the profile from the m*m matrix over exactly
[st0, en0] of each diagonal, with no wildcard replacement
(ksw2_extz2_sse.c:141-144 semantics).
"""
import numpy as np
import pytest

from ksw2_tpu.batch.scheduler import AlignJob, align_batch
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.spec import diagdiff


def _generic_mat(rng, m=5):
    mat = rng.integers(-5, 4, size=(m, m)).astype(np.int8)
    np.fill_diagonal(mat, rng.integers(1, 4, size=m))
    return mat.reshape(-1)


@pytest.mark.parametrize("family", ["extz", "extd"])
@pytest.mark.parametrize("score_only", [True, False])
@pytest.mark.parametrize("banded", [True, False])
def test_generic_sc_device(family, score_only, banded):
    rng = np.random.default_rng(hash((family, score_only, banded)) % 2**32)
    m = 5
    mat = _generic_mat(rng, m)
    jobs = []
    for _ in range(3):
        lq, lt = int(rng.integers(50, 160)), int(rng.integers(50, 160))
        jobs.append(AlignJob(rng.integers(0, m, size=lq).astype(np.int8),
                             rng.integers(0, m, size=lt).astype(np.int8),
                             w=int(rng.integers(20, 120)) if banded else -1))
    fl = Flag.GENERIC_SC | (Flag.SCORE_ONLY if score_only else Flag.NONE)
    two = dict(q2=13, e2=1) if family == "extd" else {}
    got = align_batch(jobs, m, mat, 4, 2, flag=fl, **two)
    for job, ez in zip(jobs, got):
        if family == "extz":
            want, _ = diagdiff.extz2(job.query, job.target, m, mat, 4, 2,
                                     w=job.w, flag=fl)
        else:
            want, _ = diagdiff.extd2(job.query, job.target, m, mat, 4, 2, 13,
                                     1, w=job.w, flag=fl)
        assert ez == want


@pytest.mark.parametrize("approx", [False, True])
def test_generic_sc_device_zdrop(approx):
    """Generic matrix through the exact and approximate Z-drop paths."""
    rng = np.random.default_rng(77)
    m = 5
    mat = _generic_mat(rng, m)
    q = rng.integers(0, m, size=150).astype(np.int8)
    t = np.concatenate([q[:70], rng.integers(0, m, size=90)]).astype(np.int8)
    fl = Flag.SCORE_ONLY | Flag.GENERIC_SC
    if approx:
        fl |= Flag.APPROX_MAX | Flag.APPROX_DROP
    ez = align_batch([AlignJob(q, t)], m, mat, 4, 2, zdrop=60, flag=fl)[0]
    want, _ = diagdiff.extz2(q, t, m, mat, 4, 2, zdrop=60, flag=fl)
    assert ez == want
