"""Property tests over the device path (SURVEY.md section 4).

For global-to-corner runs the CIGAR must consume exactly (tlen, qlen)
bases and re-scoring it must reproduce the reported score.  Run through
the scheduler so the whole path is covered: batched forward, direction
rows, device traceback, host RLE.
"""
import numpy as np
import pytest

import refcmp
from ksw2_tpu.batch.scheduler import AlignJob, align_batch
from ksw2_tpu.core import cigar as C
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat


def _cases(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tlen = int(rng.integers(10, 160))
        t, q = refcmp.random_pair(rng, tlen,
                                  divergence=float(rng.uniform(0, 0.35)),
                                  indel=float(rng.uniform(0, 0.15)))
        out.append(AlignJob(encode_dna(q), encode_dna(t)))
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_extz_cigar_consumes_and_rescoring_matches(seed):
    mat = simple_mat(5, 2, 4)
    jobs = _cases(seed, 6)
    for job, ez in zip(jobs, align_batch(jobs, 5, mat, 4, 2)):
        qs, ts = job.query, job.target
        assert C.consumed(ez.cigar) == (len(ts), len(qs))
        assert C.score_of(ez.cigar, qs, ts, mat, 5, 4, 2) == ez.score


@pytest.mark.parametrize("seed", [3, 4])
def test_extd_cigar_consumes_and_rescoring_matches(seed):
    mat = simple_mat(5, 2, 4)
    jobs = _cases(seed, 5)
    for job, ez in zip(jobs, align_batch(jobs, 5, mat, 4, 2, 13, 1)):
        qs, ts = job.query, job.target
        assert C.consumed(ez.cigar) == (len(ts), len(qs))
        assert C.score_of(ez.cigar, qs, ts, mat, 5, 4, 2,
                          gapo2=13, gape2=1) == ez.score


def test_rev_cigar_is_reversed():
    """REV_CIGAR emits the same runs in the opposite order."""
    mat = simple_mat(5, 2, 4)
    jobs = _cases(5, 6)
    fwd = align_batch(jobs, 5, mat, 4, 2, zdrop=50)
    rev = align_batch(jobs, 5, mat, 4, 2, zdrop=50, flag=Flag.REV_CIGAR)
    for a, b in zip(fwd, rev):
        assert a.cigar == b.cigar[::-1]
        assert a.score == b.score
