"""Seeded differential cases of the device path against the spec engines.

One module-wide job set (random pairs plus degenerate ones: empty, single
base, all-N, query much longer than target) runs through ``align_batch``
for every gap model, flag combination, Z-drop and band below; every
result field and CIGAR must equal ``spec.diagdiff``.  The jobs are the
same for every case, so the compiled programs are shared across Z-drop
and band settings.
"""
import numpy as np
import pytest

import refcmp
from ksw2_tpu.batch.scheduler import AlignJob, align_batch
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff

MAT = simple_mat(5, 2, 4)


def _pairs():
    rng = np.random.default_rng(2024)
    pairs = []
    for _ in range(8):
        t, q = refcmp.random_pair(rng, int(rng.integers(60, 120)),
                                  float(rng.uniform(0, .35)),
                                  float(rng.uniform(0, .15)), with_n=True)
        pairs.append((q, t))
    pairs += [("", "ACGT"), ("ACGT", ""), ("A", "A"), ("A", "C"),
              ("NNNNNNNN", "NNNNNN"), ("ACGTTGCA" * 12, "ACGTT"),
              ("GATT", "GATTACAGATTACAGATTACA" * 4)]
    return [(encode_dna(q), encode_dna(t)) for q, t in pairs]


PAIRS = _pairs()

FLAGS = [
    (Flag.NONE, 0),
    (Flag.RIGHT, 0),
    (Flag.SCORE_ONLY, 0),
    (Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP, 0),
    (Flag.APPROX_MAX | Flag.APPROX_DROP, 0),
    (Flag.EXTZ_ONLY, 7),
    (Flag.EXTZ_ONLY | Flag.REV_CIGAR | Flag.RIGHT, 11),
    (Flag.EQX, 0),
]

ZDROP_W = [(-1, -1), (40, -1), (20, 10)]


def spec_results(two, flag, end_bonus, zdrop, w):
    """The spec engine's results for :data:`PAIRS`."""
    want = []
    for q, t in PAIRS:
        if two:
            ez, _ = diagdiff.extd2(q, t, 5, MAT, 4, 2, 13, 1, w=w,
                                   zdrop=zdrop, end_bonus=end_bonus,
                                   flag=flag)
        else:
            ez, _ = diagdiff.extz2(q, t, 5, MAT, 4, 2, w=w, zdrop=zdrop,
                                   end_bonus=end_bonus, flag=flag)
        want.append(ez)
    return want


def device_results(two, flag, end_bonus, zdrop, w):
    """``align_batch``'s results for :data:`PAIRS`."""
    jobs = [AlignJob(q, t, w=w) for q, t in PAIRS]
    kw = dict(q2=13, e2=1) if two else {}
    return align_batch(jobs, 5, MAT, 4, 2, zdrop=zdrop, end_bonus=end_bonus,
                       flag=flag, **kw)


@pytest.mark.parametrize("zdrop,w", ZDROP_W)
@pytest.mark.parametrize("flag,end_bonus", FLAGS,
                         ids=[f"f{int(f)}" for f, _ in FLAGS])
@pytest.mark.parametrize("two", [False, True], ids=["extz", "extd"])
def test_device_matches_spec(two, flag, end_bonus, zdrop, w):
    assert device_results(two, flag, end_bonus, zdrop, w) == \
        spec_results(two, flag, end_bonus, zdrop, w)
