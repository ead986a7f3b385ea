"""The device walk as the GPU compiles it, held to the spec on the CPU.

The CPU takes one walk step per loop iteration and the GPU 16
(``ops.dispatch.walk_unroll``).  These cases run ``test_differential``'s
jobs with the walk forced to 16 steps per iteration, so the walk the GPU
runs is checked against the spec for both gap models, left and right
gaps, approximate maxima, extension-only start cells, reversed and EQX
CIGARs, Z-drop ends and bands, including walks that end inside a block
of 16 steps.  Each flag set compiles its own programs (the unrolled walk
compiles slowly on the CPU), so the flags are combined into three sets.
"""
import pytest

from ksw2_tpu.batch import scheduler
from ksw2_tpu.core.flags import Flag
from test_differential import ZDROP_W, device_results, spec_results

CIGAR_FLAGS = [
    (Flag.NONE, 0),
    (Flag.RIGHT | Flag.APPROX_MAX | Flag.APPROX_DROP | Flag.EQX, 0),
    (Flag.EXTZ_ONLY | Flag.REV_CIGAR | Flag.RIGHT, 11),
]


@pytest.mark.parametrize("zdrop,w", ZDROP_W)
@pytest.mark.parametrize("flag,end_bonus", CIGAR_FLAGS,
                         ids=[f"f{int(f)}" for f, _ in CIGAR_FLAGS])
@pytest.mark.parametrize("two", [False, True], ids=["extz", "extd"])
def test_walk16_matches_spec(monkeypatch, two, flag, end_bonus, zdrop, w):
    monkeypatch.setattr(scheduler, "walk_unroll", lambda: 16)
    assert device_results(two, flag, end_bonus, zdrop, w) == \
        spec_results(two, flag, end_bonus, zdrop, w)
