"""Traceback over a recorded direction-byte matrix.

Pure-Python replica of the shared backtrack state machine of the reference
(``/root/reference/ksw2.h:125-161``).  Direction byte layout:

* bits 0-2: which state maximised H at this cell (0=H/diag, 1=E, 2=F,
  3=E2 (or intron Ẽ), 4=F2)
* bit 3 (0x08): E gap-continuation, bit 4 (0x10): F continuation
* bit 5 (0x20): E2/Ẽ continuation, bit 6 (0x40): F2/F̃ continuation

The matrix may be laid out row-major (``is_rot=False``: row per target base)
or anti-diagonal (``is_rot=True``: row per diagonal ``r=i+j``); ``off``
gives each stored row's first target/query coordinate and ``off_end``
(diagonal layout only) the last one.  Outside the stored span the state is
forced (below: F, above: E) — band-edge clamping.

This is the semantic reference; the device walk
(:mod:`ksw2_tpu.ops.traceback`) replays it for the anti-diagonal layout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.cigar import push
from ..core.flags import CigarOp


def backtrack(
    p: np.ndarray,
    off: Sequence[int],
    off_end: Optional[Sequence[int]],
    n_col: int,
    i0: int,
    j0: int,
    *,
    is_rot: bool,
    is_rev: bool = False,
    min_intron_len: int = 0,
) -> List[int]:
    """Walk from cell ``(i0, j0)`` back to the origin, emitting a CIGAR."""
    p = p.reshape(-1)

    def _read(idx: int) -> int:
        # The reference indexes the flat matrix without bounds checks; a walk
        # that escapes the band (row layout has no off_end) reads the next
        # row's bytes, and past the buffer reads fresh-mmap zeros (verified
        # identical under kalloc and malloc).  Flat indexing reproduces the
        # in-buffer reads; out-of-buffer reads return 0.
        return int(p[idx]) if 0 <= idx < p.size else 0

    cigar: List[int] = []
    i, j, state = i0, j0, 0
    while i >= 0 and j >= 0:
        force_state = -1
        if is_rot:
            r = i + j
            if i < off[r]:
                force_state = 2
            if off_end is not None and i > off_end[r]:
                force_state = 1
            tmp = _read(r * n_col + i - off[r]) if force_state < 0 else 0
        else:
            if j < off[i]:
                force_state = 2
            if off_end is not None and j > off_end[i]:
                force_state = 1
            tmp = _read(i * n_col + j - off[i]) if force_state < 0 else 0
        if state == 0:
            state = tmp & 7  # at an H cell: take whichever state won the max
        elif not (tmp >> (state + 2)) & 1:
            state = 0  # not a continuation: drop back to H
        if state == 0:
            state = tmp & 7
        if force_state >= 0:
            state = force_state
        if state == 0:
            push(cigar, CigarOp.MATCH, 1)
            i -= 1
            j -= 1
        elif state == 1 or (state == 3 and min_intron_len <= 0):
            push(cigar, CigarOp.DEL, 1)
            i -= 1
        elif state == 3 and min_intron_len > 0:
            push(cigar, CigarOp.N_SKIP, 1)
            i -= 1
        else:
            push(cigar, CigarOp.INS, 1)
            j -= 1
    if i >= 0:
        push(
            cigar,
            CigarOp.N_SKIP if (min_intron_len > 0 and i >= min_intron_len) else CigarOp.DEL,
            i + 1,
        )
    if j >= 0:
        push(cigar, CigarOp.INS, j + 1)
    if not is_rev:
        cigar.reverse()
    return cigar


__all__ = ["backtrack"]
