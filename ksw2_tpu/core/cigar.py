"""CIGAR codec: BAM-encoded run-length alignment operations.

Encoding follows the BAM convention used by the reference
(``/root/reference/ksw2.h:113-123``): each uint32 stores ``length << 4 | op``.
Adjacent equal ops merge on push.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

from .flags import CIGAR_CHARS, CigarOp


def push(cigar: List[int], op: int, length: int) -> None:
    """Append ``length`` ops, merging with the trailing run when equal."""
    if length <= 0:
        return
    if cigar and (cigar[-1] & 0xF) == op:
        cigar[-1] += length << 4
    else:
        cigar.append((length << 4) | op)


def to_pairs(cigar: Sequence[int]) -> List[Tuple[int, int]]:
    """Decode to ``[(length, op), ...]``."""
    return [(int(c) >> 4, int(c) & 0xF) for c in cigar]


def to_string(cigar: Sequence[int]) -> str:
    """Pretty-print, e.g. ``5M2D27M``."""
    return "".join(f"{int(c) >> 4}{CIGAR_CHARS[int(c) & 0xF]}" for c in cigar)


def from_string(s: str) -> List[int]:
    """Parse a CIGAR string back into BAM-encoded uint32 runs."""
    out: List[int] = []
    num = ""
    for ch in s:
        if ch.isdigit():
            num += ch
        else:
            push(out, CIGAR_CHARS.index(ch), int(num))
            num = ""
    if num:
        raise ValueError(f"dangling length in CIGAR string: {s!r}")
    return out


def consumed(cigar: Sequence[int]) -> Tuple[int, int]:
    """Return ``(target_consumed, query_consumed)`` base counts."""
    t = q = 0
    for length, op in to_pairs(cigar):
        if op in (CigarOp.MATCH, CigarOp.EQ, CigarOp.X):
            t += length
            q += length
        elif op in (CigarOp.DEL, CigarOp.N_SKIP):
            t += length
        elif op == CigarOp.INS:
            q += length
    return t, q


def to_eqx(cigar: Sequence[int], query: np.ndarray, target: np.ndarray) -> List[int]:
    """Rewrite M runs into =/X by comparing the sequences.

    Semantics mirror ``ksw_cigar2eqx`` (reference: ksw2.h:163-182): other ops
    pass through; M runs are split base-by-base into EQ/X with run merging.
    """
    out: List[int] = []
    x = y = 0
    for length, op in to_pairs(cigar):
        if op == CigarOp.MATCH:
            for i in range(length):
                if target[x + i] == query[y + i]:
                    push(out, CigarOp.EQ, 1)
                else:
                    push(out, CigarOp.X, 1)
            x += length
            y += length
        else:
            push(out, op, length)
            if op in (CigarOp.DEL, CigarOp.N_SKIP):
                x += length
            elif op == CigarOp.INS:
                y += length
            elif op in (CigarOp.EQ, CigarOp.X):
                x += length
                y += length
    return out


def score_of(
    cigar: Sequence[int],
    query: np.ndarray,
    target: np.ndarray,
    mat: np.ndarray,
    m: int,
    gapo: int,
    gape: int,
    gapo2: int | None = None,
    gape2: int | None = None,
) -> int:
    """Re-score an alignment path; used by property tests.

    Gap runs cost ``min`` over the one/two-piece affine costs, matching the
    two-piece model of the reference (``ksw2_extd.c``).
    """
    mat = np.asarray(mat).reshape(m, m)
    s = 0
    x = y = 0
    for length, op in to_pairs(cigar):
        if op in (CigarOp.MATCH, CigarOp.EQ, CigarOp.X):
            for i in range(length):
                s += int(mat[int(target[x + i]), int(query[y + i])])
            x += length
            y += length
        elif op in (CigarOp.DEL, CigarOp.N_SKIP, CigarOp.INS):
            cost = gapo + gape * length
            if gapo2 is not None:
                cost = min(cost, gapo2 + (gape2 if gape2 is not None else gape) * length)
            s -= cost
            if op == CigarOp.INS:
                y += length
            else:
                x += length
    return s


def reverse(cigar: Iterable[int]) -> List[int]:
    return list(cigar)[::-1]


__all__ = [
    "push",
    "to_pairs",
    "to_string",
    "from_string",
    "consumed",
    "to_eqx",
    "score_of",
    "reverse",
]
