"""High-level alignment API: configure once, align many.

The reference is consumed (by minimap2) as a family of C calls whose
score parameters are fixed per run while millions of sequence pairs flow
through.  :class:`Aligner` is that usage pattern as an object: costs and
flags are bound at construction (so every compiled kernel variant is
reused across calls), and the methods accept raw DNA strings or encoded
arrays.

    >>> from ksw2_tpu import Aligner
    >>> aln = Aligner(a=2, b=4, q=4, e=2, zdrop=100)
    >>> ez = aln.extend("ACGTGGTAC", "ACGTGGTTC")      # one pair
    >>> ez.score, ez.cigar_string()
    >>> ezs = aln.extend_batch(pairs)                   # many pairs

Two-piece costs (``q2``/``e2``) switch the engines to extd2 semantics.
Every result is an :class:`~ksw2_tpu.core.result.ExtzResult` with the exact
``ksw_extz_t`` field contract (max/mqe/mte/zdropped/reach_end/cigar).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .core.flags import Flag
from .core.matrix import encode_dna, simple_mat
from .core.result import ExtzResult

Seq = Union[str, np.ndarray]


def _enc(s: Seq) -> np.ndarray:
    if isinstance(s, str):
        return encode_dna(s)
    return np.asarray(s)


class Aligner:
    """Pairwise extension aligner with fixed scoring parameters.

    Parameters mirror the reference CLI and kernel signatures: match
    ``a``, mismatch ``b`` (positive), gap open/extend ``q``/``e``,
    optional two-piece ``q2``/``e2`` (extd2), band ``w``, Z-drop
    ``zdrop``, ``end_bonus``, and ``flag`` (any ``Flag`` bits: RIGHT,
    SCORE_ONLY, APPROX_MAX|APPROX_DROP, EXTZ_ONLY, REV_CIGAR, EQX, ...).
    A custom ``mat`` (m*m int8) overrides ``a``/``b`` and implies
    GENERIC_SC unless it is a simple matrix.
    """

    def __init__(self, a: int = 2, b: int = 4, q: int = 4, e: int = 2,
                 q2: Optional[int] = None, e2: Optional[int] = None,
                 w: int = -1, zdrop: int = -1, end_bonus: int = 0,
                 flag: Flag | int = Flag.NONE, m: int = 5,
                 mat: Optional[np.ndarray] = None):
        self.m = int(m)
        self.flag = Flag(int(flag))
        if mat is not None:
            self.mat = np.asarray(mat, np.int8).reshape(-1)
            if not self._is_simple(self.mat, self.m):
                self.flag |= Flag.GENERIC_SC
        else:
            self.mat = simple_mat(self.m, int(a), -int(b))
        self.q, self.e = int(q), int(e)
        self.q2 = None if q2 is None else int(q2)
        self.e2 = None if e2 is None else int(e2)
        self.w, self.zdrop = int(w), int(zdrop)
        self.end_bonus = int(end_bonus)
        if (self.q2 is None) != (self.e2 is None):
            raise ValueError("two-piece costs need both q2 and e2")

    @staticmethod
    def _is_simple(mat: np.ndarray, m: int) -> bool:
        sq = mat.reshape(m, m)
        a, b = int(sq[0, 0]), int(sq[0, 1])
        want = np.full((m, m), b, np.int8)
        np.fill_diagonal(want, a)
        want[m - 1, :] = 0
        want[:, m - 1] = 0
        return bool((sq == want).all())

    def _jobs(self, pairs, w):
        from .batch.scheduler import AlignJob

        return [AlignJob(query=_enc(qy), target=_enc(tg),
                         w=int(w[i]) if w is not None else self.w)
                for i, (qy, tg) in enumerate(pairs)]

    def extend(self, query: Seq, target: Seq) -> ExtzResult:
        """Extension alignment of one pair (the ksw_ext* call family)."""
        return self.extend_batch([(query, target)])[0]

    def extend_batch(self, pairs: Sequence[Tuple[Seq, Seq]],
                     w: Optional[Sequence[int]] = None,
                     mesh=None) -> List[ExtzResult]:
        """Extension alignment of many pairs through the bucketing
        scheduler (scores and CIGARs; scores only under SCORE_ONLY).

        ``w`` optionally gives per-pair bands; ``mesh`` shards every
        launch's batch over a ``jax.sharding.Mesh``
        (:func:`ksw2_tpu.parallel.mesh.make_mesh`).
        """
        return self.extend_batch_async(pairs, w=w, mesh=mesh).result()

    def extend_batch_async(self, pairs: Sequence[Tuple[Seq, Seq]],
                           w: Optional[Sequence[int]] = None, mesh=None):
        """Submit a batch without waiting; returns a handle whose
        ``.result()`` yields the same list :meth:`extend_batch` would
        (and ``.result_array()`` the bare score records).  Several
        batches in flight overlap each one's host work with the device
        work of the others."""
        from .batch.scheduler import align_batch_async

        return align_batch_async(
            self._jobs(pairs, w), self.m, self.mat, self.q, self.e,
            q2=self.q2, e2=self.e2, zdrop=self.zdrop,
            end_bonus=self.end_bonus, flag=self.flag, mesh=mesh)


__all__ = ["Aligner"]
