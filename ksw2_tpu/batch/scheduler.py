"""Pair-batch scheduler: bucketing, padding, dispatch.

The reference processes pairs serially (cli.c:220-248).  Here pairs are
bucketed by padded (query, target) length so thousands advance together
through one batched forward, whose direction bytes the device traceback
walks in the same jitted program (one compiled program per bucket shape;
the kalloc arena's allocation reuse becomes compilation reuse).  The
forward comes from :func:`ksw2_tpu.ops.dispatch.select_forward`; every
bucket is dispatched before any result is fetched, so the device runs the
whole batch back to back while the host prepares the next bucket.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, NamedTuple, Optional, Sequence

import jax
import numpy as np

from ..core.flags import Flag
from ..core.result import ExtzResult
from ..ops import traceback as tb
from ..ops.batch_xla import (FIELDS, NFIELDS, P_EB, P_Q, P_E, STRUCT_FLAGS,
                             BatchSpec, make_params, n_col_bytes)
from ..ops.dispatch import select_forward, walk_unroll


def _ladder():
    out, v = [1, 2, 4, 8, 16, 32, 64], 64
    while v < 1 << 22:
        v = v * 3 // 2 if v & (v - 1) == 0 else v * 4 // 3
        out.append(v)
    return out


_LADDER = _ladder()        # 1, 2, 4, ..., 64, 96, 128, 192, 256, 384, ...


def bucket_len(n: int) -> int:
    """Round a length (at least 16, the band block) or a batch size up the
    x1.5 / x1.33 ladder: padding costs at most half a bucket, and shapes
    stay few."""
    for v in _LADDER:
        if v >= n:
            return v
    raise ValueError(f"length {n} exceeds the bucket ladder")


def bucket_key(qn: int, tn: int):
    """(Lq, Lt) bucket of a pair: square, from the longer side.  Extension
    pairs have similar lengths, and one dimension keeps the compiled
    programs few."""
    n = bucket_len(max(qn, tn, 16))
    return n, n


@dataclasses.dataclass
class AlignJob:
    query: np.ndarray   # encoded bases
    target: np.ndarray
    w: int = -1


def _memory_budget() -> int:
    """Bytes one launch may take: a quarter of the device's memory."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 4 if limit else 1 << 30


def _pair_bytes(spec: BatchSpec) -> int:
    """Device bytes one pair of a launch needs (state planes, direction
    rows and walk ops)."""
    n_diag = spec.Lq + spec.Lt - 1
    return 64 * spec.Lt + n_diag * (spec.nc + 2 if spec.nc else 0)


def _program(fwd, spec: BatchSpec, unroll: int, Q, T, qlen, tlen, w, mat,
             prm):
    """Forward, start cells and device walk of one launch."""
    rec, p = fwd(spec, Q, T, qlen, tlen, w, mat, prm)
    if not spec.nc:
        return (rec,)
    i0, j0, reach = tb.start_cells(rec, qlen, tlen, spec.flag, prm[P_EB])
    ops, ij = tb.walk(p, i0, j0, qlen, tlen, w, unroll)
    return rec, i0, reach, ops, ij


@functools.lru_cache(maxsize=512)
def _compiled(fwd, spec: BatchSpec, unroll: int, mesh=None):
    fn = functools.partial(_program, fwd, spec, unroll)
    if mesh is None:
        return jax.jit(fn)
    from ..parallel.mesh import shard_batch
    return shard_batch(mesh, fn, n_sharded=5)


class PendingBatch:
    """Handle for an in-flight batch: every launch is enqueued and its
    device->host copies started at submit time; :meth:`result` waits for
    them and assembles the per-job results."""

    def __init__(self, jobs, results, launches, flag: Flag, two: bool):
        self._jobs = jobs
        self._results = results
        self._launches = launches        # (job indices, device outputs)
        self._flag = flag
        self._two = two
        self._done = False

    def result(self) -> List[ExtzResult]:
        if self._done:
            return self._results
        for idxs, outs in self._launches:
            host = [np.asarray(o) for o in outs]
            rec = host[0]
            n = len(idxs)
            cigars = None
            if len(host) > 1:
                _, i0, reach, ops, ij = (h[:n] for h in host)
                eqx = self._two and bool(self._flag & Flag.EQX)
                cigars = tb.finish_cigars(
                    ops, ij, i0 >= 0, int(self._flag),
                    *(([self._jobs[i].query for i in idxs],
                       [self._jobs[i].target for i in idxs]) if eqx
                      else ()))
            for k, i in enumerate(idxs):
                ez = ExtzResult()
                ez.reset()
                (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte,
                 ez.mte_q, ez.score) = (int(v) for v in rec[k, :8])
                ez.zdropped = bool(rec[k, 8])
                if cigars is not None:
                    ez.reach_end = bool(reach[k])
                    ez.cigar = cigars[k]
                self._results[i] = ez
        self._done = True
        return self._results

    def result_array(self) -> np.ndarray:
        """The batch's records as one ``(n_jobs, NFIELDS)`` int32 array in
        job order (columns :data:`~ksw2_tpu.ops.batch_xla.FIELDS`),
        without building per-job objects.  Empty or guarded jobs carry
        reset rows."""
        ez = ExtzResult()
        ez.reset()
        out = np.tile(np.array([int(getattr(ez, k)) for k in FIELDS],
                               np.int32), (len(self._results), 1))
        for idxs, outs in self._launches:
            out[np.asarray(idxs)] = np.asarray(outs[0])[:len(idxs)]
        return out


class Launch(NamedTuple):
    """One device launch of a batch: which jobs, the bucket's static spec
    and the padded arguments of the launch program."""
    idxs: List[int]
    spec: BatchSpec
    args: tuple          # (Q, T, qlen, tlen, w, mat, prm)


def plan_launches(jobs: Sequence[AlignJob], m: int, mat: np.ndarray, q: int,
                  e: int, q2: Optional[int] = None, e2: Optional[int] = None,
                  zdrop: int = -1, end_bonus: int = 0,
                  flag: Flag | int = Flag.NONE, n_shards: int = 1):
    """Bucket and pad a batch.  Returns ``(launches, skipped)``: the
    :class:`Launch` list, heaviest bucket first, and the indices of the
    jobs that need no device work (empty, or costs the reference refuses),
    whose result is the reset ``ExtzResult``."""
    flag = Flag(int(flag))
    two = q2 is not None
    if two and e2 is None:
        raise ValueError("two-piece costs need both q2 and e2")
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    with_cigar = not (flag & Flag.SCORE_ONLY)
    prm = make_params(m, mat, q, e, q2, e2, zdrop=zdrop,
                      end_bonus=end_bonus)
    guard = (-int(mat[1:].min()) > 2 * int(prm[P_Q] + prm[P_E])
             or m <= (1 if two else 0))

    buckets: dict = {}
    skipped = []
    for i, job in enumerate(jobs):
        if len(job.query) == 0 or len(job.target) == 0 or guard:
            skipped.append(i)
            continue
        key = bucket_key(len(job.query), len(job.target))
        buckets.setdefault(key, []).append(i)

    budget = _memory_budget()
    launches = []
    # heaviest buckets first: the device starts on the long launches while
    # the host still prepares the rest
    order = sorted(buckets.items(), key=lambda kv: -kv[0][0] * kv[0][1]
                   * len(kv[1]))
    for (Lq, Lt), idxs in order:
        qlen = np.array([len(jobs[i].query) for i in idxs], np.int32)
        tlen = np.array([len(jobs[i].target) for i in idxs], np.int32)
        wv = np.array([jobs[i].w if jobs[i].w >= 0 else max(a, b)
                       for i, a, b in zip(idxs, qlen, tlen)], np.int32)
        nc = 0
        if with_cigar:
            need = max(n_col_bytes(int(a), int(b), int(c))
                       for a, b, c in zip(qlen, tlen, wv))
            nc = -(-need // 64) * 64
        spec = BatchSpec(Lq=Lq, Lt=Lt, two=two,
                         flag=int(flag & STRUCT_FLAGS), nc=nc)
        per_launch = max(1, budget // _pair_bytes(spec))
        for lo in range(0, len(idxs), per_launch):
            sub = idxs[lo:lo + per_launch]
            n = len(sub)
            B = -(-bucket_len(n) // n_shards) * n_shards
            Q = np.zeros((B, Lq), np.int8)
            T = np.zeros((B, Lt), np.int8)
            for k, i in enumerate(sub):
                Q[k, :len(jobs[i].query)] = jobs[i].query
                T[k, :len(jobs[i].target)] = jobs[i].target
            ql, tl, ww = (np.pad(v[lo:lo + n], (0, B - n))
                          for v in (qlen, tlen, wv))
            launches.append(Launch(sub, spec, (Q, T, ql, tl, ww, mat, prm)))
    return launches, skipped


def launch_program(spec: BatchSpec, mesh=None):
    """The jitted program of a launch on this platform (the forward from
    :func:`~ksw2_tpu.ops.dispatch.select_forward`, start cells, walk)."""
    return _compiled(select_forward(), spec, walk_unroll(), mesh)


def align_batch_async(
    jobs: Sequence[AlignJob],
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    q2: Optional[int] = None,
    e2: Optional[int] = None,
    zdrop: int = -1,
    end_bonus: int = 0,
    flag: Flag | int = Flag.NONE,
    mesh=None,
) -> PendingBatch:
    """Submit a batch of extension jobs without waiting.

    One-piece (``q2 is None``, ``ksw_extz2_sse``) or two-piece
    (``ksw_extd2_sse``) gap costs; scores only under ``SCORE_ONLY``, else
    scores and CIGARs.  ``mesh`` shards every launch's batch axis over a
    ``jax.sharding.Mesh``.
    """
    launches, skipped = plan_launches(
        jobs, m, mat, q, e, q2, e2, zdrop=zdrop, end_bonus=end_bonus,
        flag=flag, n_shards=1 if mesh is None else mesh.size)
    results: List[Optional[ExtzResult]] = [None] * len(jobs)
    for i in skipped:
        results[i] = ExtzResult()
        results[i].reset()
    pending = []
    for ln in launches:
        outs = launch_program(ln.spec, mesh)(*ln.args)
        for o in outs:
            o.copy_to_host_async()
        pending.append((ln.idxs, outs))
    return PendingBatch(jobs, results, pending, Flag(int(flag)),
                        q2 is not None)


def align_batch(jobs: Sequence[AlignJob], m: int, mat: np.ndarray, q: int,
                e: int, q2: Optional[int] = None, e2: Optional[int] = None,
                zdrop: int = -1, end_bonus: int = 0,
                flag: Flag | int = Flag.NONE, mesh=None) -> List[ExtzResult]:
    """Align a batch of extension jobs (see :func:`align_batch_async`)."""
    return align_batch_async(jobs, m, mat, q, e, q2, e2, zdrop=zdrop,
                             end_bonus=end_bonus, flag=flag,
                             mesh=mesh).result()


def align_batch_scores_async(jobs: Sequence[AlignJob], m: int,
                             mat: np.ndarray, q: int, e: int,
                             q2: Optional[int] = None,
                             e2: Optional[int] = None, zdrop: int = -1,
                             flag: Flag | int = Flag.SCORE_ONLY,
                             mesh=None) -> PendingBatch:
    """Submit a score-only batch (``SCORE_ONLY`` is implied)."""
    return align_batch_async(jobs, m, mat, q, e, q2, e2, zdrop=zdrop,
                             flag=Flag(int(flag)) | Flag.SCORE_ONLY,
                             mesh=mesh)


def align_batch_scores(jobs: Sequence[AlignJob], m: int, mat: np.ndarray,
                       q: int, e: int, q2: Optional[int] = None,
                       e2: Optional[int] = None, zdrop: int = -1,
                       flag: Flag | int = Flag.SCORE_ONLY,
                       mesh=None) -> List[ExtzResult]:
    """Score a batch of extension jobs (``SCORE_ONLY`` is implied)."""
    return align_batch_scores_async(jobs, m, mat, q, e, q2, e2, zdrop=zdrop,
                                    flag=flag, mesh=mesh).result()


__all__ = ["AlignJob", "Launch", "PendingBatch", "NFIELDS", "bucket_len",
           "bucket_key", "plan_launches", "launch_program",
           "align_batch", "align_batch_async", "align_batch_scores",
           "align_batch_scores_async"]
