"""Spec engines for the anti-diagonal *difference* DP family.

These NumPy implementations replicate, bit for bit, the observable behavior
of the reference's SIMD kernels (SSE4.1 code paths):

* :func:`extz2`  — ``ksw_extz2_sse``  (one-piece affine extension; the workhorse)
* :func:`extd2`  — ``ksw_extd2_sse``  (two-piece affine extension)
* :func:`exts2`  — ``ksw_exts2_sse``  (spliced extension, intron state)
* :func:`extf2`  — ``ksw_extf2_sse``  (linear-gap fast extension, score only)
* :func:`gg2_sse`/:func:`gg2` — global alignment via the difference recurrence

They are *specs*, not the production path: the batched device engines in
:mod:`ksw2_tpu.ops` (extz2/extd2) are validated against these, and these are
validated against golden outputs of the compiled reference binary.

Key replicated behaviors (all observable):

* Suzuki–Kasahara difference state ``u,v,x,y[,x2,y2]`` in wrapping int8,
  updated per anti-diagonal ``r = i + j`` over target index ``t = i``
  (recurrence: ``ksw2_extz2_sse.c:26-47``, derivation ``tex/ksw2.tex``).
* Band bounds ``st,en`` in rotated coordinates, *rounded to 16-lane blocks*
  (``ksw2_extz2_sse.c:107-116``).  The rounded-out lanes compute garbage that
  is deterministic (zero/const-initialised arrays) and can be observed
  through band-edge boundary reads and the traceback matrix, so the rounding
  is replicated exactly rather than widened to a device's vector width.
* The int32 exact-max scan with its 4-lane argmax tie order
  (:func:`ksw2_tpu.spec.common.exact_max_scan`), or the O(1) approximate-max
  walk under ``Flag.APPROX_MAX``.
* Z-drop termination including the exact stopping diagonal.
* Buffer-overlap notes: the reference's unaligned score-profile stores can
  spill past the ``s`` array into its copy of the target (``sf``), but only
  at byte indices below the current (non-decreasing) band start or beyond
  the last real lane — all dead thereafter.  Separate padded arrays here are
  therefore behavior-equivalent; see the analysis in ``tests/test_spec_parity``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..core.flags import NEG_INF, Flag
from ..core.result import ExtzResult
from ..core import cigar as _cigar
from .backtrack import backtrack
from .common import apply_zdrop, c_div, exact_max_scan, sra1

_I8 = np.int8
_U8 = np.uint8


def _i8(v: int) -> np.int8:
    """Python int -> wrapping int8 (C truncating conversion)."""
    return np.int8((int(v) + 128) % 256 - 128)


@dataclasses.dataclass
class Trace:
    """Recorded traceback inputs (direction matrix + per-row offsets)."""

    p: np.ndarray          # (n_diag, n_col) uint8 direction bytes
    off: np.ndarray        # (n_diag,) int32: first stored t per diagonal
    off_end: Optional[np.ndarray]  # last stored t per diagonal (rot layout)
    n_col: int


def _bounds(r: int, qlen: int, tlen: int, wl: int, wr: int) -> tuple[int, int]:
    """Band bounds on diagonal r in rotated coords (ksw2_extz2_sse.c:107-110)."""
    st = max(0, r - qlen + 1, sra1(r - wr + 1))
    en = min(tlen - 1, r, sra1(r + wl))
    return st, en


def _fill_scores(
    s: np.ndarray,
    sf: np.ndarray,
    qr: np.ndarray,
    r: int,
    qlen: int,
    st0: int,
    en0: int,
    m1: int,
    sc_mch: int,
    sc_mis: int,
    sc_N: Optional[int],
) -> None:
    """Specialized match/mismatch[/N] score fill over 16-byte blocks.

    Mirrors the unaligned-vector fill (ksw2_extz2_sse.c:125-140): stores cover
    ``[st0, st0 + 16*floor((en0-st0)/16) + 15]``.
    """
    hi = st0 + ((en0 - st0) // 16) * 16 + 16
    off = qlen - 1 - r
    sq = sf[st0:hi]
    qv = qr[st0 + off : hi + off]
    vals = np.where(sq == qv, _i8(sc_mch), _i8(sc_mis))
    if sc_N is not None:
        mask = (sq == m1) | (qv == m1)
        vals = np.where(mask, _i8(sc_N), vals)
    s[st0:hi] = vals.astype(_I8)


def _fill_scores_generic(
    s: np.ndarray, sf: np.ndarray, qr: np.ndarray, r: int, qlen: int,
    st0: int, en0: int, m: int, mat: np.ndarray,
) -> None:
    """Generic scoring-matrix gather (KSW_EZ_GENERIC_SC path)."""
    off = qlen - 1 - r
    ti = sf[st0 : en0 + 1].astype(np.int32)
    qi = qr[st0 + off : en0 + 1 + off].astype(np.int32)
    s[st0 : en0 + 1] = mat[ti * m + qi]


def _shift1(arr: np.ndarray, first: np.int8) -> np.ndarray:
    """``out[k] = arr[k-1]`` with ``out[0] = first`` (the SSE lane shift)."""
    out = np.empty_like(arr)
    out[0] = first
    out[1:] = arr[:-1]
    return out


def _umax(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """_mm_max_epu8 on int8 arrays."""
    return np.maximum(a.view(_U8), b.view(_U8)).view(_I8)


def _umin_const(a: np.ndarray, c: int) -> np.ndarray:
    """_mm_min_epu8 against a broadcast constant byte."""
    return np.minimum(a.view(_U8), np.uint8(c & 0xFF)).view(_I8)


def _select_traceback_start(
    ez: ExtzResult, flag: Flag, end_bonus: int, qlen: int, tlen: int
) -> Optional[tuple[int, int, bool]]:
    """Pick the traceback end cell (ksw2_extz2_sse.c:292-301).

    Returns (i0, j0, reach_end) or None when no traceback applies.
    """
    if not ez.zdropped and not (flag & Flag.EXTZ_ONLY):
        return tlen - 1, qlen - 1, False
    if not ez.zdropped and (flag & Flag.EXTZ_ONLY) and ez.mqe + end_bonus > ez.max:
        return ez.mqe_t, qlen - 1, True
    if ez.max_t >= 0 and ez.max_q >= 0:
        return ez.max_t, ez.max_q, False
    return None


# ---------------------------------------------------------------------------
# ksw_extz2_sse: one-piece affine extension
# ---------------------------------------------------------------------------

def extz2(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    w: int = -1,
    zdrop: int = -1,
    end_bonus: int = 0,
    flag: Flag | int = Flag.NONE,
    keep_trace: bool = False,
) -> tuple[ExtzResult, Optional[Trace]]:
    """One-piece affine-gap extension (spec of ``ksw_extz2_sse``)."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez, None
    mat = np.asarray(mat, dtype=_I8).reshape(-1)
    with_cigar = not (flag & Flag.SCORE_ONLY)
    approx_max = bool(flag & Flag.APPROX_MAX)

    q, e = int(q), int(e)
    qe = q + e
    sc_mch, sc_mis = int(mat[0]), int(mat[1])
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    max_sc_clamp = sc_mch + 2 * qe  # byte constant for the unsigned min clamp

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    n_col_ = min(qlen, tlen)
    n_col_ = (min(n_col_, w + 1) + 15) // 16 + 1
    max_sc = int(mat.max())
    min_sc = int(mat[1:].min())
    del max_sc
    if -min_sc > 2 * (q + e):
        return ez, None  # mismatches invisible in the delta range (guard)

    N = tlen_ * 16
    u = np.zeros(N, _I8)
    v = np.zeros(N, _I8)
    x = np.zeros(N, _I8)
    y = np.zeros(N, _I8)
    s = np.zeros(N + 16, _I8)
    sf = np.zeros(N + 16, _U8)
    sf[:tlen] = target
    qr = np.zeros(qlen_ * 16 + 16, _U8)
    qr[:qlen] = query[::-1]
    H = np.full(N, NEG_INF, np.int64) if not approx_max else None
    n_diag = qlen + tlen - 1
    if with_cigar:
        p = np.zeros((n_diag, n_col_ * 16), _U8)
        off = np.zeros(n_diag, np.int32)
        off_end = np.zeros(n_diag, np.int32)
    else:
        p = off = off_end = None

    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1
    for r in range(n_diag):
        st0, en0 = _bounds(r, qlen, tlen, wl, wr)
        if st0 > en0:
            ez.zdropped = True
            break
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        # boundary deltas entering lane st (previous diagonal, lane st-1)
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, v1 = x[st - 1], v[st - 1]
            else:
                x1 = v1 = _i8(0)
        else:
            x1, v1 = _i8(0), _i8(q if r else 0)
        if en >= r:  # first-column boundary (j==0 cell at t==r)
            y[r] = 0
            u[r] = _i8(q if r else 0)
        if not (flag & Flag.GENERIC_SC):
            _fill_scores(s, sf, qr, r, qlen, st0, en0, m - 1, sc_mch, sc_mis, sc_N)
        else:
            _fill_scores_generic(s, sf, qr, r, qlen, st0, en0, m, mat)

        sl = slice(st, en + 1)
        S = s[sl]
        zz = S + _i8(2 * qe)
        xt1 = _shift1(x[sl], x1)
        vt1 = _shift1(v[sl], v1)
        ut = u[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        if with_cigar:
            if not (flag & Flag.RIGHT):
                d = np.where(a > zz, 1, 0).astype(_U8)
            else:
                d = np.where(zz > a, 0, 1).astype(_U8)
        z = np.maximum(zz, a)  # signed epi8 max
        if with_cigar:
            if not (flag & Flag.RIGHT):
                d = np.where(b > z, np.uint8(2), d)
            else:
                d = np.where(z > b, d, np.uint8(2))
        z = _umax(z, b)
        z = _umin_const(z, max_sc_clamp)
        u[sl] = z - vt1
        v[sl] = z - ut
        z2 = z - _i8(q)
        a = a - z2
        b = b - z2
        if with_cigar:
            if not (flag & Flag.RIGHT):
                ta, tb = a > 0, b > 0
            else:
                ta, tb = ~(a < 0), ~(b < 0)
            d |= np.where(ta, np.uint8(0x08), np.uint8(0))
            d |= np.where(tb, np.uint8(0x10), np.uint8(0))
        # stored x/y value is max(·,0) in every variant (a==0 stores 0 both ways)
        x[sl] = np.where(a > 0, a, _i8(0))
        y[sl] = np.where(b > 0, b, _i8(0))
        if with_cigar:
            p[r, : en - st + 1] = d
            off[r] = st
            off_end[r] = en

        if not approx_max:
            v32 = v.view(_U8).astype(np.int64)
            u32 = u.view(_U8).astype(np.int64)
            if r > 0:
                max_H, max_t = exact_max_scan(H, v32, u32, st0, en0, qe)
            else:
                H[0] = int(v32[0]) - qe - qe
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and int(H[en0]) > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en
            if r - st0 == qlen - 1 and int(H[st0]) > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if apply_zdrop(ez, True, max_H, r, max_t, zdrop, e):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            v8u = v.view(_U8)
            u8u = u.view(_U8)
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v8u[last_H0_t]) - qe
                    d1 = int(u8u[last_H0_t + 1]) - qe
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v8u[last_H0_t]) - qe
                else:
                    last_H0_t += 1
                    H0 += int(u8u[last_H0_t]) - qe
                if (flag & Flag.APPROX_DROP) and apply_zdrop(
                    ez, True, H0, r, last_H0_t, zdrop, e
                ):
                    break
            else:
                H0 = int(v.view(_U8)[0]) - qe - qe
                last_H0_t = 0
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    trace = Trace(p, off, off_end, n_col_ * 16) if with_cigar else None
    if with_cigar:
        sel = _select_traceback_start(ez, flag, end_bonus, qlen, tlen)
        if sel is not None:
            i0, j0, reach_end = sel
            ez.reach_end = reach_end
            ez.cigar = backtrack(
                p, off, off_end, n_col_ * 16, i0, j0,
                is_rot=True, is_rev=bool(flag & Flag.REV_CIGAR),
            )
    return ez, trace


# ---------------------------------------------------------------------------
# ksw_extd2_sse: two-piece affine extension
# ---------------------------------------------------------------------------

def extd2(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    q2: int,
    e2: int,
    w: int = -1,
    zdrop: int = -1,
    end_bonus: int = 0,
    flag: Flag | int = Flag.NONE,
    keep_trace: bool = False,
) -> tuple[ExtzResult, Optional[Trace]]:
    """Two-piece affine-gap extension (spec of ``ksw_extd2_sse``)."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    if m <= 1 or qlen <= 0 or tlen <= 0:
        return ez, None
    mat = np.asarray(mat, dtype=_I8).reshape(-1)
    with_cigar = not (flag & Flag.SCORE_ONLY)
    approx_max = bool(flag & Flag.APPROX_MAX)

    q, e, q2, e2 = int(q), int(e), int(q2), int(e2)
    # Reference quirk: ksw2_extd2_sse.c computes `qe = q + e` at declaration
    # (line 68) *before* the canonicalization swap (line 78), and uses that
    # stale value to seed H at r==0 (lines 358/379).  When the swap fires,
    # every H value is offset by (qe_pre - qe_post) -- observable in scores.
    qe_pre_swap = q + e
    if q2 + e2 < q + e:  # canonicalize: q+e <= q2+e2
        q, q2 = q2, q
        e, e2 = e2, e
    qe, qe2 = q + e, q2 + e2
    sc_mch, sc_mis = int(mat[0]), int(mat[1])
    sc_N = -e2 if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])

    if w < 0:
        w = max(tlen, qlen)
    wl = wr = w
    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    n_col_ = min(qlen, tlen)
    n_col_ = (min(n_col_, w + 1) + 15) // 16 + 1
    min_sc = int(mat[1:].min())
    if -min_sc > 2 * (q + e):
        return ez, None

    # threshold diagonal where the two gap-cost lines cross (tex/ksw2.tex:235-240)
    long_thres = c_div(q2 - q, e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * (e - e2) - (q2 - q) - e2

    N = tlen_ * 16
    u = np.full(N, _i8(-qe), _I8)
    v = np.full(N, _i8(-qe), _I8)
    x = np.full(N, _i8(-qe), _I8)
    y = np.full(N, _i8(-qe), _I8)
    x2 = np.full(N, _i8(-qe2), _I8)
    y2 = np.full(N, _i8(-qe2), _I8)
    s = np.zeros(N + 16, _I8)
    sf = np.zeros(N + 16, _U8)
    sf[:tlen] = target
    qr = np.zeros(qlen_ * 16 + 16, _U8)
    qr[:qlen] = query[::-1]
    H = np.full(N, NEG_INF, np.int64) if not approx_max else None
    n_diag = qlen + tlen - 1
    if with_cigar:
        p = np.zeros((n_diag, n_col_ * 16), _U8)
        off = np.zeros(n_diag, np.int32)
        off_end = np.zeros(n_diag, np.int32)
    else:
        p = off = off_end = None

    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1
    right = bool(flag & Flag.RIGHT)
    for r in range(n_diag):
        st0, en0 = _bounds(r, qlen, tlen, wl, wr)
        if st0 > en0:
            ez.zdropped = True
            break
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = x[st - 1], x2[st - 1], v[st - 1]
            else:
                x1, x21, v1 = _i8(-qe), _i8(-qe2), _i8(-qe)
        else:
            x1, x21 = _i8(-qe), _i8(-qe2)
            v1 = _i8(
                -qe if r == 0 else (-e if r < long_thres else (long_diff if r == long_thres else -e2))
            )
        if en >= r:
            y[r] = _i8(-qe)
            y2[r] = _i8(-qe2)
            u[r] = _i8(
                -qe if r == 0 else (-e if r < long_thres else (long_diff if r == long_thres else -e2))
            )
        if not (flag & Flag.GENERIC_SC):
            _fill_scores(s, sf, qr, r, qlen, st0, en0, m - 1, sc_mch, sc_mis, sc_N)
        else:
            _fill_scores_generic(s, sf, qr, r, qlen, st0, en0, m, mat)

        sl = slice(st, en + 1)
        z = s[sl].copy()
        xt1 = _shift1(x[sl], x1)
        vt1 = _shift1(v[sl], v1)
        x2t1 = _shift1(x2[sl], x21)
        ut = u[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        a2 = x2t1 + vt1
        b2 = y2[sl] + ut
        if with_cigar:
            d = np.zeros(en - st + 1, _U8)
            for cand, code in ((a, 1), (b, 2), (a2, 3), (b2, 4)):
                if not right:
                    d = np.where(cand > z, np.uint8(code), d)
                else:
                    d = np.where(z > cand, d, np.uint8(code))
                z = np.maximum(z, cand)
        else:
            for cand in (a, b, a2, b2):
                z = np.maximum(z, cand)
        z = np.minimum(z, _i8(sc_mch))  # signed min clamp (extd2 variant)
        u[sl] = z - vt1
        v[sl] = z - ut
        t1 = z - _i8(q)
        a = a - t1
        b = b - t1
        t2 = z - _i8(q2)
        a2 = a2 - t2
        b2 = b2 - t2
        if with_cigar:
            if not right:
                ca, cb, ca2, cb2 = a > 0, b > 0, a2 > 0, b2 > 0
            else:
                ca, cb, ca2, cb2 = ~(a < 0), ~(b < 0), ~(a2 < 0), ~(b2 < 0)
            d |= np.where(ca, np.uint8(0x08), np.uint8(0))
            d |= np.where(cb, np.uint8(0x10), np.uint8(0))
            d |= np.where(ca2, np.uint8(0x20), np.uint8(0))
            d |= np.where(cb2, np.uint8(0x40), np.uint8(0))
            x[sl] = np.where(ca, a, _i8(0)) - _i8(qe)
            y[sl] = np.where(cb, b, _i8(0)) - _i8(qe)
            x2[sl] = np.where(ca2, a2, _i8(0)) - _i8(qe2)
            y2[sl] = np.where(cb2, b2, _i8(0)) - _i8(qe2)
            p[r, : en - st + 1] = d
            off[r] = st
            off_end[r] = en
        else:
            x[sl] = np.where(a > 0, a, _i8(0)) - _i8(qe)
            y[sl] = np.where(b > 0, b, _i8(0)) - _i8(qe)
            x2[sl] = np.where(a2 > 0, a2, _i8(0)) - _i8(qe2)
            y2[sl] = np.where(b2 > 0, b2, _i8(0)) - _i8(qe2)

        if not approx_max:
            v32 = v.astype(np.int64)  # signed reads (int8_t* in the reference)
            u32 = u.astype(np.int64)
            if r > 0:
                max_H, max_t = exact_max_scan(H, v32, u32, st0, en0, 0)
            else:
                H[0] = int(v32[0]) - qe_pre_swap
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and int(H[en0]) > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en
            if r - st0 == qlen - 1 and int(H[st0]) > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if apply_zdrop(ez, True, max_H, r, max_t, zdrop, e2):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t])
                    d1 = int(u[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t])
            else:
                H0 = int(v[0]) - qe_pre_swap
                last_H0_t = 0
            if (flag & Flag.APPROX_DROP) and apply_zdrop(
                ez, True, H0, r, last_H0_t, zdrop, e2
            ):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    trace = Trace(p, off, off_end, n_col_ * 16) if with_cigar else None
    if with_cigar:
        sel = _select_traceback_start(ez, flag, end_bonus, qlen, tlen)
        if sel is not None:
            i0, j0, reach_end = sel
            ez.reach_end = reach_end
            ez.cigar = backtrack(
                p, off, off_end, n_col_ * 16, i0, j0,
                is_rot=True, is_rev=bool(flag & Flag.REV_CIGAR),
            )
        if (flag & Flag.EQX) and ez.cigar:
            ez.cigar = _cigar.to_eqx(ez.cigar, query, target)
    return ez, trace


# ---------------------------------------------------------------------------
# ksw_exts2_sse: spliced extension (intron state on the target)
# ---------------------------------------------------------------------------

def _splice_profiles(
    target: np.ndarray, tlen: int, N: int, noncan: int, flag: Flag,
    junc: Optional[np.ndarray], junc_bonus: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Position-dependent donor/acceptor score profiles.

    Mirrors ksw2_exts2_sse.c:119-171: canonical GT..AG (forward) / CT..AC
    (reverse) sites score 0; high-confidence flanks (GTr / yAG) score 0 with
    the others at ``semi_cost = -noncan/2`` under SPLICE_FLANK; everything
    else costs ``-noncan``.  Optional per-base junction annotations add
    ``junc_bonus``.  The REV_CIGAR variant matches the patterns on the
    reversed coordinates.
    """
    donor = np.zeros(N, _I8)
    acceptor = np.zeros(N, _I8)
    if not (flag & (Flag.SPLICE_FOR | Flag.SPLICE_REV)):
        return donor, acceptor
    semi_cost = c_div(-noncan, 2) if (flag & Flag.SPLICE_FLANK) else 0
    t = target.astype(np.int32)
    fwd = bool(flag & Flag.SPLICE_FOR)
    rev = bool(flag & Flag.SPLICE_REV)
    rc = bool(flag & Flag.REV_CIGAR)
    # vectorized (the python-per-position version cost ~0.3 ms/pair and
    # dominated the fused splice wall — r5 trace); site patterns per
    # (rev_cigar, strand): donor dimer at (i+1, i+2), flank at i+3;
    # acceptor dimer at (i-1, i), flank at i-2
    d_pat = ((2, 0, 1), (1, 0, 1)) if rc else ((2, 3, 0), (1, 3, 0))
    a_pat = ((3, 2, 0), (3, 1, 0)) if rc else ((0, 2, 1), (0, 1, 1))
    dval = np.full(N, -noncan, np.int32)
    aval = np.full(N, -noncan, np.int32)
    if tlen > 4:
        i = np.arange(tlen - 4)
        can1 = np.zeros(tlen - 4, bool)
        if fwd:
            can1 |= (t[i + 1] == d_pat[0][0]) & (t[i + 2] == d_pat[0][1])
        if rev:
            can1 |= (t[i + 1] == d_pat[1][0]) & (t[i + 2] == d_pat[1][1])
        # {0,2} or {1,3} flank; N (4) is never a flank base
        fl = ((t[i + 3] & 1) == d_pat[0][2]) & (t[i + 3] < 4)
        dval[:tlen - 4] = np.where(can1 & fl, 0,
                                   np.where(can1, semi_cost, -noncan))
    if tlen > 2:
        i = np.arange(2, tlen)
        can1 = np.zeros(tlen - 2, bool)
        if fwd:
            can1 |= (t[i - 1] == a_pat[0][0]) & (t[i] == a_pat[0][1])
        if rev:
            can1 |= (t[i - 1] == a_pat[1][0]) & (t[i] == a_pat[1][1])
        fl = ((t[i - 2] & 1) == a_pat[0][2]) & (t[i - 2] < 4)
        aval[2:tlen] = np.where(can1 & fl, 0,
                                np.where(can1, semi_cost, -noncan))
    if junc is not None:
        jd = (1, 8) if (not rc) else (2, 4)      # (fwd bit, rev bit)
        ja = (2, 4) if (not rc) else (1, 8)
        jv = np.asarray(junc[:tlen]).astype(np.int32)
        hitd = np.zeros(tlen, bool)
        hita = np.zeros(tlen, bool)
        if fwd:
            hitd[:tlen - 1] |= (jv[1:tlen] & jd[0]) != 0
            hita |= (jv & ja[0]) != 0
        if rev:
            hitd[:tlen - 1] |= (jv[1:tlen] & jd[1]) != 0
            hita |= (jv & ja[1]) != 0
        dval[:tlen] = np.where(hitd, dval[:tlen].astype(np.int8)
                               .astype(np.int32) + junc_bonus,
                               dval[:tlen])
        aval[:tlen] = np.where(hita, aval[:tlen].astype(np.int8)
                               .astype(np.int32) + junc_bonus,
                               aval[:tlen])
    donor[:] = dval.astype(np.int8)
    acceptor[:] = aval.astype(np.int8)
    return donor, acceptor


def exts2(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    q2: int,
    noncan: int,
    zdrop: int = -1,
    junc_bonus: int = 0,
    flag: Flag | int = Flag.NONE,
    junc: Optional[np.ndarray] = None,
    keep_trace: bool = False,
) -> tuple[ExtzResult, Optional[Trace]]:
    """Spliced mRNA-to-genome extension (spec of ``ksw_exts2_sse``)."""
    flag = Flag(int(flag))
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    q, e, q2, noncan = int(q), int(e), int(q2), int(noncan)
    if m <= 1 or qlen <= 0 or tlen <= 0 or q2 <= q + e:
        return ez, None
    mat = np.asarray(mat, dtype=_I8).reshape(-1)
    with_cigar = not (flag & Flag.SCORE_ONLY)
    approx_max = bool(flag & Flag.APPROX_MAX)

    qe = q + e
    sc_mch, sc_mis = int(mat[0]), int(mat[1])
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    n_col_ = (min(qlen, tlen) + 15) // 16 + 1
    min_sc = int(mat[1:].min())
    if -min_sc > 2 * (q + e):
        return ez, None

    long_thres = c_div(q2 - q, e) - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * e - (q2 - q)

    N = tlen_ * 16
    u = np.full(N, _i8(-qe), _I8)
    v = np.full(N, _i8(-qe), _I8)
    x = np.full(N, _i8(-qe), _I8)
    y = np.full(N, _i8(-qe), _I8)
    x2 = np.full(N, _i8(-q2), _I8)
    donor, acceptor = _splice_profiles(target, tlen, N, noncan, flag, junc, junc_bonus)
    s = np.zeros(N + 16, _I8)
    sf = np.zeros(N + 16, _U8)
    sf[:tlen] = target
    qr = np.zeros(qlen_ * 16 + 16, _U8)
    qr[:qlen] = query[::-1]
    H = np.full(N, NEG_INF, np.int64) if not approx_max else None
    n_diag = qlen + tlen - 1
    if with_cigar:
        p = np.zeros((n_diag, n_col_ * 16), _U8)
        off = np.zeros(n_diag, np.int32)
        off_end = np.zeros(n_diag, np.int32)
    else:
        p = off = off_end = None

    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1
    right = bool(flag & Flag.RIGHT)

    def _ucol(r: int) -> np.int8:
        if r == 0:
            return _i8(-qe)
        if r < long_thres:
            return _i8(-e)
        if r == long_thres:
            return _i8(long_diff)
        return _i8(0)

    for r in range(n_diag):
        st0 = max(0, r - qlen + 1)
        en0 = min(tlen - 1, r)
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = x[st - 1], x2[st - 1], v[st - 1]
            else:
                x1, x21, v1 = _i8(-qe), _i8(-q2), _i8(-qe)
        else:
            x1, x21 = _i8(-qe), _i8(-q2)
            v1 = _ucol(r)
        if en >= r:
            y[r] = _i8(-qe)
            u[r] = _ucol(r)
        if not (flag & Flag.GENERIC_SC):
            _fill_scores(s, sf, qr, r, qlen, st0, en0, m - 1, sc_mch, sc_mis, sc_N)
        else:
            _fill_scores_generic(s, sf, qr, r, qlen, st0, en0, m, mat)

        sl = slice(st, en + 1)
        z = s[sl].copy()
        xt1 = _shift1(x[sl], x1)
        vt1 = _shift1(v[sl], v1)
        x2t1 = _shift1(x2[sl], x21)
        ut = u[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        a2 = x2t1 + vt1
        a2a = a2 + acceptor[sl]
        if with_cigar:
            d = np.zeros(en - st + 1, _U8)
            for cand, code in ((a, 1), (b, 2), (a2a, 3)):
                if not right:
                    d = np.where(cand > z, np.uint8(code), d)
                else:
                    d = np.where(z > cand, d, np.uint8(code))
                z = np.maximum(z, cand)
        else:
            for cand in (a, b, a2a):
                z = np.maximum(z, cand)
        u[sl] = z - vt1
        v[sl] = z - ut
        t1 = z - _i8(q)
        a = a - t1
        b = b - t1
        a2 = a2 - (z - _i8(q2))
        don = donor[sl]
        if with_cigar:
            if not right:
                ca, cb, cd = a > 0, b > 0, a2 > don
            else:
                ca, cb, cd = ~(a < 0), ~(b < 0), ~(don > a2)
            d |= np.where(ca, np.uint8(0x08), np.uint8(0))
            d |= np.where(cb, np.uint8(0x10), np.uint8(0))
            d |= np.where(cd, np.uint8(0x20), np.uint8(0))
            p[r, : en - st + 1] = d
            off[r] = st
            off_end[r] = en
        x[sl] = np.where(a > 0, a, _i8(0)) - _i8(qe)
        y[sl] = np.where(b > 0, b, _i8(0)) - _i8(qe)
        x2[sl] = np.maximum(a2, don) - _i8(q2)

        if not approx_max:
            v32 = v.astype(np.int64)
            u32 = u.astype(np.int64)
            if r > 0:
                max_H, max_t = exact_max_scan(H, v32, u32, st0, en0, 0)
            else:
                H[0] = int(v32[0]) - qe
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and int(H[en0]) > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en
            if r - st0 == qlen - 1 and int(H[st0]) > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if apply_zdrop(ez, True, max_H, r, max_t, zdrop, 0):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t])
                    d1 = int(u[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t])
            else:
                H0 = int(v[0]) - qe
                last_H0_t = 0
            if (flag & Flag.APPROX_DROP) and apply_zdrop(
                ez, True, H0, r, last_H0_t, zdrop, 0
            ):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    trace = Trace(p, off, off_end, n_col_ * 16) if with_cigar else None
    if with_cigar:
        if not ez.zdropped and not (flag & Flag.EXTZ_ONLY):
            i0, j0 = tlen - 1, qlen - 1
        elif ez.max_t >= 0 and ez.max_q >= 0:
            i0, j0 = ez.max_t, ez.max_q
        else:
            i0 = None
        if i0 is not None:
            ez.cigar = backtrack(
                p, off, off_end, n_col_ * 16, i0, j0,
                is_rot=True, is_rev=bool(flag & Flag.REV_CIGAR),
                min_intron_len=long_thres,
            )
    return ez, trace


# ---------------------------------------------------------------------------
# ksw_extf2_sse: linear-gap fast extension (score only, X-drop)
# ---------------------------------------------------------------------------

def extf2(
    query: np.ndarray,
    target: np.ndarray,
    mch: int,
    mis: int,
    e: int,
    w: int = -1,
    xdrop: int = -1,
) -> ExtzResult:
    """Linear-gap extension with X-drop (spec of ``ksw_extf2_sse``)."""
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    mch, e = int(mch), int(e)
    mis = mis if mis < 0 else -mis
    tlen_ = (tlen + 15) // 16
    qlen_ = (qlen + 15) // 16
    if w < 0:
        w = max(tlen, qlen)

    N = tlen_ * 16
    u = np.zeros(N, _I8)
    v = np.zeros(N, _I8)
    s = np.zeros(N + 16, _I8)
    sf = np.zeros(N + 16, _U8)
    sf[:tlen] = target
    qr = np.zeros(qlen_ * 16 + 16, _U8)
    qr[:qlen] = query[::-1]

    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1
    completed = True
    for r in range(qlen + tlen - 1):
        st0, en0 = _bounds(r, qlen, tlen, w, w)
        if st0 > en0:
            completed = False
            break
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        v1 = v[st - 1] if (st > 0 and last_st <= st - 1 <= last_en) else _i8(0)
        if en >= r:
            u[r] = 0
        _fill_scores(s, sf, qr, r, qlen, st0, en0, 0, mch, mis, None)
        sl = slice(st, en + 1)
        z = s[sl] + _i8(2 * e)
        vt1 = _shift1(v[sl], v1)
        ut = u[sl].copy()
        z = np.maximum(z, vt1)   # signed
        z = _umax(z, ut)         # unsigned
        u[sl] = z - vt1
        v[sl] = z - ut
        v8u = v.view(_U8)
        u8u = u.view(_U8)
        if r > 0:
            if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                d0 = int(v8u[last_H0_t]) - e
                d1 = int(u8u[last_H0_t + 1]) - e
                if d0 > d1:
                    H0 += d0
                else:
                    H0 += d1
                    last_H0_t += 1
            elif st0 <= last_H0_t <= en0:
                H0 += int(v8u[last_H0_t]) - e
            else:
                last_H0_t += 1
                H0 += int(u8u[last_H0_t]) - e
            if H0 > ez.max:
                ez.max, ez.max_t, ez.max_q = H0, last_H0_t, r - last_H0_t
            elif xdrop >= 0 and ez.max - H0 > xdrop:
                completed = False
                break
        else:
            H0 = int(v8u[0]) - e - e
            last_H0_t = 0
        last_st, last_en = st, en
    if completed:
        ez.score = H0
    else:
        ez.zdropped = True
    return ez


# ---------------------------------------------------------------------------
# ksw_gg2_sse / ksw_gg2: global alignment via the difference recurrence
# ---------------------------------------------------------------------------

def gg2_sse(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    w: int = -1,
    keep_trace: bool = False,
) -> tuple[int, List[int], Optional[Trace]]:
    """Global alignment, SIMD diagonal form (spec of ``ksw_gg2_sse``)."""
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, dtype=_I8).reshape(-1)
    q, e = int(q), int(e)
    qe = q + e
    if w < 0:
        w = max(tlen, qlen)
    n_col0 = min(w + 1, tlen)
    tlen_ = (tlen + 15) // 16
    n_col_ = (n_col0 + 15) // 16 + 1
    n_col = n_col_ * 16

    N = tlen_ * 16
    u = np.zeros(N, _I8)
    v = np.zeros(N, _I8)
    x = np.zeros(N, _I8)
    y = np.zeros(N, _I8)
    s = np.zeros(N + 16, _I8)
    qr = np.zeros(qlen, _U8)
    qr[:] = query[::-1]
    sfq = np.asarray(target, dtype=_U8)
    n_diag = qlen + tlen - 1
    p = np.zeros((n_diag, n_col), _U8)
    off = np.zeros(n_diag, np.int32)

    H0 = 0
    last_H0_t = 0
    last_st = last_en = -1

    def _blk_u8(region: int, k: int) -> int:
        # The reference allocates u,v,x,y,s contiguously (ksw2_gg2_sse.c:32-34);
        # when qlen > tlen + w, empty bands push the H0 walk past one array and
        # the read lands in the next one.  Deterministic, so replicated.
        regions = (u, v, x, y)
        while region < 4 and k >= N:
            k -= N
            region += 1
        if region < 4:
            return int(regions[region].view(_U8)[k])
        if k < N + 16:
            return int(s.view(_U8)[k])
        return 0  # past the whole block: reference UB, spec reads zero

    for r in range(n_diag):
        st0, en0 = _bounds(r, qlen, tlen, w, w)
        st = st0 // 16 * 16
        en = (en0 + 16) // 16 * 16 - 1
        off[r] = st
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, v1 = x[st - 1], v[st - 1]
            else:
                x1 = v1 = _i8(0)
        else:
            x1, v1 = _i8(0), _i8(q if r else 0)
        if en >= r:
            y[r] = 0
            u[r] = _i8(q if r else 0)
        # generic score fill (gg2_sse always uses the matrix gather)
        if en0 >= st0:
            offq = qlen - 1 - r
            ti = sfq[st0 : en0 + 1].astype(np.int32)
            qi = qr[st0 + offq : en0 + 1 + offq].astype(np.int32)
            s[st0 : en0 + 1] = mat[ti * m + qi]
        if st > en:  # rounded slice empty: vector loop does not run
            if r > 0:
                if st0 <= last_H0_t <= en0:
                    H0 += _blk_u8(1, last_H0_t) - qe
                else:
                    last_H0_t += 1
                    H0 += _blk_u8(0, last_H0_t) - qe
            else:
                H0 = _blk_u8(1, 0) - 2 * qe
                last_H0_t = 0
            last_st, last_en = st, en
            continue
        sl = slice(st, en + 1)
        zz = s[sl] + _i8(2 * qe)
        xt1 = _shift1(x[sl], x1)
        vt1 = _shift1(v[sl], v1)
        ut = u[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        d = np.where(a > zz, np.uint8(1), np.uint8(0))
        z = np.maximum(zz, a)
        d = np.where(b > z, np.uint8(2), d)
        z = _umax(z, b)
        u[sl] = z - vt1
        v[sl] = z - ut
        z2 = z - _i8(q)
        a = a - z2
        b = b - z2
        d |= np.where(a > 0, np.uint8(0x08), np.uint8(0))
        x[sl] = np.where(a > 0, a, _i8(0))
        d |= np.where(b > 0, np.uint8(0x10), np.uint8(0))
        y[sl] = np.where(b > 0, b, _i8(0))
        p[r, : en - st + 1] = d

        if r > 0:
            if st0 <= last_H0_t <= en0:
                H0 += _blk_u8(1, last_H0_t) - qe
            else:
                last_H0_t += 1
                H0 += _blk_u8(0, last_H0_t) - qe
        else:
            H0 = _blk_u8(1, 0) - 2 * qe
            last_H0_t = 0
        last_st, last_en = st, en

    cig = backtrack(p, off, None, n_col, tlen - 1, qlen - 1, is_rot=True)
    return H0, cig, Trace(p, off, None, n_col)


def gg2(
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    w: int = -1,
    with_cigar: bool = True,
) -> tuple[int, List[int], Optional[Trace]]:
    """Global alignment, scalar diagonal form (spec of ``ksw_gg2``)."""
    qlen, tlen = len(query), len(target)
    mat = np.asarray(mat, dtype=_I8).reshape(-1)
    q, e = int(q), int(e)
    qe = q + e
    if w < 0:
        w = max(tlen, qlen)
    n_col = min(w + 1, tlen)

    u = np.zeros(tlen + 1, _I8)
    v = np.zeros(tlen + 1, _I8)
    x = np.zeros(tlen + 1, _I8)
    y = np.zeros(tlen + 1, _I8)
    s = np.zeros(tlen, _I8)
    qr = np.asarray(query[::-1], dtype=_U8)
    tgt = np.asarray(target, dtype=_U8)
    n_diag = qlen + tlen - 1
    if with_cigar:
        p = np.zeros((qlen + tlen, n_col), _U8)
        off = np.zeros(qlen + tlen, np.int32)
    else:
        p = off = None

    H0 = 0
    last_H0_t = 0
    for r in range(n_diag):
        st, en = _bounds(r, qlen, tlen, w, w)
        if st != 0:
            if r > st + st + w - 1 or st - 1 > tlen:
                # second clause: the reference reads x[st-1] out of bounds for
                # pathological bands; the value is unused (empty core loop)
                x1 = v1 = _i8(0)
            else:
                x1, v1 = x[st - 1], v[st - 1]
        else:
            x1, v1 = _i8(0), _i8(q if r else 0)
        if en != r:
            if r < en + en - w - 1:
                y[en] = 0
                u[en] = 0
        else:
            y[r] = 0
            u[r] = _i8(q if r else 0)
        if with_cigar:
            off[r] = st
        if st > en:  # empty band: core loop does not run (no break in ksw_gg2)
            if r > 0:
                if st <= last_H0_t <= en:
                    H0 += int(v[last_H0_t]) - qe
                else:
                    last_H0_t += 1
                    # beyond the array the reference reads heap garbage
                    # (allocator-dependent, verified undefined); read 0 here
                    H0 += (int(u[last_H0_t]) if last_H0_t <= tlen else 0) - qe
            continue
        offq = qlen - 1 - r
        ti = tgt[st : en + 1].astype(np.int32)
        qi = qr[st + offq : en + 1 + offq].astype(np.int32)
        s[st : en + 1] = mat[ti * m + qi]

        sl = slice(st, en + 1)
        zz = s[sl] + _i8(2 * qe)
        xt1 = _shift1(x[sl], x1)
        vt1 = _shift1(v[sl], v1)
        ut = u[sl].copy()
        a = xt1 + vt1
        b = y[sl] + ut
        d = np.where(a > zz, np.uint8(1), np.uint8(0))
        z = np.maximum(zz, a)
        d = np.where(b > z, np.uint8(2), d)
        z = np.maximum(z, b)
        u[sl] = z - vt1
        v[sl] = z - ut
        z2 = z - _i8(q)
        a = a - z2
        b = b - z2
        d |= np.where(a > 0, np.uint8(0x08), np.uint8(0))
        x[sl] = np.where(a > 0, a, _i8(0))
        d |= np.where(b > 0, np.uint8(0x10), np.uint8(0))
        y[sl] = np.where(b > 0, b, _i8(0))
        if with_cigar:
            p[r, : en - st + 1] = d

        if r > 0:
            if st <= last_H0_t <= en:
                H0 += int(v[last_H0_t]) - qe
            else:
                last_H0_t += 1
                H0 += int(u[last_H0_t]) - qe
        else:
            H0 = int(v[0]) - 2 * qe
            last_H0_t = 0

    cig: List[int] = []
    trace = None
    if with_cigar:
        cig = backtrack(p, off, None, n_col, tlen - 1, qlen - 1, is_rot=True)
        trace = Trace(p, off, None, n_col)
    return H0, cig, trace


__all__ = ["extz2", "extd2", "exts2", "extf2", "gg2_sse", "gg2", "Trace"]
