"""Batched anti-diagonal DP as a plain XLA program (any backend).

One engine for minimap2's two DNA extension kernels: one-piece affine
(``ksw_extz2_sse``) and two-piece affine (``ksw_extd2_sse``), chosen by
``BatchSpec.two``.  Thousands of padded pairs advance one anti-diagonal per
``lax.scan`` step, vectorised over the batch; the state planes are int8 and
wrap exactly like the reference's SSE bytes (``_mm_add_epi8`` etc.), so
every observable of the reference is reproduced: 16-lane band rounding and
the garbage lanes inside it, the stale score-profile lanes, the exact-max
argmax tie order, the Z-drop stopping diagonal, and the extd pre-swap H
seed.  With ``BatchSpec.nc > 0`` the engine also emits the direction bytes
of every diagonal (the ``KSW_EZ_*`` CIGAR mode) in a band-relative window
that :mod:`ksw2_tpu.ops.traceback` walks on the device.

This is the arithmetic reference of the device path: the CUDA forward
kernel (:mod:`ksw2_tpu.ops.cuda_ext`) is held byte-equal to it, and on the
CPU it is the engine.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.flags import NEG_INF, Flag
from ..spec.common import c_div

I32 = jnp.int32
I8 = jnp.int8
_INT_MIN = -(2 ** 31) + 1
_BIGKEY = 2 ** 30

# column order of the (B, NFIELDS) result records
FIELDS = ("max", "max_t", "max_q", "mqe", "mqe_t", "mte", "mte_q", "score",
          "zdropped")
NFIELDS = len(FIELDS)


class BatchSpec(NamedTuple):
    """Static bucket configuration: one compilation per spec and shape.

    The scoring parameters are not part of it; they travel as the runtime
    vector of :func:`make_params`, so every cost setting reuses the
    compiled program.
    """
    Lq: int          # padded query length
    Lt: int          # padded target length (multiple of 16)
    two: bool        # two-piece (extd2) gap model
    flag: int        # structural Flag bits (STRUCT_FLAGS)
    nc: int          # direction-row width in bytes (0: scores only)


# Flag bits that change the compiled program; REV_CIGAR and EQX act on the
# host only
STRUCT_FLAGS = (Flag.SCORE_ONLY | Flag.RIGHT | Flag.GENERIC_SC
                | Flag.APPROX_MAX | Flag.APPROX_DROP | Flag.EXTZ_ONLY)

# layout of the runtime parameter vector
(P_M, P_MCH, P_MIS, P_N, P_Q, P_E, P_Q2, P_E2, P_SEED, P_ZDROP, P_LTHR,
 P_LDIFF, P_EB) = range(13)
NPARAMS = 13


def make_params(m, mat, q, e, q2=None, e2=None, zdrop=-1, end_bonus=0):
    """Runtime parameter vector (int32, :data:`NPARAMS`) of one cost
    setting.

    Gap costs are canonical: for two-piece runs ``q + e <= q2 + e2`` (the
    reference swaps them, ksw2_extd2_sse.c:78); the seed is the cost of H
    on diagonal 0 (``2*(q+e)`` one-piece, the pre-swap ``q+e`` two-piece,
    ksw2_extd2_sse.c:68).
    """
    mat = np.asarray(mat, np.int8).reshape(-1)
    q, e = int(q), int(e)
    lthr = ldiff = 0
    if q2 is not None:
        q2, e2 = int(q2), int(e2)
        seed = q + e
        if q2 + e2 < q + e:
            q, q2, e, e2 = q2, q, e2, e
        ew = e2
        lthr, ldiff = long_thres(q, e, q2, e2)
    else:
        q2 = e2 = 0
        seed = 2 * (q + e)
        ew = e
    corner = int(mat[m * m - 1])
    sc_N = -ew if corner == 0 else corner
    return np.array([m, int(mat[0]), int(mat[1]), sc_N, q, e, q2, e2, seed,
                     int(zdrop), lthr, ldiff, int(end_bonus)], np.int32)


def n_col_bytes(qlen: int, tlen: int, w: int) -> int:
    """Direction-row width the reference allocates (ksw2_extz2_sse.c:86)."""
    n = (min(min(qlen, tlen), w + 1) + 15) // 16 + 1
    return n * 16


def long_thres(q, e, q2, e2):
    """(long_thres, long_diff): where the two gap lines cross
    (ksw2_extd2_sse.c:88-92)."""
    lt = c_div(q2 - q, e - e2) - 1 if e != e2 else 0
    if q2 + e2 + lt * e2 > q + e + lt * e:
        lt += 1
    return lt, lt * (e - e2) - (q2 - q) - e2


def _u8(x):
    return jax.lax.bitcast_convert_type(x, jnp.uint8)


def _shift1(arr, first):
    """Batched lane shift: out[:, k] = arr[:, k-1], out[:, 0] = first."""
    return jnp.concatenate([first[:, None], arr[:, :-1]], axis=1)


def _gather(arr, idx):
    return jnp.take_along_axis(arr, idx[:, None], axis=1)[:, 0]


def forward(spec: BatchSpec, query, target, qlen, tlen, w, mat, prm):
    """The batched forward DP (unjitted; see :func:`ext_batch`).

    Args:
      query:  (B, Lq) int8 encoded bases, zero-padded
      target: (B, Lt) int8
      qlen, tlen, w: (B,) int32 per-pair lengths and band (w >= 0)
      mat:    (m*m,) int8 scoring matrix (read under GENERIC_SC only)
      prm:    (NPARAMS,) int32 runtime parameters (:func:`make_params`)

    Returns ``(records, p)``: (B, NFIELDS) int32 records in
    :data:`FIELDS` order and, when ``spec.nc``, the (n_diag, B, nc) uint8
    direction rows (row r holds lanes [st_r, st_r + nc) of diagonal r,
    ``st_r`` the 16-rounded band start), else None.
    """
    B = target.shape[0]
    N = spec.Lt
    flag = Flag(spec.flag)
    two = spec.two
    cigar = spec.nc > 0
    right = bool(flag & Flag.RIGHT)
    generic = bool(flag & Flag.GENERIC_SC)
    approx = bool(flag & Flag.APPROX_MAX)
    m, sc_mch, sc_mis, sc_N = (prm[k] for k in (P_M, P_MCH, P_MIS, P_N))
    q, e, q2, e2 = (prm[k] for k in (P_Q, P_E, P_Q2, P_E2))
    qe, qe2 = q + e, q2 + e2
    ez_e = e2 if two else e              # Z-drop gap-extension cost
    sub = 0 if two else qe               # per-step H offset
    n_diag_max = spec.Lq + spec.Lt - 1
    tvec = jnp.arange(N, dtype=I32)[None, :]
    tn = target == m - 1
    i8 = functools.partial(jnp.asarray, dtype=I8)

    def b8(v):
        """int32 -> wrapping int8 (C's truncating conversion)."""
        return v.astype(I8)

    def edge_v(r):
        """Two-piece first-row/column delta at diagonal r."""
        return b8(jnp.where(r == 0, -qe, jnp.where(
            r < prm[P_LTHR], -e, jnp.where(r == prm[P_LTHR], prm[P_LDIFF],
                                           -e2))))

    init = b8(-qe) if two else i8(0)
    planes = dict(u=init, v=init, x=init, y=init)
    if two:
        planes.update(x2=b8(-qe2), y2=b8(-qe2))
    st = {k: jnp.full((B, N), v, I8) for k, v in planes.items()}
    st.update(
        s=jnp.zeros((B, N), I8),
        Q=jnp.zeros((B, N), I8),
        H=jnp.full((B, N), NEG_INF, I32),
        max=jnp.zeros((B,), I32),
        max_t=jnp.full((B,), -1, I32),
        max_q=jnp.full((B,), -1, I32),
        mqe=jnp.full((B,), NEG_INF, I32),
        mqe_t=jnp.full((B,), -1, I32),
        mte=jnp.full((B,), NEG_INF, I32),
        mte_q=jnp.full((B,), -1, I32),
        score=jnp.full((B,), NEG_INF, I32),
        zdropped=jnp.zeros((B,), I32),
        fin=jnp.zeros((B,), bool),
        H0=jnp.zeros((B,), I32),
        last_H0_t=jnp.zeros((B,), I32),
        last_st=jnp.full((B,), -1, I32),
        last_en=jnp.full((B,), -1, I32),
    )
    if approx:
        del st["H"]

    def zdrop(st, act, Hval, r, tt):
        """ksw_apply_zdrop (ksw2.h:191-207); returns the trigger mask."""
        better = act & (Hval > st["max"])
        mt, mq = st["max_t"], st["max_q"]
        l = jnp.abs((tt - mt) - ((r - tt) - mq))
        trig = (act & jnp.logical_not(better) & (tt >= mt)
                & (r - tt >= mq) & (prm[P_ZDROP] >= 0)
                & (st["max"] - Hval > prm[P_ZDROP] + l * ez_e))
        st["max"] = jnp.where(better, Hval, st["max"])
        st["max_t"] = jnp.where(better, tt, mt)
        st["max_q"] = jnp.where(better, r - tt, mq)
        st["zdropped"] = jnp.where(trig, 1, st["zdropped"])
        st["fin"] = st["fin"] | trig
        return trig

    def body(st_, r):
        st = dict(st_)
        n_diag = qlen + tlen - 1
        st0 = jnp.maximum(0, jnp.maximum(r - qlen + 1, (r - w + 1) >> 1))
        en0 = jnp.minimum(tlen - 1, jnp.minimum(r, (r + w) >> 1))
        empty = st0 > en0
        live = (r < n_diag) & jnp.logical_not(st["fin"])
        act = live & jnp.logical_not(empty)
        # an empty band ends the run as Z-dropped (ksw2_extz2_sse.c:111-114)
        st["zdropped"] = jnp.where(live & empty, 1, st["zdropped"])
        st["fin"] = st["fin"] | (live & empty)

        stb = st0 // 16 * 16
        enb = (en0 + 16) // 16 * 16 - 1
        in_range = (stb - 1 >= st["last_st"]) & (stb - 1 <= st["last_en"])
        need_ov = ((stb == 0) | jnp.logical_not(in_range))[:, None]
        am = act[:, None]
        ovm = (tvec == stb[:, None]) & need_ov

        # first-column boundary cell t == r (ksw2_extz2_sse.c:120-123)
        col = am & (enb >= r)[:, None] & (tvec == r)
        if two:
            u0 = jnp.where(col, edge_v(r), st["u"])
            y0 = jnp.where(col, b8(-qe), st["y"])
            y20 = jnp.where(col, b8(-qe2), st["y2"])
            v_edge = jnp.where(stb == 0, edge_v(r), b8(-qe))
            x_edge = jnp.broadcast_to(b8(-qe), (B,))
        else:
            ucol = b8(jnp.where(r > 0, q, 0))
            u0 = jnp.where(col, ucol, st["u"])
            y0 = jnp.where(col, i8(0), st["y"])
            v_edge = jnp.where(stb == 0, ucol, i8(0))
            x_edge = jnp.zeros((B,), I8)

        # query symbols along the diagonal (t -> query[r - t])
        qv = _gather(query, jnp.clip(r, 0, jnp.maximum(qlen - 1, 0)))
        Qn = jnp.where(am, _shift1(st["Q"], qv), st["Q"])
        # score profile: only these lanes are refreshed, the others keep
        # stale values exactly like the reference's s[] buffer
        if generic:
            sval = jnp.take(mat, target.astype(I32) * m
                            + Qn.astype(I32)).astype(I8)
            fill_hi = en0
        else:
            eq = target == Qn
            nm = tn | (Qn == m - 1)
            sval = jnp.where(eq, b8(sc_mch), b8(sc_mis))
            sval = jnp.where(nm, b8(sc_N), sval)
            fill_hi = st0 + ((en0 - st0) // 16) * 16 + 15
        smask = am & (tvec >= st0[:, None]) & (tvec <= fill_hi[:, None])
        s = jnp.where(smask, sval, st["s"])

        zero8 = jnp.zeros((B,), I8)
        xt1 = jnp.where(ovm, x_edge[:, None], _shift1(st["x"], zero8))
        vt1 = jnp.where(ovm, v_edge[:, None], _shift1(st["v"], zero8))
        a = xt1 + vt1
        b = y0 + u0
        if not two:
            zz = s + b8(2 * qe)
            if cigar:
                d = (zz <= a) if right else (a > zz)
                d = d.astype(jnp.uint8)
            z = jnp.maximum(zz, a)
            if cigar:
                take_b = (z <= b) if right else (b > z)
                d = jnp.where(take_b, jnp.uint8(2), d)
            z = jax.lax.bitcast_convert_type(
                jnp.minimum(jnp.maximum(_u8(z), _u8(b)),
                            (sc_mch + 2 * qe).astype(jnp.uint8)), I8)
            unew = z - vt1
            vnew = z - u0
            z2 = z - b8(q)
            a = a - z2
            b = b - z2
            cands = (a, b)
        else:
            x2t1 = jnp.where(ovm, b8(-qe2), _shift1(st["x2"], zero8))
            a2 = x2t1 + vt1
            b2 = y20 + u0
            z = s
            d = jnp.zeros((B, N), jnp.uint8) if cigar else None
            for cand, code in ((a, 1), (b, 2), (a2, 3), (b2, 4)):
                if cigar:
                    take = (z <= cand) if right else (cand > z)
                    d = jnp.where(take, jnp.uint8(code), d)
                z = jnp.maximum(z, cand)
            z = jnp.minimum(z, b8(sc_mch))
            unew = z - vt1
            vnew = z - u0
            t1 = z - b8(q)
            t2 = z - b8(q2)
            a, b, a2, b2 = a - t1, b - t1, a2 - t2, b2 - t2
            cands = (a, b, a2, b2)
        if cigar:
            for k, c in enumerate(cands):
                bit = (c >= 0) if right else (c > 0)
                d = d | (bit.astype(jnp.uint8) << (3 + k))
        bmask = am & (tvec >= stb[:, None]) & (tvec <= enb[:, None])
        pos = lambda c: jnp.maximum(c, i8(0))          # noqa: E731
        st["u"] = jnp.where(bmask, unew, u0)
        st["v"] = jnp.where(bmask, vnew, st["v"])
        if two:
            st["x"] = jnp.where(bmask, pos(a) - b8(qe), st["x"])
            st["y"] = jnp.where(bmask, pos(b) - b8(qe), y0)
            st["x2"] = jnp.where(bmask, pos(a2) - b8(qe2), st["x2"])
            st["y2"] = jnp.where(bmask, pos(b2) - b8(qe2), y20)
        else:
            st["x"] = jnp.where(bmask, pos(a), st["x"])
            st["y"] = jnp.where(bmask, pos(b), y0)
        st["Q"] = Qn
        st["s"] = s

        # H deltas: unsigned bytes one-piece, signed two-piece
        if two:
            vu = st["v"].astype(I32)
            uu = st["u"].astype(I32)
        else:
            vu = _u8(st["v"]).astype(I32)
            uu = _u8(st["u"]).astype(I32)
        is0 = r == 0
        last = act & (r == qlen + tlen - 2) & (en0 == tlen - 1)
        if not approx:
            H = st["H"]
            h_en0 = jnp.where(
                en0 > 0,
                _gather(H, jnp.maximum(en0 - 1, 0)) + _gather(uu, en0) - sub,
                _gather(H, en0) + _gather(vu, en0) - sub)
            h_last = jnp.where(is0, vu[:, 0] - prm[P_SEED], h_en0)
            scan = (bmask & (tvec >= st0[:, None]) & (tvec < en0[:, None])
                    & jnp.logical_not(is0))
            Hnew = H + vu - sub
            H = jnp.where(scan, Hnew, H)
            M = jnp.maximum(jnp.max(jnp.where(scan, Hnew, _INT_MIN), axis=1),
                            h_last)
            # the reference's 4-lane max scan (spec.common.exact_max_scan):
            # lane order, then first block, then the scalar tail
            en1 = st0 + (en0 - st0) // 4 * 4
            cls = (tvec - st0[:, None]) & 3
            key = jnp.where(tvec < en1[:, None], cls * (1 << 26) + tvec,
                            (1 << 28) + tvec)
            kmin = jnp.min(jnp.where(scan & (Hnew == M[:, None]), key,
                                     _BIGKEY), axis=1)
            max_t = jnp.where(h_last == M, en0, kmin & ((1 << 26) - 1))
            max_t = jnp.where(is0, 0, max_t)
            H = jnp.where(am & (tvec == en0[:, None]), h_last[:, None], H)
            st["H"] = H
            upd = act & (en0 == tlen - 1) & (h_last > st["mte"])
            st["mte"] = jnp.where(upd, h_last, st["mte"])
            st["mte_q"] = jnp.where(upd, r - enb, st["mte_q"])
            h_st0 = _gather(H, st0)
            upd = act & (r - st0 == qlen - 1) & (h_st0 > st["mqe"])
            st["mqe"] = jnp.where(upd, h_st0, st["mqe"])
            st["mqe_t"] = jnp.where(upd, st0, st["mqe_t"])
            trig = zdrop(st, act, M, r, max_t)
            st["score"] = jnp.where(last & jnp.logical_not(trig), h_last,
                                    st["score"])
        else:
            lt = st["last_H0_t"]
            c1 = (lt >= st0) & (lt <= en0)
            c2 = (lt + 1 >= st0) & (lt + 1 <= en0)
            d0 = _gather(vu, lt) - sub
            d1 = _gather(uu, jnp.minimum(lt + 1, N - 1)) - sub
            both = c1 & c2
            newH0 = jnp.where(both, st["H0"] + jnp.maximum(d0, d1),
                              jnp.where(c1, st["H0"] + d0, st["H0"] + d1))
            newlt = jnp.where(both, jnp.where(d0 > d1, lt, lt + 1),
                              jnp.where(c1, lt, lt + 1))
            st["H0"] = jnp.where(act, jnp.where(is0, vu[:, 0] - prm[P_SEED],
                                                newH0), st["H0"])
            st["last_H0_t"] = jnp.where(act, jnp.where(is0, 0, newlt), lt)
            trig = jnp.zeros((B,), bool)
            if flag & Flag.APPROX_DROP:
                # one-piece skips diagonal 0; two-piece tests it too
                dact = act if two else act & jnp.logical_not(is0)
                trig = zdrop(st, dact, st["H0"], r, st["last_H0_t"])
            st["score"] = jnp.where(last & jnp.logical_not(trig), st["H0"],
                                    st["score"])

        st["last_st"] = jnp.where(act, stb, st["last_st"])
        st["last_en"] = jnp.where(act, enb, st["last_en"])
        row = None
        if cigar:
            k = jnp.arange(spec.nc, dtype=I32)[None, :]
            idx = jnp.minimum(stb[:, None] + k, N - 1)
            row = jnp.take_along_axis(d, idx, axis=1)
            row = jnp.where(am & (k <= (enb - stb)[:, None]), row,
                            jnp.uint8(0))
        return st, row

    out, p = jax.lax.scan(body, st, jnp.arange(n_diag_max, dtype=I32))
    rec = jnp.stack([out[k].astype(I32) for k in FIELDS], axis=1)
    return rec, p


@functools.partial(jax.jit, static_argnums=(0,))
def ext_batch(spec: BatchSpec, query, target, qlen, tlen, w, mat, prm):
    """Jitted :func:`forward` (the XLA engine of the device path)."""
    return forward(spec, query, target, qlen, tlen, w, mat, prm)


__all__ = ["BatchSpec", "FIELDS", "NFIELDS", "NPARAMS", "STRUCT_FLAGS",
           "make_params", "n_col_bytes", "long_thres", "forward",
           "ext_batch"]
