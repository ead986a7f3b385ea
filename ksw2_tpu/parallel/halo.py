"""Cross-device splitting of ONE alignment: target-sharded halo wavefront.

Every other distributed surface in this framework shards the *pair batch*
(pairs are independent).  This module shards a single huge DP matrix: the
target axis is split into contiguous blocks, one per device of a
``jax.sharding.Mesh``, and the anti-diagonal difference recurrence of
``ksw_extz2_sse`` (ksw2_extz2_sse.c:150-286) runs as a software pipeline
over diagonal blocks.

Why this is possible: the Suzuki-Kasahara recurrence only reads *leftward*
-- cell (r, t) consumes (r-1, t-1) via the shifted x/v deltas and
(r-1, t) via u/y, and the int32 H row identity reads H(r-1, t-1) -- so
information crosses a device boundary at exactly one lane per diagonal,
left to right.  Device d can therefore run diagonal block b as soon as
device d-1 has finished block b: a classic wavefront pipeline with skew 1.
Per round, each device advances K diagonals over its local lanes and
ships a (K, 3) package of boundary (x, v, H) values to its right
neighbour with ``lax.ppermute`` -- the halo.  Pipeline fill/drain costs
(n_devices - 1) rounds; comm is one small ppermute per round between neighbouring devices.

This is the DP analogue of sequence/context parallelism (SURVEY.md
section 5): one sequence too big for a device's wavefront spreads over the
mesh, state crossing chips is O(1) per diagonal.  Scope: one-piece affine
extension (extz2 semantics), score-only, exact deferred max -- byte parity
with ``ksw_extz2_sse`` for banded and unbanded runs.  Z-drop is
unsupported here by design: the drop test consults the *global* running
max every diagonal, which would force a full-mesh reduction per diagonal
and serialize the pipeline; batch-axis sharding (parallel/mesh.py) is the
right tool for droppable extensions.

Byte representation: the unsigned canon (deltas carried one per int32
lane, SSE byte ops as masked int32 ops), 16-rounded band blocks with the
reference's garbage-lane evolution, the stale st-1 edge override, and the
H/HM/RD deferred-max finalization with SSE merge-order tie-breaks.
"""
from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.flags import NEG_INF, Flag

I32 = jnp.int32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m
_INT_MIN = -(2 ** 31) + 1


def _halo_body(qlen, tlen, w, rlim, sc, K, C, D, axis, carry_in, query_pad,
               target_loc, t0):
    """One pipeline round: advance K diagonals over this device's C lanes.

    All arrays live per device (shard_map body).  ``carry_in`` bundles the
    mutable state planes plus the pipeline bookkeeping.
    """
    (s_round, u, v, x, y, s, H, HM, RD, MQ, pbs, rx, carry_bnd) = carry_in
    dev = jax.lax.axis_index(axis)
    blk = s_round - dev                      # my diagonal block this round
    lane = t0 + jnp.arange(C, dtype=I32)     # global target positions
    lane0 = lane == 0
    qe = sc["qe"]
    clamp = sc["clamp"]
    ndc = qlen + tlen - 1

    def diag_step(k, st):
        u, v, x, y, s, H, HM, RD, MQ, pbs, tx, carry_bnd = st
        r = blk * K + k
        act = (blk >= 0) & (r < rlim)
        # band bounds (ksw2_extz2_sse.c:107-116), global coordinates
        st0 = jnp.maximum(0, jnp.maximum(r + 1 - qlen, (r + 1 - w) >> 1))
        en0 = jnp.minimum(tlen - 1, jnp.minimum(r, (r + w) >> 1))
        stb = st0 & -16
        enb = en0 | 15
        need_ov = (stb == 0) | (stb == pbs)
        pbs_n = jnp.where(act, stb, pbs)
        ov_v = jnp.where(stb == 0, jnp.where(r > 0, sc["q"], 0), 0)

        col_mask = act & (enb >= r) & (lane == r)
        ucol = jnp.where(r > 0, sc["q"], 0)
        ut = jnp.where(col_mask, ucol, u)
        yt = jnp.where(col_mask, 0, y)

        # query symbol plane: query[min(r - t, qlen - 1)] once r >= t,
        # init value 0 before that
        qidx = jnp.clip(r - lane, 0, qlen - 1)
        Qn = jnp.where(r >= lane, jnp.take(query_pad, qidx), 0)

        fill_hi = st0 + ((en0 - st0) & -16) + 15
        eq = target_loc == Qn
        nm = (target_loc == sc["m1"]) | (Qn == sc["m1"])
        sval = jnp.where(eq, sc["mch"], sc["mis"])
        sval = jnp.where(nm, sc["N"], sval)
        smask = act & (lane >= st0) & (lane <= fill_hi)
        sn = jnp.where(smask, sval, s)

        # halo shift: lane t consumes x/v/H of (t-1, r-1); the first lane
        # of this shard takes them from the neighbour's package
        bx, bv, bH = rx[k, 0], rx[k, 1], rx[k, 2]
        ovn = (lane == stb) & need_ov
        xs = jnp.where(lane0, 0, jnp.concatenate([bx[None], x[:-1]]))
        xs = jnp.where(ovn, 0, xs)
        vs = jnp.where(lane0, ov_v, jnp.concatenate([bv[None], v[:-1]]))
        vs = jnp.where(ovn, ov_v, vs)
        a = (xs + vs) & 255
        b = (yt + ut) & 255
        zb = jnp.maximum(sn, a ^ 128)          # signed epi8 max (biased)
        z = zb ^ 128
        z = jnp.maximum(z, b)                  # max_epu8
        z = jnp.minimum(z, clamp)              # min_epu8 vs constant
        unew = (z - vs) & 255
        vnew = (z - ut) & 255
        z2 = z - sc["q"]
        an = (a - z2) & 255
        bn = (b - z2) & 255
        bmask = act & (lane >= stb) & (lane <= enb)
        un = jnp.where(bmask, unew, u)
        vn = jnp.where(bmask, vnew, v)
        xn = jnp.where(bmask, jnp.where((an ^ 128) > 128, an, 0), x)
        yn = jnp.where(bmask, jnp.where((bn ^ 128) > 128, bn, 0), y)

        # int32 H row (vector column identities)
        is0 = r == 0
        Hs_prev = jnp.where(lane0, NEG_INF,
                            jnp.concatenate([bH[None], H[:-1]]))
        Hv = H + vn - qe
        Hs = Hs_prev + un - qe
        h_en0_vec = jnp.where(en0 > 0, Hs, Hv)
        h_en0_vec = jnp.where(is0, vn - 2 * qe, h_en0_vec)
        scan_mask = act & (lane >= st0) & (lane < en0) & jnp.logical_not(is0)
        en0m = act & (lane == en0)
        Hn = jnp.where(en0m, h_en0_vec, jnp.where(scan_mask, Hv, H))
        better = Hn > HM
        HMn = jnp.where(better, Hn, HM)
        RDn = jnp.where(better, r, RD)
        MQn = jnp.where(act & ((r - st0) == qlen - 1) & (lane == st0),
                        Hn, MQ)

        # boundary package for the right neighbour: my last lane after r
        bnd = jnp.stack([xn[-1], vn[-1], Hn[-1]])
        # tx[k] must hold my boundary at diagonal r-1: slot 0 gets the
        # carry (last diagonal of my previous block), slot k>0 the value
        # recorded after diagonal r-1 of this block
        tx = jax.lax.dynamic_update_slice(tx, carry_bnd[None], (k, 0))
        carry_n = bnd
        return (un, vn, xn, yn, sn, Hn, HMn, RDn, MQn, pbs_n, tx, carry_n)

    tx0 = jnp.zeros((K, 3), I32)
    st = (u, v, x, y, s, H, HM, RD, MQ, pbs, tx0, carry_bnd)
    st = jax.lax.fori_loop(0, K, diag_step, st)
    (u, v, x, y, s, H, HM, RD, MQ, pbs, tx, carry_bnd) = st
    # ship the boundary package right; leftmost device receives zeros
    # (its lane-0 overrides never read them)
    rx_next = jax.lax.ppermute(tx, axis,
                               [(i, i + 1) for i in range(D - 1)])
    return (s_round + 1, u, v, x, y, s, H, HM, RD, MQ, pbs, rx_next,
            carry_bnd)


@functools.lru_cache(maxsize=32)
def _cached_halo(mesh_id, TV, C, D, K, axis, qlen, tlen, w, sc_items):
    sc = dict(sc_items)
    mesh = _MESHES[mesh_id]
    n_blocks = -(-((qlen + tlen - 1)) // K)
    n_rounds = n_blocks + D - 1
    ndb = qlen + tlen - 1
    rlim = min(ndb, 2 * qlen + w - 1, 2 * tlen + w - 1,
               1 if w == 0 else ndb)

    def run(query_pad, target_pad):
        def body(query_pad, target_loc):
            dev = jax.lax.axis_index(axis)
            t0 = dev * C
            zero = jnp.zeros((C,), I32)
            carry = (jnp.asarray(0, I32), zero, zero, zero, zero,
                     jnp.full((C,), ((2 * sc["qe"]) & 255) ^ 128, I32),
                     jnp.full((C,), NEG_INF, I32),
                     jnp.full((C,), NEG_INF, I32), zero,
                     jnp.full((C,), NEG_INF, I32), zero,
                     jnp.zeros((K, 3), I32), jnp.zeros((3,), I32))

            def round_body(_, c):
                return _halo_body(qlen, tlen, w, rlim, sc, K, C, D, axis,
                                  c, query_pad, target_loc, t0)

            c = jax.lax.fori_loop(0, n_rounds, round_body, carry)
            (_, u, v, x, y, s, H, HM, RD, MQ, pbs, rx, cb) = c
            return H, HM, RD, MQ

        # check_vma off: the loop carry starts replicated (zeros) and
        # becomes device-varying through ppermute/axis_index
        f = jax.shard_map(body, mesh=mesh,
                          in_specs=(P(), P(axis)),
                          out_specs=(P(axis),) * 4, check_vma=False)
        return f(query_pad, target_pad)

    return jax.jit(run)


_MESHES: Dict[int, Mesh] = {}


def halo_extz_score(
    mesh: Mesh,
    query: np.ndarray,
    target: np.ndarray,
    m: int,
    mat: np.ndarray,
    q: int,
    e: int,
    w: int = -1,
    flag: Flag | int = Flag.SCORE_ONLY,
    block_diagonals: int = 256,
):
    """Score ONE extension pair with its target axis sharded over ``mesh``.

    Returns an ``ExtzResult`` with the exact ``ksw_extz2_sse`` score-only
    fields (max/max_t/max_q, mqe/mqe_t, mte/mte_q, score) for zdrop < 0.
    The mesh's first axis is the target-block axis.
    """
    from ..core.result import ExtzResult

    flag = Flag(int(flag))
    if not (flag & Flag.SCORE_ONLY):
        raise ValueError("halo engine is score-only")
    if flag & (Flag.APPROX_MAX | Flag.GENERIC_SC):
        raise ValueError("halo engine: exact max, fixed 5x5 scoring only")
    ez = ExtzResult()
    ez.reset()
    qlen, tlen = len(query), len(target)
    if m <= 0 or qlen <= 0 or tlen <= 0:
        return ez
    mat = np.asarray(mat, dtype=np.int8).reshape(-1)
    if -int(mat[1:].min()) > 2 * (q + e):
        return ez                      # reference guard
    if w < 0:
        w = max(qlen, tlen)
    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    TV = _round_up(max(tlen, 1), 128 * D)
    C = TV // D
    K = int(block_diagonals)
    sc_N = -e if int(mat[m * m - 1]) == 0 else int(mat[m * m - 1])
    qe = q + e
    sc = (("q", int(q)), ("qe", int(qe)),
          ("mch", ((int(mat[0]) + 2 * qe) & 255) ^ 128),
          ("mis", ((int(mat[1]) + 2 * qe) & 255) ^ 128),
          ("N", ((sc_N + 2 * qe) & 255) ^ 128),
          ("clamp", (int(mat[0]) + 2 * qe) & 255),
          ("m1", int(m) - 1))

    _MESHES[id(mesh)] = mesh
    run = _cached_halo(id(mesh), TV, C, D, K, axis, qlen, tlen, int(w), sc)
    qpad = np.zeros(max(qlen, 1), np.int32)
    qpad[:qlen] = np.asarray(query, np.int32)
    tpad = np.zeros(TV, np.int32)
    tpad[:tlen] = np.asarray(target, np.int32)
    H, HM, RD, MQ = (np.asarray(a) for a in
                     run(jnp.asarray(qpad), jnp.asarray(tpad)))

    return _finalize(ez, H, HM, RD, MQ, qlen, tlen, int(w))


def _finalize(ez, H, HM, RD, MQ, qlen, tlen, w):
    """Host finalization: the deferred-max reduction with the exact scan
    tie-breaks of the reference's no-Z-drop scan."""
    ndc = qlen + tlen - 1
    rlim = min(ndc, 2 * qlen + w - 1, 2 * tlen + w - 1,
               1 if w == 0 else ndc)
    lanes = np.arange(len(HM), dtype=np.int64)

    V = int(HM.max())
    if V > 0:
        cand = HM == V
        rstar = int(RD[cand].min())
        st0s = max(0, rstar + 1 - qlen, (rstar + 1 - w) >> 1)
        en0s = min(tlen - 1, rstar, (rstar + w) >> 1)
        first = cand & (RD == rstar)
        en0_hit = bool(first[en0s]) if 0 <= en0s < len(first) else False
        if en0_hit or rstar == 0:
            max_t = 0 if rstar == 0 else en0s
        else:
            en1 = st0s + (en0s - st0s) // 4 * 4
            cls = (lanes - st0s) & 3
            key = np.where(lanes < en1, cls * (1 << 26) + lanes,
                           (1 << 28) + lanes)
            max_t = int(key[first].min() & ((1 << 26) - 1))
        ez.max, ez.max_t, ez.max_q = V, max_t, rstar - max_t
    else:
        ez.max, ez.max_t, ez.max_q = 0, -1, -1

    mqe = int(MQ.max())
    if mqe > NEG_INF:
        ez.mqe = mqe
        ez.mqe_t = int(lanes[MQ == mqe].min())
    corner = tlen - 1
    mte = int(HM[corner])
    if mte > NEG_INF:
        en_c = ((tlen - 1 + 16) // 16) * 16 - 1
        ez.mte = mte
        ez.mte_q = int(RD[corner]) - en_c

    fin_en0 = min(tlen - 1, ndc - 1, (ndc - 1 + w) >> 1)
    if rlim == ndc and fin_en0 == tlen - 1:
        ez.score = int(H[corner])
    ez.zdropped = rlim < ndc
    return ez


__all__ = ["halo_extz_score"]
