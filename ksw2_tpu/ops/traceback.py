"""Batched traceback over the direction bytes, on the device.

Replays ``ksw_backtrack`` (ksw2.h:125-161) for the anti-diagonal layout
of :func:`ksw2_tpu.ops.batch_xla.forward`: every pair of the batch takes
one step per walk step, reading its direction byte straight from the
(n_diag, B, nc) rows on the device, so the matrices never cross to the
host; only one op byte per step does.  The band-edge force states come
from the closed-form rounded band.  :func:`finish_cigars` run-length
encodes the ops on the host, adds the leading-gap flush and reverses.
"""
from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from ..core.cigar import push, to_eqx
from ..core.flags import CigarOp, Flag
from .batch_xla import FIELDS

I32 = jnp.int32
NO_OP = 255          # op byte of a step after the walk ended
_F = {k: i for i, k in enumerate(FIELDS)}


def start_cells(rec, qlen, tlen, flag: int, end_bonus: int):
    """Traceback start cell per pair (ksw2_extz2_sse.c:292-301).

    Returns ``(i0, j0, reach_end)``; ``i0 = -1`` where no traceback
    applies."""
    extz_only = bool(Flag(flag) & Flag.EXTZ_ONLY)
    zdr = rec[:, _F["zdropped"]] != 0
    mx, mxt, mxq = (rec[:, _F[k]] for k in ("max", "max_t", "max_q"))
    reach = (jnp.logical_not(zdr) & extz_only
             & (rec[:, _F["mqe"]] + end_bonus > mx))
    corner = jnp.logical_not(zdr) & (not extz_only)
    has_max = (mxt >= 0) & (mxq >= 0)
    i0 = jnp.where(corner, tlen - 1, jnp.where(
        reach, rec[:, _F["mqe_t"]], jnp.where(has_max, mxt, -1)))
    j0 = jnp.where(corner, qlen - 1, jnp.where(
        reach, qlen - 1, jnp.where(has_max, mxq, -1)))
    return i0, j0, reach


def walk(p, i0, j0, qlen, tlen, w, unroll: int = 1):
    """Walk every pair back from ``(i0, j0)``.

    Returns ``(ops, ij)``: (B, n_steps) uint8 op codes in walk order
    (0=M, 1=I, 2=D; :data:`NO_OP` after the end) and the (B, 2) cell where
    the walk left the matrix.  Each loop iteration takes ``unroll`` steps,
    so the loop's per-iteration cost is paid once per ``unroll`` ops.
    """
    n_diag, B, nc = p.shape
    flat = p.reshape(-1)
    lane = jnp.arange(B, dtype=I32)
    n_iter = -(-(n_diag + 1) // unroll)

    def step(i, j, state):
        live = (i >= 0) & (j >= 0)
        r = i + j
        st0 = jnp.maximum(0, jnp.maximum(r - qlen + 1, (r - w + 1) >> 1))
        en0 = jnp.minimum(tlen - 1, jnp.minimum(r, (r + w) >> 1))
        stb = st0 // 16 * 16
        enb = (en0 + 16) // 16 * 16 - 1
        force = jnp.where(i < stb, 2, jnp.where(i > enb, 1, -1))
        idx = ((jnp.clip(r, 0, n_diag - 1) * B + lane) * nc
               + jnp.clip(i - stb, 0, nc - 1))
        tmp = jnp.where(force >= 0, 0, flat[idx].astype(I32))
        cont = (tmp >> (state + 2)) & 1
        s1 = jnp.where((state != 0) & (cont != 0), state, tmp & 7)
        s1 = jnp.where(force >= 0, force, s1)
        is_m = s1 == 0
        is_d = (s1 == 1) | (s1 == 3)           # E or E2: consumes target
        op = jnp.where(live, jnp.where(is_m, 0, jnp.where(is_d, 2, 1)),
                       NO_OP).astype(jnp.uint8)
        i = jnp.where(live & (is_m | is_d), i - 1, i)
        j = jnp.where(live & jnp.logical_not(is_d), j - 1, j)
        state = jnp.where(live, s1, state)
        return i, j, state, op

    def cond(c):
        k, i, j, _, _ = c
        return (k < n_iter) & jnp.any((i >= 0) & (j >= 0))

    def body(c):
        k, i, j, state, ops = c
        block = []
        for _ in range(unroll):
            i, j, state, op = step(i, j, state)
            block.append(op)
        ops = jax.lax.dynamic_update_slice(
            ops, jnp.stack(block, axis=1), (0, k * unroll))
        return k + 1, i, j, state, ops

    ops0 = jnp.full((B, n_iter * unroll), NO_OP, jnp.uint8)
    _, i, j, _, ops = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, I32), i0.astype(I32), j0.astype(I32),
                     jnp.zeros((B,), I32), ops0))
    return ops, jnp.stack([i, j], axis=1)


def finish_cigars(ops: np.ndarray, ij: np.ndarray, has_start: np.ndarray,
                  flag: int, queries=None, targets=None) -> List[List[int]]:
    """Host side: RLE of the walk ops, leading-gap flush, orientation
    (ksw2.h:150-159), and the EQX rewrite where asked."""
    flag = Flag(flag)
    out: List[List[int]] = []
    for b in range(ops.shape[0]):
        cigar: List[int] = []
        if not has_start[b]:
            out.append(cigar)
            continue
        row = ops[b]
        n = int(np.argmax(row == NO_OP)) if (row == NO_OP).any() \
            else row.shape[0]
        row = row[:n]
        if n:
            cut = np.flatnonzero(np.diff(row)) + 1
            starts = np.concatenate(([0], cut))
            ends = np.concatenate((cut, [n]))
            for s, t in zip(starts, ends):
                push(cigar, int(row[s]), int(t - s))
        i, j = int(ij[b, 0]), int(ij[b, 1])
        if i >= 0:
            push(cigar, CigarOp.DEL, i + 1)
        if j >= 0:
            push(cigar, CigarOp.INS, j + 1)
        if not (flag & Flag.REV_CIGAR):
            cigar.reverse()
        if queries is not None and cigar:
            cigar = to_eqx(cigar, queries[b], targets[b])
        out.append(cigar)
    return out


__all__ = ["NO_OP", "start_cells", "walk", "finish_cigars"]
