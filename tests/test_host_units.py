"""Host-side units of the device path: cost canonicalisation, the CIGAR
finish of the device walk, and the compile-cache placement."""
import numpy as np
import pytest

from ksw2_tpu.core.flags import CigarOp, Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.ops import batch_xla as bx
from ksw2_tpu.ops.traceback import NO_OP, finish_cigars
from ksw2_tpu.spec.common import c_div


def test_params_one_piece():
    prm = bx.make_params(5, simple_mat(5, 2, 4), 4, 2, zdrop=100,
                         end_bonus=9)
    assert prm.dtype == np.int32 and prm.shape == (bx.NPARAMS,)
    assert (prm[bx.P_MCH], prm[bx.P_MIS], prm[bx.P_N]) == (2, -4, -2)
    assert (prm[bx.P_SEED], prm[bx.P_ZDROP], prm[bx.P_EB]) == (12, 100, 9)


@pytest.mark.parametrize("q,e,q2,e2", [(4, 2, 13, 1), (13, 1, 4, 2),
                                       (4, 2, 24, 1), (6, 3, 6, 3)])
def test_params_two_piece_canonical(q, e, q2, e2):
    """The cheaper line comes first; H is seeded with the pre-swap q+e
    (ksw2_extd2_sse.c:68,78); sc_N follows the post-swap e2."""
    prm = bx.make_params(5, simple_mat(5, 2, 4), q, e, q2, e2)
    assert prm[bx.P_Q] + prm[bx.P_E] <= prm[bx.P_Q2] + prm[bx.P_E2]
    assert prm[bx.P_SEED] == q + e
    assert prm[bx.P_N] == -prm[bx.P_E2]
    lt, ld = bx.long_thres(*(int(prm[k]) for k in
                              (bx.P_Q, bx.P_E, bx.P_Q2, bx.P_E2)))
    assert (prm[bx.P_LTHR], prm[bx.P_LDIFF]) == (lt, ld)


def test_long_thres_crossing():
    """long_thres is the first gap length where the second line is no
    dearer than the first."""
    q, e, q2, e2 = 4, 2, 24, 1
    lt, _ = bx.long_thres(q, e, q2, e2)
    assert lt == c_div(q2 - q, e - e2) - 1 + \
        int(q2 + e2 + (c_div(q2 - q, e - e2) - 1) * e2 >
            q + e + (c_div(q2 - q, e - e2) - 1) * e)
    assert q2 + e2 + lt * e2 <= q + e + lt * e


def test_n_col_bytes():
    assert bx.n_col_bytes(100, 200, 500) == (100 + 15) // 16 * 16 + 16
    assert bx.n_col_bytes(1000, 1000, 50) == (51 + 15) // 16 * 16 + 16


def _ops(*rows):
    w = max(len(r) for r in rows) + 1
    out = np.full((len(rows), w), NO_OP, np.uint8)
    for k, r in enumerate(rows):
        out[k, :len(r)] = r
    return out


def test_finish_cigar_runs_and_tail():
    ops = _ops([0, 0, 2, 2, 0, 1])           # walk order: M M D D M I
    ij = np.array([[1, -1]])                 # two target bases left over
    (cig,) = finish_cigars(ops, ij, np.array([True]), 0)
    # reversed, with the leading 2D flush: 2D 1I 1M 2D 2M
    assert cig == [(2 << 4) | CigarOp.DEL, (1 << 4) | CigarOp.INS,
                   (1 << 4) | CigarOp.MATCH, (2 << 4) | CigarOp.DEL,
                   (2 << 4) | CigarOp.MATCH]


def test_finish_cigar_rev_and_no_start():
    ops = _ops([0, 0, 1], [0])
    ij = np.array([[-1, -1], [-1, -1]])
    fwd, none = finish_cigars(ops, ij, np.array([True, False]), 0)
    (rev, _) = finish_cigars(ops, ij, np.array([True, False]),
                             int(Flag.REV_CIGAR))
    assert none == [] and rev == fwd[::-1]


def test_finish_cigar_eqx():
    q = np.array([0, 1, 2, 3], np.uint8)
    t = np.array([0, 1, 3, 3], np.uint8)
    ops = _ops([0, 0, 0, 0])
    (cig,) = finish_cigars(ops, np.array([[-1, -1]]), np.array([True]), 0,
                           [q], [t])
    assert cig == [(2 << 4) | CigarOp.EQ, (1 << 4) | CigarOp.X,
                   (1 << 4) | CigarOp.EQ]


def test_compile_cache_honours_env(monkeypatch):
    """JAX_COMPILATION_CACHE_DIR set: the package sets no directory."""
    import jax

    from ksw2_tpu.utils import ccache

    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    ccache.ensure_compile_cache()
    assert calls == []


def test_compile_cache_default_path(monkeypatch):
    """Unset: one fixed directory inside the checkout (not on CPU runs)."""
    import os

    import jax

    from ksw2_tpu.utils import ccache

    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    ccache.ensure_compile_cache()          # this suite runs on the CPU
    assert calls == []
    monkeypatch.setattr(ccache, "_platforms", lambda: "cuda")
    ccache.ensure_compile_cache()
    assert ("jax_compilation_cache_dir", ccache.CACHE_DIR) in calls
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert ccache.CACHE_DIR == os.path.join(repo, ".jax_cache")
