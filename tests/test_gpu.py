"""CUDA forward kernel vs the XLA engine, and the device path vs the spec.

These need the card (CUDA has no interpret mode) and carry the ``gpu``
marker; run them on a GPU machine with ``python -m pytest -m gpu tests``.
The ``gpu`` fixture skips them anywhere else.  Everything is integer DP,
so every comparison is exact equality.
"""
import numpy as np
import pytest

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")


def _batch(seed, n, lmax, w=-1, with_n=True, lmin=1):
    from ksw2_tpu.batch.scheduler import bucket_len

    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        tl = int(rng.integers(lmin, lmax))
        t, q = refcmp.random_pair(rng, tl, float(rng.uniform(0, .35)),
                                  float(rng.uniform(0, .12)), with_n=with_n)
        pairs.append((encode_dna(q), encode_dna(t)))
    Lq = bucket_len(max(len(q) for q, _ in pairs))
    Lt = bucket_len(max(len(t) for _, t in pairs))
    Q = np.zeros((n, Lq), np.int8)
    T = np.zeros((n, Lt), np.int8)
    for k, (q, t) in enumerate(pairs):
        Q[k, :len(q)] = q
        T[k, :len(t)] = t
    ql = np.array([len(q) for q, _ in pairs], np.int32)
    tl = np.array([len(t) for _, t in pairs], np.int32)
    wv = np.where(w < 0, np.maximum(ql, tl), w).astype(np.int32)
    return pairs, Q, T, ql, tl, wv


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("flag,zdrop,w", [
    (Flag.SCORE_ONLY, 100, -1),
    (Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP, 40, -1),
    (Flag.NONE, 60, 50),
    (Flag.RIGHT, -1, -1),
    (Flag.GENERIC_SC, 30, 20),
])
def test_cuda_forward_equals_xla(gpu, two, flag, zdrop, w):
    import jax

    from ksw2_tpu.ops import cuda_ext
    from ksw2_tpu.ops.batch_xla import (BatchSpec, ext_batch, make_params,
                                        n_col_bytes)

    pairs, Q, T, ql, tl, wv = _batch(7 + int(flag) + two, 48, 700, w)
    mat = simple_mat(5, 2, 4)
    if flag & Flag.GENERIC_SC:
        rng = np.random.default_rng(3)
        mat = rng.integers(-5, 4, size=25).astype(np.int8)
    nc = 0 if flag & Flag.SCORE_ONLY else max(
        n_col_bytes(a, b, c) for a, b, c in zip(ql, tl, wv))
    nc = -(-nc // 16) * 16
    spec = BatchSpec(Q.shape[1], T.shape[1], two, int(flag), nc)
    prm = make_params(5, mat, 4, 2, *((13, 1) if two else (None, None)),
                      zdrop=zdrop)
    args = (Q, T, ql, tl, wv, mat, prm)
    rec_x, p_x = ext_batch(spec, *args)
    rec_c, p_c = jax.jit(cuda_ext.forward, static_argnums=0)(spec, *args)
    np.testing.assert_array_equal(np.asarray(rec_c), np.asarray(rec_x))
    if nc:
        np.testing.assert_array_equal(np.asarray(p_c), np.asarray(p_x))


def test_cuda_forward_global_scratch(gpu):
    """Targets too long for shared memory run from the global scratch."""
    import jax

    from ksw2_tpu.ops import cuda_ext
    from ksw2_tpu.ops.batch_xla import BatchSpec, ext_batch, make_params

    pairs, Q, T, ql, tl, wv = _batch(11, 4, 9000, w=64, with_n=False,
                                     lmin=7000)
    spec = BatchSpec(Q.shape[1], T.shape[1], True, int(Flag.SCORE_ONLY), 0)
    assert cuda_ext.pair_bytes(spec) > cuda_ext.SMEM_LIMIT
    mat = simple_mat(5, 2, 4)
    args = (Q, T, ql, tl, wv, mat, make_params(5, mat, 4, 2, 13, 1,
                                               zdrop=200))
    rec_x, _ = ext_batch(spec, *args)
    rec_c, _ = jax.jit(cuda_ext.forward, static_argnums=0)(spec, *args)
    np.testing.assert_array_equal(np.asarray(rec_c), np.asarray(rec_x))


@pytest.mark.parametrize("two", [False, True])
def test_align_batch_on_gpu_matches_spec(gpu, two):
    from ksw2_tpu.batch.scheduler import AlignJob, align_batch

    pairs, *_ = _batch(5 + two, 40, 400)
    mat = simple_mat(5, 2, 4)
    jobs = [AlignJob(q, t) for q, t in pairs]
    kw = dict(q2=13, e2=1) if two else {}
    got = align_batch(jobs, 5, mat, 4, 2, zdrop=100, flag=Flag.EQX, **kw)
    for (q, t), ez in zip(pairs, got):
        if two:
            want, _ = diagdiff.extd2(q, t, 5, mat, 4, 2, 13, 1, zdrop=100,
                                     flag=Flag.EQX)
        else:
            want, _ = diagdiff.extz2(q, t, 5, mat, 4, 2, zdrop=100,
                                     flag=Flag.EQX)
        assert ez == want
