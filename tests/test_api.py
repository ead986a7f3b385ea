"""High-level Aligner API: routing, parity with the underlying engines."""
import numpy as np
import pytest

from ksw2_tpu import Aligner
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat
from ksw2_tpu.spec import diagdiff


def _pair(seed, L=90, div=0.15):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, size=L).astype(np.int32)
    t = np.where(rng.random(L) < div,
                 rng.integers(0, 4, size=L), q).astype(np.int32)
    return q, t


def test_extend_one_piece_matches_spec():
    q, t = _pair(1)
    aln = Aligner(a=2, b=4, q=4, e=2, zdrop=100)
    ez = aln.extend(q, t)
    want, _ = diagdiff.extz2(q, t, 5, simple_mat(5, 2, -4), 4, 2,
                             zdrop=100)
    assert (ez.score, ez.max, ez.cigar) == (want.score, want.max,
                                            want.cigar)


def test_extend_two_piece_and_strings():
    q, t = _pair(2)
    aln = Aligner(a=2, b=4, q=4, e=2, q2=13, e2=1)
    qs = "".join("ACGT"[v] for v in q)
    ts = "".join("ACGT"[v] for v in t)
    ez = aln.extend(qs, ts)
    want, _ = diagdiff.extd2(q, t, 5, simple_mat(5, 2, -4), 4, 2, 13, 1)
    assert (ez.score, ez.cigar) == (want.score, want.cigar)


def test_generic_matrix_autodetected():
    rng = np.random.default_rng(3)
    mat = rng.integers(-5, 4, size=(5, 5)).astype(np.int8)
    np.fill_diagonal(mat, 2)
    aln = Aligner(mat=mat, q=4, e=2)
    assert aln.flag & Flag.GENERIC_SC
    aln2 = Aligner(mat=simple_mat(5, 2, -4), q=4, e=2)
    assert not (aln2.flag & Flag.GENERIC_SC)
    q, t = _pair(4, L=60)
    ez = aln.extend(q, t)
    want, _ = diagdiff.extz2(q, t, 5, mat.reshape(-1), 4, 2,
                             flag=Flag.GENERIC_SC)
    assert (ez.score, ez.cigar) == (want.score, want.cigar)


def test_extend_batch_matches_spec():
    rng = np.random.default_rng(5)
    pairs = [_pair(10 + i, L=int(rng.integers(40, 120))) for i in range(9)]
    aln = Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=Flag.SCORE_ONLY)
    ezs = aln.extend_batch(pairs)
    assert len(ezs) == 9
    for (q, t), ez in zip(pairs, ezs):
        want, _ = diagdiff.extz2(q, t, 5, simple_mat(5, 2, -4), 4, 2,
                                 zdrop=100, flag=Flag.SCORE_ONLY)
        assert ez.max == want.max and ez.score == want.score


def test_extend_batch_per_pair_bands():
    """``w`` gives each pair its own band inside one batch."""
    pairs = [_pair(40 + i, L=100, div=0.2) for i in range(6)]
    bands = [3, 10, 25, 60, -1, 0]
    aln = Aligner(a=2, b=4, q=4, e=2, q2=13, e2=1, zdrop=80)
    for (q, t), w, ez in zip(pairs, bands, aln.extend_batch(pairs, w=bands)):
        want, _ = diagdiff.extd2(q, t, 5, simple_mat(5, 2, -4), 4, 2, 13, 1,
                                 w=w, zdrop=80)
        assert ez == want, w


def test_bad_params_raise():
    with pytest.raises(ValueError):
        Aligner(q2=13)          # two-piece needs both q2 and e2
    with pytest.raises(ValueError):
        Aligner(e2=1)


def test_result_array_matches_results():
    """``extend_batch_async(...).result_array()`` carries the same records
    as the per-job results, reset rows for empty jobs included."""
    pairs = [("", "ACGT")] + [_pair(70 + i, L=80) for i in range(4)]
    aln = Aligner(zdrop=100, flag=Flag.SCORE_ONLY)
    want = aln.extend_batch(pairs)
    arr = aln.extend_batch_async(pairs).result_array()
    for row, ez in zip(arr, want):
        assert tuple(row) == (ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t,
                              ez.mte, ez.mte_q, ez.score, int(ez.zdropped))


def test_extend_batch_mesh_cigars_match_local():
    """Aligner.extend_batch(mesh=...) == the local scheduler, CIGARs incl."""
    import refcmp
    from ksw2_tpu.api import Aligner
    from ksw2_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(23)
    pairs = []
    for _ in range(13):
        tl = int(rng.integers(30, 160))
        t, q = refcmp.random_pair(rng, tl, divergence=0.2, indel=0.1)
        pairs.append((q, t))
    al = Aligner(a=2, b=4, q=4, e=2, zdrop=100)
    sh = al.extend_batch(pairs, mesh=make_mesh(8))
    lo = al.extend_batch(pairs)
    assert len(sh) == len(lo)
    for i, (a_, b_) in enumerate(zip(sh, lo)):
        assert a_.tsv_fields() == b_.tsv_fields(), i
        assert a_.cigar == b_.cigar, i


def test_extend_batch_mesh_two_piece_matches_local():
    """Two-piece CIGAR batches shard over the mesh like one-piece ones."""
    import refcmp
    from ksw2_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(24)
    pairs = []
    for _ in range(11):
        tl = int(rng.integers(30, 200))
        t, q = refcmp.random_pair(rng, tl, divergence=0.2, indel=0.1)
        pairs.append((q, t))
    al = Aligner(a=2, b=4, q=4, e=2, q2=24, e2=1, zdrop=200, w=50)
    sh = al.extend_batch(pairs, mesh=make_mesh(4))
    lo = al.extend_batch(pairs)
    assert sh == lo


def test_extend_batch_async_matches_sync():
    """Aligner.extend_batch_async handles equal the synchronous path,
    for one-piece and two-piece configurations."""
    import refcmp
    from ksw2_tpu import Aligner

    rng = np.random.default_rng(61)
    pairs = []
    for L in (150, 300, 520):
        t, q = refcmp.random_pair(rng, L, divergence=0.2, indel=0.08)
        pairs.append((q, t))
    for kw in ({}, {"q2": 13, "e2": 1}):
        al = Aligner(zdrop=100, **kw)
        want = al.extend_batch(pairs)
        hs = [al.extend_batch_async(pairs) for _ in range(2)]
        for h in hs:
            got = h.result()
            for a, b in zip(want, got):
                assert a.tsv_fields() == b.tsv_fields()
                assert a.cigar == b.cigar
