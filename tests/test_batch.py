"""Batched XLA engine + scheduler vs the spec engine."""
import numpy as np
import pytest

import refcmp
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat, encode_dna
from ksw2_tpu.batch.scheduler import AlignJob, align_batch_scores
from ksw2_tpu.spec import diagdiff


@pytest.mark.parametrize("flag,zdrop", [
    (Flag.SCORE_ONLY, -1),
    (Flag.SCORE_ONLY, 20),
    (Flag.SCORE_ONLY | Flag.APPROX_MAX | Flag.APPROX_DROP, 20),
])
def test_batch_matches_spec(flag, zdrop):
    rng = np.random.default_rng(42)
    jobs = []
    for _ in range(16):
        tlen = int(rng.integers(5, 200))
        t, q = refcmp.random_pair(rng, tlen, divergence=float(rng.uniform(0, 0.4)),
                                  indel=float(rng.uniform(0, 0.15)), with_n=True)
        jobs.append(AlignJob(encode_dna(q), encode_dna(t)))
    mat = simple_mat(5, 2, 4)
    got = align_batch_scores(jobs, 5, mat, 4, 2, zdrop=zdrop, flag=flag)
    for job, ez in zip(jobs, got):
        want, _ = diagdiff.extz2(job.query, job.target, 5, mat, 4, 2,
                                 w=-1, zdrop=zdrop, flag=flag)
        assert (ez.score, ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t,
                ez.mte, ez.mte_q, ez.zdropped) == \
               (want.score, want.max, want.max_t, want.max_q, want.mqe,
                want.mqe_t, want.mte, want.mte_q, want.zdropped)


def test_empty_and_degenerate_jobs():
    mat = simple_mat(5, 2, 4)
    jobs = [AlignJob(encode_dna("A"), encode_dna("A")),
            AlignJob(encode_dna(""), encode_dna("ACGT"))]
    out = align_batch_scores(jobs, 5, mat, 4, 2)
    # expectation through the spec for the single-base pair
    want, _ = diagdiff.extz2(jobs[0].query, jobs[0].target, 5, mat, 4, 2,
                             flag=Flag.SCORE_ONLY)
    assert out[0].score == want.score
    assert out[1].score == -0x40000000 and out[1].max_t == -1


def test_align_batch_full_results():
    import refcmp
    from ksw2_tpu.batch.scheduler import AlignJob, align_batch
    from ksw2_tpu.core.matrix import encode_dna, simple_mat
    from ksw2_tpu.spec import diagdiff

    rng = np.random.default_rng(7)
    jobs, wants = [], []
    mat = simple_mat(5, 2, 4)
    for i in range(10):
        tlen = int(rng.integers(8, 200))   # crosses the 128 batch boundary
        t, q = refcmp.random_pair(rng, tlen, divergence=0.3, indel=0.12)
        qs, ts = encode_dna(q), encode_dna(t)
        jobs.append(AlignJob(qs, ts))
        want, _ = diagdiff.extz2(qs, ts, 5, mat, 4, 2, w=-1, zdrop=60)
        wants.append(want)
    ezs = align_batch(jobs, 5, mat, 4, 2, zdrop=60)
    for i, (got, want) in enumerate(zip(ezs, wants)):
        assert got.tsv_fields() == want.tsv_fields(), i


def test_align_batch_two_piece():
    import refcmp
    from ksw2_tpu.batch.scheduler import AlignJob, align_batch
    from ksw2_tpu.core.matrix import encode_dna, simple_mat
    from ksw2_tpu.spec import diagdiff

    rng = np.random.default_rng(8)
    jobs, wants = [], []
    mat = simple_mat(5, 2, 4)
    for i in range(8):
        tlen = int(rng.integers(8, 120))
        t, q = refcmp.random_pair(rng, tlen, divergence=0.3, indel=0.12)
        qs, ts = encode_dna(q), encode_dna(t)
        jobs.append(AlignJob(qs, ts))
        want, _ = diagdiff.extd2(qs, ts, 5, mat, 4, 2, 13, 1, w=-1, zdrop=60)
        wants.append(want)
    ezs = align_batch(jobs, 5, mat, 4, 2, q2=13, e2=1, zdrop=60)
    for i, (got, want) in enumerate(zip(ezs, wants)):
        assert got.tsv_fields() == want.tsv_fields(), i


def test_bucket_ladder():
    """Lengths and batch sizes round up a x1.5 / x1.33 ladder: padding
    stays under half a bucket and the number of shapes stays small."""
    from ksw2_tpu.batch.scheduler import bucket_len

    prev = 0
    for n in range(1, 20000, 7):
        b = bucket_len(n)
        assert b >= n and b < 2 * n + 1
        assert b >= prev
        prev = b
    shapes = {bucket_len(n) for n in range(1, 20000)}
    assert len(shapes) <= 30, len(shapes)


def test_bucket_key_policy():
    """Buckets are square, from the longer side, and every bucketed
    length is a multiple of the 16-lane band block."""
    from ksw2_tpu.batch.scheduler import bucket_key, bucket_len

    assert bucket_len(1) == 1 and bucket_len(64) == 64
    assert bucket_len(65) == 96 and bucket_len(97) == 128
    assert bucket_len(300) == 384 and bucket_len(3000) == 3072
    assert bucket_key(300, 400) == (512, 512)
    assert bucket_key(400, 300) == (512, 512)
    assert bucket_key(3, 5) == (16, 16)
    for t in range(1, 5000, 13):
        assert bucket_key(10, t)[1] % 16 == 0


def test_align_batch_scores2_matches_spec():
    """Two-piece score-only jobs through align_batch."""
    import refcmp
    from ksw2_tpu.batch.scheduler import AlignJob, align_batch
    from ksw2_tpu.core.matrix import encode_dna
    from ksw2_tpu.spec import diagdiff

    rng = np.random.default_rng(11)
    mat = simple_mat(5, 2, 4)
    jobs, cases = [], []
    for L in (90, 200, 430, 700, 1200):
        t, q = refcmp.random_pair(rng, L, divergence=0.2, indel=0.08)
        cases.append((encode_dna(q), encode_dna(t)))
        jobs.append(AlignJob(query=cases[-1][0], target=cases[-1][1]))
    ezs = align_batch(jobs, 5, mat, 4, 2, q2=13, e2=1, zdrop=100,
                      flag=Flag.SCORE_ONLY)
    for (qs, ts), ez in zip(cases, ezs):
        want, _ = diagdiff.extd2(qs, ts, 5, mat, 4, 2, 13, 1, zdrop=100,
                                 flag=Flag.SCORE_ONLY)
        assert (ez.score, ez.max, ez.max_t, ez.max_q, ez.zdropped) == \
            (want.score, want.max, want.max_t, want.max_q, want.zdropped)


def test_result_array_matches_results():
    """PendingScores.result_array (the bulk serving accessor) must agree
    field-for-field with the ExtzResult path, empty jobs included."""
    import refcmp
    from ksw2_tpu.batch.scheduler import (AlignJob,
                                          align_batch_scores_async)
    from ksw2_tpu.core.matrix import encode_dna

    rng = np.random.default_rng(44)
    mat = simple_mat(5, 2, 4)
    jobs = [AlignJob(query=np.zeros(0, np.uint8),
                     target=np.zeros(0, np.uint8))]   # empty job first
    for L in (120, 300, 700):
        t, q = refcmp.random_pair(rng, L, divergence=0.2, indel=0.08)
        jobs.append(AlignJob(query=encode_dna(q), target=encode_dna(t)))
    want = align_batch_scores_async(jobs, 5, mat, 4, 2, zdrop=100,
                                    flag=Flag.SCORE_ONLY).result()
    arr = align_batch_scores_async(jobs, 5, mat, 4, 2, zdrop=100,
                                   flag=Flag.SCORE_ONLY).result_array()
    assert arr.shape == (len(jobs), 9)
    for i, w in enumerate(want):
        assert tuple(arr[i]) == (w.max, w.max_t, w.max_q, w.mqe,
                                 w.mqe_t, w.mte, w.mte_q, w.score,
                                 int(w.zdropped)), i


def test_align_batch_scores2_async_handles():
    """Several two-piece score batches in flight (the serving shape);
    each handle's results must match the synchronous path."""
    import refcmp
    from ksw2_tpu.batch.scheduler import (AlignJob, align_batch_scores,
                                          align_batch_scores_async)
    from ksw2_tpu.core.matrix import encode_dna

    rng = np.random.default_rng(12)
    mat = simple_mat(5, 2, 4)
    jobs = []
    for L in (120, 260, 500, 900):
        t, q = refcmp.random_pair(rng, L, divergence=0.2, indel=0.08)
        jobs.append(AlignJob(query=encode_dna(q), target=encode_dna(t)))
    want = align_batch_scores(jobs, 5, mat, 4, 2, 13, 1, zdrop=100,
                              flag=Flag.SCORE_ONLY)
    hs = [align_batch_scores_async(jobs, 5, mat, 4, 2, 13, 1, zdrop=100,
                                   flag=Flag.SCORE_ONLY)
          for _ in range(3)]
    for h in hs:
        got = h.result()
        for w, g in zip(want, got):
            assert (g.score, g.max, g.max_t, g.max_q, g.zdropped) == \
                (w.score, w.max, w.max_t, w.max_q, w.zdropped)


def test_every_bucket_dispatches_through_select_forward():
    """The scheduler takes its forward from the one selection function,
    once per bucket, and runs what it returns."""
    from ksw2_tpu.batch import scheduler
    from ksw2_tpu.ops import batch_xla

    rng = np.random.default_rng(7)
    jobs = []
    for _ in range(12):
        tlen = int(rng.integers(20, 600))
        t, q = refcmp.random_pair(rng, tlen, divergence=0.15, indel=0.05)
        jobs.append(AlignJob(encode_dna(q), encode_dna(t)))
    mat = simple_mat(5, 2, 4)
    seen, ran = [], []
    orig = scheduler.select_forward

    def fwd(*a):
        ran.append(a[0])
        return batch_xla.forward(*a)

    def spy():
        seen.append(1)
        assert orig() is batch_xla.forward
        return fwd

    scheduler.select_forward = spy
    try:
        align_batch_scores(jobs, 5, mat, 4, 2, zdrop=100,
                           flag=Flag.SCORE_ONLY)
    finally:
        scheduler.select_forward = orig
    buckets = {scheduler.bucket_key(len(j.query), len(j.target))
               for j in jobs}
    assert len(seen) == len(buckets) and len(ran) == len(buckets)


def test_launches_split_by_memory_budget(monkeypatch):
    """A bucket larger than the memory budget runs as several launches
    with the same results."""
    from ksw2_tpu.batch import scheduler

    rng = np.random.default_rng(17)
    mat = simple_mat(5, 2, 4)
    jobs = []
    for _ in range(9):
        t, q = refcmp.random_pair(rng, 90, divergence=0.2, indel=0.08)
        jobs.append(AlignJob(encode_dna(q), encode_dna(t)))
    whole = scheduler.align_batch(jobs, 5, mat, 4, 2, zdrop=60)
    spec = scheduler.BatchSpec(Lq=128, Lt=128, two=False, flag=0, nc=64)
    monkeypatch.setattr(scheduler, "_memory_budget",
                        lambda: 2 * scheduler._pair_bytes(spec))
    h = scheduler.align_batch_async(jobs, 5, mat, 4, 2, zdrop=60)
    assert len(h._launches) >= 3
    assert [e.tsv_fields() for e in h.result()] == \
        [e.tsv_fields() for e in whole]


def test_async_submit_collect_overlap():
    """Two batches submitted before either is collected must both give
    per-pair results identical to the synchronous path."""
    from ksw2_tpu.batch.scheduler import align_batch_scores_async

    rng = np.random.default_rng(13)
    mat = simple_mat(5, 2, 4)
    batches = []
    for _ in range(2):
        jobs = []
        for _ in range(10):
            tlen = int(rng.integers(20, 400))
            t, q = refcmp.random_pair(rng, tlen,
                                      divergence=float(rng.uniform(0, .3)),
                                      indel=0.1)
            jobs.append(AlignJob(encode_dna(q), encode_dna(t)))
        batches.append(jobs)
    handles = [align_batch_scores_async(jobs, 5, mat, 4, 2, zdrop=50,
                                        flag=Flag.SCORE_ONLY)
               for jobs in batches]
    for jobs, h in zip(batches, handles):
        sync = align_batch_scores(jobs, 5, mat, 4, 2, zdrop=50,
                                  flag=Flag.SCORE_ONLY)
        got = h.result()
        assert [e.__dict__ for e in got] == [e.__dict__ for e in sync]
        assert h.result() is got      # idempotent


def test_align_batch_async_cigars():
    """Two CIGAR batches in flight at once must both match the sync path
    (the serving twin of the score-path async test)."""
    from ksw2_tpu.batch.scheduler import align_batch, align_batch_async

    rng = np.random.default_rng(29)
    mat = simple_mat(5, 2, 4)
    batches = []
    for _ in range(2):
        jobs = []
        for _ in range(6):
            tlen = int(rng.integers(30, 250))
            t, q = refcmp.random_pair(rng, tlen, divergence=0.25,
                                      indel=0.1)
            jobs.append(AlignJob(encode_dna(q), encode_dna(t)))
        batches.append(jobs)
    handles = [align_batch_async(jobs, 5, mat, 4, 2, zdrop=60)
               for jobs in batches]
    for jobs, h in zip(batches, handles):
        sync = align_batch(jobs, 5, mat, 4, 2, zdrop=60)
        got = h.result()
        assert [e.tsv_fields() for e in got] == \
               [e.tsv_fields() for e in sync]
        assert h.result() is got
