"""FASTA/FASTQ reader tests."""
import gzip

from ksw2_tpu.io.fasta import read_fastx


def test_multiline_fasta(tmp_path):
    p = tmp_path / "x.fa"
    p.write_text(">s1 a comment here\nACGT\nACGT\n>s2\nTTTT\n")
    recs = list(read_fastx(str(p)))
    assert [(r.name, r.comment, r.seq) for r in recs] == [
        ("s1", "a comment here", "ACGTACGT"), ("s2", "", "TTTT")]


def test_fastq(tmp_path):
    p = tmp_path / "x.fq"
    p.write_text("@r1\nACGT\n+\nIIII\n@r2 c\nAC\n+\n!!\n")
    recs = list(read_fastx(str(p)))
    assert recs[0].seq == "ACGT" and recs[0].qual == "IIII"
    assert recs[1].name == "r2" and recs[1].qual == "!!"


def test_gzip(tmp_path):
    p = tmp_path / "x.fa.gz"
    with gzip.open(str(p), "wt") as f:
        f.write(">g\nAACC\n")
    recs = list(read_fastx(str(p)))
    assert recs[0].seq == "AACC"


def test_reference_data():
    """The reference CLI's test pairs, kept in tests/data."""
    import os

    data = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    recs = list(read_fastx(os.path.join(data, "t1.fa")))
    assert len(recs) == 5 and recs[0].name == "t1"
    assert [len(r.seq) for r in recs] == [3, 19, 72, 15, 34]
    qrecs = list(read_fastx(os.path.join(data, "q1.fa")))
    assert [r.name for r in qrecs] == ["q1", "q2", "q3", "q4", "q5"]
