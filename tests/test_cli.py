"""CLI compatibility: byte-identical TSV with the reference's ksw2-test."""
import io
import os
import sys

import pytest

from ksw2_tpu import cli

TDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GOLDEN_T1Q1_EXTZ2 = """t1\tq1\t-2\t4\t1\t1\t2M1D
t2\tq2\t-12\t2\t0\t0\t2D7M2D4M4D
t3\tq3\t12\t48\t35\t33\t5M2D27M6D7M2D4M3D3M3D2M2D6M
t4\tq4\t-18\t0\t-1\t-1\t11D4M
t5\tq5\t-46\t10\t4\t4\t34M
"""

GOLDEN_T1Q1_EXTD2 = """t1\tq1\t-2\t4\t1\t1\t2M1D
t2\tq2\t-12\t2\t0\t0\t2D7M2D4M4D
t3\tq3\t14\t48\t35\t33\t5M2D28M19D4M3I2M2I4M2D6M
t4\tq4\t-16\t0\t-1\t-1\t11D4M
t5\tq5\t-19\t10\t4\t4\t34M
"""
# (note: BASELINE.md lists t5 extd2_sse as 8, but the live reference binary
# prints -19 with the default params; the binary is the ground truth here --
# 8 matches the scalar ksw_extd N-scoring instead)


def run_cli(argv):
    buf = io.StringIO()
    old = sys.stdout
    sys.stdout = buf
    try:
        rc = cli.main(argv)
    finally:
        sys.stdout = old
    assert rc == 0
    return buf.getvalue()


def test_extz2_sse_t1q1():
    out = run_cli(["-t", "extz2_sse", f"{TDIR}/t1.fa", f"{TDIR}/q1.fa"])
    assert out == GOLDEN_T1Q1_EXTZ2


def test_extd2_sse_t1q1_defaults():
    out = run_cli(["-t", "extd2_sse", f"{TDIR}/t1.fa", f"{TDIR}/q1.fa"])
    assert out == GOLDEN_T1Q1_EXTD2


def test_banded_regression_from_t5_header():
    # the command recorded in test/t1.fa's t5 header (a past upstream bug)
    out = run_cli(["-t", "extz2_sse", "-A1", "-B9", "-O16", "-E1", "-w10",
                   f"{TDIR}/t1.fa", f"{TDIR}/q1.fa"])
    assert out.splitlines()[2].split("\t")[2] == "-1073741824"  # banded-out
    assert out.splitlines()[4].split("\t")[2:] == ["-30", "5", "4", "4", "34M"]


def test_literal_sequences():
    out = run_cli(["-t", "extz2_sse", "ACGTACGT", "ACGTTCGT"])
    fields = out.strip().split("\t")
    assert fields[:2] == ["first", "second"]
    assert fields[2] == "10"  # 7 matches * 2 - 4 mismatch


def test_all_vs_all_mode(tmp_path):
    t = tmp_path / "t.fa"
    q = tmp_path / "q.fa"
    t.write_text(">a\nACGT\n>b\nAAAA\n")
    q.write_text(">x\nACGT\n")
    out = run_cli(["-t", "extz2_sse", "-a", str(t), str(q)])
    lines = out.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("a\tx\t8")


def test_cli_device_backend_matches_golden():
    """The device backend (the XLA engine under JAX_PLATFORMS=cpu) prints
    the same TSV as the spec backend, in a fresh process."""
    import subprocess

    def run(*extra):
        return subprocess.run(
            [sys.executable, "-m", "ksw2_tpu.cli", *extra, "-t", "extz2_sse",
             f"{TDIR}/t1.fa", f"{TDIR}/q1.fa"],
            capture_output=True, text=True, check=True, cwd=REPO,
            env=dict(os.environ, JAX_PLATFORMS="cpu")).stdout

    out = run("--backend", "device")
    assert out == run("--backend", "spec") == GOLDEN_T1Q1_EXTZ2


@pytest.mark.parametrize("algo,extra", [
    ("extz2_sse", ["-r", "-z", "20"]),
    ("extd2_sse", ["-s", "-w", "5"]),
    ("test", []),
])
def test_cli_device_backend_matches_spec(algo, extra):
    """--backend device output is byte-identical to --backend spec."""
    base = ["-t", algo] + extra + [f"{TDIR}/t1.fa", f"{TDIR}/q1.fa"]
    want = run_cli(["--backend", "spec"] + base)
    got = run_cli(["--backend", "device"] + base)
    assert got == want


def test_cli_device_backend_refuses_spec_only_algos(capsys):
    """Algorithms without a device engine run under --backend spec only."""
    rc = cli.main(["--backend", "device", "-t", "gg2_sse", "ACGT", "ACGT"])
    assert rc == 1
    assert "--backend spec" in capsys.readouterr().err
