"""Re-derive the anchors ``chip_smoke.py`` pins.

Any intentional change to ``refcmp.random_pair`` or the workload recipes
of ``bench/workloads.py`` invalidates them.  Each anchor comes from its
source of truth: the compiled reference binary where the CLI can express
the parameters (``$KSW2_REF_BIN``; skipped when absent), the executable
spec otherwise.  Prints each next to the pinned value; exits 2 on any
difference.

    python bench/regen_checksums.py
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile

_repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _repo)
sys.path.insert(0, os.path.join(_repo, "bench"))

import chip_smoke  # noqa: E402
import workloads  # noqa: E402

REF_BIN = os.environ.get("KSW2_REF_BIN", "")
_DNA = "ACGTN"


def run_binary(pairs, algo, args):
    """Sum of the max column of the reference CLI over ``pairs``."""
    with tempfile.TemporaryDirectory() as td:
        tf = os.path.join(td, "t.fa")
        qf = os.path.join(td, "q.fa")
        with open(tf, "w") as f:
            for i, (_, t) in enumerate(pairs):
                f.write(">t%d\n%s\n" % (i, "".join(_DNA[c] for c in t)))
        with open(qf, "w") as f:
            for i, (q, _) in enumerate(pairs):
                f.write(">q%d\n%s\n" % (i, "".join(_DNA[c] for c in q)))
        out = subprocess.run(
            [REF_BIN, "-t", algo, *map(str, args), tf, qf],
            capture_output=True, check=True).stdout.decode("latin-1")
    return sum(int(line.split("\t")[3]) for line in out.strip().split("\n"))


def main() -> int:
    from ksw2_tpu.core.flags import Flag
    from ksw2_tpu.core.matrix import simple_mat
    from ksw2_tpu.spec import diagdiff

    rows = []
    if REF_BIN and os.path.exists(REF_BIN):
        rows.append(("mixed_512 sum(max) [extz2_sse -s -z100, binary]",
                     run_binary(workloads.mixed_jobs(), "extz2_sse",
                                ["-s", "-z", 100]),
                     workloads.MIXED_512_SUM_MAX))
    else:
        print("KSW2_REF_BIN not set: binary-backed rows skipped")
    q, t = workloads.long_pair()
    ez, _ = diagdiff.extz2(q, t, 5, simple_mat(5, 2, 4), 4, 2,
                           flag=Flag.SCORE_ONLY)
    rows.append(("pair_50k fields [spec]", chip_smoke.fields(ez),
                 chip_smoke.PAIR_50K_ANCHOR))
    ok = True
    for name, got, want in rows:
        good = got == want
        ok &= good
        print(f"{'OK ' if good else 'DIFF'} {name}: got {got}, "
              f"pinned {want}")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
