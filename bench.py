"""Headline timing: the 50 kb x 50 kb pair, exact max, score-only, on one
GPU (the reference README's benchmark shape).

Prints ONE JSON line: the wall times, the DP cells (2.5 G) and the device
(see ``bench/suite.py`` for the other workloads).  Needs a GPU and fails
without one.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "bench"))
import suite  # noqa: E402


def main() -> int:
    import jax

    if jax.default_backend() != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    name, aln, pairs = [r for r in suite.rows() if r[0] == "pair_50k"][0]
    row = suite.run_row(name, aln, pairs, suite.card())
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
