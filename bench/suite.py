"""Timing suite of the device path: one JSON line per workload.

Each row times ``Aligner.extend_batch`` on one of the seeded workloads of
``bench/workloads.py``: warm (the first call compiles and is reported as
set-up), then three calls that end in fetched results; the row gives every
wall time, the DP cells the batch covers, and the device it ran on.
Needs a GPU and fails without one.

    python bench/suite.py [--only scores_512,ont_2048,...]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import workloads  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rows():
    """(name, aligner, pairs) of every workload."""
    from ksw2_tpu import Aligner
    from ksw2_tpu.core.flags import Flag

    mixed = workloads.mixed_jobs()
    score = Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=Flag.SCORE_ONLY)
    return [
        ("scores_512", score, mixed),
        ("scores_16384", score, mixed * 32),
        ("ont_2048", Aligner(a=2, b=4, q=4, e=2, q2=24, e2=1, zdrop=400,
                             w=500), workloads.ont_jobs()),
        ("pair_50k", Aligner(a=2, b=4, q=4, e=2, flag=Flag.SCORE_ONLY),
         [workloads.long_pair()]),
    ]


def cells(aln, pairs) -> int:
    """Band cells of the full DP of every pair (no Z-drop stop)."""
    total = 0
    for q, t in pairs:
        w = aln.w if aln.w >= 0 else max(len(q), len(t))
        total += sum(min(len(t), i + w + 1) - max(0, i - w)
                     for i in range(len(q))) if w < max(len(q), len(t)) \
            else len(q) * len(t)
    return total


def run_row(name, aln, pairs, label, reps=3):
    import jax

    t0 = time.perf_counter()
    aln.extend_batch(pairs)
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        aln.extend_batch(pairs)
        walls.append(time.perf_counter() - t0)
    d = jax.devices()[0]
    return dict(workload=name, n_pairs=len(pairs), cells=cells(aln, pairs),
                first_call_s=first, wall_s=walls, card=label,
                device=dict(platform=d.platform, kind=d.device_kind,
                            count=len(jax.devices())))


def main(argv=None) -> int:
    import jax

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated workloads")
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    label = card()
    for name, aln, pairs in rows():
        if args.only and name not in args.only.split(","):
            continue
        print(json.dumps(run_row(name, aln, pairs, label)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
