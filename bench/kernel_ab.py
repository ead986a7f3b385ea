"""End-to-end A/B of the two forward engines on the card.

Times ``Aligner.extend_batch`` with the plain-XLA forward (a) and with the
CUDA forward (b) on the smoke workloads, in one process, in turns
(a, b, b, a), warm, each call ending in fetched results.  The scheduler
picks its forward by platform only; this script swaps it for the (a) turns
and checks that both engines return identical results; it also times the
forward alone on every launch of the batch (device time, inputs already on
the device).  Prints one JSON line per workload.

    python bench/kernel_ab.py [--only scores_512,ont_2048,...]

Needs a GPU; fails without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import workloads  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def engine(name: str):
    """Run the scheduler on forward (a) "xla" or (b) "cuda"."""
    from ksw2_tpu.batch import scheduler
    from ksw2_tpu.ops import batch_xla, cuda_ext

    fwd = {"xla": batch_xla.forward, "cuda": cuda_ext.forward}[name]
    saved = scheduler.select_forward
    scheduler.select_forward = lambda: fwd
    try:
        yield
    finally:
        scheduler.select_forward = saved


def cases():
    from ksw2_tpu import Aligner
    from ksw2_tpu.core.flags import Flag

    mixed = workloads.mixed_jobs()
    score = Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=Flag.SCORE_ONLY)
    ont = Aligner(a=2, b=4, q=4, e=2, q2=24, e2=1, zdrop=400, w=500)
    exact = Aligner(a=2, b=4, q=4, e=2, flag=Flag.SCORE_ONLY)
    return {
        "scores_512": (score, mixed),
        "scores_16384": (score, mixed * 32),
        "ont_2048": (ont, workloads.ont_jobs()),
        "pair_50k": (exact, [workloads.long_pair()]),
    }


def forward_times(aln, pairs, order=("xla", "cuda", "cuda", "xla")):
    """Device time of the forward alone over every launch of the batch
    (planned as the scheduler plans it), per engine, in turns."""
    import jax

    from ksw2_tpu.batch.scheduler import plan_launches
    from ksw2_tpu.ops import batch_xla, cuda_ext

    launches, _ = plan_launches(
        aln._jobs(pairs, None), aln.m, aln.mat, aln.q, aln.e, aln.q2,
        aln.e2, zdrop=aln.zdrop, end_bonus=aln.end_bonus, flag=aln.flag)
    fwd = {name: jax.jit(f, static_argnums=0) for name, f in
           (("xla", batch_xla.forward), ("cuda", cuda_ext.forward))}
    args = [(ln.spec, jax.device_put(ln.args)) for ln in launches]

    def run(name):
        outs = [fwd[name](spec, *a) for spec, a in args]
        jax.block_until_ready(outs)

    for name in ("xla", "cuda"):
        run(name)                            # compile
    times = {"xla": [], "cuda": []}
    for name in order:
        t0 = time.perf_counter()
        run(name)
        times[name].append(time.perf_counter() - t0)
    return times


def digest(ezs):
    return [(e.max, e.max_t, e.max_q, e.mqe, e.mqe_t, e.mte, e.mte_q,
             e.score, e.zdropped, e.reach_end, tuple(e.cigar)) for e in ezs]


def main(argv=None) -> int:
    import jax

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="", help="comma-separated workloads")
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        print("no GPU found", file=sys.stderr)
        return 1
    label = card()
    print(label, flush=True)
    rows = []
    for name, (aln, pairs) in cases().items():
        if args.only and name not in args.only.split(","):
            continue
        outs, times = {}, {"xla": [], "cuda": []}
        for eng in ("xla", "cuda"):              # warm-up: compile
            t0 = time.perf_counter()
            with engine(eng):
                outs[eng] = digest(aln.extend_batch(pairs))
            times[eng + "_first"] = time.perf_counter() - t0
        for eng in ("xla", "cuda", "cuda", "xla"):
            t0 = time.perf_counter()
            with engine(eng):
                aln.extend_batch(pairs)
            times[eng].append(time.perf_counter() - t0)
        fwd_t = forward_times(aln, pairs)
        row = dict(workload=name, n_pairs=len(pairs), card=label,
                   forward_xla_s=fwd_t["xla"], forward_cuda_s=fwd_t["cuda"],
                   equal=outs["xla"] == outs["cuda"],
                   xla_s=times["xla"], cuda_s=times["cuda"],
                   xla_first_s=times["xla_first"],
                   cuda_first_s=times["cuda_first"],
                   speedup=float(np.mean(times["xla"])
                                 / np.mean(times["cuda"])),
                   device=dict(platform=jax.devices()[0].platform,
                               kind=jax.devices()[0].device_kind,
                               count=len(jax.devices())))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return 0 if all(r["equal"] for r in rows) else 2


if __name__ == "__main__":
    sys.exit(main())
