"""AOT-precompile the standard bucket ladder into the persistent cache.

The reference's kalloc contract is zero per-call setup cost across millions
of alignment calls (kalloc.c:41-62).  The analogue here has two layers:

1. in-process: every launch program is cached per bucket shape, so a shape
   compiles once (the scoring costs are runtime values and never force a
   recompile);
2. cross-process: the persistent JAX compilation cache
   (:mod:`ksw2_tpu.utils.ccache`) makes later processes load programs
   instead of compiling them.

This module fills layer 2 ahead of time: ``python -m ksw2_tpu.precompile``
compiles the launch programs the scheduler produces for square buckets of
the length ladder (one-piece and two-piece, scores and CIGARs), so a
deployment's first real workload starts hot.  Reruns are cache hits.

Usage::

    python -m ksw2_tpu.precompile [--max-len 3072] [--batch 512]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-len", type=int, default=3072,
                    help="largest bucket length to warm [3072]")
    ap.add_argument("--batch", type=int, default=512,
                    help="jobs per bucket (sets the launch batch) [512]")
    args = ap.parse_args(argv)

    from .batch.scheduler import (AlignJob, bucket_len, launch_program,
                                  plan_launches)
    from .core.flags import Flag
    from .core.matrix import simple_mat

    mat = simple_mat(5, 2, 4)
    lengths = sorted({bucket_len(n) for n in range(64, args.max_len + 1, 16)})
    t_start = time.time()
    n = 0
    for L in lengths:
        jobs = [AlignJob(np.zeros(L, np.int8), np.zeros(L, np.int8))] \
            * args.batch
        for two in (False, True):
            for flag in (Flag.SCORE_ONLY, Flag.NONE):
                launches, _ = plan_launches(
                    jobs, 5, mat, 4, 2, *((24, 1) if two else (None, None)),
                    flag=flag)
                for ln in launches:
                    launch_program(ln.spec).lower(*ln.args).compile()
                    n += 1
        print(f"bucket {L}: {n} programs, {time.time() - t_start:.1f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
