"""ksw2-test-compatible command-line interface.

Same options, algorithm names, defaults and TSV output as the reference CLI
(``cli.c:159-259``), so golden diffs are plain ``diff``-able.  Extensions are
flagged explicitly:

* ``--backend {spec,device}`` selects the engine: ``spec`` (the NumPy
  reference engines, every algorithm) or ``device`` (the batched device
  path: ``extz2_sse``, ``extd2_sse`` and ``test``; the whole input runs as
  one batch).  The default is ``device`` when JAX finds a GPU, else
  ``spec``.
* exts2 CIGARs print intron ops as ``N`` (the reference CLI prints a NUL
  byte there — an out-of-bounds read of its op-name string).

Usage: ``python -m ksw2_tpu.cli [options] <DNA-target> <DNA-query>``
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .core.flags import Flag
from .core.matrix import encode_dna, simple_mat
from .core.result import ExtzResult

ALGOS = ("gg", "gg2", "gg2_sse", "extz", "extz2_sse", "extd", "extd2_sse",
         "extf2_sse", "exts2_sse", "test")
DEVICE_ALGOS = ("extz2_sse", "extd2_sse", "test")


def dispatch(
    algo: str,
    qseq: str,
    tseq: str,
    m: int = 5,
    a: int = 2,
    b: int = 4,
    q: int = 4,
    e: int = 2,
    q2: int = 13,
    e2: int = 1,
    w: int = -1,
    zdrop: int = -1,
    flag: Flag | int = Flag.NONE,
) -> ExtzResult:
    """Spec-engine dispatch with the reference CLI's parameter mapping."""
    from .spec import diagdiff, rowdp

    flag = Flag(int(flag))
    mat = simple_mat(m, a, -b)
    qs = encode_dna(qseq)
    ts = encode_dna(tseq)
    ez = ExtzResult()
    ez.reset()

    if algo == "gg":
        score, cig = rowdp.gg(qs, ts, m, mat, q, e, w=w,
                              with_cigar=not (flag & Flag.SCORE_ONLY))
        ez.score = score
        ez.max, ez.max_t, ez.max_q = 0, -1, -1
        ez.mqe = ez.mte = -0x40000000
        ez.cigar = cig if not (flag & Flag.SCORE_ONLY) else []
    elif algo == "gg2":
        score, cig, _ = diagdiff.gg2(qs, ts, m, mat, q, e, w=w,
                                     with_cigar=not (flag & Flag.SCORE_ONLY))
        ez.score = score
        ez.max, ez.max_t, ez.max_q = 0, -1, -1
        ez.cigar = cig if not (flag & Flag.SCORE_ONLY) else []
    elif algo == "gg2_sse":
        score, cig, _ = diagdiff.gg2_sse(qs, ts, m, mat, q, e, w=w)
        ez.score = score
        ez.max, ez.max_t, ez.max_q = 0, -1, -1
        ez.cigar = cig
    elif algo == "extz":
        ez = rowdp.extz(qs, ts, m, mat, q, e, w=w, zdrop=zdrop, flag=flag)
    elif algo == "extz2_sse":
        ez, _ = diagdiff.extz2(qs, ts, m, mat, q, e, w=w, zdrop=zdrop,
                               flag=flag)
    elif algo == "extd":
        ez = rowdp.extd(qs, ts, m, mat, q, e, q2, e2, w=w, zdrop=zdrop,
                        flag=flag)
    elif algo == "extd2_sse":
        ez, _ = diagdiff.extd2(qs, ts, m, mat, q, e, q2, e2, w=w,
                               zdrop=zdrop, flag=flag)
    elif algo == "extf2_sse":
        ez = diagdiff.extf2(qs, ts, int(mat[0]), int(mat[1]), e, w=w,
                            xdrop=zdrop)
    elif algo == "exts2_sse":
        smat = simple_mat(5, 1, -2)
        ez, _ = diagdiff.exts2(qs, ts, 5, smat, 2, 1, 32, 4, zdrop=zdrop,
                               junc_bonus=0, flag=flag | Flag.SPLICE_FOR)
    elif algo == "test":
        ez, _ = diagdiff.extd2(qs, ts, m, mat, 4, 2, 24, 1, w=751, zdrop=400,
                               flag=Flag.APPROX_MAX)
    else:
        print(f"ERROR: can't find algorithm '{algo}'", file=sys.stderr)
        sys.exit(1)
    return ez


def device_batch(algo: str, pairs, a: int = 2, b: int = 4, q: int = 4,
                 e: int = 2, q2: int = 13, e2: int = 1, w: int = -1,
                 zdrop: int = -1, flag: Flag | int = Flag.NONE,
                 rep: int = 1) -> List[ExtzResult]:
    """Run (query, target) string pairs through the batched device path
    with the reference CLI's parameter mapping."""
    from .batch.scheduler import AlignJob, align_batch

    mat = simple_mat(5, a, -b)
    two = algo != "extz2_sse"
    if algo == "test":      # cli.c:120-123
        q, e, q2, e2, w, zdrop, flag = 4, 2, 24, 1, 751, 400, \
            Flag.APPROX_MAX
    jobs = [AlignJob(encode_dna(qs), encode_dna(ts), w=w)
            for qs, ts in pairs]
    for _ in range(rep):
        ezs = align_batch(jobs, 5, mat, q, e, q2=q2 if two else None,
                          e2=e2 if two else None, zdrop=zdrop, flag=flag)
    return ezs


def print_aln(tname: str, qname: str, ez: ExtzResult, out=None) -> None:
    fields = [tname, qname] + ez.tsv_fields()
    print("\t".join(fields), file=out if out is not None else sys.stdout)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ksw2-tpu", add_help=True,
        description="batched pairwise alignment (ksw2-test compatible)")
    ap.add_argument("-t", dest="algo", default="extd",
                    help=f"algorithm: {', '.join(ALGOS)} [extd]")
    ap.add_argument("-w", dest="w", type=int, default=-1, help="band width [inf]")
    ap.add_argument("-R", dest="rep", type=int, default=1, help="repeat (benchmark) [1]")
    ap.add_argument("-z", dest="zdrop", type=int, default=-1, help="Z-drop [-1]")
    ap.add_argument("-r", dest="right", action="store_true", help="gap right alignment")
    ap.add_argument("-s", dest="score_only", action="store_true", help="score only")
    ap.add_argument("-g", dest="approx", action="store_true", help="approximate max")
    ap.add_argument("-K", dest="no_kalloc", action="store_true",
                    help="(compat no-op: no arena allocator here)")
    ap.add_argument("-A", dest="a", type=int, default=2, help="match score [2]")
    ap.add_argument("-B", dest="b", type=int, default=4, help="mismatch penalty [4]")
    ap.add_argument("-O", dest="gapo", default="4,13", help="gap open [4,13]")
    ap.add_argument("-E", dest="gape", default="2,1", help="gap ext [2,1]")
    ap.add_argument("-a", dest="all_vs_all", action="store_true", help="all vs all")
    ap.add_argument("--backend", default=None,
                    choices=("spec", "device"),
                    help="engine backend [device when JAX finds a GPU, "
                         "else spec]")
    ap.add_argument("--stats", action="store_true",
                    help="print the km_stat-style engine report to stderr")
    ap.add_argument("target", help="target FASTA/FASTQ (or literal sequence)")
    ap.add_argument("query", help="query FASTA/FASTQ (or literal sequence)")
    args = ap.parse_args(argv)

    if args.backend is None:
        # the analogue of the reference's runtime dispatch picking the
        # widest SIMD the machine has
        import jax

        args.backend = "device" if jax.default_backend() == "gpu" else "spec"
    if args.backend == "device" and args.algo not in DEVICE_ALGOS:
        print(f"ERROR: algorithm '{args.algo}' has no device engine (device "
              f"algorithms: {', '.join(DEVICE_ALGOS)}); use --backend spec",
              file=sys.stderr)
        return 1

    if args.stats:
        # like km_stat's end-of-run stderr report (kalloc.c:191-214), on
        # every exit path
        import atexit

        from .utils.stats import print_stats
        atexit.register(print_stats)

    def _two(sv, d2):
        parts = str(sv).split(",")
        v1 = int(parts[0])
        v2 = int(parts[1]) if len(parts) > 1 else (v1 if "," not in str(sv) else d2)
        if len(parts) == 1:
            v2 = v1
        return v1, v2

    q, q2 = _two(args.gapo, 13)
    e, e2 = _two(args.gape, 1)
    flag = Flag.NONE
    if args.right:
        flag |= Flag.RIGHT
    if args.score_only:
        flag |= Flag.SCORE_ONLY
    if args.approx:
        flag |= Flag.APPROX_MAX | Flag.APPROX_DROP

    kw = dict(a=args.a, b=args.b, q=q, e=e, q2=q2, e2=e2, w=args.w,
              zdrop=args.zdrop, flag=flag)

    t_is_file = os.path.exists(args.target)
    q_is_file = os.path.exists(args.query)
    if not t_is_file and not q_is_file:
        # literal sequences (the reference maps argv[optind+1] to the query)
        pairs = [("first", "second", args.query, args.target)]
    elif not (t_is_file and q_is_file):
        print("ERROR: need two readable files or two literal sequences",
              file=sys.stderr)
        return 1
    else:
        from .io.fasta import read_fastx

        if not args.all_vs_all:
            recs = zip(read_fastx(args.target), read_fastx(args.query))
        else:
            targets = list(read_fastx(args.target))
            recs = [(trec, qrec) for qrec in read_fastx(args.query)
                    for trec in targets]
        pairs = [(trec.name, qrec.name, qrec.seq, trec.seq)
                 for trec, qrec in recs]

    if args.backend == "device":
        ezs = device_batch(args.algo, [(p[2], p[3]) for p in pairs],
                           rep=args.rep, **kw)
    else:
        ezs = []
        for _, _, qs, ts in pairs:
            for _ in range(args.rep):
                ez = dispatch(args.algo, qs, ts, **kw)
            ezs.append(ez)
    for (tname, qname, _, _), ez in zip(pairs, ezs):
        print_aln(tname, qname, ez)
    return 0


if __name__ == "__main__":
    sys.exit(main())
