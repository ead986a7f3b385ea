"""Smoke test of the device path on one GPU (or four with ``--cards 4``).

Runs the batch entry points a read mapper calls, at the sizes it sends,
and checks every result exactly (integer DP: the tolerance is zero):

1. device: the GPU and its power limit; anything but a GPU fails;
2. compile: every launch program of phases 3-5, with its memory analysis
   and the compile seconds (set-up time);
3. short-read-scale one-piece scores: the seed-777 mixed recipe
   (150-3000 bp) through ``Aligner.extend_batch``; 512 jobs against the
   reference-binary anchor, the same recipe as one 16,384-job call, and a
   seeded 64-job sample against the spec;
4. noisy-long-read-shaped two-piece CIGARs (minimap2 map-ont costs, band
   500): 2,048 heavy-tailed 100 bp - 10 kb jobs, a seeded sample of 16
   (with the longest) against the spec;
5. one 50 kb x 50 kb one-piece pair, exact max, score-only, against an
   anchor derived from ``spec/diagdiff.py``;
6. kernel parity: the CUDA forward and the XLA forward byte-equal on every
   launch of phases 3 and 4.

With ``--cards 4`` it runs only the four-card path: phase-3 scores and
phase-4-shaped one-piece CIGARs with the batch sharded over four cards,
and ``halo_extz_score`` (the 50 kb pair split over the cards), each
compared with one card.

Every phase prints one line; wall times are labelled with the card and its
power limit and are not benchmark numbers.  The last line is the JSON
verdict.  Any failure raises and exits non-zero.

    python chip_smoke.py [--cards 4]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "bench"))

# fields of the 50 kb pair (workloads.long_pair, a=2 b=4 q=4 e=2, exact
# max, no Z-drop): max, max_t, max_q, mqe, mqe_t, mte, mte_q, score,
# zdropped, from spec.diagdiff.extz2
PAIR_50K_ANCHOR = [51338, 49815, 49999, 51338, 49815, 50966, 49999, 50966, 0]
SAMPLE_SCORES = 64
SAMPLE_CIGARS = 16


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def phase(n: int, name: str, **fields) -> None:
    print(f"phase {n} {name}: " + json.dumps(fields, default=str),
          flush=True)


def fields(ez):
    return [ez.max, ez.max_t, ez.max_q, ez.mqe, ez.mqe_t, ez.mte, ez.mte_q,
            ez.score, int(ez.zdropped)]


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def configs():
    from ksw2_tpu import Aligner
    from ksw2_tpu.core.flags import Flag

    return dict(
        scores=Aligner(a=2, b=4, q=4, e=2, zdrop=100, flag=Flag.SCORE_ONLY),
        ont=Aligner(a=2, b=4, q=4, e=2, q2=24, e2=1, zdrop=400, w=500),
        ont_one=Aligner(a=2, b=4, q=4, e=2, zdrop=400, w=500),
        exact=Aligner(a=2, b=4, q=4, e=2, flag=Flag.SCORE_ONLY),
    )


def plan(aln, pairs, n_shards=1):
    from ksw2_tpu.batch.scheduler import plan_launches

    return plan_launches(aln._jobs(pairs, None), aln.m, aln.mat, aln.q,
                         aln.e, aln.q2, aln.e2, zdrop=aln.zdrop,
                         end_bonus=aln.end_bonus, flag=aln.flag,
                         n_shards=n_shards)[0]


def spec_result(aln, q, t):
    from ksw2_tpu.spec import diagdiff

    if aln.q2 is None:
        ez, _ = diagdiff.extz2(q, t, aln.m, aln.mat, aln.q, aln.e, w=aln.w,
                               zdrop=aln.zdrop, flag=aln.flag)
    else:
        ez, _ = diagdiff.extd2(q, t, aln.m, aln.mat, aln.q, aln.e, aln.q2,
                               aln.e2, w=aln.w, zdrop=aln.zdrop,
                               flag=aln.flag)
    return ez


def one_card(label: str) -> None:
    import jax

    import workloads
    from ksw2_tpu.batch.scheduler import launch_program
    from ksw2_tpu.ops import batch_xla, cuda_ext

    cfg = configs()
    mixed = workloads.mixed_jobs()
    ont = workloads.ont_jobs()
    pair = workloads.long_pair()
    rng = np.random.default_rng(2026)

    # 2. compile every launch program the workloads use
    compiled, t_all = [], 0.0
    for name, aln, pairs in (("scores", cfg["scores"], mixed),
                             ("scores", cfg["scores"], mixed * 32),
                             ("ont", cfg["ont"], ont),
                             ("exact", cfg["exact"], [pair])):
        for ln in plan(aln, pairs):
            prog = launch_program(ln.spec)
            exe, dt = timed(lambda: prog.lower(*ln.args).compile())
            t_all += dt
            ma = exe.memory_analysis()
            compiled.append(dict(
                workload=name, spec=ln.spec._asdict(), B=ln.args[0].shape[0],
                compile_s=round(dt, 3),
                temp_bytes=getattr(ma, "temp_size_in_bytes", None),
                argument_bytes=getattr(ma, "argument_size_in_bytes", None),
                output_bytes=getattr(ma, "output_size_in_bytes", None)))
    phase(2, "compile", programs=len(compiled), compile_s=round(t_all, 2),
          card=label, memory=compiled)

    # 3. short-read-scale one-piece scores
    aln = cfg["scores"]
    ez512, t512 = timed(lambda: aln.extend_batch(mixed))
    total = sum(e.max for e in ez512)
    assert total == workloads.MIXED_512_SUM_MAX, (total,)
    ez16k, t16k = timed(lambda: aln.extend_batch(mixed * 32))
    assert len(ez16k) == 32 * len(mixed)
    assert [fields(e) for e in ez16k] == [fields(e) for e in ez512] * 32
    sample = rng.choice(len(mixed), SAMPLE_SCORES, replace=False)
    for i in sample:
        want = spec_result(aln, *mixed[i])
        assert fields(ez512[i]) == fields(want), (i, ez512[i], want)
    phase(3, "scores", jobs=[len(mixed), len(ez16k)], sum_max=int(total),
          anchor=workloads.MIXED_512_SUM_MAX, spec_sample=SAMPLE_SCORES,
          wall_s=[round(t512, 3), round(t16k, 3)], card=label)

    # 4. noisy-long-read-shaped two-piece CIGARs
    aln = cfg["ont"]
    ez_ont, t_ont = timed(lambda: aln.extend_batch(ont))
    longest = int(np.argmax([len(t) for _, t in ont]))
    others = np.delete(np.arange(len(ont)), longest)
    picks = [longest] + [int(i) for i in rng.choice(
        others, SAMPLE_CIGARS - 1, replace=False)]
    for i in picks:
        want = spec_result(aln, *ont[i])
        assert ez_ont[i] == want, (i, fields(ez_ont[i]), fields(want))
    n_ops = sum(len(e.cigar) for e in ez_ont)
    phase(4, "cigars", jobs=len(ont), spec_sample=len(picks),
          longest_bp=len(ont[longest][1]), cigar_runs=n_ops,
          wall_s=round(t_ont, 3), card=label)

    # 5. one 50 kb x 50 kb pair, exact max, score-only
    (ez50,), t50 = timed(lambda: cfg["exact"].extend_batch([pair]))
    assert fields(ez50) == PAIR_50K_ANCHOR, (fields(ez50), PAIR_50K_ANCHOR)
    phase(5, "pair_50k", fields=fields(ez50), wall_s=round(t50, 3),
          card=label)

    # 6. CUDA forward == XLA forward on every launch of phases 3 and 4
    xla = jax.jit(batch_xla.forward, static_argnums=0)
    cuda = jax.jit(cuda_ext.forward, static_argnums=0)
    n_launch = 0
    for aln, pairs in ((cfg["scores"], mixed), (cfg["scores"], mixed * 32),
                       (cfg["ont"], ont)):
        for ln in plan(aln, pairs):
            rx, px = xla(ln.spec, *ln.args)
            rc, pc = cuda(ln.spec, *ln.args)
            assert np.array_equal(np.asarray(rx), np.asarray(rc)), ln.spec
            if ln.spec.nc:
                assert np.array_equal(np.asarray(px), np.asarray(pc)), \
                    ln.spec
            n_launch += 1
    phase(6, "kernel_parity", launches=n_launch, card=label)


def four_cards(label: str) -> None:
    import workloads
    from ksw2_tpu.core.flags import Flag
    from ksw2_tpu.core.matrix import simple_mat
    from ksw2_tpu.parallel.halo import halo_extz_score
    from ksw2_tpu.parallel.mesh import make_mesh

    cfg = configs()
    mesh = make_mesh(4)
    mixed = workloads.mixed_jobs()
    ont = workloads.ont_jobs()
    out = {}
    for name, aln, pairs in (("scores_16384", cfg["scores"], mixed * 32),
                             ("ont_one_piece", cfg["ont_one"], ont)):
        one, t1 = timed(lambda: aln.extend_batch(pairs))
        four, t4 = timed(lambda: aln.extend_batch(pairs, mesh=mesh))
        assert four == one, name
        out[name] = dict(jobs=len(pairs), wall_s_1=round(t1, 3),
                         wall_s_4=round(t4, 3))
    q, t = workloads.long_pair()
    halo, th = timed(lambda: halo_extz_score(
        mesh, q, t, 5, simple_mat(5, 2, 4), 4, 2, w=-1,
        flag=Flag.SCORE_ONLY))
    (ez1,) = cfg["exact"].extend_batch([(q, t)])
    assert fields(halo) == fields(ez1) == PAIR_50K_ANCHOR, \
        (fields(halo), fields(ez1))
    out["halo_50k"] = dict(wall_s=round(th, 3), fields=fields(halo))
    phase(7, "four_cards", card=label, **out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    plat = devs[0].platform
    if plat != "gpu" or len(devs) < args.cards:
        print(f"needs {args.cards} GPU(s); JAX found {devs}",
              file=sys.stderr)
        return 1
    label = card_label()
    print(label, flush=True)
    phase(1, "device", devices=[str(d) for d in devs], card=label)
    if args.cards == 4:
        four_cards(label)
    else:
        one_card(label)
    print(json.dumps({"ok": True, "device": {
        "platform": plat, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
