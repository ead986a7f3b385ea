"""Seeded workloads of the device path, shared by ``chip_smoke.py`` and the
bench scripts.  Everything is generated from a seed at run time.

* :func:`mixed_jobs` -- short-read-scale extension pairs, 150-3000 bp,
  the recipe whose reference-binary anchors ``bench/regen_checksums.py``
  pins (seed 777, 512 jobs).
* :func:`ont_jobs` -- noisy-long-read-shaped pairs (minimap2 ``map-ont``
  extension calls): heavy-tailed lengths between 100 bp and 10 kb, about
  10% divergence, half of it indels.
* :func:`long_pair` -- one 50 kb x 50 kb pair, the reference README's
  benchmark shape.
"""
from __future__ import annotations

import os
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
sys.path.insert(0, os.path.join(_REPO, "tests"))

import refcmp  # noqa: E402
from ksw2_tpu.core.matrix import encode_dna  # noqa: E402

# sum of ez.max over mixed_jobs() under extz2_sse -s -z100, a=2 b=4 q=4 e=2,
# from the reference binary (bench/regen_checksums.py)
MIXED_512_SUM_MAX = 165978


def mixed_jobs(seed: int = 777):
    """The 512 pinned short-read-scale pairs as (query, target) codes."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([150, 250, 400, 700, 1100, 1500, 3000], 512,
                      p=[.3, .25, .15, .12, .08, .06, .04])
    jobs = []
    for L in lens:
        t, q = refcmp.random_pair(rng, int(L), divergence=0.15, indel=0.06)
        jobs.append((encode_dna(q), encode_dna(t)))
    return jobs


def mutate(rng, target: np.ndarray, sub: float, ins: float, dele: float):
    """A noisy copy of ``target``: substitutions, single-base insertions
    and deletions at the given per-base rates (vectorised)."""
    u = rng.random(target.shape[0])
    keep = u >= dele
    q = target.copy()
    is_sub = (u >= dele) & (u < dele + sub)
    q[is_sub] = (q[is_sub] + rng.integers(1, 4, int(is_sub.sum()))) % 4
    is_ins = (u >= dele + sub) & (u < dele + sub + ins)
    reps = keep.astype(np.int64) + is_ins
    out = np.repeat(q, reps)
    # the inserted copy of each base becomes a random base
    first = np.cumsum(reps) - reps
    ins_pos = first[is_ins] + 1
    out[ins_pos] = rng.integers(0, 4, ins_pos.shape[0])
    return out.astype(np.uint8)


def ont_jobs(n: int = 2048, seed: int = 4242):
    """Heavy-tailed 100 bp - 10 kb noisy pairs as (query, target) codes."""
    rng = np.random.default_rng(seed)
    lens = np.clip(np.round(rng.lognormal(np.log(800), 1.0, n)), 100, 10000)
    lens[rng.integers(0, n)] = 10000          # always one at the cap
    jobs = []
    for L in lens.astype(int):
        t = rng.integers(0, 4, L).astype(np.uint8)
        jobs.append((mutate(rng, t, 0.05, 0.025, 0.025), t))
    return jobs


def long_pair(seed: int = 50):
    """One 50 kb x 50 kb extension pair (query, target)."""
    rng = np.random.default_rng(seed)
    t, q = refcmp.random_pair(rng, 50000, divergence=0.1, indel=0.04)
    return encode_dna(q[:50000]), encode_dna(t)
