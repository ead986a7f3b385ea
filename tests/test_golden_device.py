"""Golden parity of the device path: every ``extz2_sse``/``extd2_sse``
case of the reference-generated corpus (tests/golden/cases.jsonl) through
``align_batch``.

The cases run in a few module-scoped batches, one ``align_batch`` call per
cost setting (the band is per job), so the compiled programs stay few;
each case is then one assertion against the reference binary's fields.
"""
import json
import os

import pytest

from ksw2_tpu.batch.scheduler import AlignJob, align_batch
from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import encode_dna, simple_mat

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cases.jsonl")
ALGOS = ("extz2_sse", "extd2_sse")


def _load():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f]
    return [c for c in cases if c["algo"] in ALGOS]


CASES = _load()


def _flag(p):
    flag = Flag.NONE
    if p["right"]:
        flag |= Flag.RIGHT
    if p["score_only"]:
        flag |= Flag.SCORE_ONLY
    if p["approx"]:
        flag |= Flag.APPROX_MAX | Flag.APPROX_DROP
    return flag


@pytest.fixture(scope="module")
def device_results():
    """Fields of every case, run grouped by algorithm and costs."""
    groups = {}
    for i, c in enumerate(CASES):
        p = c["params"]
        key = (c["algo"],) + tuple(v for k, v in sorted(p.items())
                                   if k != "w")
        groups.setdefault(key, []).append(i)
    out = {}
    for idxs in groups.values():
        c0 = CASES[idxs[0]]
        p = c0["params"]
        jobs = [AlignJob(encode_dna(CASES[i]["query"]),
                         encode_dna(CASES[i]["target"]),
                         w=CASES[i]["params"]["w"]) for i in idxs]
        two = c0["algo"] == "extd2_sse"
        ezs = align_batch(jobs, 5, simple_mat(5, p["a"], -p["b"]), p["q"],
                          p["e"], q2=p["q2"] if two else None,
                          e2=p["e2"] if two else None, zdrop=p["z"],
                          flag=_flag(p))
        for i, ez in zip(idxs, ezs):
            out[i] = ez.tsv_fields()
    return out


@pytest.mark.parametrize("idx", range(len(CASES)),
                         ids=lambda i: f"{CASES[i]['algo']}-{i}")
def test_golden_case_device(device_results, idx):
    case = CASES[idx]
    got = device_results[idx]
    if case.get("fields_only"):
        got = got[:4]
    assert got == case["expect"], (
        f"{case['algo']} {case['params']} tlen={len(case['target'])} "
        f"qlen={len(case['query'])}")
