"""Black-box CLI fuzz: our CLI vs the reference binary, random inputs.

Complements the fixed golden files in tests/test_cli.py: random sequence
pairs (with N runs) and random flag combinations go through BOTH CLIs as
literal-sequence arguments and the TSV output must match byte-for-byte
(after the reference's NUL-for-N-op quirk is normalized).  Runs the spec
backend in subprocesses; the device backend's parity is covered by
tests/test_golden_device.py, tests/test_differential.py and
chip_smoke.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
REF_BIN = os.environ.get("KSW2_REF_BIN", "/tmp/refbuild/ksw2-test")

sys.path.insert(0, HERE)
import refcmp  # noqa: E402


def _run(cmd):
    r = subprocess.run(cmd, capture_output=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, (cmd, r.stderr[-500:])
    return r.stdout.replace(b"\x00", b"N").decode()


@pytest.mark.skipif(not refcmp.have_ref(), reason="reference binary absent")
def test_cli_random_flag_fuzz():
    rng = np.random.default_rng(99)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    n = 0
    for trial in range(14):
        tlen = int(rng.integers(8, 160))
        t, q = refcmp.random_pair(rng, tlen, float(rng.uniform(0, 0.4)),
                                  float(rng.uniform(0, 0.2)),
                                  bool(rng.integers(0, 2)))
        algo = str(rng.choice(["extz2_sse", "extd2_sse", "gg", "gg2_sse",
                               "extf2_sse", "exts2_sse", "extz", "extd"]))
        args = ["-t", algo]
        if rng.random() < 0.5 and algo not in ("exts2_sse",):
            args += ["-w", str(int(rng.integers(3, 80)))]
        if rng.random() < 0.5:
            args += ["-z", str(int(rng.integers(20, 200)))]
        if rng.random() < 0.3:
            args += ["-r"]
        if rng.random() < 0.3:
            args += ["-s"]
        if rng.random() < 0.4:
            args += ["-g"]
        if rng.random() < 0.3:
            args += ["-A", str(int(rng.integers(1, 4))),
                     "-B", str(int(rng.integers(1, 10)))]
        if rng.random() < 0.3:
            args += ["-O", f"{int(rng.integers(2, 10))},"
                           f"{int(rng.integers(10, 30))}",
                     "-E", f"{int(rng.integers(2, 5))},1"]
        ref = _run([REF_BIN] + args + [t, q])
        # spec backend: deterministic, validated against the binary; the
        # CLI defaults to the device backend on a GPU, so pin it here
        mine = subprocess.run(
            [sys.executable, "-m", "ksw2_tpu.cli", "--backend", "spec"]
            + args + [t, q],
            capture_output=True, timeout=300, cwd=REPO, env=env)
        assert mine.returncode == 0, (args, mine.stderr[-500:])
        got = mine.stdout.decode()
        assert got == ref, (trial, args, t, q, "\nREF: " + ref,
                            "GOT: " + got)
        n += 1
    assert n == 14
