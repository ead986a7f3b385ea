"""The one platform dispatch point (ops/dispatch.py)."""
import jax
import numpy as np
import pytest

from ksw2_tpu.core.flags import Flag
from ksw2_tpu.core.matrix import simple_mat
from ksw2_tpu.ops import batch_xla, dispatch
from ksw2_tpu.ops.batch_xla import BatchSpec, make_params

SPECS = [BatchSpec(Lq=64, Lt=64, two=False, flag=int(Flag.SCORE_ONLY),
                   nc=0),
         BatchSpec(Lq=48, Lt=64, two=True, flag=0, nc=64)]


def _args(spec, B=2):
    rng = np.random.default_rng(1)
    mat = simple_mat(5, 2, 4)
    prm = make_params(5, mat, 4, 2, *((24, 1) if spec.two else ()),
                      zdrop=100)
    return (rng.integers(0, 4, (B, spec.Lq)).astype(np.int8),
            rng.integers(0, 4, (B, spec.Lt)).astype(np.int8),
            np.full(B, spec.Lq, np.int32), np.full(B, spec.Lt, np.int32),
            np.full(B, spec.Lt, np.int32), mat.reshape(-1), prm)


@pytest.mark.parametrize("platform", ["rocm", "METAL", "neuron", "cuda_x"])
def test_unknown_platform_raises_naming_it(platform):
    with pytest.raises(RuntimeError, match=platform):
        dispatch.select_forward(platform=platform)


@pytest.mark.parametrize("spec", SPECS)
def test_cpu_runs_the_xla_engine_never_an_interpreter(spec):
    """Under JAX_PLATFORMS=cpu every bucket runs on the compiled XLA
    engine (nothing interprets unless a caller asks)."""
    assert dispatch.cpu_requested()
    assert dispatch.select_forward() is batch_xla.forward
    assert dispatch.select_forward(platform="cpu") is batch_xla.forward
    rec, p = jax.jit(dispatch.select_forward(), static_argnums=0)(
        spec, *_args(spec))
    assert rec.shape == (2, len(batch_xla.FIELDS))
    assert (p is None) == (spec.nc == 0)


def test_cpu_without_asking_raises(monkeypatch):
    """A machine where JAX found no GPU and nobody asked for the CPU gets
    an error, not a silent CPU fallback."""
    monkeypatch.setattr(dispatch, "cpu_requested", lambda: False)
    with pytest.raises(RuntimeError, match="JAX_PLATFORMS=cpu"):
        dispatch.select_forward(platform="cpu")


def test_gpu_selects_the_cuda_forward():
    from ksw2_tpu.ops import cuda_ext

    assert dispatch.select_forward(platform="gpu") is cuda_ext.forward
