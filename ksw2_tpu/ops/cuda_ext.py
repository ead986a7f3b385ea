"""The hand-written CUDA forward (Hopper), called through ``jax.ffi``.

:func:`forward` has the signature and the outputs of
:func:`ksw2_tpu.ops.batch_xla.forward` and is byte-equal to it; the kernel
itself is ``cuda/ext_forward.cu`` (one thread block per pair, the band in
shared memory).  The shared library is built from that source with
``nvcc`` at first use, into ``cuda/build/`` (listed in ``.gitignore``),
under a name that carries the source's hash, so an edited kernel is
rebuilt and a built one is reused.  Build it ahead of time with::

    python -m ksw2_tpu.ops.cuda_ext

The CUDA toolkit is looked up in ``$CUDA_HOME`` (default
``/usr/local/cuda``).  CUDA code has no interpret mode: the tests that
run this kernel carry the ``gpu`` marker.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np

from .batch_xla import BatchSpec

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "cuda", "ext_forward.cu")
BUILD_DIR = os.path.join(_HERE, "cuda", "build")
TARGET = "ksw2_ext_forward"
# a launch keeps each pair's planes in shared memory up to this many bytes
# (two blocks per SM at the largest), else in a global scratch result
SMEM_LIMIT = 100 * 1024

_lock = threading.Lock()
_registered = False


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libksw2ext-{digest}.so")


def build() -> str:
    """Compile the kernel library if it is not built yet; returns its
    path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = os.path.join(cuda, "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc") or nvcc
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", tmp, SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as err:
        raise RuntimeError(f"nvcc failed:\n{err.stderr}") from err
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.Ksw2ExtForward), platform="CUDA")
        _registered = True


def pair_bytes(spec: BatchSpec) -> int:
    """Bytes of one pair's planes, score profile and H row."""
    return spec.Lt * (2 * (6 if spec.two else 4) + 1 + 4)


def forward(spec: BatchSpec, query, target, qlen, tlen, w, mat, prm):
    """CUDA twin of :func:`ksw2_tpu.ops.batch_xla.forward`."""
    _register()
    B = target.shape[0]
    n_diag = spec.Lq + spec.Lt - 1
    per_pair = pair_bytes(spec)
    use_smem = per_pair <= SMEM_LIMIT
    out_types = (
        jax.ShapeDtypeStruct((B, 9), jnp.int32),
        jax.ShapeDtypeStruct((n_diag, B, spec.nc) if spec.nc else (1,),
                             jnp.uint8),
        jax.ShapeDtypeStruct((1,) if use_smem else (B * per_pair,),
                             jnp.uint8),
    )
    rec, p, _ = jax.ffi.ffi_call(TARGET, out_types)(
        jnp.asarray(query, jnp.int8), jnp.asarray(target, jnp.int8),
        jnp.asarray(qlen, jnp.int32), jnp.asarray(tlen, jnp.int32),
        jnp.asarray(w, jnp.int32), jnp.asarray(mat, jnp.int8),
        jnp.asarray(prm, jnp.int32), flag=np.int32(spec.flag),
        nc=np.int32(spec.nc), two=np.int32(spec.two),
        use_smem=np.int32(use_smem))
    return rec, (p if spec.nc else None)


__all__ = ["SOURCE", "BUILD_DIR", "build", "forward", "pair_bytes"]


if __name__ == "__main__":
    print(build())
