import os
import sys

# XLA's CPU backend occasionally segfaults *inside compilation* (LLVM pass
# recursion) when the whole suite's compiles run on the default 8 MB main
# stack.  The main thread's stack VMA grows on page fault up to
# RLIMIT_STACK, so raising the soft limit at runtime is enough — no re-exec
# (which would also lose pytest's captured stdout fds).
try:
    import resource

    _want = 256 << 20
    _soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
    if _soft != resource.RLIM_INFINITY and _soft < _want:
        resource.setrlimit(resource.RLIMIT_STACK, (
            _want if _hard == resource.RLIM_INFINITY else min(_want, _hard),
            _hard))
except (ImportError, ValueError, OSError):
    pass  # best-effort; the suite still runs on the default stack

# Under JAX_PLATFORMS=cpu the suite runs on an 8-device virtual CPU mesh;
# on a GPU machine (``pytest -m gpu``) the flag only shapes the unused
# CPU client.
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_executables_between_modules():
    """Free compiled XLA executables after each test module.

    XLA:CPU's JIT has crashed (segfault inside LLVM during a *later*
    compile) once enough executables accumulate in one process; dropping
    the jit caches between modules keeps the resident JIT state small.
    """
    yield
    import jax

    jax.clear_caches()
