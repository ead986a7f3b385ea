"""ksw2_tpu — batched pairwise sequence alignment (ksw2 semantics) in JAX."""
from .utils.ccache import ensure_compile_cache as _ensure_compile_cache

# the kalloc analogue: every process reuses previously compiled programs
# from the persistent cache (see utils/ccache.py)
_ensure_compile_cache()

from .api import Aligner  # noqa: E402  (needs the cache configured first)

__all__ = ["Aligner"]
