"""Runtime observability: the ``km_stat`` analogue.

The reference's arena allocator reports capacity / available / largest-block
numbers so callers can see how the memory reused across millions of
alignment calls is doing (``kalloc.c:191-214``).  This framework's arena is
the *compile cache* — one XLA program per bucket shape, device buffers
recycled by the runtime — so the equivalent report is: how many kernel
variants each engine family has compiled (hits/misses of every shape
bucket), plus the device's live memory counters.

``engine_stats()`` returns the numbers; ``format_stats()`` renders the
stderr-style report like ``km_stat`` does.
"""
from __future__ import annotations

import sys
from typing import Dict


def _iter_caches():
    """Yield (name, lru-cached fn) for every kernel-builder cache."""
    import importlib

    mods = ["ksw2_tpu.batch.scheduler", "ksw2_tpu.parallel.mesh",
            "ksw2_tpu.parallel.halo"]
    seen = set()                 # dedupe re-exported builders on identity
    for name in mods:
        if name not in sys.modules:
            continue                      # never imported: nothing compiled
        mod = importlib.import_module(name)
        for attr in dir(mod):
            fn = getattr(mod, attr)
            if callable(fn) and hasattr(fn, "cache_info") \
                    and id(fn) not in seen:
                seen.add(id(fn))
                yield f"{name.rsplit('.', 1)[1]}.{attr}", fn


def engine_stats() -> Dict[str, dict]:
    """Compile-cache population + device memory counters.

    Returns ``{"caches": {name: {hits, misses, size}}, "device": {...}}``.
    Only engines that have actually been imported/compiled appear.
    """
    caches = {}
    for name, fn in _iter_caches():
        info = fn.cache_info()
        if info.currsize or info.hits or info.misses:
            caches[name] = {"hits": info.hits, "misses": info.misses,
                            "size": info.currsize}
    dev: Dict[str, object] = {}
    try:
        import jax

        d = jax.local_devices()[0]
        dev["platform"] = d.platform
        ms = getattr(d, "memory_stats", lambda: None)()
        if ms:
            for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                      "largest_free_block_bytes", "num_allocs"):
                if k in ms:
                    dev[k] = ms[k]
        dev["live_buffers"] = sum(1 for _ in jax.live_arrays())
    except Exception:                       # no backend in this process
        pass
    return {"caches": caches, "device": dev}


def format_stats() -> str:
    """Human-readable report in the spirit of ``km_stat``'s stderr lines."""
    st = engine_stats()
    lines = []
    nvar = sum(c["size"] for c in st["caches"].values())
    nhit = sum(c["hits"] for c in st["caches"].values())
    nmiss = sum(c["misses"] for c in st["caches"].values())
    lines.append(f"[ksw2_tpu] compiled variants: {nvar} "
                 f"(cache hits {nhit}, misses {nmiss})")
    for name, c in sorted(st["caches"].items()):
        lines.append(f"  {name}: size {c['size']}, hits {c['hits']}, "
                     f"misses {c['misses']}")
    dev = st["device"]
    if dev:
        extra = ", ".join(f"{k}={v}" for k, v in dev.items())
        lines.append(f"  device: {extra}")
    return "\n".join(lines)


def print_stats(file=None) -> None:
    print(format_stats(), file=file or sys.stderr)


__all__ = ["engine_stats", "format_stats", "print_stats"]
