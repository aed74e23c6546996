"""Process set-up: host allocator tuning and the persistent compile cache.

``tune_host_allocator`` raises glibc's mmap and trim thresholds so large
blocks live on the brk heap and are *reused warm* across alloc/free cycles
instead of being returned to the OS and faulted in again on the next call
(every large short-lived allocation — a 32 MiB ``str.encode``, a NumPy
temporary, an XLA compile arena — would otherwise re-fault its pages). No-op
(safely) on non-glibc platforms.
"""

from __future__ import annotations

import ctypes
import os

_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

#: Root of the checkout that holds this package.
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_done = False


def cache_dir() -> str:
    """The persistent cache directory: ``$JAX_COMPILATION_CACHE_DIR`` when set,
    else ``<checkout>/.jax_cache``. JAX's compile cache and the converged
    capacity cache (ops/packed_bitap._cap_cache) both live there."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache. When
    ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and this sets
    no other directory; otherwise the cache goes to ``<checkout>/.jax_cache``
    (a fixed path, so it hits across processes)."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def tune_host_allocator() -> bool:
    """Idempotent; returns True if glibc accepted the tuning."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok1 = libc.mallopt(ctypes.c_int(_M_MMAP_THRESHOLD), ctypes.c_int(1 << 30))
        ok2 = libc.mallopt(ctypes.c_int(_M_TRIM_THRESHOLD), ctypes.c_int(1 << 30))
        _done = bool(ok1) and bool(ok2)
    except Exception:
        _done = False
    return _done
