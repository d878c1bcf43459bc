"""Run-time choices made from what the process can observe.

* :func:`kkt_method` — the KKT solve method for a platform.
* :func:`enable_compile_cache` — JAX's persistent compilation cache.
* :func:`device_info` — the device fields every measurement line carries.
"""
from __future__ import annotations

import os

import jax

# <checkout>/algames_tpu/runtime.py -> <checkout>
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kkt_method(platform: str | None = None) -> str:
    """KKT solve method for ``platform`` (default: JAX's default backend).

    ``'pallas'`` — the fused sweep kernel (``ops/thomas_pallas.py``), which
    on a GPU replaces the few hundred small launches per Newton iteration of
    the XLA scan; ``'schur'`` — the XLA scan everywhere else (on the CPU the
    kernel only runs in the Pallas interpreter)."""
    platform = platform or jax.default_backend()
    return "pallas" if platform == "gpu" else "schur"


def compile_cache_dir() -> str | None:
    """Directory this process should give JAX's compilation cache, or
    ``None`` when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it)."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache(min_compile_secs: float = 1.0) -> None:
    """Keep compiled programs across processes: in ``JAX_COMPILATION_CACHE_DIR``
    when it is set, else in ``<checkout>/.jax_cache``."""
    path = compile_cache_dir()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)


def device_info() -> dict:
    """``platform``, ``device_kind`` and device count of this process."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}
