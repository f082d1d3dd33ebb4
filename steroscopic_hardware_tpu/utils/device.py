"""Where the program runs: the one backend choice and the compile cache.

``sad_backend`` is the single place that maps the JAX platform to a
disparity path: the hand-written kernel (``ops/sad_pallas.py``) on a GPU,
the XLA formulation (``ops/sad_xla.py``) on the CPU. Any other platform is
an error, never a silent fallback. Kernels run in interpret mode only where
a test asks for it.

``enable_compile_cache`` gives every entry point the same persistent
compilation cache: ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it
itself), otherwise ``.jax_cache`` at the root of the checkout.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_BACKENDS = {"gpu": "pallas", "cpu": "xla"}


def sad_backend(platform: str | None = None) -> str:
    """``"pallas"`` on a GPU, ``"xla"`` on the CPU; raises elsewhere.

    ``platform`` defaults to that of the first JAX device (which
    initialises the backend, so call this lazily, not at import)."""
    if platform is None:
        platform = jax.devices()[0].platform
    try:
        return _BACKENDS[platform]
    except KeyError:
        raise RuntimeError(
            f"no disparity path for platform {platform!r}; "
            f"supported: {sorted(_BACKENDS)}") from None


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    return path
