"""Where the port keeps what it compiles (port of
``mimo_ofdm_tpu/utils/compile_cache.py``).

The JAX package turns on XLA's persistent compilation cache, so that one
machine compiles each jitted program once rather than once per process.
The port compiles its kernels' shared libraries, each built with ``nvcc``
from its ``csrc/*.cu`` source at first use (``kernels/build.py``). Those
builds are already persistent: they land in ``mimo_ofdm_tpu_torch/_build/``
under names keyed by the source and the flags, and later processes load
them. :func:`enable_persistent_cache` only chooses the directory, e.g. one
shared by several checkouts.
"""

from __future__ import annotations

import os
from pathlib import Path

_DISABLE_VALUES = ("0", "off", "none", "disabled")
ENV_VAR = "MIMO_OFDM_TPU_TORCH_COMPILE_CACHE"


def enable_persistent_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernel build directory at ``cache_dir``, else at
    ``$MIMO_OFDM_TPU_TORCH_COMPILE_CACHE``, else leave the default
    (``mimo_ofdm_tpu_torch/_build/``); returns the directory in use, or
    ``None`` when the variable is one of ``0``, ``off``, ``none``,
    ``disabled``, which also leaves the default in place.

    Unlike XLA's cache, which keys each compiled program and may be
    turned on at any time before the first compile, this redirects the
    library builds: call it before the first kernel launch (a library
    already loaded in this process stays in use), and a directory that
    holds the library for a source and these flags skips ``nvcc`` for it."""
    from mimo_ofdm_tpu_torch.kernels import build

    env = os.environ.get(ENV_VAR, "")
    if env and env.strip().lower() in _DISABLE_VALUES:
        return None
    chosen = cache_dir or env
    if not chosen:
        return str(build.BUILD_DIR)
    build.BUILD_DIR = Path(chosen)
    build.load_library.cache_clear()
    return chosen
