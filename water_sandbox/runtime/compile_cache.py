"""Where the entry points keep JAX's persistent compile cache.

The CLI, ``bench.py`` and ``chip_smoke.py`` call :func:`configure` before
their first compilation; importing the package sets nothing. Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no other
directory is set here. Otherwise the cache lives at a fixed path inside the
checkout (listed in ``.gitignore``), so one checkout's runs share it.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def configure(environ=None) -> str:
    """Point JAX's compile cache at ``$JAX_COMPILATION_CACHE_DIR`` (left to
    JAX) or else at ``<checkout>/.jax_cache``. Returns the directory used."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_DIR)
    return CHECKOUT_DIR
