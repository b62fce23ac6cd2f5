"""A module-scoped fixture for the port's memory-heavy test files: after the
module (its own module fixtures are released first), drop JAX's compiled
programs and hand the heap the module freed back to the system. A test
worker goes on to other files and otherwise keeps that heap (many GB after
tests/test_torch_train_step.py), and the whole suite, run with several
workers, comes close to the memory of the machine it runs on. Later files
recompile their JAX programs, from the on-disk cache where it has them.

    from torch_memory import release_memory_after_module  # noqa: F401
"""
import ctypes
import gc

import jax
import pytest


@pytest.fixture(scope="module", autouse=True)
def release_memory_after_module():
    yield
    jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except OSError:         # not glibc: nothing to trim
        pass
