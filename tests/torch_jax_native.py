"""The JAX package's native host Adam for the port's tests that compare
with it (``tests/test_torch_cpu_adam.py``, ``tests/test_torch_offload*.py``,
``tests/test_torch_zero3_offload.py``, ...), built once per build cache
whatever the order in which test workers reach it (not collected by
pytest: no ``test_`` prefix).

The JAX module builds its library through ``ops/op_builder.OpBuilder.
jit_load``, which compiles every build to the same ``<so>.tmp`` in the
build cache and then renames it. Workers that start on an empty cache
build at once; a worker whose build or rename loses the race marks its
library failed (``cpu_adam._LIB_FAILED``) for the rest of its process and
runs the numpy path, and the port's bit-for-bit comparisons with the
native library then fail. ``jax_native_lib`` takes an exclusive
``flock`` on a lock file in the build cache, clears the module's failed
mark and builds or loads the library under the lock, so a worker either
builds alone or finds the finished library. Nothing in the JAX package
changes.

    python tests/torch_jax_native.py    # prints NATIVE_OK, or exits 1
"""
import fcntl
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

LOCK_NAME = "cpu_adam.build.lock"


def jax_native_lib(tries: int = 3):
    """The JAX ``cpu_adam`` module's native library (a ``ctypes.CDLL``),
    built or loaded under the build cache's lock; raises when it cannot
    be had. A test whose claim needs the native library calls this
    before it builds a JAX host optimizer."""
    from deepspeed_tpu.ops import cpu_adam as jca
    from deepspeed_tpu.ops import op_builder as job
    lock = os.path.join(job._cache_dir(), LOCK_NAME)
    with open(lock, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for _ in range(tries):
                # (a module global: a failure before this call, in this
                # process, would otherwise stick)
                jca._LIB_FAILED = False
                lib = jca._native_lib()
                if lib is not None:
                    return lib
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    raise RuntimeError("the JAX cpu_adam library did not build or load "
                       f"from {job._cache_dir()}")


@pytest.fixture(scope="module", autouse=True)
def jax_native():
    """Autouse in every module that imports it: the JAX host Adam is
    native before the module's first JAX host optimizer is built."""
    return jax_native_lib()


if __name__ == "__main__":
    from deepspeed_tpu.ops import cpu_adam as _jca
    jax_native_lib()
    opt = _jca.DeepSpeedCPUAdam({"w": __import__("numpy").zeros(
        4, "float32")})
    print("NATIVE_OK" if opt.native else "NATIVE_MISSING", flush=True)
    sys.exit(0 if opt.native else 1)
