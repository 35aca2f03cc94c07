"""Make the JAX package's native library whole before a port test compares against it.

The JAX package's ``data/native.py`` runs ``native/build.sh`` when
``native/libdiffreg_native.so`` is missing; the script has g++ write that path
in place, so a test worker whose loader meets the half-written file remembers
the failure and falls back to the numpy/scipy twins for good. Those twins
return the same voxels in another row order, and the port (which has no
fallback) then meets a differently ordered JAX pyramid.

Importing this module, which every ``tests/test_torch_*.py`` that builds data
through the JAX package does at its top, and so every pytest-xdist worker at
collection: under an ``fcntl`` lock in the port's build directory, compiles
the library as ``native/build.sh`` does to a temporary name and renames it into
place if it is missing, then asserts that the JAX package loaded it, so a
worker left on the twins fails loudly instead of comparing against another
pyramid.

A worker may have met the half-written file before this module is imported:
``tests/test_native.py`` asks for the library at module level, and pytest
collects it first. So a failed load that the JAX loader has cached is
forgotten (its ``_TRIED``/``_LIB`` state reset, no file of the package
changed) and the load tried again; a file that still does not load is
waited for once (another worker's in-place build may be finishing) and then
built anew and renamed into place.
"""
from __future__ import annotations

import fcntl
import os
import subprocess
import time

REPO_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(REPO_DIR, "native")
LIBRARY = os.path.join(NATIVE_DIR, "libdiffreg_native.so")
LOCK_PATH = os.path.join(REPO_DIR, "diffreg_tpu_torch", "build", "native_guard.lock")
SOURCES = [os.path.join(NATIVE_DIR, "src", "diffreg_native.cpp"),
           os.path.join(NATIVE_DIR, "src", "diffreg_graph.cpp")]
ATTEMPTS = 4


def build_library() -> None:
    """Compile as native/build.sh does, to a temporary name, and rename it into place."""
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    # the flags of native/build.sh
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                    "-fPIC", *SOURCES, "-o", tmp],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, LIBRARY)


def jax_loads_library() -> bool:
    """Whether the JAX package's loader holds the library, asked afresh: a
    cached failure is forgotten first. The file must exist (a missing one
    would start the package's in-place build)."""
    from diffreg_tpu.data import native

    if native._LIB is None:
        native._TRIED = False
    try:
        return native.native_available()
    except AttributeError:  # a file cut short before its symbols
        native._TRIED, native._LIB = False, None
        return False


def ensure_native_library() -> None:
    os.makedirs(os.path.dirname(LOCK_PATH), exist_ok=True)
    with open(LOCK_PATH, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for attempt in range(ATTEMPTS):
                if not os.path.exists(LIBRARY):
                    build_library()
                if jax_loads_library():
                    break
                time.sleep(1.0)
                if jax_loads_library():
                    break
                build_library()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    from diffreg_tpu.data.native import native_available

    assert native_available(), (
        f"the JAX package could not load {LIBRARY}: it would compare the port "
        "against its numpy twins, whose pyramids are ordered differently")


ensure_native_library()
