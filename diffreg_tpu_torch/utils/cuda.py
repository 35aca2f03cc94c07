"""Build and load the hand-written Hopper kernels in ``diffreg_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>.so`` at first use, then loaded with
ctypes; a library is stale when its source or a shared ``csrc/*.cuh`` header
is newer. ``build_kernels`` starts one ``nvcc`` per stale source, all at once,
and waits for all of them; it returns the seconds and the compiler's
``-Xptxas -v`` report (registers, shared memory, spills) of each.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading
import time
from typing import Dict

from .build import BUILD_DIR, PACKAGE_DIR, PendingBuild, is_stale

CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def _sources() -> Dict[str, str]:
    return {os.path.splitext(os.path.basename(p))[0]: p
            for p in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))}


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def build_kernels(timeout: float = 600.0) -> Dict[str, dict]:
    """Compile every stale kernel library in parallel; return per-kernel
    ``{"seconds": s, "log": ptxas report}`` (an empty dict when all are fresh)."""
    with _LOCK:
        pending = {}
        t0 = time.perf_counter()
        headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        for name, src in _sources().items():
            if is_stale(_lib_path(name), [src, *headers]):
                pending[name] = PendingBuild([_nvcc(), *NVCC_FLAGS, src], _lib_path(name))
        report = {}
        errors = []
        for name, build in pending.items():
            try:
                log = build.wait(timeout)
            except RuntimeError as e:
                errors.append(str(e))
                continue
            report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if errors:
            raise RuntimeError("\n".join(errors))
        return report


def kernel_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if it is missing or stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_kernels()
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(_lib_path(name))
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: {lib.error_string(err).decode()} (CUDA error {err})")


def launch(lib: ctypes.CDLL, entry: str, device, *args) -> None:
    """Call the C entry point ``entry`` of ``lib`` with ``args`` and the current
    stream of ``device``, with ``device`` the current CUDA device for the call:
    an entry's ``cudaFuncSetAttribute``, its SM count and its launch act on the
    current device, which is another card's when the tensors' is not current.
    Raises if the entry returned a CUDA error."""
    import torch

    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, entry)
