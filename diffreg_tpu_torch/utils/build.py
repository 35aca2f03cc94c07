"""Compile C++/CUDA sources of the repository into shared libraries at first use.

Outputs go to ``diffreg_tpu_torch/build/`` (listed in ``.gitignore``). A
library is rebuilt when it is missing or older than one of its sources. Each
compile writes to a file named after the process and is renamed into place,
so concurrent test workers never load a half-written library.
"""
from __future__ import annotations

import os
import subprocess
from typing import List, Sequence

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
REPO_DIR = os.path.dirname(PACKAGE_DIR)


def is_stale(out: str, sources: Sequence[str]) -> bool:
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(s) > built for s in sources)


class PendingBuild:
    """One compiler process writing ``out``; ``wait`` renames it into place."""

    def __init__(self, argv: List[str], out: str):
        os.makedirs(BUILD_DIR, exist_ok=True)
        self.out = out
        self.tmp = f"{out}.{os.getpid()}.tmp"
        self.argv = argv + ["-o", self.tmp]
        self.proc = subprocess.Popen(self.argv, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True)

    def wait(self, timeout: float) -> str:
        """Wait for the compiler; return its diagnostics or raise on failure."""
        try:
            stdout, stderr = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise RuntimeError(f"build of {self.out} exceeded {timeout:.0f} s")
        if self.proc.returncode != 0:
            if os.path.exists(self.tmp):
                os.remove(self.tmp)
            raise RuntimeError(
                f"build of {self.out} failed (rc={self.proc.returncode}):\n"
                f"{' '.join(self.argv)}\n{stdout}{stderr}")
        os.replace(self.tmp, self.out)
        return stdout + stderr
