"""Run-snapshot source backup.

Counterpart of the JAX package's utils/snapshot.py (the reference's
train-time ``cp -r models configs ... lib``, Diff-Reg-3dmatch/main.py:66-74):
a training run archives the package, the repository's ``configs/`` and the
YAML it ran with next to its checkpoints.
"""
from __future__ import annotations

import os
import shutil

_IGNORE = shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "build")


def backup_sources(save_dir: str, config_path: str | None = None) -> str:
    """Copy the package source and configs (and the run's YAML) under
    ``save_dir/source_backup``; returns that directory. An existing backup (a
    resumed run) is left as it is: the code that started the run is kept."""
    dst = os.path.join(save_dir, "source_backup")
    if os.path.isdir(dst):
        return dst
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    configs_dir = os.path.join(os.path.dirname(pkg_dir), "configs")
    os.makedirs(dst)
    shutil.copytree(pkg_dir, os.path.join(dst, os.path.basename(pkg_dir)), ignore=_IGNORE)
    if os.path.isdir(configs_dir):
        shutil.copytree(configs_dir, os.path.join(dst, "configs"), ignore=_IGNORE)
    if config_path and os.path.isfile(config_path):
        shutil.copy2(config_path, dst)
    return dst
