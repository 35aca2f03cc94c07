"""Checkpoint manager — keep-last-N ``torch.save`` files with best-metric tracking.

Counterpart of the JAX package's engine/checkpoint.py (orbax there). A
checkpoint is one file ``<dir>/<step>.pt`` holding a ``TrainState``'s
state_dict: the model's parameters and buffers, the optimizer state and the
step. ``best.json`` beside it records, per metric, the best value and its
step: higher is better, except for metrics whose name contains "loss".
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._meta_path = os.path.join(self.directory, "best.json")
        self._best = {}
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._best = json.load(f)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m[1]) for name in os.listdir(self.directory)
                      if (m := re.fullmatch(r"(\d+)\.pt", name)))

    def save(self, step: int, state: Any, metrics: Optional[dict] = None):
        """Save ``state.state_dict()`` as ``step``, drop all but the newest
        ``max_to_keep`` files, and update the best value of each metric."""
        tmp = self._path(step) + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        if metrics:
            for name, value in metrics.items():
                value = float(value)
                higher_better = "loss" not in name.lower()
                cur = self._best.get(name)
                if cur is None or (value > cur["value"] if higher_better
                                   else value < cur["value"]):
                    self._best[name] = {"value": value, "step": int(step)}
            with open(self._meta_path, "w") as f:
                json.dump(self._best, f, indent=2)

    def restore(self, state: Any, step: Optional[int] = None):
        """Load checkpoint ``step`` (default the latest) into ``state`` and
        return it; None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        device = next(state.model.parameters()).device
        state.load_state_dict(torch.load(self._path(step), map_location=device,
                                         weights_only=True))
        return state

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def best_step(self, metric: str) -> Optional[int]:
        entry = self._best.get(metric)
        return None if entry is None else entry["step"]
