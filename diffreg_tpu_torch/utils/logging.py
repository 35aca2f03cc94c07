"""Meters, boards, timers, logger — the observability layer of training.

Counterpart of the JAX package's utils/logging.py: the reference's Lepard
``Timers`` (lib/tictok.py), AverageMeter and text Logger (lib/utils.py:13-26),
and vision3d's ``SummaryBoard`` of AverageMeters with a TensorBoard event
writer (used only when ``tensorboardX`` imports).
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0
        self.last = 0.0

    def update(self, value, n: int = 1):
        value = float(value)
        self.last = value
        self.sum += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class SummaryBoard:
    """Named AverageMeters with a one-line summary formatter."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, metrics: Dict[str, float], n: int = 1):
        for k, v in metrics.items():
            try:
                self.meters[k].update(float(v), n)
            except (TypeError, ValueError):
                pass

    def summary(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        self.meters.clear()

    def format(self, keys=None) -> str:
        keys = keys or sorted(self.meters)
        return ", ".join(f"{k}: {self.meters[k].avg:.4f}" for k in keys if k in self.meters)


class Timers:
    """Keyed tic/toc timers (lib/tictok.py equivalent).

    Host clock: around device work, the caller synchronizes the device before
    each ``toc`` (``torch.cuda.synchronize``), or the enqueue is what it times.
    """

    def __init__(self):
        self._start: Dict[str, float] = {}
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def tic(self, key: str):
        self._start[key] = time.perf_counter()

    def toc(self, key: str):
        if key in self._start:
            self.meters[key].update(time.perf_counter() - self._start.pop(key))

    def summary(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}


class Logger:
    """Text + JSONL + optional TensorBoard logger. ``echo`` False keeps the
    text off standard output (a data-parallel run's other processes)."""

    def __init__(self, log_dir: Optional[str] = None, use_tensorboard: bool = True,
                 echo: bool = True):
        self.log_dir = log_dir
        self.echo = echo
        self._tb = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "log.jsonl"), "a")
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(log_dir)
                except Exception:
                    self._tb = None

    def info(self, msg: str):
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        line = f"[{stamp}] {msg}"
        if self.echo:
            print(line, flush=True)
        if self.log_dir:
            with open(os.path.join(self.log_dir, "log.txt"), "a") as f:
                f.write(line + "\n")

    def warning(self, msg: str):
        self.info(f"WARNING: {msg}")

    def metrics(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        clean = {}
        for k, v in metrics.items():
            try:
                clean[k] = float(v)
            except (TypeError, ValueError):
                continue
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, "prefix": prefix, **clean}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in clean.items():
                self._tb.add_scalar(f"{prefix}{k}", v, step)

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
