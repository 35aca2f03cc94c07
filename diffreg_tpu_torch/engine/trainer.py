"""Epoch-based and iteration-based trainers.

Counterpart of the JAX package's engine/trainer.py (the reference
lib/trainer.py:16-290 and vision3d's epoch/iteration-based trainers): the
epoch loop, a summary board of per-step metrics, periodic logging, a
checkpoint per epoch with best-metric tracking, ``resume`` and ``validate``.
The step is ``engine.train.make_train_step``'s; the JAX package's random key
becomes a ``torch.Generator`` on the trainer's device, from which each step's
``model.draw_train_inputs`` are drawn. Batches are moved to that device.
``BatchTester`` is the batched test loop (vision3d's) that ``engine.tester``'s
testers are built on.

In a process group (``parallel``) the Trainer runs the data-parallel step
(``parallel.mesh``) in every process: process 0's parameters are broadcast at
the start and after ``resume``, each process draws from a generator seeded
from (seed, rank), every process takes the same number of steps an epoch
(``parallel.distributed.lockstep``), and process 0 alone writes the
checkpoints and the logger's files, the others waiting at a barrier.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import torch

from ..parallel.distributed import barrier, is_master, lockstep, process_index
from ..parallel.mesh import broadcast_state
from ..utils.device import resolve_device
from ..utils.logging import Logger, SummaryBoard, Timers
from .checkpoint import CheckpointManager
from .train import TrainState


@dataclasses.dataclass
class TrainerConfig:
    max_epoch: int = 100
    log_every: int = 100
    save_dir: str = "snapshot/run"
    keep_checkpoints: int = 5


def rank_seed(seed: int, rank: int) -> int:
    """The train draws' seed of process ``rank``: ``seed`` itself on process 0
    (one process draws as before), another stream on every other."""
    return seed + (rank << 32)


def _scalars(info: dict) -> dict:
    """The 0-d entries of a step's info as Python floats (one device readback)."""
    return {k: float(v) for k, v in info.items() if getattr(v, "ndim", 1) == 0}


class Trainer:
    """Runs ``train_step(state, batch, inputs, timers)`` over
    ``make_train_iter(epoch)``'s (batch, meta) pairs on ``device`` (default
    "cuda"; raises when CUDA is missing). ``seed`` seeds the generator of the
    training draws (``rank_seed`` in a process group)."""

    def __init__(self, train_step: Callable, state: TrainState,
                 make_train_iter: Callable[[int], Iterable], cfg: TrainerConfig, *,
                 make_val_iter: Optional[Callable[[int], Iterable]] = None,
                 val_step: Optional[Callable] = None, logger: Optional[Logger] = None,
                 device=None, seed: int = 0):
        self.device = resolve_device(device)
        self.train_step = train_step
        self.state = state
        self.make_train_iter = make_train_iter
        self.make_val_iter = make_val_iter
        self.val_step = val_step
        self.cfg = cfg
        self.logger = logger or (Logger(cfg.save_dir) if is_master()
                                 else Logger(None, echo=False))
        self.ckpt = CheckpointManager(f"{cfg.save_dir}/checkpoints", cfg.keep_checkpoints)
        self.generator = torch.Generator(self.device).manual_seed(
            rank_seed(seed, process_index()))
        self.timers = Timers()
        self.start_epoch = 0
        self.metrics = {}           # the last epoch's summary
        broadcast_state(state)

    def resume(self):
        if self.ckpt.restore(self.state) is not None:
            self.start_epoch = int(self.ckpt.latest_step())
            broadcast_state(self.state)
            self.logger.info(f"resumed from epoch {self.start_epoch}")

    def _step(self, batch):
        batch = batch.to(self.device)
        inputs = self.state.model.draw_train_inputs(batch, self.generator)
        self.state, info = self.train_step(self.state, batch, inputs, self.timers)
        return _scalars(info)

    def _end_epoch(self, epoch: int, step_count: int, board: SummaryBoard) -> dict:
        metrics = board.summary()
        if self.make_val_iter is not None and self.val_step is not None:
            val = self.validate(epoch)
            metrics.update({f"val_{k}": v for k, v in val.items()})
            self.logger.metrics(step_count, val, prefix="val/")
        if is_master():
            self.ckpt.save(epoch + 1, self.state, metrics)
        barrier()       # no process reads a checkpoint before it is written
        self.metrics = metrics
        return metrics

    def train(self):
        step_count = 0
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            board = SummaryBoard()
            for batch, _meta in lockstep(self.make_train_iter(epoch)):
                board.update(self._step(batch))
                step_count += 1
                if step_count % self.cfg.log_every == 0:
                    self.logger.info(f"epoch {epoch} step {step_count}: "
                                     f"{board.format(['loss', 'recall_coarse'])}")
                    self.logger.metrics(step_count, board.summary(), prefix="train/")
            metrics = self._end_epoch(epoch, step_count, board)
            self.logger.info(
                f"epoch {epoch} done: {', '.join(f'{k}={v:.4f}' for k, v in metrics.items())}")
        return self.state

    def validate(self, epoch: int):
        board = SummaryBoard()
        for batch, _meta in self.make_val_iter(epoch):
            batch = batch.to(self.device)
            inputs = self.state.model.draw_train_inputs(batch, self.generator)
            board.update(_scalars(self.val_step(self.state, batch, inputs)))
        return board.summary()


class CycleIterator:
    """Endless iterator over a restartable loader (vision3d CycleLoader): an
    exhausted epoch iterator is rebuilt with the next epoch index."""

    def __init__(self, make_iter: Callable[[int], Iterable], epoch: int = 0):
        self.make_iter = make_iter
        self.epoch = epoch
        self._it = iter(make_iter(epoch))

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self.epoch += 1
            self._it = iter(self.make_iter(self.epoch))
            return next(self._it)


class IterBasedTrainer(Trainer):
    """Iteration-based trainer (vision3d iter_based_trainer.py:41-128): each
    pseudo-epoch is ``num_iters_per_epoch`` batches pulled from a cycling
    loader; checkpoints and validation run per pseudo-epoch."""

    def __init__(self, *args, num_iters_per_epoch: int = 1000, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_iters_per_epoch = num_iters_per_epoch

    def train(self):
        loader = CycleIterator(self.make_train_iter, self.start_epoch)
        step_count = self.start_epoch * self.num_iters_per_epoch
        for epoch in range(self.start_epoch, self.cfg.max_epoch):
            board = SummaryBoard()
            for _ in range(self.num_iters_per_epoch):
                batch, _meta = next(loader)
                board.update(self._step(batch))
                step_count += 1
                if step_count % self.cfg.log_every == 0:
                    self.logger.info(f"iter-epoch {epoch} step {step_count}: "
                                     f"{board.format(['loss'])}")
                    self.logger.metrics(step_count, board.summary(), prefix="train/")
            self._end_epoch(epoch, step_count, board)
        return self.state


class BatchTester:
    """Batched test loop with per-sample evaluation (vision3d/engine/
    batch_tester.py:16-70): ``forward(batch, generator)`` once per batch, then
    ``eval_sample(i, batch, out, meta_i)`` -> {name: value} per sample,
    averaged on a summary board (a name that a sample leaves out is averaged
    over the samples that give it). Pass both as callables, or subclass and
    override the methods (``engine.tester``'s testers do). Batches are moved
    to ``device`` (default "cuda"; raises when CUDA is missing); the draws come
    from the ``generator`` given to ``test`` (default: seed 0 on that device)."""

    def __init__(self, forward: Optional[Callable] = None,
                 eval_sample: Optional[Callable] = None,
                 batch_size_of: Optional[Callable] = None, logger: Optional[Logger] = None,
                 device=None):
        self.device = resolve_device(device)
        if forward is not None:
            self.forward = forward
        if eval_sample is not None:
            self.eval_sample = eval_sample
        self.batch_size_of = batch_size_of or (lambda b: b.batch_size)
        self.logger = logger or Logger(None)

    def forward(self, batch, generator: torch.Generator):
        raise NotImplementedError

    def eval_sample(self, i: int, batch, out, meta) -> dict:
        raise NotImplementedError

    def test(self, make_iter: Callable[[], Iterable],
             generator: Optional[torch.Generator] = None) -> dict:
        """The averaged rows and ``samples``, the number of samples."""
        generator = generator or torch.Generator(self.device).manual_seed(0)
        board = SummaryBoard()
        n = 0
        for batch, meta in make_iter():
            batch = batch.to(self.device)
            out = self.forward(batch, generator)
            for i in range(self.batch_size_of(batch)):
                row = self.eval_sample(i, batch, out, meta[i] if meta is not None else None)
                board.update({k: float(v) for k, v in row.items()})
                n += 1
        summary = board.summary()
        summary["samples"] = n
        return summary
