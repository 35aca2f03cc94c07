"""Data-parallel train and eval steps: one process per device, the gradient
all-reduced by hand.

Counterpart of the JAX package's parallel/mesh.py. There one jit over a
``data`` mesh shards the global batch, replicates the parameters and lets XLA
insert the gradient all-reduce. Here every process holds the parameters, runs
``train_forward`` on its shard of the global batch and differentiates its loss
with ``torch.autograd.grad``; then

  * the loss's batch-wide counts and sums are all-reduced inside the loss
    (``GlobalBatch``), so its value is the global batch's in every process
    and each process's gradient is its share of the global batch's gradient
    (the focal terms' positive and negative counts and has_pos, the recall
    and precision counts, the motion loss's overlap count, the 2D-3D pair
    means: JAX's jit takes all of them over the sharded batch);
  * ``all_reduce_gradients`` sums the shares over the processes: the
    gradients (zeros for a parameter the loss does not reach) flattened into
    float32 buckets, one all-reduce a bucket;
  * the update (``engine.train.apply_gradients``: NaN zeroing, the global-norm
    clip, the non-finite skip, MultiSteps) sees the same gradient in every
    process, so every process makes the same update.

The model is not wrapped in ``DistributedDataParallel``: its reducer is armed
by the wrapper's ``forward`` and fires on ``.backward()`` into ``.grad``,
while the step calls ``model.train_forward`` and ``torch.autograd.grad``.
``broadcast_state`` copies process 0's parameters and buffers to the others.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..engine.losses import BatchReduction, LossConfig, diffreg_loss
from ..engine.train import make_loss_train_step
from .distributed import (all_gather_rows, all_reduce, all_reduce_, broadcast_, process_count,
                          process_index)

BUCKET_BYTES = 256 * 2**20      # gradient bytes an all-reduce carries at most


class GlobalBatch(BatchReduction):
    """The global batch: a batch-wide sum is all-reduced over the processes.
    Its value is the global total; its gradient flows to this process's part
    alone, so that the processes' gradients add up to the global one."""

    def sum(self, x):
        total = all_reduce(x)
        if not x.requires_grad:
            return total
        return total + (x - x.detach())

    def mean(self, x):
        return self.sum(x.sum()) / self.sum(x.new_tensor(float(x.numel())))


def _buckets(tensors, cap_bytes):
    """Runs of consecutive tensor indices of one dtype and at most
    ``cap_bytes`` (a larger tensor is a run of its own)."""
    bucket, size = [], 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != tensors[bucket[0]].dtype or size + nbytes > cap_bytes):
            yield bucket
            bucket, size = [], 0
        bucket.append(i)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def all_reduce_gradients(grads, params):
    """The sum over the processes of each process's gradients (None: zeros of
    the parameter's shape, so that every process reduces the same list),
    through flat buckets (``_buckets``)."""
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, params)]
    out = list(grads)
    for bucket in _buckets(grads, BUCKET_BYTES):
        flat = all_reduce_(torch.cat([grads[i].reshape(-1) for i in bucket]))
        for i, part in zip(bucket, flat.split([grads[i].numel() for i in bucket])):
            out[i] = part.view_as(grads[i])
    return out


def gradient_bytes(params) -> int:
    """Bytes ``all_reduce_gradients`` carries for ``params``."""
    return sum(p.numel() * p.element_size() for p in params)


@torch.no_grad()
def broadcast_state(state) -> None:
    """Overwrite every process's model parameters and buffers with process 0's."""
    if process_count() > 1:
        for t in state.model.state_dict().values():
            broadcast_(t)


def make_parallel_train_step(loss_cfg: LossConfig):
    """The data-parallel 3D train step (``engine.train.make_train_step``'s
    signature and info): this process's shard of the batch and its draws in,
    the global batch's loss and gradient out (JAX: mesh.py:56-72)."""
    reduce = GlobalBatch()
    return make_loss_train_step(
        lambda outputs, batch: diffreg_loss(outputs, batch, loss_cfg, reduce),
        reduce_gradients=all_reduce_gradients)


def make_parallel_train_step_2d3d(circle_cfg, focal_cfg: LossConfig, fine_cfg=None):
    """The data-parallel 2D-3D train step (``engine.train2d3d``'s), as
    ``make_parallel_train_step`` (JAX: mesh.py:75-98)."""
    from ..engine.losses2d3d import loss_2d3d

    reduce = GlobalBatch()
    return make_loss_train_step(
        lambda outputs, batch: loss_2d3d(outputs, circle_cfg, focal_cfg, batch=batch,
                                         fine_cfg=fine_cfg, reduce=reduce),
        reduce_gradients=all_reduce_gradients)


def shard_rows(batch_size: int, rank: Optional[int] = None,
               world: Optional[int] = None) -> slice:
    """The rows of a batch of ``batch_size`` that process ``rank`` of
    ``world`` takes (contiguous, in process order; the world divides the
    batch)."""
    rank = process_index() if rank is None else rank
    world = process_count() if world is None else world
    if batch_size % world:
        raise ValueError(f"a batch of {batch_size} does not split over {world} processes")
    per = batch_size // world
    return slice(rank * per, (rank + 1) * per)


def _take(x, axis: int, rows: slice):
    return None if x is None else x[(slice(None),) * axis + (rows,)]


def _gather(x, axis: int, per: int):
    """Every process's rows of ``x`` in process order: tensors along
    ``axis`` (which must hold ``per`` rows), tuples, named tuples, lists and
    dicts entry by entry (along axis 0), anything else as it is."""
    if isinstance(x, torch.Tensor):
        if x.dim() <= axis or x.shape[axis] != per:
            raise ValueError(f"an output of shape {tuple(x.shape)} has no batch axis {axis} "
                             f"of {per} rows")
        return all_gather_rows(x, axis)
    if isinstance(x, dict):
        return {k: _gather(v, 0, per) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_gather(v, 0, per) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_gather(v, 0, per) for v in x)
    return x


# the batch axis of a draw or an output entry where it is not 0
DRAW_AXES = {"ddim_noise": 1}            # [steps, B, S, T]
OUT_AXES = {"step_condition": 1}         # [steps, B]


def make_parallel_eval_step(model, mode: str = "ddim"):
    """``eval_step(batch, **draws) -> model(batch, mode=mode, **draws)`` over
    the processes (JAX: mesh.py:101-109): where the world divides the batch,
    each process runs its rows (``shard_rows``) with its rows of the draws,
    which every process made for the whole batch from the same-seeded
    generator, and the outputs are all-gathered in row order, so every process
    holds the whole batch's. Otherwise, and in one process, each runs the
    whole batch."""

    def eval_step(batch, **draws):
        world, b = process_count(), batch.batch_size
        if world == 1 or b % world:
            return model(batch, mode=mode, **draws)
        rows = shard_rows(b)
        out = model(batch.select(rows), mode=mode,
                    **{k: _take(v, DRAW_AXES.get(k, 0), rows) for k, v in draws.items()})
        return {k: _gather(v, OUT_AXES.get(k, 0), b // world) for k, v in out.items()}

    return eval_step
