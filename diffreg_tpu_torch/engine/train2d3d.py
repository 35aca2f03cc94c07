"""2D-3D training step: the circle, focal and fine losses over DiffReg2D3D.

Counterpart of the JAX package's engine/train2d3d.py (the reference 2D-3D
experiment's trainval.py with OverallLoss): the train state and optimizer of
``engine.train`` (the CLI uses Adam), the loss of ``engine.losses2d3d``. The
draws of a step (t, noise) come from ``DiffReg2D3D.draw_train_inputs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .losses import LossConfig
from .losses2d3d import CircleLossConfig, FineLossConfig, loss_2d3d
from .train import OptimConfig, TrainState, create_train_state, make_loss_train_step


def create_train_state_2d3d(model, optim_cfg: OptimConfig) -> TrainState:
    """A train state over every parameter of the model. As in the JAX
    package's 2D-3D step, a non-finite gradient does not skip the step: its
    NaN entries are zeroed and the update is applied, whatever
    ``optim_cfg.skip_nonfinite_updates`` says."""
    return create_train_state(model, dataclasses.replace(optim_cfg,
                                                         skip_nonfinite_updates=False))


def make_train_step_2d3d(circle_cfg: CircleLossConfig, focal_cfg: LossConfig,
                         fine_cfg: Optional[FineLossConfig] = None):
    """``train_step(state, batch, inputs, timers=None) -> (state, info)``: info
    holds circle, focal (logged only), gt_hat, with ``fine_cfg`` and the
    batch's fine GT fine and fine_recall, loss, grads_finite and grad_norm."""
    return make_loss_train_step(lambda outputs, batch: loss_2d3d(
        outputs, circle_cfg, focal_cfg, batch=batch, fine_cfg=fine_cfg))
