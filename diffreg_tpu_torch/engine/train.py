"""Training engine: learning-rate schedules, the optimizer, the train step.

Counterpart of the JAX package's engine/train.py, whose optimizer is an optax
chain. The port writes that chain as plain tensor code, in optax's order and
with its formulas, and updates the parameters in place:

  * ``zero_nans`` (NaN gradients -> 0);
  * ``clip_by_global_norm`` when ``max_grad_norm > 0``: with the global norm
    n, gradients are kept when n < max_norm and become (g / n) * max_norm
    otherwise (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
  * SGD: ``add_decayed_weights`` then momentum (trace: b = g + m b) and the
    step -lr(count) b; or AdamW (bias-corrected moments, eps 1e-8 outside the
    square root, then + wd p, then -lr(count));
  * ``MultiSteps`` when ``grad_accum_steps > 1``: the running mean of k
    gradients, one update every k-th call;
  * the reference's ``validate_gradient``: a non-finite gradient skips the
    whole step, optimizer state included (lib/trainer.py:196-200).

``count`` is the number of applied updates, as optax's schedules count them:
``exponential`` is optax's ``exponential_decay(staircase=True)``, the
``warmup_*`` schedules shift it by one (vision3d's LambdaLR convention).
Schedules evaluate in float32, as JAX does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .losses import LossConfig, diffreg_loss

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    optimizer: str = "sgd"          # sgd | adam (AdamW)
    lr: float = 0.015
    momentum: float = 0.93
    weight_decay: float = 1e-6
    scheduler_gamma: float = 0.95   # ExpLR decay per epoch
    steps_per_epoch: int = 1000     # updates per epoch: the ExpLR staircase width
    grad_accum_steps: int = 1       # iter_size
    max_grad_norm: float = 0.0      # 0 = off
    skip_nonfinite_updates: bool = True
    scheduler: str = "exponential"  # exponential | warmup_exponential |
    #                                 warmup_cosine | warmup_linear
    warmup_steps: int = 0
    total_steps: int = 100000       # warmup_cosine / warmup_linear horizon
    eta_init: float = 0.1           # warmup start multiplier
    eta_min: float = 0.1            # decay floor multiplier


def exponential_decay(init_value: float, transition_steps: int, decay_rate: float):
    """optax.exponential_decay(staircase=True): init * rate ** floor(count / steps)."""
    def schedule(count: int) -> float:
        p = np.floor(F32(count) / F32(transition_steps))
        return float(F32(init_value) * np.power(F32(decay_rate), p, dtype=F32))
    return schedule


def warmup_annealing_schedule(kind: str, base_lr: float, warmup_steps: int,
                              total_steps: int = 0, gamma: float = 0.95,
                              step_size: int = 1000, eta_init: float = 0.1,
                              eta_min: float = 0.1):
    """vision3d WarmUp{Exponential,Cosine,Linear}AnnealingFunction
    (optimizer.py:13-74): linear warmup from eta_init * lr, then the chosen
    annealing with an eta_min * lr floor, at step = count + 1."""
    def schedule(count: int) -> float:
        # the JAX package's expressions, with Python floats folded first as JAX does
        step = F32(count) + F32(1.0)
        warm = F32(1.0 - eta_init) / F32(max(warmup_steps, 1)) * step + F32(eta_init)
        decay_step = step - F32(warmup_steps)
        if kind == "warmup_exponential":
            mult = max(np.power(F32(gamma), np.floor((decay_step + F32(1.0)) / F32(step_size)),
                                dtype=F32), F32(eta_min))
        elif kind in ("warmup_cosine", "warmup_linear"):
            frac = decay_step / F32(max(total_steps - warmup_steps, 1))
            if kind == "warmup_cosine":
                mult = F32(0.5 * (1.0 - eta_min)) * (F32(1.0) + np.cos(F32(np.pi) * frac,
                                                                       dtype=F32)) + F32(eta_min)
            else:
                mult = F32(1.0 - eta_min) * (F32(1.0) - frac) + F32(eta_min)
            if step > total_steps:
                mult = F32(eta_min)
        else:
            raise ValueError(kind)
        return float(F32(base_lr) * (warm if step < warmup_steps else mult))
    return schedule


def make_schedule(cfg: OptimConfig):
    if cfg.scheduler == "exponential":
        return exponential_decay(cfg.lr, cfg.steps_per_epoch, cfg.scheduler_gamma)
    return warmup_annealing_schedule(cfg.scheduler, cfg.lr, cfg.warmup_steps, cfg.total_steps,
                                     gamma=cfg.scheduler_gamma, step_size=cfg.steps_per_epoch,
                                     eta_init=cfg.eta_init, eta_min=cfg.eta_min)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


class Optimizer:
    """The JAX package's optax chain over named parameters (see the module
    docstring). ``update(grads)`` takes one gradient per parameter and updates
    the parameters in place; the skip on a non-finite gradient is the train
    step's (it does not call ``update``)."""

    B1, B2, EPS = 0.9, 0.999, 1e-8      # optax.adamw defaults

    def __init__(self, named_params: List[Tuple[str, nn.Parameter]], cfg: OptimConfig):
        if cfg.optimizer not in ("sgd", "adam"):
            raise ValueError(cfg.optimizer)
        self.cfg = cfg
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.schedule = make_schedule(cfg)
        self.count = 0          # applied updates
        self.mini_step = 0      # gradients accumulated towards the next update
        kinds = ("momentum",) if cfg.optimizer == "sgd" else ("mu", "nu")
        if cfg.grad_accum_steps > 1:
            kinds += ("acc",)
        self.buffers: Dict[str, Dict[str, torch.Tensor]] = {
            kind: {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for n, p in named_params} for kind in kinds}

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        """Accumulate one step of gradients, or apply them (every
        ``grad_accum_steps``-th call)."""
        cfg = self.cfg
        k = cfg.grad_accum_steps
        if k > 1:
            acc = self.buffers["acc"]
            for n, g in zip(self.names, grads):
                acc[n].add_((g - acc[n]) / (self.mini_step + 1))
            if self.mini_step < k - 1:
                self.mini_step += 1
                return
            grads = [acc[n].clone() for n in self.names]
            for n in self.names:
                acc[n].zero_()
            self.mini_step = 0
        grads = [torch.where(torch.isnan(g), torch.zeros_like(g), g) for g in grads]
        if cfg.max_grad_norm > 0:
            norm = global_norm(grads)
            keep = norm < cfg.max_grad_norm
            grads = [torch.where(keep, g, (g / norm) * cfg.max_grad_norm) for g in grads]
        step = -self.schedule(self.count)
        if cfg.optimizer == "sgd":
            for n, p, g in zip(self.names, self.params, grads):
                if cfg.weight_decay > 0:
                    g = g + cfg.weight_decay * p
                buf = self.buffers["momentum"][n]
                buf.copy_(g + cfg.momentum * buf)
                p.add_(step * buf)
        else:
            c = self.count + 1
            corr1 = float(F32(1.0) - np.power(F32(self.B1), F32(c), dtype=F32))
            corr2 = float(F32(1.0) - np.power(F32(self.B2), F32(c), dtype=F32))
            for n, p, g in zip(self.names, self.params, grads):
                mu, nu = self.buffers["mu"][n], self.buffers["nu"][n]
                mu.copy_((1 - self.B1) * g + self.B1 * mu)
                nu.copy_((1 - self.B2) * (g * g) + self.B2 * nu)
                u = (mu / corr1) / (torch.sqrt(nu / corr2) + self.EPS)
                p.add_(step * (u + cfg.weight_decay * p))
        self.count += 1

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "buffers": {kind: dict(bufs) for kind, bufs in self.buffers.items()}}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        self.count, self.mini_step = int(state["count"]), int(state["mini_step"])
        for kind, bufs in self.buffers.items():
            for n, buf in bufs.items():
                buf.copy_(state["buffers"][kind][n])


@dataclasses.dataclass
class TrainState:
    """The port's form of the JAX TrainState: the model holds the parameters
    (and buffers), the optimizer its state, ``step`` counts train steps."""
    model: nn.Module
    optimizer: Optimizer
    step: int = 0

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def create_train_state(model, optim_cfg: OptimConfig) -> TrainState:
    """A train state over ``model.named_trained_parameters()``."""
    return TrainState(model, Optimizer(model.named_trained_parameters(), optim_cfg))


def apply_gradients(optimizer: Optimizer, grads) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of ``grads`` (None for a parameter the loss does not reach: a
    zero gradient, as in JAX). With ``skip_nonfinite_updates`` a non-finite
    gradient skips the whole step. Returns (grads_finite, grad_norm) of the
    raw gradients, as 0-d tensors."""
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, optimizer.params)]
    grads_finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
    grad_norm = global_norm(grads)
    if not optimizer.cfg.skip_nonfinite_updates or bool(grads_finite):
        optimizer.update(grads)
    return grads_finite, grad_norm


def _lap(timers, name: Optional[str], device, next_name: Optional[str] = None):
    """Close the timer ``name`` (after a device synchronize) and open ``next_name``."""
    if timers is None:
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if name is not None:
        timers.toc(name)
    if next_name is not None:
        timers.tic(next_name)


def make_loss_train_step(loss_fn, reduce_gradients=None):
    """``train_step(state, batch, inputs, timers=None) -> (state, info)`` for
    ``loss_fn(outputs, batch) -> (loss, info)`` over ``model.train_forward``.

    ``inputs`` is ``model.draw_train_inputs``'s dict. info holds the loss
    terms, ``grads_finite`` and ``grad_norm`` (of the raw gradients) as 0-d
    tensors; ``apply_gradients`` makes the update. ``reduce_gradients(grads,
    params) -> grads`` runs between the backward and the update (the
    data-parallel step's all-reduce, ``parallel.mesh``). With ``timers``
    (``utils.logging.Timers``) the forward, backward, all_reduce (with
    ``reduce_gradients``) and optimizer phases are timed, each ended by a
    device synchronize."""

    def train_step(state: TrainState, batch, inputs, timers=None):
        params = state.optimizer.params
        device = params[0].device
        _lap(timers, None, device, "forward")
        outputs = state.model.train_forward(batch, **inputs)
        loss, info = loss_fn(outputs, batch)
        _lap(timers, "forward", device, "backward")
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        if reduce_gradients is not None:
            _lap(timers, "backward", device, "all_reduce")
            grads = reduce_gradients(grads, params)
            _lap(timers, "all_reduce", device, "optimizer")
        else:
            _lap(timers, "backward", device, "optimizer")
        grads_finite, grad_norm = apply_gradients(state.optimizer, grads)
        _lap(timers, "optimizer", device)
        state.step += 1
        info = {k: v.detach() for k, v in info.items()}
        return state, {**info, "grads_finite": grads_finite, "grad_norm": grad_norm}

    return train_step


def make_train_step(loss_cfg: LossConfig):
    """The 3D train step (``make_loss_train_step``) on ``diffreg_loss``; the
    draws are (t, g, euler)."""
    return make_loss_train_step(lambda outputs, batch: diffreg_loss(outputs, batch, loss_cfg))


def make_eval_step(loss_cfg: LossConfig):
    """``eval_step(state, batch, inputs) -> info``: the training loss without
    an update (the reference BaseTrainer's validation loop)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch, inputs):
        outputs = state.model.train_forward(batch, **inputs)
        return diffreg_loss(outputs, batch, loss_cfg)[1]

    return eval_step
