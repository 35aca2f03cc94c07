"""Backward by recomputation, for the autograd Functions around the kernels.

The JAX package's kernels have no backward kernel: their ``custom_vjp``
recomputes the plain formulation at the saved inputs and differentiates it.
The port's Functions do the same with ``recompute_grads``, each under a
profiler range of its own: ``kpconv_backward_recompute``,
``masked_attention_backward_recompute`` and their bf16 instances'
``kpconv_bf16_backward_recompute``, ``masked_attention_bf16_backward_recompute``.
"""
from __future__ import annotations

import torch


def recompute_grads(name, plain, saved, needs, grad_out):
    """Gradients of ``plain(*saved)`` with respect to the inputs flagged in
    ``needs`` (None for the others), recomputed under ``enable_grad``. The work
    is a profiler range called ``name`` (tools/profile_port_train.py reads it)."""
    with torch.enable_grad(), torch.profiler.record_function(name):
        inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs)]
        wanted = [t for t, need in zip(inputs, needs) if need]
        grads = iter(torch.autograd.grad(plain(*inputs), wanted, grad_out) if wanted else ())
    return tuple(next(grads) if need else None for need in needs)
