"""Precision policy: float32 by default, TF32 only where the config asks for it.

The JAX package pins its contractions to ``Precision.HIGHEST`` unless the
config says ``precision: default`` (``diffreg_tpu/utils/precision.py``),
which lowers exactly the contractions that read ``get_precision()``; on an
NVIDIA card JAX's DEFAULT is one-pass TF32. The port's counterpart:

  * ``pin_float32`` sets the process baseline at model construction: TF32 off
    for CUDA matmuls and cuDNN, and bf16 GEMMs reduced in f32, so that the
    Sinkhorn logits, the pose covariance and the convolutions keep full
    float32 on the card, and the bf16 path accumulates in f32 as JAX's
    ``preferred_element_type=float32`` does;
  * ``matmul_precision(policy)`` wraps one call site that JAX runs at
    ``get_precision()``: TF32 inside it under "default", float32 under
    "highest", and the flag restored after. The policy travels in the
    configs to the site (``MatchingConfig.precision``), never through a flag
    set before construction, so two models with different policies coexist;
  * ``policy_bmm(a, b, policy)`` is such a site with its gradient: autograd
    runs a backward after the forward's ``with`` has restored the flag, so
    the product's two backward GEMMs get their own switch, as the transpose
    of JAX's ``einsum(..., precision=get_precision())`` keeps that precision.

Of JAX's ``get_precision()`` sites, the port's plain matmuls are the
matcher's similarity product (``nn/matching.py``). The others are the f32
branches of KPConv and of the transformer's attention, which the port runs
through its kernels: those keep f32 accuracy (3xTF32) under either policy.
On the CPU TF32 does not exist, so both packages compute float32 there.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("highest", "default")


def pin_float32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN and keep bf16 GEMM reductions in
    f32 (process-wide)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def matmul_precision(policy: str):
    """CUDA matmuls inside run in TF32 when ``policy`` is "default", in float32
    when it is "highest"; the previous setting is restored on exit."""
    if policy not in PRECISIONS:
        raise ValueError(f"precision {policy!r}: one of {PRECISIONS}")
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = policy == "default"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _PolicyBmm(torch.autograd.Function):
    """a @ b with the forward and both backward GEMMs under one policy."""

    @staticmethod
    def forward(ctx, a, b, policy):
        ctx.save_for_backward(a, b)
        ctx.policy = policy
        with matmul_precision(policy):
            return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        da = db = None
        with matmul_precision(ctx.policy):
            if ctx.needs_input_grad[0]:
                da = torch.bmm(grad, b.transpose(1, 2))
            if ctx.needs_input_grad[1]:
                db = torch.bmm(a.transpose(1, 2), grad)
        return da, db, None


def policy_bmm(a, b, policy: str):
    """Batched a [B, M, K] @ b [B, K, N] at ``policy`` ("default": TF32 on
    CUDA, "highest": float32), its gradients included."""
    return _PolicyBmm.apply(a, b, policy)
