"""Masked multi-head attention: the plain PyTorch version and the Hopper kernel.

Counterpart of the JAX package's ops/pallas/attention_kernel.py
(``masked_attention_pallas``), in its layout: q [B, H, L, D], k/v
[B, H, S, D], kv_mask [B, S] -> [B, H, L, D]. Keys with ``kv_mask`` False
are set to -1e9 for every query before the softmax, as the TPU kernel does.
Rows of invalid queries are garbage that callers mask downstream.

``masked_attention`` is the entry the transformer calls: a CUDA tensor
launches the hand-written kernel (``csrc/attention.cu``) or raises; a CPU
tensor runs the plain version. On CUDA tensors the kernel runs inside
``MaskedAttentionFunction``, whose backward recomputes the plain version and
differentiates it: the dq/dk/dv of the JAX package's ``custom_vjp``
(``ops/pallas/attention_kernel.py``), with the probabilities rebuilt in the
backward, not kept from the forward.

``precision`` is the policy of the plain version (``utils/precision.py``):
"default" runs its products, and the backward recompute's, in TF32 on CUDA,
as the JAX package's XLA attention runs at ``get_precision()``; the kernel
computes in 3xTF32 (f32 accuracy) under either policy.

bf16 q, k and v are the JAX package's bf16 compute path: the kernel's bf16
instance on CUDA inside ``MaskedAttentionBF16Function`` (its backward
recomputes ``masked_attention_bf16_plain`` and differentiates it, as
``jax.grad`` differentiates the JAX layer's XLA attention),
``masked_attention_bf16_plain`` on the CPU; both return bf16.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda import kernel_library, launch
from ..utils.precision import matmul_precision
from .masked import NEG_INF
from .recompute import recompute_grads


def masked_attention_plain(q, k, v, kv_mask, scale):
    """softmax(where(kv_mask, (q * scale) k^T, -1e9)) v."""
    logits = torch.einsum("bhld,bhsd->bhls", q * scale, k)
    logits = torch.where(kv_mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    return torch.einsum("bhls,bhsd->bhld", torch.softmax(logits, dim=-1), v)


def masked_attention_bf16_plain(q, k, v, kv_mask, scale):
    """The bf16 instance's function, in f32 with its roundings, which are the
    JAX layer's XLA path's (nn/transformer.py:414-429): logits of the bf16 q
    and k summed in f32, masked, scaled and softmaxed in f32, the
    probabilities rounded to bf16 for P.V (f32 sums), the output rounded to
    bf16. bf16 in, bf16 out."""
    logits = torch.einsum("bhld,bhsd->bhls", q.float(), k.float())
    logits = torch.where(kv_mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits * scale, dim=-1)
    return torch.einsum("bhls,bhsd->bhld", p.to(torch.bfloat16).float(), v.float()).to(
        torch.bfloat16)


def _check_inputs(name, q, k, v, kv_mask, dtype):
    for arg, t in {"q": q, "k": k, "v": v}.items():
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dtype} CUDA tensor")
    if not kv_mask.is_cuda or kv_mask.dtype != torch.bool or not kv_mask.is_contiguous():
        raise ValueError(f"{name}: kv_mask must be a contiguous bool CUDA tensor")
    b, h, l, d = q.shape
    s = k.shape[2]
    if k.shape != (b, h, s, d) or v.shape != (b, h, s, d) or kv_mask.shape != (b, s):
        raise ValueError(f"{name}: inconsistent shapes "
                         f"{q.shape} {k.shape} {v.shape} {kv_mask.shape}")
    return b, h, l, s, d


def masked_attention_cuda(q, k, v, kv_mask, scale):
    """Launch the Hopper attention kernel; same contract as the plain version."""
    b, h, l, s, d = _check_inputs("masked_attention_cuda", q, k, v, kv_mask, torch.float32)
    lib = _library()
    out = torch.empty_like(q)
    launch(lib, "masked_attention_forward", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           kv_mask.data_ptr(), out.data_ptr(), b, h, l, s, d, float(scale))
    masked_attention_cuda.launches += 1
    return out


masked_attention_cuda.launches = 0


def masked_attention_cuda_bf16(q, k, v, kv_mask, scale):
    """Launch the kernel's bf16 instance (head width up to 144); bf16 q, k, v
    -> bf16, as ``masked_attention_bf16_plain``."""
    b, h, l, s, d = _check_inputs("masked_attention_cuda_bf16", q, k, v, kv_mask,
                                  torch.bfloat16)
    lib = _library()
    out = torch.empty_like(q)
    launch(lib, "masked_attention_forward_bf16", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           kv_mask.data_ptr(), out.data_ptr(), b, h, l, s, d, float(scale))
    masked_attention_cuda_bf16.launches += 1
    return out


masked_attention_cuda_bf16.launches = 0


class MaskedAttentionFunction(torch.autograd.Function):
    """``masked_attention_cuda`` forward; plain-recompute backward for q, k, v
    at the ``precision`` policy."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale, precision="highest"):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.scale, ctx.precision = scale, precision
        return masked_attention_cuda(q, k, v, kv_mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        with matmul_precision(ctx.precision):
            grads = recompute_grads("masked_attention_backward_recompute",
                                    lambda *a: masked_attention_plain(*a, ctx.scale),
                                    ctx.saved_tensors, ctx.needs_input_grad[:4], grad_out)
        return (*grads, None, None)


class MaskedAttentionBF16Function(torch.autograd.Function):
    """``masked_attention_cuda_bf16`` forward; plain-recompute backward of
    ``masked_attention_bf16_plain`` for the bf16 q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, scale):
        ctx.save_for_backward(q, k, v, kv_mask)
        ctx.scale = scale
        return masked_attention_cuda_bf16(q, k, v, kv_mask, scale)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_grads("masked_attention_bf16_backward_recompute",
                                 lambda *a: masked_attention_bf16_plain(*a, ctx.scale),
                                 ctx.saved_tensors, ctx.needs_input_grad[:4], grad_out), None)


def _library():
    lib = kernel_library("attention")
    if lib.masked_attention_forward.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.masked_attention_forward.argtypes = [vp] * 5 + [ci] * 5 + [ctypes.c_float, vp]
        lib.masked_attention_forward.restype = ci
        lib.masked_attention_forward_bf16.argtypes = [vp] * 5 + [ci] * 5 + [ctypes.c_float, vp]
        lib.masked_attention_forward_bf16.restype = ci
    return lib


def masked_attention(q, k, v, kv_mask, scale, precision="highest"):
    """Masked attention on the tensors' device: the Hopper kernel (under
    autograd) for CUDA tensors, the plain version for CPU tensors; bf16
    tensors take the bf16 path (its kernel instance on CUDA). ``precision``:
    the f32 plain version's policy (in the backward on CUDA)."""
    if q.dtype == torch.bfloat16:
        if q.is_cuda:
            return MaskedAttentionBF16Function.apply(q.contiguous(), k.contiguous(),
                                                     v.contiguous(), kv_mask.contiguous(), scale)
        return masked_attention_bf16_plain(q, k, v, kv_mask, scale)
    if q.is_cuda:
        return MaskedAttentionFunction.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                             kv_mask.contiguous(), scale, precision)
    with matmul_precision(precision):
        return masked_attention_plain(q, k, v, kv_mask, scale)
