"""Kernel-point convolution: the plain PyTorch version and the Hopper kernel.

Counterpart of the JAX package's ops/kpconv.py (``kpconv``, ``max_pool``,
``closest_pool``, ``kpconv_batched``) and of its Pallas kernel
ops/pallas/kpconv_kernel.py. Neighborhoods are fixed-K and sentinel-padded
(index == Ns is the shadow point: position 1e6, zero features). Linear
influence and sum aggregation, the only modes on the Diff-Reg path.

``kpconv_batched`` is the entry the backbone calls: a CUDA tensor launches
the hand-written kernel (``csrc/kpconv.cu``) or raises; a CPU tensor runs
the plain version. On CUDA tensors the kernel runs inside ``KPConvFunction``,
whose backward recomputes the plain version at the saved inputs and
differentiates it, as the JAX package's ``custom_vjp`` does
(``ops/pallas/kpconv_kernel.py``): the gathered rows are rebuilt one layer at
a time in the backward and freed after it, never kept from the forward.

``compute_dtype="bfloat16"`` is the JAX package's bf16 path
(``diffreg_tpu/ops/kpconv.py:kpconv`` with ``compute_dtype``): the support
table is gathered as bf16 values [hi(pos), lo(pos), feats] (the CUDA route
reads them as bf16 with the features moved to a 16-byte boundary,
``kpconv_bf16_table_aligned``), positions are
rebuilt in f32 as hi + lo, the influence is computed in f32 and rounded to
bf16, the influence-weighted features are summed in f32 and rounded to bf16,
and the contraction with the bf16 weights accumulates in f32. On CUDA tensors
it launches the kernel's bf16 instance (``kpconv_cuda_bf16``) inside
``KPConvBF16Function``, whose backward recomputes ``kpconv_bf16_plain`` and
differentiates it, as ``jax.grad`` differentiates the JAX package's bf16
einsums: the gradient reaches ``x`` through the table's feature columns
and the f32 weights through their cast at use.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda import kernel_library, launch
from .recompute import recompute_grads

_SHADOW = 1.0e6


def _gather_rows(table, inds):
    """table [B, N, C], inds [B, Nq, K] -> [B, Nq, K, C]: one ``index_select``
    over the flattened batch. Its backward is an ``index_add_`` (atomic adds);
    advanced indexing's sort-based backward took 480 of a train step's 590 ms
    of device time at full width (tools/profile_port_train.py on an H100)."""
    b, n, c = table.shape
    rows = inds.long() + torch.arange(b, device=table.device).reshape(b, 1, 1) * n
    return table.reshape(b * n, c).index_select(0, rows.reshape(-1)).reshape(*inds.shape, c)


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent):
    """Plain KPConv, batched.

    q_pts [B, Nq, 3], s_pts [B, Ns, 3], neighb_inds [B, Nq, K] (sentinel Ns),
    x [B, Ns, Cin] (padded rows 0), kernel_points [P, 3], weights [P, Cin, Cout]
    -> [B, Nq, Cout].
    """
    weighted, neighbor_num = kpconv_aggregate(q_pts, s_pts, neighb_inds, x, kernel_points,
                                              kp_extent)
    out = torch.einsum("bnpc,pcd->bnd", weighted, weights)
    return out / neighbor_num[..., None].to(out.dtype)


def kpconv_aggregate(q_pts, s_pts, neighb_inds, x, kernel_points, kp_extent):
    """KPConv before its contraction: the influence-weighted features
    [B, Nq, P, Cin] and the density count [B, Nq] (at least 1)."""
    b, _, cin = x.shape
    table = torch.cat([
        torch.cat([s_pts, s_pts.new_full((b, 1, 3), _SHADOW)], dim=1),
        torch.cat([x, x.new_zeros((b, 1, cin))], dim=1)], dim=-1)
    gathered = _gather_rows(table, neighb_inds)                 # [B, Nq, K, 3+Cin]
    neighbors = gathered[..., :3] - q_pts[:, :, None, :]
    feats = gathered[..., 3:]
    # ||n - kp||^2 = ||n||^2 + ||kp||^2 - 2 n.kp, as the JAX package computes it
    n2 = torch.sum(neighbors * neighbors, dim=-1, keepdim=True)
    k2 = torch.sum(kernel_points * kernel_points, dim=-1)
    cross = torch.einsum("bnkc,pc->bnkp", neighbors, kernel_points)
    sq_d = torch.clamp(n2 + k2 - 2.0 * cross, min=0.0)
    infl = torch.clamp(1.0 - torch.sqrt(sq_d) / kp_extent, min=0.0)
    weighted = torch.einsum("bnkp,bnkc->bnpc", infl, feats)
    # density normalization: a neighbor counts iff its feature-sum is positive
    # (the reference's quirk, blocks.py:354-357)
    neighbor_num = (feats.sum(dim=-1) > 0.0).sum(dim=-1).clamp_min(1)
    return weighted, neighbor_num


def _bf16_support_rows(s_pts, x):
    """The rows of the JAX package's bf16 support table, as f32 values:
    hi [B, Ns + 1, 3] and lo of the positions (pos = hi + lo to ~5e-5 of a
    metre; plain bf16 would be off by a centimetre at metre scale) and the
    features [B, Ns + 1, Cin] at their bf16 values (the gradient passed
    straight through to ``x``), the shadow row appended (position 1e6, zero
    features)."""
    b, _, cin = x.shape
    pts = torch.cat([s_pts, s_pts.new_full((b, 1, 3), _SHADOW)], dim=1)
    hi = _round_bf16(pts)
    lo = _round_bf16(pts - hi)
    feats = _Bf16Values.apply(x)
    return hi, lo, torch.cat([feats, feats.new_zeros((b, 1, cin))], dim=1)


class _Bf16Values(torch.autograd.Function):
    """x at its bf16 values, the gradient passed unchanged."""

    @staticmethod
    def forward(ctx, x):
        return _round_bf16(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


def kpconv_bf16_table_aligned(s_pts, x):
    """The CUDA route's bf16 support table [B, Ns + 1, 8 + Cin]: the JAX
    package's [hi(pos), lo(pos), features] rows with two zero columns after
    the positions, so that the features start at a 16-byte boundary (the
    kernel stages them with 16-byte copies): [hi, lo, 0, 0, features]."""
    hi, lo, feats = _bf16_support_rows(s_pts, x)
    return torch.cat([hi, lo, hi.new_zeros((*hi.shape[:2], 2)), feats],
                     dim=-1).to(torch.bfloat16)


def kpconv_bf16_plain(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent):
    """Plain KPConv of the bf16 path, in f32 with bf16 roundings where the
    JAX package rounds (every product of two bf16 values is exact in f32, so
    f32 sums of them are what an f32-accumulating bf16 product computes).
    Same arguments as ``kpconv`` (f32 x and weights); returns f32.

    Its gradient rounds where JAX's bf16 cotangents are rounded (the weights'
    gradient, and each gathered neighbour's feature cotangent), then adds the
    neighbours' cotangents per support row in f32. JAX adds them in bf16
    (XLA's CPU scatter-add rounds each addition, in index order); f32 sums
    make the CUDA recompute, which adds with atomics, agree with this plain
    version to f32 summation order."""
    gathered = _gather_rows(torch.cat(_bf16_support_rows(s_pts, x), dim=-1), neighb_inds)
    neighbors = (gathered[..., :3] + gathered[..., 3:6]) - q_pts[:, :, None, :]
    feats = gathered[..., 6:]
    if feats.requires_grad:
        feats.register_hook(_round_bf16)       # JAX's bf16 cotangent of the gathered rows
    n2 = torch.sum(neighbors * neighbors, dim=-1, keepdim=True)
    k2 = torch.sum(kernel_points * kernel_points, dim=-1)
    cross = torch.einsum("bnkc,pc->bnkp", neighbors, kernel_points)
    sq_d = torch.clamp(n2 + k2 - 2.0 * cross, min=0.0)
    infl = torch.clamp(1.0 - torch.sqrt(sq_d) / kp_extent, min=0.0)
    weighted = torch.einsum("bnkp,bnkc->bnpc", _round_bf16(infl), feats)
    out = torch.einsum("bnpc,pcd->bnd", _round_bf16(weighted), _round_bf16(weights))
    neighbor_num = (feats.sum(dim=-1) > 0.0).sum(dim=-1).clamp_min(1)
    return out / neighbor_num[..., None].to(out.dtype)


def _round_bf16(t):
    return t.to(torch.bfloat16).float()


def kpconv_cuda(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent):
    """Launch the Hopper KPConv kernel; same contract as ``kpconv``."""
    tensors = {"q_pts": q_pts, "s_pts": s_pts, "x": x,
               "kernel_points": kernel_points, "weights": weights}
    for name, t in tensors.items():
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"kpconv_cuda: {name} must be a contiguous float32 CUDA tensor")
    if (not neighb_inds.is_cuda or neighb_inds.dtype != torch.int32
            or not neighb_inds.is_contiguous()):
        raise ValueError("kpconv_cuda: neighb_inds must be a contiguous int32 CUDA tensor")
    b, nq, k = neighb_inds.shape
    ns = s_pts.shape[1]
    p, cin, cout = weights.shape
    if (q_pts.shape != (b, nq, 3) or s_pts.shape != (b, ns, 3) or x.shape != (b, ns, cin)
            or kernel_points.shape != (p, 3)):
        raise ValueError("kpconv_cuda: inconsistent shapes "
                         f"{q_pts.shape} {s_pts.shape} {neighb_inds.shape} {x.shape} "
                         f"{kernel_points.shape} {weights.shape}")
    lib = _library()
    out = torch.empty((b, nq, cout), device=x.device, dtype=torch.float32)
    launch(lib, "kpconv_forward", x.device, q_pts.data_ptr(), s_pts.data_ptr(),
           neighb_inds.data_ptr(), x.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
           out.data_ptr(), b, nq, ns, k, cin, cout, p, float(kp_extent))
    kpconv_cuda.launches += 1
    return out


kpconv_cuda.launches = 0


def kpconv_cuda_bf16(q_pts, table, neighb_inds, kernel_points, weights, kp_extent):
    """Launch the kernel's bf16 instance: ``table`` [B, Ns + 1, 8 + Cin] bf16
    (``kpconv_bf16_table_aligned``), ``weights`` [P, Cin, Cout] bf16, f32
    query and kernel points; returns f32 [B, Nq, Cout], as
    ``kpconv_bf16_plain``."""
    for name, t, dtype in (("q_pts", q_pts, torch.float32), ("table", table, torch.bfloat16),
                           ("kernel_points", kernel_points, torch.float32),
                           ("weights", weights, torch.bfloat16),
                           ("neighb_inds", neighb_inds, torch.int32)):
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"kpconv_cuda_bf16: {name} must be a contiguous {dtype} CUDA tensor")
    b, nq, k = neighb_inds.shape
    p, cin, cout = weights.shape
    ns = table.shape[1] - 1
    if (q_pts.shape != (b, nq, 3) or table.shape != (b, ns + 1, 8 + cin)
            or kernel_points.shape != (p, 3)):
        raise ValueError("kpconv_cuda_bf16: inconsistent shapes "
                         f"{q_pts.shape} {table.shape} {neighb_inds.shape} "
                         f"{kernel_points.shape} {weights.shape}")
    lib = _library()
    out = torch.empty((b, nq, cout), device=table.device, dtype=torch.float32)
    launch(lib, "kpconv_forward_bf16", table.device, q_pts.data_ptr(), table.data_ptr(),
           neighb_inds.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
           out.data_ptr(), b, nq, ns, k, cin, cout, p, float(kp_extent))
    kpconv_cuda_bf16.launches += 1
    return out


kpconv_cuda_bf16.launches = 0


class KPConvFunction(torch.autograd.Function):
    """``kpconv_cuda`` forward; plain-recompute backward for the inputs that
    need a gradient (features and weights on the training path)."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent):
        ctx.save_for_backward(q_pts, s_pts, neighb_inds, x, kernel_points, weights)
        ctx.kp_extent = kp_extent
        return kpconv_cuda(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_grads("kpconv_backward_recompute",
                                 lambda *a: kpconv(*a, ctx.kp_extent), ctx.saved_tensors,
                                 ctx.needs_input_grad[:6], grad_out), None)


class KPConvBF16Function(torch.autograd.Function):
    """``kpconv_cuda_bf16`` forward on the table built from ``s_pts`` and
    ``x`` (so that ``x`` has a gradient; the shadow row is made inside and
    gets none); plain-recompute backward of ``kpconv_bf16_plain`` for the
    inputs that need a gradient (features and f32 weights in training)."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent):
        ctx.save_for_backward(q_pts, s_pts, neighb_inds, x, kernel_points, weights)
        ctx.kp_extent = kp_extent
        return kpconv_cuda_bf16(q_pts, kpconv_bf16_table_aligned(s_pts, x), neighb_inds,
                                kernel_points, weights.to(torch.bfloat16).contiguous(),
                                kp_extent)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_grads("kpconv_bf16_backward_recompute",
                                 lambda *a: kpconv_bf16_plain(*a, ctx.kp_extent),
                                 ctx.saved_tensors, ctx.needs_input_grad[:6], grad_out), None)


def _library():
    lib = kernel_library("kpconv")
    if lib.kpconv_forward.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.kpconv_forward.argtypes = [vp] * 7 + [ci] * 7 + [ctypes.c_float, vp]
        lib.kpconv_forward.restype = ci
        lib.kpconv_forward_bf16.argtypes = [vp] * 6 + [ci] * 7 + [ctypes.c_float, vp]
        lib.kpconv_forward_bf16.restype = ci
    return lib


def kpconv_batched(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
                   compute_dtype=None):
    """KPConv on the tensors' device: the Hopper kernel (under autograd) for
    CUDA tensors, the plain version for CPU tensors. ``compute_dtype``
    "bfloat16" takes the bf16 path (its kernel instance on CUDA); None or
    "float32" the f32 one."""
    if compute_dtype == "bfloat16":
        if x.is_cuda:
            return KPConvBF16Function.apply(q_pts.contiguous(), s_pts.contiguous(),
                                            neighb_inds.contiguous(), x.contiguous(),
                                            kernel_points.contiguous(), weights.contiguous(),
                                            kp_extent)
        return kpconv_bf16_plain(q_pts, s_pts, neighb_inds, x, kernel_points, weights,
                                 kp_extent)
    if compute_dtype not in (None, "float32"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: bfloat16, float32 or None")
    if x.is_cuda:
        return KPConvFunction.apply(q_pts.contiguous(), s_pts.contiguous(),
                                    neighb_inds.contiguous(), x.contiguous(),
                                    kernel_points.contiguous(), weights.contiguous(), kp_extent)
    return kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent)


def max_pool(x, inds):
    """Max over sentinel-padded neighborhoods; shadow rows contribute 0.

    x [B, Ns, C], inds [B, Nq, K] -> [B, Nq, C].
    """
    shadow = torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)
    return _gather_rows(shadow, inds).amax(dim=2)


def closest_pool(x, inds):
    """Feature of the nearest (first) neighbor; x [B, Ns, C], inds [B, Nq, K]."""
    shadow = torch.cat([x, x.new_zeros((x.shape[0], 1, x.shape[2]))], dim=1)
    return _gather_rows(shadow, inds[:, :, :1])[:, :, 0]
