"""Kernel-point convolution: the plain PyTorch version and the Hopper kernel.

Counterpart of the JAX package's ops/kpconv.py (``kpconv``,
``kpconv_deformable``, ``max_pool``, ``closest_pool``, ``kpconv_batched``) and
of its Pallas kernel ops/pallas/kpconv_kernel.py. Neighborhoods are fixed-K
and sentinel-padded (index == Ns is the shadow point: position 1e6, zero
features). Every function takes the JAX package's modes: ``influence``
linear, constant or gaussian, and ``aggregation`` sum or closest
(``influence_weights``). The Pallas kernel has linear and sum only (JAX runs
the others in XLA); the Hopper kernel has each pair as an instance.

``kpconv_deformable`` computes its offset conv through ``kpconv_batched`` (the
Hopper kernel on CUDA tensors) and its deformed conv, whose kernel points
differ per query, in batched plain PyTorch on every device: JAX computes it in
XLA, and no kernel of either package computes it.

``kpconv_batched`` is the entry the backbone calls: a CUDA tensor launches
the hand-written kernel (``csrc/kpconv.cu``) or raises; a CPU tensor runs
the plain version (the bf16 instance is ``csrc/kpconv_bf16.cu``, a library of
its own). On CUDA tensors the kernel runs inside ``KPConvFunction``,
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
import torch.nn.functional as F

from ..utils.cuda import kernel_library, launch
from .recompute import recompute_grads

_SHADOW = 1.0e6
INFLUENCES = ("linear", "constant", "gaussian")
AGGREGATIONS = ("sum", "closest")


def check_modes(influence, aggregation):
    if influence not in INFLUENCES:
        raise ValueError(f"KP_influence {influence!r}: one of {INFLUENCES}")
    if aggregation not in AGGREGATIONS:
        raise ValueError(f"aggregation_mode {aggregation!r}: one of {AGGREGATIONS}")


def gaussian_denominator(kp_extent):
    """2 sigma^2 + 1e-9 with sigma = 0.3 extent, in double, as the JAX package
    forms it from its Python float extent."""
    return 2.0 * (float(kp_extent) * 0.3) ** 2 + 1e-9


def influence_weights(sq_d, kp_extent, influence="linear", aggregation="sum"):
    """Kernel-point influence weights [..., P] of squared distances sq_d
    (the JAX package's ``_influence_weights``): linear max(1 - d / extent, 0),
    constant 1, or gaussian exp(-d^2 / (2 sigma^2 + 1e-9)); under "closest"
    every kernel point but each neighbour's nearest (the first on ties, as
    ``jnp.argmin``) weighs 0."""
    check_modes(influence, aggregation)
    if influence == "linear":
        w = torch.clamp(1.0 - torch.sqrt(sq_d) / kp_extent, min=0.0)
    elif influence == "constant":
        w = torch.ones_like(sq_d)
    else:
        w = torch.exp(-sq_d / gaussian_denominator(kp_extent))
    if aggregation == "closest":
        w = w * F.one_hot(sq_d.argmin(dim=-1), sq_d.shape[-1]).to(w.dtype)
    return w


def _gather_rows(table, inds):
    """table [B, N, C], inds [B, Nq, K] -> [B, Nq, K, C]: one ``index_select``
    over the flattened batch. Its backward is an ``index_add_`` (atomic adds);
    advanced indexing's sort-based backward took 480 of a train step's 590 ms
    of device time at full width (tools/profile_port_train.py on an H100)."""
    b, n, c = table.shape
    rows = inds.long() + torch.arange(b, device=table.device).reshape(b, 1, 1) * n
    return table.reshape(b * n, c).index_select(0, rows.reshape(-1)).reshape(*inds.shape, c)


def kpconv(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
           influence="linear", aggregation="sum"):
    """Plain KPConv, batched.

    q_pts [B, Nq, 3], s_pts [B, Ns, 3], neighb_inds [B, Nq, K] (sentinel Ns),
    x [B, Ns, Cin] (padded rows 0), kernel_points [P, 3], weights [P, Cin, Cout]
    -> [B, Nq, Cout].
    """
    weighted, neighbor_num = kpconv_aggregate(q_pts, s_pts, neighb_inds, x, kernel_points,
                                              kp_extent, influence, aggregation)
    out = torch.einsum("bnpc,pcd->bnd", weighted, weights)
    return out / neighbor_num[..., None].to(out.dtype)


def _gather(q_pts, s_pts, neighb_inds, x):
    """The gathered neighbours: offsets from the query [B, Nq, K, 3] and
    features [B, Nq, K, Cin], through one gather of [position, features] rows
    (the shadow row appended)."""
    b, _, cin = x.shape
    table = torch.cat([
        torch.cat([s_pts, s_pts.new_full((b, 1, 3), _SHADOW)], dim=1),
        torch.cat([x, x.new_zeros((b, 1, cin))], dim=1)], dim=-1)
    gathered = _gather_rows(table, neighb_inds)                 # [B, Nq, K, 3+Cin]
    return gathered[..., :3] - q_pts[:, :, None, :], gathered[..., 3:]


def kpconv_aggregate(q_pts, s_pts, neighb_inds, x, kernel_points, kp_extent,
                     influence="linear", aggregation="sum"):
    """KPConv before its contraction: the influence-weighted features
    [B, Nq, P, Cin] and the density count [B, Nq] (at least 1)."""
    neighbors, feats = _gather(q_pts, s_pts, neighb_inds, x)
    # ||n - kp||^2 = ||n||^2 + ||kp||^2 - 2 n.kp, as the JAX package computes it
    n2 = torch.sum(neighbors * neighbors, dim=-1, keepdim=True)
    k2 = torch.sum(kernel_points * kernel_points, dim=-1)
    cross = torch.einsum("bnkc,pc->bnkp", neighbors, kernel_points)
    sq_d = torch.clamp(n2 + k2 - 2.0 * cross, min=0.0)
    infl = influence_weights(sq_d, kp_extent, influence, aggregation)
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


def kpconv_bf16_plain(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
                      influence="linear", aggregation="sum"):
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
    neighbors, feats = _bf16_gather(q_pts, s_pts, neighb_inds, x)
    n2 = torch.sum(neighbors * neighbors, dim=-1, keepdim=True)
    k2 = torch.sum(kernel_points * kernel_points, dim=-1)
    cross = torch.einsum("bnkc,pc->bnkp", neighbors, kernel_points)
    sq_d = torch.clamp(n2 + k2 - 2.0 * cross, min=0.0)
    infl = influence_weights(sq_d, kp_extent, influence, aggregation)
    weighted = torch.einsum("bnkp,bnkc->bnpc", _round_bf16(infl), feats)
    out = torch.einsum("bnpc,pcd->bnd", _round_bf16(weighted), _round_bf16(weights))
    neighbor_num = (feats.sum(dim=-1) > 0.0).sum(dim=-1).clamp_min(1)
    return out / neighbor_num[..., None].to(out.dtype)


def _bf16_gather(q_pts, s_pts, neighb_inds, x):
    """The bf16 path's gathered neighbours: offsets from the query [B, Nq, K, 3]
    rebuilt in f32 as hi + lo, and features [B, Nq, K, Cin] at their bf16
    values, whose cotangent is rounded to bf16 as JAX's is."""
    gathered = _gather_rows(torch.cat(_bf16_support_rows(s_pts, x), dim=-1), neighb_inds)
    neighbors = (gathered[..., :3] + gathered[..., 3:6]) - q_pts[:, :, None, :]
    feats = gathered[..., 6:]
    if feats.requires_grad:
        feats.register_hook(_round_bf16)       # JAX's bf16 cotangent of the gathered rows
    return neighbors, feats


def _round_bf16(t):
    return t.to(torch.bfloat16).float()


def _mode_codes(kp_extent, influence, aggregation):
    """The C entry points' mode arguments: extent, influence code, closest flag,
    gaussian denominator."""
    check_modes(influence, aggregation)
    return (float(kp_extent), INFLUENCES.index(influence), int(aggregation == "closest"),
            gaussian_denominator(kp_extent))


def _count(wrapper, influence, aggregation):
    wrapper.launches += 1
    key = f"{influence}/{aggregation}"
    wrapper.mode_launches[key] = wrapper.mode_launches.get(key, 0) + 1


def kpconv_cuda(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
                influence="linear", aggregation="sum"):
    """Launch the Hopper KPConv kernel; same contract as ``kpconv``. Counts its
    launches in ``launches`` and, per "influence/aggregation", in
    ``mode_launches``."""
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
    lib = _library("kpconv")
    out = torch.empty((b, nq, cout), device=x.device, dtype=torch.float32)
    launch(lib, "kpconv_forward", x.device, q_pts.data_ptr(), s_pts.data_ptr(),
           neighb_inds.data_ptr(), x.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
           out.data_ptr(), b, nq, ns, k, cin, cout, p,
           *_mode_codes(kp_extent, influence, aggregation))
    _count(kpconv_cuda, influence, aggregation)
    return out


kpconv_cuda.launches = 0
kpconv_cuda.mode_launches = {}


def kpconv_cuda_bf16(q_pts, table, neighb_inds, kernel_points, weights, kp_extent,
                     influence="linear", aggregation="sum"):
    """Launch the kernel's bf16 instance: ``table`` [B, Ns + 1, 8 + Cin] bf16
    (``kpconv_bf16_table_aligned``), ``weights`` [P, Cin, Cout] bf16, f32
    query and kernel points; returns f32 [B, Nq, Cout], as
    ``kpconv_bf16_plain``. Counts as ``kpconv_cuda`` does."""
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
    lib = _library("kpconv_bf16")
    out = torch.empty((b, nq, cout), device=table.device, dtype=torch.float32)
    launch(lib, "kpconv_forward_bf16", table.device, q_pts.data_ptr(), table.data_ptr(),
           neighb_inds.data_ptr(), kernel_points.data_ptr(), weights.data_ptr(),
           out.data_ptr(), b, nq, ns, k, cin, cout, p,
           *_mode_codes(kp_extent, influence, aggregation))
    _count(kpconv_cuda_bf16, influence, aggregation)
    return out


kpconv_cuda_bf16.launches = 0
kpconv_cuda_bf16.mode_launches = {}


class KPConvFunction(torch.autograd.Function):
    """``kpconv_cuda`` forward; plain-recompute backward for the inputs that
    need a gradient (features and weights on the training path)."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
                influence="linear", aggregation="sum"):
        ctx.save_for_backward(q_pts, s_pts, neighb_inds, x, kernel_points, weights)
        ctx.modes = (kp_extent, influence, aggregation)
        return kpconv_cuda(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
                           influence, aggregation)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_grads("kpconv_backward_recompute",
                                 lambda *a: kpconv(*a, *ctx.modes), ctx.saved_tensors,
                                 ctx.needs_input_grad[:6], grad_out), None, None, None)


class KPConvBF16Function(torch.autograd.Function):
    """``kpconv_cuda_bf16`` forward on the table built from ``s_pts`` and
    ``x`` (so that ``x`` has a gradient; the shadow row is made inside and
    gets none); plain-recompute backward of ``kpconv_bf16_plain`` for the
    inputs that need a gradient (features and f32 weights in training)."""

    @staticmethod
    def forward(ctx, q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
                influence="linear", aggregation="sum"):
        ctx.save_for_backward(q_pts, s_pts, neighb_inds, x, kernel_points, weights)
        ctx.modes = (kp_extent, influence, aggregation)
        return kpconv_cuda_bf16(q_pts, kpconv_bf16_table_aligned(s_pts, x), neighb_inds,
                                kernel_points, weights.to(torch.bfloat16).contiguous(),
                                kp_extent, influence, aggregation)

    @staticmethod
    def backward(ctx, grad_out):
        return (*recompute_grads("kpconv_bf16_backward_recompute",
                                 lambda *a: kpconv_bf16_plain(*a, *ctx.modes),
                                 ctx.saved_tensors, ctx.needs_input_grad[:6], grad_out),
                None, None, None)


def _library(name):
    """The loaded ``lib<name>.so`` (csrc/kpconv.cu: ``kpconv_forward``;
    csrc/kpconv_bf16.cu: ``kpconv_forward_bf16``), its entry typed."""
    lib = kernel_library(name)
    entry = getattr(lib, "kpconv_forward" if name == "kpconv" else "kpconv_forward_bf16")
    if entry.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        modes = [ctypes.c_float, ci, ci, ctypes.c_float]   # extent, influence, closest, den
        entry.argtypes = [vp] * (7 if name == "kpconv" else 6) + [ci] * 7 + modes + [vp]
        entry.restype = ci
    return lib


def kpconv_batched(q_pts, s_pts, neighb_inds, x, kernel_points, weights, kp_extent,
                   compute_dtype=None, influence="linear", aggregation="sum"):
    """KPConv on the tensors' device: the Hopper kernel (under autograd) for
    CUDA tensors, the plain version for CPU tensors. ``compute_dtype``
    "bfloat16" takes the bf16 path (its kernel instance on CUDA); None or
    "float32" the f32 one. ``influence`` and ``aggregation``: the modes of
    ``influence_weights``, each an instance of the kernel on CUDA."""
    if compute_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"compute_dtype {compute_dtype!r}: bfloat16, float32 or None")
    args = (q_pts, s_pts, neighb_inds, x, kernel_points, weights)
    if x.is_cuda:
        function = KPConvBF16Function if compute_dtype == "bfloat16" else KPConvFunction
        return function.apply(*(t.contiguous() for t in args), kp_extent, influence,
                              aggregation)
    plain = kpconv_bf16_plain if compute_dtype == "bfloat16" else kpconv
    return plain(*args, kp_extent, influence, aggregation)


def kpconv_deformable(q_pts, s_pts, neighb_inds, x, kernel_points, weights, offset_weights,
                      offset_bias, kp_extent, influence="linear", aggregation="sum",
                      modulated=False, compute_dtype=None, offset_kernel_points=None):
    """Deformable (``modulated``: and modulated) KPConv, batched: the JAX
    package's ``kpconv_deformable`` (the reference's ``KPConv(deformable=True)``).

    A rigid KPConv over the same neighbourhood (``kpconv_batched``, with the
    offset conv's own ``offset_kernel_points``, default ``kernel_points``)
    predicts per-query kernel offsets [B, Nq, P, 3] in units of the extent and,
    when ``modulated``, per-point gains 2 sigmoid(.); the deformed conv then
    zeroes the features of neighbours outside every deformed point's extent
    (``sq_d < extent^2``, the static form of the reference's re-gather), so
    that they count neither in the sum nor in the density count. The same
    arguments as ``kpconv_batched`` plus ``offset_weights`` [P, Cin, (3 or 4) P]
    and ``offset_bias``. Returns (features [B, Nq, Cout], aux) with aux
    ``min_d2`` [B, Nq, P] (each deformed point's squared distance to its
    nearest neighbour), ``deformed_kp`` [B, Nq, P, 3] and ``offset_features``
    [B, Nq, (3 or 4) P]. ``compute_dtype`` "bfloat16" rounds where JAX's bf16
    path rounds: the gathered features and the influences to bf16, their f32
    sums to bf16 before the contraction with the bf16 weights."""
    b, nq, _ = q_pts.shape
    p = kernel_points.shape[0]
    bf16 = compute_dtype == "bfloat16"
    okp = kernel_points if offset_kernel_points is None else offset_kernel_points
    offset_features = kpconv_batched(q_pts, s_pts, neighb_inds, x, okp, offset_weights,
                                     kp_extent, compute_dtype, influence,
                                     aggregation) + offset_bias
    unscaled = offset_features[..., :3 * p].reshape(b, nq, p, 3)
    deformed_kp = kernel_points + unscaled * kp_extent                # [B, Nq, P, 3]

    neighbors, feats = (_bf16_gather if bf16 else _gather)(q_pts, s_pts, neighb_inds, x)
    n2 = torch.sum(neighbors * neighbors, dim=-1, keepdim=True)     # [B, Nq, K, 1]
    k2 = torch.sum(deformed_kp * deformed_kp, dim=-1)                # [B, Nq, P]
    cross = torch.einsum("bnkc,bnpc->bnkp", neighbors, deformed_kp)
    sq_d = torch.clamp(n2 + k2[:, :, None, :] - 2.0 * cross, min=0.0)
    min_d2 = sq_d.amin(dim=2)
    in_range = (sq_d < kp_extent ** 2).any(dim=3)                    # [B, Nq, K]
    feats = feats * in_range[..., None].to(feats.dtype)
    infl = influence_weights(sq_d, kp_extent, influence, aggregation)
    weighted = torch.einsum("bnkp,bnkc->bnpc", _round_bf16(infl) if bf16 else infl, feats)
    if modulated:
        weighted = weighted * (2.0 * torch.sigmoid(offset_features[..., 3 * p:]))[..., None]
    if bf16:
        out = torch.einsum("bnpc,pcd->bnd", _round_bf16(weighted), _round_bf16(weights))
    else:
        out = torch.einsum("bnpc,pcd->bnd", weighted, weights)
    neighbor_num = (feats.sum(dim=-1) > 0.0).sum(dim=-1).clamp_min(1)
    out = out / neighbor_num[..., None].to(out.dtype)
    return out, {"min_d2": min_d2, "deformed_kp": deformed_kp,
                 "offset_features": offset_features}


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
