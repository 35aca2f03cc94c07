"""SO(3) conversions and helpers (the reference's vision3d/ops/so3.py).

Counterpart of the JAX package's geometry/so3.py. Scalar-first quaternions
throughout; ``quaternion_to_matrix`` comes from geometry/procrustes.py and
``matrix_to_quaternion`` from eval/metrics.py. Every function is batched and
runs on its inputs' device; the degenerate cases of the reference's Python
loops are masked selects, so nothing waits on the host.
"""
from __future__ import annotations

import math

import torch

from ..ops.features import safe_divide
from .procrustes import quaternion_to_matrix


def skew_symmetric_matrix(vector):
    """[v]_x: [*, 3] -> [*, 3, 3]."""
    x, y, z = vector[..., 0], vector[..., 1], vector[..., 2]
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(vector.shape[:-1] + (3, 3))


def rodrigues_rotation_formula(omega, theta):
    """R = I + sin(t) K + (1 - cos(t)) K^2; omega [*, 3] unit axes, theta [*]
    angles (rad)."""
    k = skew_symmetric_matrix(omega)
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + s * k + (1.0 - c) * (k @ k)


def axis_angle_to_rotation_matrix(phi):
    """so(3) exp map; phi = theta * axis, zero -> identity."""
    theta = torch.linalg.norm(phi, dim=-1)
    omega = safe_divide(phi, theta[..., None])
    return rodrigues_rotation_formula(omega, theta)


def axis_angle_to_quaternion(phi):
    theta = torch.linalg.norm(phi, dim=-1, keepdim=True)
    omega = safe_divide(phi, theta)
    return torch.cat([torch.cos(0.5 * theta), omega * torch.sin(0.5 * theta)], dim=-1)


def quaternion_to_axis_angle(q):
    """Angle forced into [0, pi] (the axis flips if needed)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    cos_half = q[..., :1]
    sin_half = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    theta = 2.0 * torch.where(cos_half < 0.0, torch.atan2(-sin_half, -cos_half),
                              torch.atan2(sin_half, cos_half))
    omega = safe_divide(q[..., 1:], sin_half)
    return omega * theta


def rotation_matrix_to_axis_angle(rotation):
    """SO(3) log map through the quaternion."""
    from ..eval.metrics import matrix_to_quaternion

    return quaternion_to_axis_angle(matrix_to_quaternion(rotation))


def alignment_rotation_matrix(src_vector, tgt_vector, eps: float = 1e-5):
    """Rotation aligning src to tgt via Rodrigues. Antiparallel pairs (cross
    product ~0, dot < 0) rotate by pi about an axis orthogonal to src, taken
    from the reference's first auxiliary axis, or its second where the first
    is parallel to src."""
    s = src_vector / torch.linalg.norm(src_vector, dim=-1, keepdim=True).clamp_min(eps)
    t = tgt_vector / torch.linalg.norm(tgt_vector, dim=-1, keepdim=True).clamp_min(eps)
    skew = skew_symmetric_matrix(s)
    phi = (skew @ t[..., None])[..., 0]                    # sin(theta) * axis
    opposite = torch.sum(s * t, dim=-1) < 0.0

    def aux_phi(i):
        aux = torch.zeros_like(t)
        aux[..., i] = 1.0
        p = (skew @ aux[..., None])[..., 0]
        n = torch.linalg.norm(p, dim=-1, keepdim=True).clamp_min(1e-12)
        return p / n * math.pi, n[..., 0]

    p0, n0 = aux_phi(0)
    p1, _ = aux_phi(1)
    fallback = torch.where((n0 > eps)[..., None], p0, p1)
    degenerate = (torch.linalg.norm(phi, dim=-1) < eps) & opposite
    phi = torch.where(degenerate[..., None], fallback, phi)

    sin_theta = torch.linalg.norm(phi, dim=-1)
    cos_theta = torch.sum(s * t, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)
    theta = torch.where(degenerate, torch.full_like(theta, math.pi), theta)
    omega = safe_divide(phi, sin_theta[..., None])
    return rodrigues_rotation_formula(omega, theta)


def quaternion_product(x, y):
    """Hamilton product, scalar-first."""
    xw, xx, xy, xz = x.unbind(-1)
    yw, yx, yy, yz = y.unbind(-1)
    return torch.stack([
        xw * yw - xx * yx - xy * yy - xz * yz,
        xx * yw + xw * yx + xy * yz - xz * yy,
        xy * yw + xw * yy + xz * yx - xx * yz,
        xz * yw + xw * yz + xx * yy - xy * yx,
    ], dim=-1)


def quaternion_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quaternion_rotate(q, x):
    """y = q * x * q^-1 over pure quaternions."""
    xq = torch.cat([torch.zeros_like(x[..., :1]), x], dim=-1)
    yq = quaternion_product(quaternion_product(q, xq), quaternion_conjugate(q))
    return yq[..., 1:]


def apply_rotation(points, rotation):
    """R @ p over [*, N, 3]."""
    return points @ rotation.transpose(-1, -2)

