"""EPro-PnP: probabilistic PnP with a differentiable LM solver.

Counterpart of the JAX package's geometry/epropnp.py (the reference's
Diff-Reg-2d3d/ops/pnp/: epropnp.py, levenberg_marquardt.py, camera.py,
cost_fun.py, common.py, distributions.py), in eager PyTorch on the device of
its inputs:

  * the trust-region LM loop keeps per-object accept/reject state as masks,
    a fixed number of iterations with no read back to the host (its solves
    and inverses are the ``_ex`` forms, which leave the factorization's status
    on the device);
  * ``torch.multinomial`` without replacement becomes Gumbel top-k with ties
    to the lower index, as in JAX;
  * the AMIS loop runs its few iterations with the triangular proposal-mixture
    log-prob bookkeeping of the reference;
  * the Student-t, von Mises/uniform mixture and angular central Gaussian
    proposals are sample/log-prob functions; von Mises sampling is the
    Best-Fisher rejection sampler, whose rounds are the one loop that reads
    the device (whether every draw was accepted), as JAX's while_loop does;
  * ``safe_cholesky`` substitutes a default factor where the factorization
    fails, chosen on the device from ``cholesky_ex``'s status.

Conventions match the reference: pose is [x, y, z, yaw] (4 DoF) or
[x, y, z, w, i, j, k] (6 DoF, scalar-first unit quaternion); the weights
``w2d`` are per axis; the camera is a pinhole ``cam_mats`` [*, 3, 3].

Randomness: the functions that draw take ``rng``, a ``torch.Generator`` on
the inputs' device or a draw source (``utils/draws.py``), and split it where
the JAX functions split their keys. The LM solve runs without gradients;
gradients flow through ``gn_step``/``pose_add`` and the AMIS cost terms, not
through the proposal fits.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.topk import stable_top_k
from ..utils.draws import as_draws
from .so3 import quaternion_to_matrix, skew_symmetric_matrix

# ---------------------------------------------------------------------------
# rotation parameterizations
# ---------------------------------------------------------------------------


def yaw_to_rot_mat(yaw):
    """Rotation about +Y by ``yaw`` radians. [...] -> [..., 3, 3]."""
    s, c = torch.sin(yaw), torch.cos(yaw)
    z = torch.zeros_like(yaw)
    o = torch.ones_like(yaw)
    rows = torch.stack([c, z, s, z, o, z, -s, z, c], dim=-1)
    return rows.reshape(yaw.shape + (3, 3))


def _pose_to_rot(pose):
    """pose [..., 4 or 7] -> rotation [..., 3, 3]."""
    if pose.shape[-1] == 4:
        return yaw_to_rot_mat(pose[..., 3])
    return quaternion_to_matrix(pose[..., 3:])


def get_quaternion_transform_mat(quaternions):
    """Tangent-space delta (3) -> quaternion-embedding delta (4): [..., 4] ->
    [..., 4, 3]."""
    w, i, j, k = quaternions.unbind(-1)
    rows = torch.stack([i, j, k,
                        -w, -k, j,
                        k, -w, -i,
                        -j, i, -w], dim=-1)
    return rows.reshape(quaternions.shape[:-1] + (4, 3))


def _matvec(mat, vec):
    return (mat @ vec[..., None])[..., 0]


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _solve(a, b):
    """a^-1 b for b [..., n], the status left on the device (NaN/inf where
    a is singular, as XLA gives)."""
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def _inv(a):
    return torch.linalg.inv_ex(a)[0]


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------


class PerspectiveCamera(NamedTuple):
    """Pinhole camera batch; ``lb``/``ub`` are optional [..., 2] pixel bounds
    (both or neither)."""
    cam_mats: torch.Tensor           # [*, 3, 3]
    z_min: float = 0.1
    lb: Optional[torch.Tensor] = None
    ub: Optional[torch.Tensor] = None

    @staticmethod
    def from_img_shape(cam_mats, img_shape, allowed_border=200):
        """Bounds from an [h, w] image shape."""
        lb = torch.full(img_shape.shape[:-1] + (2,), -0.5 - allowed_border,
                        dtype=cam_mats.dtype, device=cam_mats.device)
        ub = img_shape.flip(-1).to(cam_mats.dtype) + (-0.5 + allowed_border)
        return PerspectiveCamera(cam_mats, lb=lb, ub=ub)


def camera_project(x3d, pose, camera: PerspectiveCamera, with_jac: bool,
                   clip_jac: bool = True):
    """Project, and (optionally) the pose-tangent Jacobian: x3d [*, n, 3],
    pose [*, 4 or 7] -> x2d_proj [*, n, 2] and jac [*, n, 2, dof] (dof 4 or
    6) or None."""
    dof = 4 if pose.shape[-1] == 4 else 6
    rot = _pose_to_rot(pose)
    x3d_rot = x3d @ rot.transpose(-1, -2)
    x2dh = (x3d_rot + pose[..., None, :3]) @ camera.cam_mats.transpose(-1, -2)
    zcam = torch.clamp(x2dh[..., 2:3], min=camera.z_min)
    x2d_proj = x2dh[..., :2] / zcam

    lb, ub = camera.lb, camera.ub
    if lb is not None and ub is not None:
        x2d_proj = torch.minimum(torch.maximum(x2d_proj, lb[..., None, :]), ub[..., None, :])

    if not with_jac:
        return x2d_proj, None

    k2 = camera.cam_mats[..., None, :2, :2]                       # [*, 1, 2, 2]
    d_xy = k2 / zcam[..., None]                                   # [*, n, 2, 2]
    d_z = (camera.cam_mats[..., None, :2, 2:3] - x2d_proj[..., None]) / zcam[..., None]
    if dof == 4:
        d_xzcam_d_yaw = torch.stack((x3d_rot[..., 2], -x3d_rot[..., 0]), dim=-1)[..., None]
        d_rot = torch.cat([d_xy[..., :1], d_z], dim=-1) @ d_xzcam_d_yaw
    else:
        d_rot = torch.cat([d_xy, d_z], dim=-1) @ skew_symmetric_matrix(x3d_rot * 2)
    jac = torch.cat([d_xy, d_z, d_rot], dim=-1)                    # [*, n, 2, dof]

    if clip_jac:
        clip_mask = zcam == camera.z_min
        if lb is not None and ub is not None:
            clip_mask = clip_mask | (x2d_proj == lb[..., None, :]) \
                | (x2d_proj == ub[..., None, :])
        jac = torch.where(clip_mask[..., None], torch.zeros_like(jac), jac)
    return x2d_proj, jac


# ---------------------------------------------------------------------------
# Huber cost
# ---------------------------------------------------------------------------


class HuberPnPCost(NamedTuple):
    """delta is a scalar or a [*] per-object tensor."""
    delta: torch.Tensor
    eps: float = 1e-10


def adaptive_huber_delta(x2d, w2d, relative_delta=0.5):
    """AdaptiveHuberPnPCost.set_param (unbiased variance, as torch's)."""
    x2d_std = torch.sqrt(torch.var(x2d, dim=-2, correction=1).sum(dim=-1))
    return w2d.mean(dim=(-2, -1)) * x2d_std * relative_delta


def _delta(cost_fun, like):
    return torch.as_tensor(cost_fun.delta, dtype=like.dtype, device=like.device)


def evaluate_pnp(x3d, x2d, w2d, pose, camera: PerspectiveCamera,
                 cost_fun: HuberPnPCost, with_jac: bool = False,
                 clip_jac: bool = True):
    """Residual, cost and Jacobian of the robust reprojection objective.
    Returns (residual [*, 2n], cost [*], jacobian [*, 2n, dof] or None)."""
    n = x2d.shape[-2]
    x2d_proj, jac_cam = camera_project(x3d, pose, camera, with_jac, clip_jac)
    delta = _delta(cost_fun, x2d)[..., None]                      # [*, 1]
    residual = (x2d_proj - x2d) * w2d                             # [*, n, 2]
    s_sqrt = torch.linalg.norm(residual, dim=-1)                  # [*, n]
    half_rho = torch.where(s_sqrt <= delta, 0.5 * torch.square(s_sqrt),
                           delta * s_sqrt - 0.5 * torch.square(delta))
    cost = half_rho.sum(dim=-1)
    rho_d_sqrt = torch.sqrt(torch.clamp(delta / torch.clamp(s_sqrt, min=cost_fun.eps),
                                        max=1.0))
    residual = (residual * rho_d_sqrt[..., None]).reshape(residual.shape[:-2] + (n * 2,))
    jacobian = None
    if with_jac:
        jacobian = (jac_cam * (w2d * rho_d_sqrt[..., None])[..., None]
                    ).reshape(jac_cam.shape[:-3] + (n * 2, jac_cam.shape[-1]))
    return residual, cost, jacobian


# ---------------------------------------------------------------------------
# normalization helpers
# ---------------------------------------------------------------------------


def pnp_normalize(x3d, pose=None, detach_transformation=True):
    offset = torch.mean(x3d.detach() if detach_transformation else x3d, dim=-2)
    x3d_norm = x3d - offset[..., None, :]
    pose_norm = None
    if pose is not None:
        t = pose[..., :3] + _matvec(_pose_to_rot(pose), offset)
        pose_norm = torch.cat([t, pose[..., 3:]], dim=-1)
    return offset, x3d_norm, pose_norm


def pnp_denormalize(offset, pose_norm):
    t = pose_norm[..., :3] - _matvec(_pose_to_rot(pose_norm), offset)
    return torch.cat([t, pose_norm[..., 3:]], dim=-1)


# ---------------------------------------------------------------------------
# LM solver
# ---------------------------------------------------------------------------


class LMConfig(NamedTuple):
    """Solver constants."""
    dof: int = 4
    num_iter: int = 10
    min_lm_diagonal: float = 1e-6
    max_lm_diagonal: float = 1e32
    min_relative_decrease: float = 1e-3
    initial_trust_region_radius: float = 30.0
    max_trust_region_radius: float = 1e16
    eps: float = 1e-5


def pose_add(pose, step, dof: int):
    """Apply a tangent-space step."""
    if dof == 4:
        return pose + step
    q = pose[..., 3:] + _matvec(get_quaternion_transform_mat(pose[..., 3:]), step[..., 3:])
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([pose[..., :3] + step[..., :3], q], dim=-1)


def _normal_equations(jac, res):
    """(J^T J, J^T r)."""
    return jac.transpose(-1, -2) @ jac, _matvec(jac.transpose(-1, -2), res)


def gn_step(x3d, x2d, w2d, pose, camera, cost_fun, dof: int, eps=1e-5):
    """One differentiable Gauss-Newton step: the LM solve runs without
    gradients, then ``pose_add(pose, gn_step(...))`` backpropagates through
    one linearized solve."""
    residual, _, jac = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun, with_jac=True)
    jtj, gradient = _normal_equations(jac, residual)
    return -_solve(jtj + _eye(dof, jac) * eps, gradient)


def _lm_trust_region(x3d, x2d, w2d, camera, cost_fun, pose0, cfg: LMConfig):
    """Fixed-iteration trust-region core: the reference's in-place masked
    writes of (pose, jac, residual, cost, radius, decrease factor, success)
    are selects on the device."""
    def eval_fn(pose):
        return evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun, with_jac=True,
                            clip_jac=True)

    res, c, jac = eval_fn(pose0)
    pose = pose0
    jac_n, res_n, c_n = jac, res, c
    batch = pose0.shape[:-1]
    radius = torch.full(batch, cfg.initial_trust_region_radius, dtype=pose0.dtype,
                        device=pose0.device)
    dfac = torch.full(batch, 2.0, dtype=pose0.dtype, device=pose0.device)
    ok = torch.zeros(batch, dtype=torch.bool, device=pose0.device)
    eye = _eye(cfg.dof, pose0)
    for _ in range(cfg.num_iter):
        # adopt the last iteration's accepted candidate
        jac = torch.where(ok[..., None, None], jac_n, jac)
        res = torch.where(ok[..., None], res_n, res)
        c = torch.where(ok, c_n, c)

        jtj, gradient = _normal_equations(jac, res)
        diag = torch.diagonal(jtj, dim1=-2, dim2=-1)
        lm_add = torch.clamp(diag, cfg.min_lm_diagonal, cfg.max_lm_diagonal) \
            / radius[..., None] + cfg.eps
        step = -_solve(jtj + eye * lm_add[..., None, :], gradient)

        pose_new = pose_add(pose, step, cfg.dof)
        res_n, c_n, jac_n = eval_fn(pose_new)

        # model cost change and acceptance
        mcc = -torch.sum(step * (_matvec(jtj, step) / 2 + gradient), dim=-1)
        rd = (c - c_n) / mcc
        ok = (rd >= cfg.min_relative_decrease) & (mcc > 0.0)

        pose = torch.where(ok[..., None], pose_new, pose)
        # the reference's order: the accepted shrink, a global clamp, then the
        # rejected division (so a rejected radius can dip below eps)
        grow = torch.clamp(1.0 - (2.0 * rd - 1.0) ** 3, min=1.0 / 3.0)
        radius = torch.where(ok, radius / grow, radius)
        radius = torch.clamp(radius, cfg.eps, cfg.max_trust_region_radius)
        radius = torch.where(ok, radius, radius / dfac)
        dfac = torch.where(ok, torch.full_like(dfac, 2.0), dfac * 2.0)

    # final adoption for the covariance and cost outputs
    jac = torch.where(ok[..., None, None], jac_n, jac)
    c = torch.where(ok, c_n, c)
    jtj = jac.transpose(-1, -2) @ jac + eye * cfg.eps
    return pose, jtj, c


def _lm_fast(x3d, x2d, w2d, camera, cost_fun, pose0, cfg: LMConfig):
    """fast_mode: plain Gauss-Newton, no trust region, unclipped Jacobian. The
    J^T J and cost returned are those of the last iteration's pre-update pose,
    as the reference's loop leaves them."""
    pose = pose0
    jtj = torch.zeros(pose0.shape[:-1] + (cfg.dof, cfg.dof), dtype=pose0.dtype,
                      device=pose0.device)
    c = torch.zeros(pose0.shape[:-1], dtype=pose0.dtype, device=pose0.device)
    for _ in range(cfg.num_iter):
        res, c, jac = evaluate_pnp(x3d, x2d, w2d, pose, camera, cost_fun, with_jac=True,
                                   clip_jac=False)
        jtj, gradient = _normal_equations(jac, res)
        jtj = jtj + _eye(cfg.dof, jac) * cfg.eps
        step = -_solve(jtj, gradient)
        pose = pose + step if cfg.dof == 4 else pose_add(pose, step, 6)
    return pose, jtj, c


def _detach_camera(camera):
    return camera._replace(
        cam_mats=camera.cam_mats.detach(),
        lb=None if camera.lb is None else camera.lb.detach(),
        ub=None if camera.ub is None else camera.ub.detach())


def lm_solve(x3d, x2d, w2d, camera, cost_fun, pose_init, cfg: LMConfig,
             fast_mode: bool = False):
    """LMSolver.solve from a given initialization. Returns (pose_opt [*, 4 or
    7], pose_cov [*, dof, dof], cost [*]), all without gradients, as torch's
    no_grad solve; ``gn_step``/``pose_add`` give the differentiable
    pose_opt_plus."""
    core = _lm_fast if fast_mode else _lm_trust_region
    with torch.no_grad():
        delta = cost_fun.delta
        cost_sg = cost_fun._replace(
            delta=delta.detach() if isinstance(delta, torch.Tensor) else delta)
        pose, jtj, cost = core(x3d.detach(), x2d.detach(), w2d.detach(),
                               _detach_camera(camera), cost_sg, pose_init.detach(), cfg)
        return pose, _inv(jtj), cost


class RSLMConfig(NamedTuple):
    """Random-sample LM initializer."""
    num_points: int = 16
    num_proposals: int = 64
    lm: LMConfig = LMConfig(num_iter=3)


def center_based_init(x2d, x3d, camera, dof: int, eps=1e-6):
    """Scale-matching translation init."""
    x2dh = torch.cat([x2d, torch.ones_like(x2d[..., :1])], dim=-1)
    x2dc = torch.linalg.solve_ex(camera.cam_mats, x2dh.transpose(-1, -2))[0].transpose(-1, -2)
    x2dc = x2dc[..., :2] / torch.clamp(x2dc[..., 2:], min=eps)
    x2dc_mean = x2dc.mean(dim=-2)
    x2dc_std = torch.std(x2dc, dim=-2, correction=1)
    x3d_std = torch.std(x3d, dim=-2, correction=1)
    mh = torch.cat([x2dc_mean, torch.ones_like(x2dc_mean[..., :1])], dim=-1)
    if dof == 4:
        scale = x3d_std[..., 1] / torch.clamp(x2dc_std[..., 1], min=eps)
    else:
        scale = math.sqrt(2 / 3) * torch.linalg.norm(x3d_std, dim=-1) \
            / torch.clamp(torch.linalg.norm(x2dc_std, dim=-1), min=eps)
    return mh * scale[..., None]


def _take_rows(x, inds):
    """x [B, n, C] gathered along n by inds [P, B, S] -> [P, B, S, C]."""
    p = inds.shape[0]
    src = x[None].expand((p,) + x.shape)
    return torch.gather(src, 2, inds[..., None].expand(inds.shape + x.shape[-1:]))


def rslm_solve(rng, x3d, x2d, w2d, camera, cost_fun, cfg: RSLMConfig,
               dof: int, fast_mode: bool = False, eps=1e-5):
    """RSLMSolver.solve: the best of ``num_proposals`` LM solves from random
    subsets. Returns (pose [B, 4 or 7], min_cost [B])."""
    bs, pn, _ = x2d.shape
    P, S = cfg.num_proposals, cfg.num_points
    k_inds, k_rot = as_draws(rng).split(2)

    # multinomial without replacement of the mean weights == Gumbel top-k
    mean_w = w2d.mean(dim=-1).expand(P, bs, pn)
    gumbel = k_inds.gumbel((P, bs, pn), x2d.dtype)
    _, inds = stable_top_k(torch.log(torch.clamp(mean_w, min=1e-30)) + gumbel, S)

    x2d_s, x3d_s, w2d_s = _take_rows(x2d, inds), _take_rows(x3d, inds), _take_rows(w2d, inds)

    t_init = center_based_init(x2d, x3d, camera, dof).expand(P, bs, 3)
    if dof == 4:
        yaw = k_rot.uniform((P, bs, 1), x2d.dtype) * (2 * math.pi)
        pose_init = torch.cat([t_init, yaw], dim=-1)
    else:
        q = k_rot.normal((P, bs, 4), x2d.dtype)
        q_norm = torch.linalg.norm(q, dim=-1, keepdim=True)
        pole = torch.tensor([1.0, 0, 0, 0], dtype=x2d.dtype, device=x2d.device)
        q = torch.where(q_norm < eps, pole, q / torch.clamp(q_norm, min=eps))
        pose_init = torch.cat([t_init, q], dim=-1)

    cam_p = camera._replace(
        cam_mats=camera.cam_mats.expand(P, bs, 3, 3),
        lb=None if camera.lb is None else camera.lb.expand(P, bs, 2),
        ub=None if camera.ub is None else camera.ub.expand(P, bs, 2))
    cost_p = cost_fun._replace(delta=_delta(cost_fun, x2d).expand(P, bs))

    pose, _, _ = lm_solve(x3d_s, x2d_s, w2d_s, cam_p, cost_p, pose_init,
                          cfg.lm._replace(dof=dof), fast_mode=fast_mode)
    # score every proposal on the whole set and keep the best
    _, cost_all, _ = evaluate_pnp(x3d[None], x2d[None], w2d[None], pose, camera, cost_fun)
    best = torch.argmin(cost_all, dim=0)
    pose = torch.gather(pose, 0, best[None, :, None].expand((1,) + pose.shape[1:]))[0]
    return pose, torch.amin(cost_all, dim=0)


def lm_solver(x3d, x2d, w2d, camera, cost_fun, cfg: LMConfig,
              rs_cfg: Optional[RSLMConfig] = None, rng=None, pose_init=None,
              cost_init=None, force_init_solve: bool = False,
              with_pose_opt_plus: bool = False, fast_mode: bool = False,
              normalize: bool = False):
    """LMSolver.forward with the initializer's arbitration: without
    ``pose_init`` (or with ``force_init_solve``) the RSLM initializer runs;
    with both, the lower cost wins per object. Returns (pose_opt, pose_cov,
    cost, pose_opt_plus)."""
    transform = None
    if normalize:
        transform, x3d, pose_init = pnp_normalize(x3d, pose_init)

    if pose_init is None or force_init_solve:
        assert rs_cfg is not None and rng is not None, \
            "init solver required when pose_init is None or force_init_solve"
        if pose_init is None:
            pose0, _ = rslm_solve(rng, x3d, x2d, w2d, camera, cost_fun, rs_cfg, cfg.dof,
                                  fast_mode=fast_mode)
        else:
            if cost_init is None:
                _, cost_init, _ = evaluate_pnp(x3d, x2d, w2d, pose_init, camera, cost_fun)
            pose_solve, cost_solve = rslm_solve(rng, x3d, x2d, w2d, camera, cost_fun,
                                                rs_cfg, cfg.dof, fast_mode=fast_mode)
            pose0 = torch.where((cost_init < cost_solve)[..., None], pose_init, pose_solve)
    else:
        pose0 = pose_init

    pose_opt, pose_cov, cost = lm_solve(x3d, x2d, w2d, camera, cost_fun, pose0, cfg,
                                        fast_mode=fast_mode)

    pose_opt_plus = None
    if with_pose_opt_plus:
        step = gn_step(x3d, x2d, w2d, pose_opt, camera, cost_fun, cfg.dof, cfg.eps)
        pose_opt_plus = pose_add(pose_opt, step, cfg.dof)

    if normalize:
        pose_opt = pnp_denormalize(transform, pose_opt)
        if pose_opt_plus is not None:
            pose_opt_plus = pnp_denormalize(transform, pose_opt_plus)
    return pose_opt, pose_cov, cost, pose_opt_plus


# ---------------------------------------------------------------------------
# proposal distributions
# ---------------------------------------------------------------------------


def safe_cholesky(mat, default_diag=None):
    """cholesky_wrapper: where the factorization fails (or yields NaN), a
    default factor instead, chosen on the device (``cholesky_ex`` does not
    raise or read back its status)."""
    n = mat.shape[-1]
    tril, info = torch.linalg.cholesky_ex(mat)
    if default_diag is not None:
        default = torch.diag(torch.as_tensor(default_diag, dtype=mat.dtype, device=mat.device))
    else:
        default = _eye(n, mat)
    bad = (info > 0)[..., None, None] | torch.isnan(tril).any(dim=-1, keepdim=True) \
        .any(dim=-2, keepdim=True)
    return torch.where(bad, default, tril)


def _mahalanobis_sq(scale_tril, x):
    """||L^-1 x||^2 with a batched lower-triangular L (batch dims broadcast)."""
    n = x.shape[-1]
    batch = torch.broadcast_shapes(scale_tril.shape[:-2], x.shape[:-1])
    tril = scale_tril.expand(batch + (n, n))
    xb = x.expand(batch + (n,))
    y = torch.linalg.solve_triangular(tril, xb[..., None], upper=False)[..., 0]
    return torch.sum(torch.square(y), dim=-1)


def _half_log_det(scale_tril):
    return torch.log(torch.diagonal(scale_tril, dim1=-2, dim2=-1)).sum(-1)


def mvt_log_prob(x, loc, scale_tril, df: float = 3.0):
    """Multivariate Student-t log-density (pyro's MultivariateStudentT)."""
    p = x.shape[-1]
    m = _mahalanobis_sq(scale_tril, x - loc)
    return (math.lgamma((df + p) / 2) - math.lgamma(df / 2)
            - 0.5 * p * math.log(df * math.pi) - _half_log_det(scale_tril)
            - 0.5 * (df + p) * torch.log1p(m / df))


def mvt_sample(rng, loc, scale_tril, sample_shape: Tuple[int, ...], df: float = 3.0):
    """x = loc + (L z) sqrt(df / chi2_df)."""
    kz, kg = as_draws(rng).split(2)
    shape = tuple(sample_shape) + tuple(loc.shape)
    z = kz.normal(shape, loc.dtype)
    chi2 = 2.0 * kg.gamma(df / 2.0, shape[:-1], loc.dtype)
    return loc + _matvec(scale_tril, z) * torch.sqrt(df / chi2)[..., None]


def von_mises_log_prob(x, loc, kappa):
    """VM(loc, kappa) log-density through the exponentially scaled Bessel I0."""
    return kappa * torch.cos(x - loc) - math.log(2 * math.pi) \
        - (torch.log(torch.special.i0e(kappa)) + kappa)


def von_mises_sample(rng, loc, kappa, sample_shape: Tuple[int, ...]):
    """Best-Fisher (1979) rejection sampler, every draw of a round at once;
    rounds repeat until every draw is accepted (one read of the device a
    round). A tiny kappa takes the uniform draw, its limit, and no rounds
    (in f32 its draws are never accepted)."""
    rng = as_draws(rng)
    shape = tuple(sample_shape) + tuple(loc.shape)
    kappa_b = kappa.expand(shape)
    kappa_s = torch.clamp(kappa_b, min=1e-7)
    tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa_s * kappa_s)
    rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa_s)
    r = (1.0 + rho * rho) / (2.0 * rho)

    k = rng
    done = kappa_b < 1e-6
    theta = torch.zeros(shape, dtype=loc.dtype, device=loc.device)
    while not bool(done.all()):
        k, k1, k2, k3 = k.split(4)
        u1 = k1.uniform(shape, loc.dtype)
        u2 = k2.uniform(shape, loc.dtype)
        u3 = k3.uniform(shape, loc.dtype)
        z = torch.cos(math.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa_s * (r - f)
        accept = (c * (2.0 - c) - u2 > 0.0) \
            | (torch.log(torch.clamp(c, min=1e-30) / u2) + 1.0 - c >= 0.0)
        new_theta = torch.sign(u3 - 0.5) * torch.arccos(torch.clamp(f, -1.0, 1.0))
        theta = torch.where(done, theta, torch.where(accept, new_theta, theta))
        done = done | accept
    sample = theta + loc
    uni = rng.fold_in(1).uniform(shape, loc.dtype, -math.pi, math.pi)
    return torch.where(kappa_b < 1e-6, uni, sample)


def vm_uniform_mix_log_prob(x, loc, kappa, uniform_mix=0.25):
    """VonMisesUniformMix.log_prob."""
    vm = von_mises_log_prob(x, loc, kappa) + math.log(1 - uniform_mix)
    return torch.logaddexp(vm, torch.full_like(vm, math.log(uniform_mix / (2 * math.pi))))


def vm_uniform_mix_sample(rng, loc, kappa, n_samples: int, uniform_mix=0.25):
    """VonMisesUniformMix.sample: the first round(n * mix) samples along axis 0
    are uniform, the rest von Mises (the reference's deterministic split)."""
    n_uni = round(n_samples * uniform_mix)
    ku, kv = as_draws(rng).split(2)
    uni = ku.uniform((n_uni,) + tuple(loc.shape), loc.dtype, -math.pi, math.pi)
    vm = von_mises_sample(kv, loc, kappa, (n_samples - n_uni,))
    return torch.cat([uni, vm], dim=0)


def acg_log_prob(x, scale_tril, eps=1e-6):
    """AngularCentralGaussian.log_prob."""
    q = x.shape[-1]
    area = 2 * math.pi ** (0.5 * q) / math.gamma(0.5 * q)
    m = _mahalanobis_sq(scale_tril, x)
    return torch.log(m) * (-q / 2) - _half_log_det(scale_tril) - math.log(area)


def acg_sample(rng, scale_tril, sample_shape: Tuple[int, ...], eps=1e-6):
    """AngularCentralGaussian.rsample."""
    q = scale_tril.shape[-1]
    shape = tuple(sample_shape) + tuple(scale_tril.shape[:-2]) + (q,)
    z = as_draws(rng).normal(shape, scale_tril.dtype)
    g = _matvec(scale_tril, z)
    norm = torch.linalg.norm(g, dim=-1, keepdim=True)
    pole = torch.zeros(q, dtype=scale_tril.dtype, device=scale_tril.device)
    pole[0] = 1.0
    return torch.where(norm < eps, pole, g / torch.clamp(norm, min=eps))


# ---------------------------------------------------------------------------
# EPro-PnP Monte Carlo forward
# ---------------------------------------------------------------------------


def _weighted_translation(samples, w):
    """Weighted mean and covariance of the samples' translations, w [S, B]."""
    t = samples[..., :3]
    trans_mode = (w[..., None] * t).sum(dim=0)
    dev = t - trans_mode
    trans_cov = torch.einsum("sb,sbi,sbj->bij", w, dev, dev)
    return trans_mode, trans_cov


class EProPnP4DoF(NamedTuple):
    """AMIS config, 4 DoF: Student-t position proposal and von Mises/uniform
    mixture yaw proposal."""
    mc_samples: int = 512
    num_iter: int = 4
    eps: float = 1e-5

    @property
    def iter_samples(self):
        assert self.mc_samples % self.num_iter == 0
        return self.mc_samples // self.num_iter

    def initial_fit(self, pose_opt, pose_cov, camera):
        trans_mode = pose_opt[..., :3]
        trans_tril = safe_cholesky(pose_cov[..., :3, :3], [1.0, 1.0, 4.0])
        rot_mode = pose_opt[..., 3:]
        rot_kappa = 0.33 / torch.clamp(pose_cov[..., 3:, 3], min=self.eps)
        return trans_mode, trans_tril, rot_mode, rot_kappa

    def sample(self, rng, params, n):
        trans_mode, trans_tril, rot_mode, rot_kappa = params
        kt, kr = as_draws(rng).split(2)
        t = mvt_sample(kt, trans_mode, trans_tril, (n,))
        yaw = vm_uniform_mix_sample(kr, rot_mode[..., 0], rot_kappa[..., 0], n)
        return torch.cat([t, yaw[..., None]], dim=-1)

    def log_prob(self, params, pose):
        trans_mode, trans_tril, rot_mode, rot_kappa = params
        return mvt_log_prob(pose[..., :3], trans_mode, trans_tril) \
            + vm_uniform_mix_log_prob(pose[..., 3], rot_mode[..., 0], rot_kappa[..., 0])

    def estimate_params(self, samples, logweights, camera):
        """Weighted re-fit of both proposals."""
        w = torch.softmax(logweights, dim=0)                      # [S, B]
        trans_mode, trans_cov = _weighted_translation(samples, w)
        trans_tril = safe_cholesky(trans_cov, [1.0, 1.0, 4.0])
        sin_m = (w * torch.sin(samples[..., 3])).sum(dim=0)
        cos_m = (w * torch.cos(samples[..., 3])).sum(dim=0)
        rot_mode = torch.atan2(sin_m, cos_m)[..., None]
        r_sq = (sin_m ** 2 + cos_m ** 2)[..., None]
        rot_kappa = 0.33 * torch.clamp(torch.sqrt(r_sq), min=self.eps) \
            * (2 - r_sq) / torch.clamp(1 - r_sq, min=self.eps)
        return trans_mode, trans_tril, rot_mode, rot_kappa


class EProPnP6DoF(NamedTuple):
    """AMIS config, 6 DoF: Student-t position proposal and angular central
    Gaussian quaternion proposal."""
    mc_samples: int = 512
    num_iter: int = 4
    eps: float = 1e-5
    acg_mle_iter: int = 3
    acg_dispersion: float = 0.001

    @property
    def iter_samples(self):
        assert self.mc_samples % self.num_iter == 0
        return self.mc_samples // self.num_iter

    def _disperse(self, rot_cov):
        eye4 = _eye(4, rot_cov)
        return safe_cholesky(rot_cov + torch.linalg.det(rot_cov)[..., None, None] ** 0.25
                             * (self.acg_dispersion * eye4))

    def initial_fit(self, pose_opt, pose_cov, camera):
        trans_mode = pose_opt[..., :3]
        trans_tril = safe_cholesky(pose_cov[..., :3, :3])
        eye4 = _eye(4, pose_opt)
        tmat = get_quaternion_transform_mat(pose_opt[..., 3:])
        rot_cov = _inv(tmat @ _inv(pose_cov[..., 3:, 3:]) @ tmat.transpose(-1, -2) + eye4)
        rot_cov = rot_cov / torch.diagonal(rot_cov, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        return trans_mode, trans_tril, self._disperse(rot_cov)

    def sample(self, rng, params, n):
        trans_mode, trans_tril, rot_tril = params
        kt, kr = as_draws(rng).split(2)
        t = mvt_sample(kt, trans_mode, trans_tril, (n,))
        q = acg_sample(kr, rot_tril, (n,), self.eps)
        return torch.cat([t, q], dim=-1)

    def log_prob(self, params, pose):
        trans_mode, trans_tril, rot_tril = params
        return mvt_log_prob(pose[..., :3], trans_mode, trans_tril) \
            + acg_log_prob(pose[..., 3:], rot_tril)

    def estimate_params(self, samples, logweights, camera):
        """Weighted Student-t re-fit and the fixed-point ACG MLE."""
        w = torch.softmax(logweights, dim=0)                      # [S, B]
        trans_mode, trans_cov = _weighted_translation(samples, w)
        trans_tril = safe_cholesky(trans_cov)
        eye4 = _eye(4, samples)
        rot = samples[..., 3:]                                    # [S, B, 4]
        rrt = rot[..., :, None] * rot[..., None, :]               # [S, B, 4, 4]
        rot_cov = eye4.expand(trans_cov.shape[:-2] + (4, 4))
        for _ in range(self.acg_mle_iter):
            m = torch.einsum("sbi,bij,sbj->sb", rot, _inv(rot_cov), rot)
            inv_m = w / torch.clamp(m, min=self.eps)
            inv_m = inv_m / inv_m.sum(dim=0)
            rot_cov = torch.einsum("sb,sbij->bij", inv_m, rrt) + eye4 * self.eps
        return trans_mode, trans_tril, self._disperse(rot_cov)


def monte_carlo_forward(rng, cfg, x3d, x2d, w2d, camera, cost_fun,
                        lm_cfg: LMConfig, rs_cfg: RSLMConfig,
                        pose_init=None, force_init_solve: bool = True,
                        normalize: bool = False):
    """EProPnPBase.monte_carlo_forward: adaptive multiple importance sampling
    over the pose posterior. ``cfg`` is an EProPnP4DoF or EProPnP6DoF.
    Returns (pose_opt, cost, pose_opt_plus, pose_samples [mc, B, d],
    pose_sample_logweights [mc, B], cost_init). The log-weights are
    differentiable with respect to (x3d, x2d, w2d), as in torch: the proposal
    parameters are fit without gradients, the integrand's cost is not."""
    transform = None
    if normalize:
        transform, x3d, pose_init = pnp_normalize(x3d, pose_init)

    cost_init = None
    if pose_init is not None:
        _, cost_init, _ = evaluate_pnp(x3d, x2d, w2d, pose_init, camera, cost_fun)

    k_solve, k_mc = as_draws(rng).split(2)
    pose_opt, pose_cov, cost, pose_opt_plus = lm_solver(
        x3d, x2d, w2d, camera, cost_fun, lm_cfg, rs_cfg, k_solve,
        pose_init=pose_init, cost_init=cost_init,
        force_init_solve=force_init_solve, with_pose_opt_plus=True)

    n_iter, n_s = cfg.num_iter, cfg.iter_samples
    with torch.no_grad():
        params = [cfg.initial_fit(pose_opt, pose_cov, camera)]
    samples = []                                   # per iteration [n_s, B, d]
    costs = []                                     # per iteration [n_s, B]
    # logp[i][j]: proposal i evaluated on iteration j's samples
    logp = [[None] * n_iter for _ in range(n_iter)]
    logweights = None
    keys = k_mc.split(n_iter)

    for i in range(n_iter):
        with torch.no_grad():
            samples.append(cfg.sample(keys[i], params[i], n_s))
        costs.append(evaluate_pnp(x3d, x2d, w2d, samples[i], camera, cost_fun)[1])
        with torch.no_grad():
            for j in range(i + 1):
                logp[i][j] = cfg.log_prob(params[i], samples[j])
            for j in range(i):
                logp[j][i] = cfg.log_prob(params[j], samples[i])
            # the mixture over proposals 0..i for samples 0..i
            stacked = torch.stack([torch.stack(logp[d][:i + 1], dim=0)
                                   for d in range(i + 1)], dim=0)
            mix = torch.logsumexp(stacked, dim=0) - math.log(i + 1)
        logweights = -torch.stack(costs, dim=0) - mix          # [i+1, n_s, B]
        if i == n_iter - 1:
            break
        with torch.no_grad():
            flat_s = torch.cat(samples, dim=0)
            flat_w = logweights.detach().reshape((-1,) + logweights.shape[2:])
            params.append(cfg.estimate_params(flat_s, flat_w, camera))

    pose_samples = torch.cat(samples, dim=0)                   # [mc, B, d]
    pose_sample_logweights = logweights.reshape((cfg.mc_samples,) + logweights.shape[2:])

    if normalize:
        pose_opt = pnp_denormalize(transform, pose_opt)
        pose_samples = pnp_denormalize(transform, pose_samples)
        if pose_opt_plus is not None:
            pose_opt_plus = pnp_denormalize(transform, pose_opt_plus)
    return (pose_opt, cost, pose_opt_plus, pose_samples, pose_sample_logweights, cost_init)
