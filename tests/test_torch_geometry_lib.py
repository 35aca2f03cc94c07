"""The port's library geometry against the JAX package's, on the CPU: SO(3),
embedded deformation with its two non-rigid ICP solvers, and EPro-PnP.

Inputs are made with numpy from a seed; random draws are JAX's own, replayed
through ``torch_jax_draws.JaxDraws`` (the RSLM Gumbel draws and initial
rotations, the Student-t normal and gamma draws, the von Mises rounds and
uniform draws, the ACG normal draws, AMIS's per-iteration draws), so every
sampler and ``monte_carlo_forward`` are held entry by entry. The port's own
draws from a ``torch.Generator`` cannot be replayed: those samplers are held
by their statistics (``test_own_draws_statistics``).

Limits: elementwise f32 within 1e-6 of the largest entry of JAX's result
(``assert_rel``); the solvers at the limits stated beside them, each with
its reason.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffreg_tpu.geometry import deformation as jax_deformation
from diffreg_tpu.geometry import epropnp as jep
from diffreg_tpu.geometry import so3 as jax_so3
from diffreg_tpu_torch.geometry import deformation, so3
from diffreg_tpu_torch.geometry import epropnp as ep
from torch_jax_draws import JaxDraws

T = torch.from_numpy
REL = 1e-6


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rel_err(got, ref):
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def assert_rel(got, ref, rel=REL):
    err = rel_err(got, ref)
    assert err <= rel, err


# ---------------------------------------------------------------- SO(3)


def _so3_inputs():
    rng = np.random.RandomState(0)
    phi = rng.randn(12, 3).astype(np.float32)
    phi[0] = 0.0                                             # zero angle
    phi[1] = np.array([math.pi, 0, 0], np.float32)           # angle pi
    phi[2] = np.array([0, 0, -math.pi], np.float32)
    q = rng.randn(12, 4).astype(np.float32)
    q[3, 0] = -abs(q[3, 0])                                  # w < 0: the angle folds
    q[4] = [1, 0, 0, 0]
    q[5] = [0, 1, 0, 0]                                      # half turn
    src, tgt = rng.randn(2, 12, 3).astype(np.float32)
    tgt[0] = src[0] * 2.0                                    # parallel
    tgt[1] = -src[1]                                         # antiparallel
    src[2], tgt[2] = [1, 0, 0], [-1, 0, 0]                   # antiparallel on aux axis 0
    src[3], tgt[3] = [0, 0, 2], [0, 0, -1]
    pts = rng.randn(12, 7, 3).astype(np.float32)
    axes = rng.randn(12, 3)
    axes = (axes / np.linalg.norm(axes, axis=1, keepdims=True)).astype(np.float32)
    return phi, q, src, tgt, pts, axes


SO3_CASES = {
    "skew_symmetric_matrix": lambda m, phi, q, s, t, p, a: m.skew_symmetric_matrix(phi),
    "rodrigues_rotation_formula": lambda m, phi, q, s, t, p, a:
        m.rodrigues_rotation_formula(a, phi[..., 0]),
    "axis_angle_to_rotation_matrix": lambda m, phi, q, s, t, p, a:
        m.axis_angle_to_rotation_matrix(phi),
    "axis_angle_to_quaternion": lambda m, phi, q, s, t, p, a: m.axis_angle_to_quaternion(phi),
    "quaternion_to_axis_angle": lambda m, phi, q, s, t, p, a: m.quaternion_to_axis_angle(q),
    "rotation_matrix_to_axis_angle": lambda m, phi, q, s, t, p, a:
        m.rotation_matrix_to_axis_angle(m.axis_angle_to_rotation_matrix(phi)),
    "alignment_rotation_matrix": lambda m, phi, q, s, t, p, a: m.alignment_rotation_matrix(s, t),
    "quaternion_product": lambda m, phi, q, s, t, p, a: m.quaternion_product(q, 0.5 * q + 0.1),
    "quaternion_conjugate": lambda m, phi, q, s, t, p, a: m.quaternion_conjugate(q),
    "quaternion_rotate": lambda m, phi, q, s, t, p, a: m.quaternion_rotate(q, s),
    "apply_rotation": lambda m, phi, q, s, t, p, a:
        m.apply_rotation(p, m.axis_angle_to_rotation_matrix(phi)),
    "quaternion_to_matrix": lambda m, phi, q, s, t, p, a: m.quaternion_to_matrix(
        m.axis_angle_to_quaternion(phi)),
}


@pytest.mark.parametrize("name", sorted(SO3_CASES))
def test_so3(name):
    """Every SO(3) function, with zero and pi angles, a w < 0 quaternion, and
    parallel and antiparallel alignments (both auxiliary axes)."""
    inputs = _so3_inputs()
    ref = SO3_CASES[name](jax_so3, *map(jnp.asarray, inputs))
    got = SO3_CASES[name](so3, *[T(np.ascontiguousarray(x)) for x in inputs])
    assert_rel(got, ref)
    assert np.isfinite(_np(got)).all()


def test_alignment_edges_rotate_onto_target():
    _, _, src, tgt, _, _ = _so3_inputs()
    r = so3.alignment_rotation_matrix(T(src), T(tgt)).numpy()
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", r, unit(src)), unit(tgt), atol=1e-5)


# ---------------------------------------------------------------- deformation


@pytest.fixture(scope="module")
def deform_case():
    """A graph of 10 nodes over 60 points under a smooth deformation; one JAX
    run of each solver."""
    rng = np.random.RandomState(1)
    pts = rng.rand(60, 3).astype(np.float32)
    nodes = pts[:10]
    d2 = ((pts[:, None] - nodes[None]) ** 2).sum(-1)
    anchors = np.argsort(d2, axis=1)[:, :4].astype(np.int32)
    weights = np.exp(-np.take_along_axis(d2, anchors, 1) / 0.1).astype(np.float32)
    anchors[:5, 3] = -1                                      # absent anchors
    nd2 = ((nodes[:, None] - nodes[None]) ** 2).sum(-1)
    nbr = np.argsort(nd2, axis=1)[:, :4]                     # first is the node itself
    edges = np.stack([np.repeat(np.arange(10), 4), nbr.reshape(-1)], 1).astype(np.int32)
    edge_w = rng.rand(len(edges)).astype(np.float32) + 0.5
    tgt = pts + 0.05 * np.sin(3 * pts[:, [1, 2, 0]]).astype(np.float32)
    args = (nodes, pts, tgt, anchors, weights, edges)
    ref_gn = jax_deformation.non_rigid_icp_gauss_newton(*map(jnp.asarray, args),
                                                        edge_weights=jnp.asarray(edge_w))
    ref_adam = jax_deformation.non_rigid_icp_adam(*map(jnp.asarray, args),
                                                  jnp.asarray(edge_w), num_iterations=500)
    return args, edge_w, ref_gn, ref_adam


def test_embedded_deformation_warps(deform_case):
    (nodes, pts, _, anchors, weights, _), _, _, _ = deform_case
    rng = np.random.RandomState(2)
    rot = np.array(jax_so3.axis_angle_to_rotation_matrix(
        jnp.asarray(0.3 * rng.randn(10, 3).astype(np.float32))))
    trn = 0.1 * rng.randn(10, 3).astype(np.float32)
    dense_w = rng.rand(60, 10).astype(np.float32)
    ref = jax_deformation.apply_embedded_deformation_dense(*map(jnp.asarray, (
        pts, nodes, rot, trn, dense_w)))
    assert_rel(deformation.apply_embedded_deformation_dense(*map(T, (pts, nodes, rot, trn,
                                                                     dense_w))), ref)
    ref = jax_deformation.apply_embedded_deformation(*map(jnp.asarray, (
        pts, nodes, rot, trn, anchors, weights)))
    assert_rel(deformation.apply_embedded_deformation(*map(T, (pts, nodes, rot, trn, anchors,
                                                               weights))), ref)


# Gauss-Newton: 5 damped dense solves of 60 unknowns; the packages agree to
# 7.8e-7 of the largest rotation/translation entry, each f32 package within
# 1.7e-6 of a float64 run of the port (measured): held at 1e-5.
GN_REL = 1e-5
# Adam: 500 steps of g / sqrt(nu). Where a gradient is f32 rounding noise, the
# noise sets full-size steps, so each f32 package lies 2.3e-4 (JAX) and
# 8.9e-4 (the port) from a float64 run of the port, and 6.6e-4 from the other
# (measured, of the largest entry): held at 2e-3.
ADAM_REL = 2e-3


def test_non_rigid_icp_gauss_newton(deform_case):
    args, edge_w, ref, _ = deform_case
    rot, trn = deformation.non_rigid_icp_gauss_newton(*map(T, args), edge_weights=T(edge_w))
    assert_rel(rot, ref[0], GN_REL)
    assert_rel(trn, ref[1], GN_REL)
    # the warp moves the points onto their targets
    nodes, pts, tgt, anchors, weights, _ = args
    warped = deformation.apply_embedded_deformation(T(pts), T(nodes), rot, trn, T(anchors),
                                                    T(weights)).numpy()
    assert np.abs(warped - tgt).mean() < 0.5 * np.abs(pts - tgt).mean()


def test_non_rigid_icp_adam(deform_case):
    args, edge_w, _, ref = deform_case
    rot, trn = deformation.non_rigid_icp_adam(*map(T, args), T(edge_w), num_iterations=500)
    assert_rel(rot, ref[0], ADAM_REL)
    assert_rel(trn, ref[1], ADAM_REL)


# ---------------------------------------------------------------- EPro-PnP


def _problem(seed, batch, n, dof, noise=0.5):
    """A synthetic pinhole PnP problem with a known pose (the JAX package's
    tests/test_epropnp.py setup, in f32)."""
    rng = np.random.RandomState(seed)
    k = np.array([[480.0, 0, 320], [0, 480.0, 240], [0, 0, 1]], np.float32)
    cam_mats = np.broadcast_to(k, (batch, 3, 3)).copy()
    x3d = rng.uniform(-1, 1, (batch, n, 3)).astype(np.float32)
    t = np.stack([rng.uniform(-0.5, 0.5, batch), rng.uniform(-0.5, 0.5, batch),
                  rng.uniform(4, 6, batch)], 1)
    if dof == 4:
        rot = rng.uniform(-0.5, 0.5, (batch, 1))
    else:
        rot = rng.normal(0, 1, (batch, 4))
        rot[:, 0] += 3.0
        rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    pose = np.concatenate([t, rot], axis=1).astype(np.float32)
    x2d, _ = jep.camera_project(jnp.asarray(x3d), jnp.asarray(pose),
                                jep.PerspectiveCamera(jnp.asarray(cam_mats)), with_jac=False)
    x2d = (np.asarray(x2d) + rng.normal(0, noise, (batch, n, 2))).astype(np.float32)
    w2d = rng.uniform(0.5, 1.5, (batch, n, 2)).astype(np.float32)
    return cam_mats, x3d, x2d, w2d, pose


def _objects(mod, conv, cam_mats, x2d, w2d, bounds=False):
    lb = ub = None
    if bounds:
        lb, ub = conv(np.full((len(cam_mats), 2), 100.0, np.float32)), \
            conv(np.full((len(cam_mats), 2), 500.0, np.float32))
    camera = mod.PerspectiveCamera(conv(cam_mats), lb=lb, ub=ub)
    return camera, mod.HuberPnPCost(delta=mod.adaptive_huber_delta(conv(x2d), conv(w2d)))


def _both(cam_mats, x2d, w2d, bounds=False):
    return (_objects(jep, jnp.asarray, cam_mats, x2d, w2d, bounds),
            _objects(ep, T, cam_mats, x2d, w2d, bounds))


@pytest.mark.parametrize("dof,bounds", [(4, False), (6, False), (6, True)])
def test_project_and_evaluate(dof, bounds):
    """The residuals are projections (~300 px) less their targets: an ulp of a
    projection is 3e-5 px there, so the residual and its robust rescaling are
    held at 1e-6 of the projections' largest entry times the largest weight."""
    cam_mats, x3d, x2d, w2d, pose = _problem(10 + dof, 3, 40, dof)
    pose = pose + np.float32(0.05)                           # away from the optimum
    (cam_j, cost_j), (cam_t, cost_t) = _both(cam_mats, x2d, w2d, bounds)
    assert_rel(cost_t.delta, cost_j.delta)
    ref = jax.jit(lambda a, b: jep.camera_project(a, b, cam_j, True))(jnp.asarray(x3d),
                                                                      jnp.asarray(pose))
    got = ep.camera_project(T(x3d), T(pose), cam_t, True)
    for g, r in zip(got, ref):
        assert_rel(g, r)
    scale = float(np.abs(np.asarray(ref[0])).max() * w2d.max())
    ref = jax.jit(lambda *a: jep.evaluate_pnp(*a, cam_j, cost_j, True))(
        *map(jnp.asarray, (x3d, x2d, w2d, pose)))
    got = ep.evaluate_pnp(*map(T, (x3d, x2d, w2d, pose)), cam_t, cost_t, True)
    assert float(np.abs(got[0].numpy() - np.asarray(ref[0])).max()) <= REL * scale
    assert_rel(got[1], ref[1])
    assert_rel(got[2], ref[2])


# One Gauss-Newton step near the optimum solves J^T J x = -J^T r on residuals
# that cancel (see test_project_and_evaluate): each f32 package lies 4e-5 to
# 8e-5 of the step's largest entry from a float64 run of the port (measured),
# and 1.1e-4 from the other: held at 5e-4.
GN_STEP_REL = 5e-4


@pytest.mark.parametrize("dof", [4, 6])
def test_normalize_pose_add_gn_step(dof):
    cam_mats, x3d, x2d, w2d, pose = _problem(20 + dof, 2, 30, dof)
    (cam_j, cost_j), (cam_t, cost_t) = _both(cam_mats, x2d, w2d)
    ref = jax.jit(jep.pnp_normalize)(jnp.asarray(x3d), jnp.asarray(pose))
    got = ep.pnp_normalize(T(x3d), T(pose))
    for g, r in zip(got, ref):
        assert_rel(g, r)
    assert_rel(ep.pnp_denormalize(got[0], got[2]), jep.pnp_denormalize(ref[0], ref[2]))
    ref_step = jax.jit(lambda *a: jep.gn_step(*a, cam_j, cost_j, dof))(
        *map(jnp.asarray, (x3d, x2d, w2d, pose)))
    step = ep.gn_step(*map(T, (x3d, x2d, w2d, pose)), cam_t, cost_t, dof)
    assert_rel(step, ref_step, GN_STEP_REL)
    assert_rel(ep.pose_add(T(pose), T(np.array(ref_step)), dof),
               jep.pose_add(jnp.asarray(pose), ref_step, dof))
    assert_rel(ep.center_based_init(T(x2d), T(x3d), cam_t, dof),
               jax.jit(lambda a, b: jep.center_based_init(a, b, cam_j, dof))(
                   jnp.asarray(x2d), jnp.asarray(x3d)))


# LM: 10 trust-region iterations from a perturbed pose in f32. The solves and
# the accept tests see f32 rounding differences; the poses agree to 2e-6 of
# their largest entry (measured), the covariance (an inverse of J^T J) and the
# cost to 3e-5: held at 1e-4.
LM_REL = 1e-4


@pytest.mark.parametrize("dof,fast", [(4, False), (6, False), (6, True)])
def test_lm_solve(dof, fast):
    cam_mats, x3d, x2d, w2d, pose = _problem(30 + dof, 3, 48, dof, noise=0.3)
    init = pose.copy()
    init[:, :3] += 0.1
    if dof == 6:
        init[:, 3:] = init[:, 3:] + 0.05
        init[:, 3:] /= np.linalg.norm(init[:, 3:], axis=1, keepdims=True)
    (cam_j, cost_j), (cam_t, cost_t) = _both(cam_mats, x2d, w2d)
    ref = jax.jit(lambda a, b, c, d: jep.lm_solve(a, b, c, cam_j, cost_j, d,
                                                  jep.LMConfig(dof=dof), fast_mode=fast))(
        *map(jnp.asarray, (x3d, x2d, w2d, init)))
    got = ep.lm_solve(*map(T, (x3d, x2d, w2d)), cam_t, cost_t, T(init), ep.LMConfig(dof=dof),
                      fast_mode=fast)
    for g, r in zip(got, ref):
        assert_rel(g, r, LM_REL)
    np.testing.assert_allclose(got[0].numpy()[:, :3], pose[:, :3], atol=0.05)


@pytest.mark.parametrize("dof", [4, 6])
def test_rslm_solve_replays_jax(dof):
    """Same Gumbel subsets and initial rotations (JAX's draws): the same best
    proposal, at LM_REL."""
    cam_mats, x3d, x2d, w2d, pose = _problem(40 + dof, 2, 40, dof, noise=0.3)
    (cam_j, cost_j), (cam_t, cost_t) = _both(cam_mats, x2d, w2d)
    key = jax.random.PRNGKey(40 + dof)
    cfg = jep.RSLMConfig(num_points=8, num_proposals=16)
    ref = jax.jit(lambda k, a, b, c: jep.rslm_solve(k, a, b, c, cam_j, cost_j, cfg, dof))(
        key, *map(jnp.asarray, (x3d, x2d, w2d)))
    got = ep.rslm_solve(JaxDraws(key), *map(T, (x3d, x2d, w2d)), cam_t, cost_t,
                        ep.RSLMConfig(num_points=8, num_proposals=16), dof)
    for g, r in zip(got, ref):
        assert_rel(g, r, LM_REL)


def test_safe_cholesky():
    good = np.eye(3, dtype=np.float32) * 2.0
    mats = np.stack([good, -np.eye(3, dtype=np.float32), np.full((3, 3), np.nan, np.float32)])
    ref = jep.safe_cholesky(jnp.asarray(mats), [1.0, 1.0, 4.0])
    assert_rel(ep.safe_cholesky(T(mats), [1.0, 1.0, 4.0]), ref)
    assert_rel(ep.safe_cholesky(T(mats)), jep.safe_cholesky(jnp.asarray(mats)))


def test_log_probs():
    rng = np.random.RandomState(50)
    a = rng.randn(3, 4, 4).astype(np.float32)
    tril = np.linalg.cholesky(a @ a.transpose(0, 2, 1) + np.eye(4, dtype=np.float32))
    x = rng.randn(5, 3, 4).astype(np.float32)
    loc = rng.randn(3, 4).astype(np.float32)
    assert_rel(ep.mvt_log_prob(T(x), T(loc), T(tril)),
               jep.mvt_log_prob(jnp.asarray(x), jnp.asarray(loc), jnp.asarray(tril)))
    assert_rel(ep.acg_log_prob(T(x), T(tril)), jep.acg_log_prob(jnp.asarray(x),
                                                                 jnp.asarray(tril)))
    ang, mu = rng.uniform(-3, 3, (6, 3)).astype(np.float32), rng.randn(3).astype(np.float32)
    kappa = np.array([0.1, 2.0, 50.0], np.float32)
    assert_rel(ep.von_mises_log_prob(T(ang), T(mu), T(kappa)),
               jep.von_mises_log_prob(jnp.asarray(ang), jnp.asarray(mu), jnp.asarray(kappa)))
    assert_rel(ep.vm_uniform_mix_log_prob(T(ang), T(mu), T(kappa)),
               jep.vm_uniform_mix_log_prob(jnp.asarray(ang), jnp.asarray(mu),
                                           jnp.asarray(kappa)))


def test_samplers_replay_jax():
    """Student-t, von Mises (every rejection round), the uniform mixture and
    the ACG, on JAX's draws."""
    rng = np.random.RandomState(51)
    a = rng.randn(3, 3, 3).astype(np.float32)
    tril3 = np.linalg.cholesky(a @ a.transpose(0, 2, 1) + np.eye(3, dtype=np.float32))
    b = rng.randn(3, 4, 4).astype(np.float32)
    tril4 = np.linalg.cholesky(b @ b.transpose(0, 2, 1) + np.eye(4, dtype=np.float32))
    loc = rng.randn(3, 3).astype(np.float32)
    mu = rng.randn(3).astype(np.float32)
    # (below kappa ~1e-6 the f32 rejection rounds of both packages never accept)
    kappa = np.array([0.05, 2.0, 50.0], np.float32)
    k = jax.random.PRNGKey(51)
    ref = jax.jit(lambda k, a, b, c, d, e: (
        jep.mvt_sample(k, a, b, (64,)), jep.von_mises_sample(k, c, d, (64,)),
        jep.vm_uniform_mix_sample(k, c, d, 64), jep.acg_sample(k, e, (64,))))(
        k, *map(jnp.asarray, (loc, tril3, mu, kappa, tril4)))
    assert_rel(ep.mvt_sample(JaxDraws(k), T(loc), T(tril3), (64,)), ref[0])
    # a von Mises draw near its mode is arccos(f) with f within ulps of 1: one
    # ulp of f (each package's own cos) moves it by sqrt(2 * 2^-24) = 3.5e-4 rad,
    # so those draws are held at 1e-3 rad
    for got, r in ((ep.von_mises_sample(JaxDraws(k), T(mu), T(kappa), (64,)), ref[1]),
                   (ep.vm_uniform_mix_sample(JaxDraws(k), T(mu), T(kappa), 64), ref[2])):
        assert float(np.abs(got.numpy() - np.asarray(r)).max()) <= 1e-3
    assert_rel(ep.acg_sample(JaxDraws(k), T(tril4), (64,)), ref[3])


def test_von_mises_tiny_kappa_takes_no_rounds():
    """Draws below kappa 1e-6 (never accepted in f32) take the uniform draw and
    no rejection rounds, so the sampler ends; the other draws of the call are
    those of a call where that kappa is one that does accept: identical."""
    gen_draws = lambda: JaxDraws(jax.random.PRNGKey(52))
    mu = T(np.array([0.3, -1.0, 2.0], np.float32))
    tiny = ep.von_mises_sample(gen_draws(), mu, T(np.array([1e-8, 2.0, 50.0], np.float32)), (64,))
    fine = ep.von_mises_sample(gen_draws(), mu, T(np.array([0.05, 2.0, 50.0], np.float32)), (64,))
    assert torch.equal(tiny[:, 1:], fine[:, 1:])
    assert bool(((tiny[:, 0] >= -np.pi) & (tiny[:, 0] <= np.pi)).all())


def test_own_draws_statistics():
    """The samplers on a torch.Generator, held by their statistics at 20,000
    draws: the von Mises circular mean within 0.03 rad and its resultant
    length within 0.02 of I1/I0 (standard errors ~0.003 and ~0.002 at kappa 2);
    the Student-t (df 3) median within 0.03 of its location; every ACG draw of
    unit norm, its second moment's leading eigenvector that of the scale."""
    from scipy.special import i0, i1

    gen = torch.Generator().manual_seed(0)
    n = 20000
    for kappa, loc in ((2.0, 0.5), (20.0, -1.0)):
        s = ep.von_mises_sample(gen, torch.tensor(loc), torch.tensor(kappa), (n,)).numpy()
        z = np.exp(1j * s.astype(np.float64)).mean()
        assert abs(np.angle(z) - loc) < 0.03
        assert abs(abs(z) - i1(kappa) / i0(kappa)) < 0.02
    t = ep.mvt_sample(gen, torch.tensor([1.0, -2.0, 0.5]), torch.eye(3), (n,)).numpy()
    np.testing.assert_allclose(np.median(t, axis=0), [1.0, -2.0, 0.5], atol=0.03)
    cov = np.diag([4.0, 1.0, 0.5, 0.25]).astype(np.float32)
    q = ep.acg_sample(gen, T(np.linalg.cholesky(cov)), (n,)).numpy()
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)
    emp = (q[:, :, None] * q[:, None, :]).mean(0)
    assert abs(np.linalg.eigh(emp)[1][0, -1]) > 0.999


# AMIS in float64 (JAX with x64 enabled, the port on float64 tensors, JAX's
# float64 draws), where the comparison sees the algorithm rather than f32
# rounding: in f32 the 6-DoF proposals (an inverse of J^T J's rotation block,
# dispersed and factored) leave each package 1e-3 to 1.5e-2 of the largest
# sample, log-weight and gradient entry from a float64 run, while in float64
# the packages agree to 1.6e-11 (measured): held at 1e-9. The f32 path is held
# card against CPU in chip_smoke's phase 24.
MC_REL = 1e-9


@pytest.fixture(scope="module", params=[4, 6])
def mc_case(request):
    """One JAX compile a DoF: the forward (4 DoF), or the forward with its
    gradient (6 DoF, whose proposals are the longer path)."""
    dof = request.param
    cam_mats, x3d, x2d, w2d, pose = [a.astype(np.float64) for a in
                                     _problem(60 + dof, 2, 48, dof, noise=0.3)]
    key = jax.random.PRNGKey(60 + dof)
    coef = np.random.RandomState(61).randn(96, 2)

    def run(mod, conv, rng, x2d_, w2d_):
        camera = mod.PerspectiveCamera(conv(cam_mats))
        cost = mod.HuberPnPCost(delta=mod.adaptive_huber_delta(x2d_, w2d_))
        cfg = (mod.EProPnP4DoF if dof == 4 else mod.EProPnP6DoF)(mc_samples=96, num_iter=3)
        out = mod.monte_carlo_forward(rng, cfg, conv(x3d), x2d_, w2d_, camera, cost,
                                      mod.LMConfig(dof=dof, num_iter=10), mod.RSLMConfig(),
                                      pose_init=conv(pose))
        loss = (out[4] * conv(coef)).sum() + out[2].sum()
        return loss, out

    jax.config.update("jax_enable_x64", True)
    try:
        args = (jnp.asarray(x2d), jnp.asarray(w2d))
        fn = lambda a, b: run(jep, jnp.asarray, key, a, b)
        if dof == 6:
            (_, ref), ref_grads = jax.jit(jax.value_and_grad(fn, argnums=(0, 1),
                                                             has_aux=True))(*args)
        else:
            (_, ref), ref_grads = jax.jit(fn)(*args), None
        x2d_t, w2d_t = T(x2d).requires_grad_(True), T(w2d).requires_grad_(True)
        loss, got = run(ep, T, JaxDraws(key), x2d_t, w2d_t)
    finally:
        jax.config.update("jax_enable_x64", False)
    got_grads = torch.autograd.grad(loss, (x2d_t, w2d_t))
    return pose, ref, got, ref_grads, got_grads


def test_monte_carlo_forward_entries(mc_case):
    """pose_opt, cost, pose_opt_plus, the samples, their log-weights and
    cost_init, entry by entry on JAX's draws."""
    pose, ref, got, _, _ = mc_case
    for g, r in zip(got, ref):
        assert_rel(g, r, MC_REL)
    np.testing.assert_allclose(got[0].detach().numpy()[:, :3], pose[:, :3], atol=0.05)


@pytest.mark.parametrize("mc_case", [6], indirect=True)
def test_monte_carlo_forward_gradients(mc_case):
    """d loss / d x2d and d loss / d w2d (through the AMIS costs and the
    Gauss-Newton step of pose_opt_plus) against jax.grad."""
    _, _, _, ref_grads, got_grads = mc_case
    for g, r in zip(got_grads, ref_grads):
        assert_rel(g, r, MC_REL)
