"""Geometry: the port's counterparts of the JAX package's geometry.

The names are those the JAX package's geometry/__init__.py exports, wherever
the port has them.
"""
from .epropnp import (EProPnP4DoF, EProPnP6DoF, HuberPnPCost, LMConfig, PerspectiveCamera,
                      RSLMConfig, adaptive_huber_delta, camera_project, evaluate_pnp, gn_step,
                      lm_solve, lm_solver, monte_carlo_forward, pose_add, rslm_solve,
                      safe_cholesky)
from .se3 import apply_transform, compose, inverse, rotation_error_deg, translation_error
from .procrustes import ProcrustesResult, soft_procrustes, weighted_kabsch
from .deformation import (apply_embedded_deformation, apply_embedded_deformation_dense,
                          non_rigid_icp_adam, non_rigid_icp_gauss_newton)
from .so3 import (alignment_rotation_matrix, apply_rotation, axis_angle_to_quaternion,
                  axis_angle_to_rotation_matrix, quaternion_conjugate, quaternion_product,
                  quaternion_rotate, quaternion_to_axis_angle, quaternion_to_matrix,
                  rodrigues_rotation_formula, rotation_matrix_to_axis_angle,
                  skew_symmetric_matrix)
