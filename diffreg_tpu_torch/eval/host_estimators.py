"""Host pose estimators for metric-audit runs: OpenCV's PnP, and the choice
of backend with the fallback to the device estimators.

Counterpart of the JAX package's eval/host_estimators.py. The device
estimators (``eval/ransac.py``, ``eval/pnp.py``) are the pairs/s path; a
metric audit against the reference's tables runs the reference's own host
estimator, so that a difference in the solver is not read as one in the
network:

- ``pnp_pose_opencv``: cv2.solvePnPRansac with the reference's settings
  (SOLVEPNP_P3P, 5000 iterations, 8 px tolerance, the (v, u) -> (u, v)
  pixel transposition), as the JAX package calls it; ``eval.pnp_backend:
  opencv`` and the 2D-3D ``parity_eval`` run it.

As the JAX package's main does, a config that asks for a host estimator on a
machine without its library runs the device estimator instead, with a
warning. The Open3D RANSAC (``eval.pose_backend: open3d``, the 3D
``parity_eval``) has no port: where open3d imports the port refuses the
config rather than run another estimator than the one asked for.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# backend -> (config key, the library's import name, the device fallback)
_BACKENDS = {"open3d": ("pose_backend", "open3d", "device RANSAC"),
             "opencv": ("pnp_backend", "cv2", "device PnP")}


def has_module(name: str) -> bool:
    """Whether the library ``name`` (an import name of ``_BACKENDS``) imports."""
    try:
        __import__(name)
        return True
    except ImportError:
        return False


def resolve_backend(backend: str, logger=None) -> str:
    """The backend to run for a config's ``backend``: "device" as it is; a
    host backend whose library is missing falls back to "device" with the JAX
    package's warning; "opencv" where cv2 imports; "open3d" where open3d
    imports raises NotImplementedError (no port)."""
    if backend == "device":
        return backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown estimator backend {backend!r} (device, open3d or opencv)")
    key, library, fallback = _BACKENDS[backend]
    if has_module(library):
        if backend == "opencv":
            return backend
        raise NotImplementedError(
            f"eval.{key}={backend}: the Open3D RANSAC (eval/host_estimators.py of the JAX "
            "package) has no port; use the device estimator")
    if logger is not None:
        logger.warning(f"eval.{key}={backend} but {library} is not installed — falling back "
                       f"to the {fallback}")
    return "device"


def pnp_pose_opencv(corr_points: np.ndarray, corr_pixels: np.ndarray, intrinsics: np.ndarray,
                    distortion: Optional[np.ndarray] = None, num_iterations: int = 5000,
                    distance_tolerance: float = 8.0,
                    transposed: bool = True) -> Optional[np.ndarray]:
    """cv2.solvePnPRansac -> [4, 4] camera-from-cloud transform (float64), or
    None below 4 correspondences or when cv2 finds no pose. ``corr_points``
    [C, 3]; ``corr_pixels`` [C, 2], (v, u) when ``transposed``; ``intrinsics``
    [3, 3]."""
    import cv2

    corr_points = np.asarray(corr_points, np.float64)
    corr_pixels = np.asarray(corr_pixels, np.float64)
    if corr_points.shape[0] < 4:
        return None
    if transposed:
        corr_pixels = corr_pixels[..., ::-1].copy()   # (v, u) -> (u, v)
    if distortion is None:
        distortion = np.zeros((4, 1))
    ok, axis_angle, translation, _ = cv2.solvePnPRansac(
        corr_points, corr_pixels, np.asarray(intrinsics, np.float64), distortion,
        iterationsCount=num_iterations, reprojectionError=distance_tolerance,
        flags=cv2.SOLVEPNP_P3P)
    if not ok or axis_angle is None:
        return None
    rotation, _ = cv2.Rodrigues(axis_angle)
    transform = np.eye(4)
    transform[:3, :3] = rotation
    transform[:3, 3] = translation[:, 0]
    return transform
