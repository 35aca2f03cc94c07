"""Host pose estimators (Open3D's RANSAC, OpenCV's PnP): availability and the
fallback to the device estimators.

The JAX package's eval/host_estimators.py runs the reference's host
estimators for metric-audit runs (``eval.pose_backend: open3d``,
``eval.pnp_backend: opencv``, or ``parity_eval``, which asks for both). The
port has no host estimator yet (ROADMAP §1 item 6). As the JAX package's
main does, a config that asks for one on a machine without its library runs
the device estimator instead, with a warning; where the library imports,
the port refuses the config rather than run another estimator than the one
asked for.
"""
from __future__ import annotations

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
    package's warning; one whose library imports raises NotImplementedError."""
    if backend == "device":
        return backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown estimator backend {backend!r} (device, open3d or opencv)")
    key, library, fallback = _BACKENDS[backend]
    if has_module(library):
        raise NotImplementedError(
            f"eval.{key}={backend}: the host estimators (eval/host_estimators.py of the JAX "
            "package) are not ported yet (ROADMAP §1 item 6); use the device estimator")
    if logger is not None:
        logger.warning(f"eval.{key}={backend} but {library} is not installed — falling back "
                       f"to the {fallback}")
    return "device"
