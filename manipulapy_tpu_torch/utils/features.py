"""Feature availability detection and dependency reporting.

Counterpart of ``manipulapy_tpu/utils/features.py``: optional extras are
probed with ``importlib.util.find_spec``, never imported, and the
user-facing ``check_dependencies`` / ``get_installation_command`` /
``require_feature`` / ``test_installation`` keep their contracts. The
feature map is the JAX one with the port's stack: ``core`` is torch and
numpy; the JAX ``"tpu"`` feature becomes ``"cuda"`` (a CUDA device that
PyTorch sees, and ``nvcc`` to build the kernels); ``"mesh"`` is more than
one CUDA device; ``"checkpoint"`` needs only numpy (the port's checkpoint
has no orbax counterpart).
"""

from __future__ import annotations

import importlib.util
from typing import Dict, List, Optional

import torch

# feature -> list of (module, pip package) requirements.
_FEATURE_DEPS: Dict[str, List[tuple]] = {
    "core": [("torch", "torch"), ("numpy", "numpy")],
    "simulation": [("pybullet", "pybullet")],
    "vision": [("cv2", "opencv-python")],
    "yolo": [("ultralytics", "ultralytics")],
    "ml": [("torch", "torch"), ("sklearn", "scikit-learn")],
    "checkpoint": [("numpy", "numpy")],
}

_INSTALL_HINTS = {
    "simulation": "pip install pybullet",
    "vision": "pip install opencv-python",
    "yolo": "pip install ultralytics",
    "ml": "pip install scikit-learn",
}

_available_features: Optional[Dict[str, bool]] = None
_missing: Dict[str, List[Dict[str, str]]] = {}


def _check_dependency(module_name: str, package_name: str, feature: str) -> bool:
    """True if ``module_name`` is importable — probed WITHOUT importing."""
    try:
        spec = importlib.util.find_spec(module_name)
    except (ImportError, ValueError):
        spec = None
    available = spec is not None
    if not available:
        _missing.setdefault(feature, []).append({"module": module_name, "package": package_name})
    return available


def _cuda_available() -> bool:
    """True if PyTorch sees a CUDA device and ``nvcc`` resolves."""
    from ..ops._build import nvcc_path

    if not torch.cuda.is_available():
        return False
    try:
        nvcc_path()
    except RuntimeError:
        return False
    return True


def get_available_features(refresh: bool = False) -> Dict[str, bool]:
    """Which optional features are usable in this environment."""
    global _available_features
    if _available_features is not None and not refresh:
        return dict(_available_features)

    _missing.clear()
    feats: Dict[str, bool] = {}
    for feature, deps in _FEATURE_DEPS.items():
        feats[feature] = all(_check_dependency(m, p, feature) for m, p in deps)
    feats["cuda"] = _cuda_available()
    feats["mesh"] = torch.cuda.device_count() > 1
    _available_features = feats
    return dict(feats)


def missing_dependencies() -> Dict[str, List[Dict[str, str]]]:
    """Per-feature list of missing {module, package} entries."""
    get_available_features()
    return {k: list(v) for k, v in _missing.items()}


def get_installation_command(feature: str) -> str:
    """The pip command that enables ``feature`` (empty if none needed)."""
    return _INSTALL_HINTS.get(feature, "")


def require_feature(feature: str) -> None:
    """Raise ``ImportError`` with an actionable message if unavailable."""
    feats = get_available_features()
    if feature not in feats:
        raise ValueError(f"unknown feature {feature!r}; known: {sorted(feats)}")
    if not feats[feature]:
        hint = get_installation_command(feature)
        missing = ", ".join(d["package"] for d in _missing.get(feature, [])) or feature
        raise ImportError(
            f"feature {feature!r} requires: {missing}." + (f" Install with: {hint}" if hint else "")
        )


def check_dependencies(verbose: bool = True) -> Dict[str, bool]:
    """Print (optionally) and return the feature availability table."""
    feats = get_available_features(refresh=True)
    if verbose:
        print("manipulapy_tpu_torch feature availability")
        print("=" * 40)
        for feature in sorted(feats):
            status = "available" if feats[feature] else "NOT available"
            print(f"{feature:<12}: {status}")
            for dep in _missing.get(feature, []):
                print(f"    missing {dep['module']} ({dep['package']})")
        hints = [_INSTALL_HINTS[f] for f in sorted(feats) if not feats[f] and f in _INSTALL_HINTS]
        if hints:
            print("\nTo enable missing features:")
            for h in hints:
                print(f"  {h}")
    return feats


def test_installation(device=None) -> bool:
    """Smoke-test the core stack: model build, FK, inverse dynamics and one
    rollout. True if the core library works.

    On ``device`` (the card unless the caller names the CPU): the UR5, its
    FK and inverse dynamics, then a float32 rollout of a (4, 6) batch over
    3 waypoints, which a card serves with the K1 kernel (``ops/dispatch.py``)
    as the JAX function's one jit is its compiled program.
    """
    try:
        from ..dynamics import inverse_dynamics
        from ..kinematics import forward_kinematics
        from ..models import catalog
        from ..trajectory import forward_dynamics_trajectory

        model = catalog.ur5(device=device)
        q = torch.zeros(model.num_joints, dtype=model.dtype, device=model.device)
        T = forward_kinematics(model, q)
        tau = inverse_dynamics(model, q, q, q)
        f32 = dict(dtype=torch.float32, device=model.device)
        q0 = torch.zeros((4, model.num_joints), **f32)
        qs, dqs, ddqs = forward_dynamics_trajectory(model, q0, q0, torch.zeros((4, 3, model.num_joints), **f32))
        return all(bool(torch.isfinite(x).all()) for x in (T, tau, qs, dqs, ddqs))
    except Exception:
        return False
