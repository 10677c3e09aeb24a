"""Matplotlib plotting utilities (host-side, non-jit).

Counterpart of the reference's scattered plotting surface: trajectory /
TCP / EE plots (``path_planning.py:1928-2232``), annotated step-response
plots (``control.py:680-847``), manipulability-ellipsoid rendering
(``singularity.py:69-133``) and the Monte-Carlo workspace trisurf
(``singularity.py:186-214``). Counterpart of ``manipulapy_tpu/plotting.py``:
all functions take tensors on any device or NumPy arrays, pull them to
the host, and return the matplotlib ``Figure`` so callers can save or
show; nothing here touches the device path.

Matplotlib is imported lazily so the compute stack never pays for it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "plot_trajectory",
    "plot_ee_trajectory",
    "plot_cartesian_trajectory",
    "plot_step_response",
    "plot_manipulability_ellipsoid",
    "plot_workspace",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)  # headless-safe default
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_trajectory(
    trajectory,
    Tf: Optional[float] = None,
    title: str = "Joint trajectory",
    joint_names: Optional[Sequence[str]] = None,
):
    """Position/velocity/acceleration vs time for an (N, J) trajectory.

    ``trajectory`` is a :class:`~manipulapy_tpu_torch.trajectory.Trajectory`
    NamedTuple or any object with ``position/velocity/acceleration``
    (reference ``plot_trajectory``, ``path_planning.py:1928``).
    """
    plt = _plt()
    pos = _np(trajectory.position)
    vel = _np(trajectory.velocity)
    acc = _np(trajectory.acceleration)
    N, J = pos.shape
    t = np.linspace(0.0, Tf if Tf is not None else 1.0, N)
    names = joint_names or [f"joint {j}" for j in range(J)]

    fig, axes = plt.subplots(3, 1, figsize=(9, 8), sharex=True)
    for data, ax, label in zip((pos, vel, acc), axes, ("position", "velocity", "acceleration")):
        for j in range(J):
            ax.plot(t, data[:, j], label=names[j] if label == "position" else None)
        ax.set_ylabel(label)
        ax.grid(True, alpha=0.3)
    axes[0].legend(loc="upper right", fontsize=8)
    axes[-1].set_xlabel("time [s]")
    fig.suptitle(title)
    fig.tight_layout()
    return fig


def plot_ee_trajectory(positions, title: str = "End-effector path"):
    """3D path of (N, 3) end-effector positions (reference
    ``plot_tcp_trajectory``/``plot_ee_trajectory``)."""
    plt = _plt()
    p = _np(positions)
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot(p[:, 0], p[:, 1], p[:, 2], "-", lw=1.5)
    ax.scatter(*p[0], color="green", label="start")
    ax.scatter(*p[-1], color="red", label="goal")
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
    ax.legend()
    ax.set_title(title)
    return fig


def plot_cartesian_trajectory(trajectory, Tf: Optional[float] = None):
    """Cartesian (N, 3) pos/vel/acc triple plot + 3D path in one figure."""
    plt = _plt()
    pos = _np(trajectory.position)
    N = pos.shape[0]
    t = np.linspace(0.0, Tf if Tf is not None else 1.0, N)
    fig = plt.figure(figsize=(11, 5))
    ax3d = fig.add_subplot(121, projection="3d")
    ax3d.plot(pos[:, 0], pos[:, 1], pos[:, 2])
    ax3d.set_title("path")
    ax = fig.add_subplot(122)
    for k, lbl in enumerate("xyz"):
        ax.plot(t, pos[:, k], label=lbl)
    ax.set_xlabel("time [s]"); ax.set_ylabel("position [m]")
    ax.legend(); ax.grid(True, alpha=0.3)
    fig.tight_layout()
    return fig


def plot_step_response(t, y, setpoint, metrics: Optional[dict] = None, title: str = "Step response"):
    """Step response with rise/overshoot/settling annotations
    (reference ``plot_steady_state_response``, ``control.py:680-847``).

    ``metrics`` defaults to :func:`manipulapy_tpu_torch.control.step_response_metrics`.
    """
    plt = _plt()
    t = _np(t); y = _np(y)
    if metrics is None:
        from .control import step_response_metrics

        metrics = step_response_metrics(torch.as_tensor(t), torch.as_tensor(y), _np(setpoint))
    metrics = {k: float(_np(v).reshape(-1)[0]) for k, v in metrics.items()}

    fig, ax = plt.subplots(figsize=(9, 5))
    ax.plot(t, y if y.ndim == 1 else y[:, 0], lw=1.5, label="response")
    sp = float(_np(setpoint).reshape(-1)[0])
    ax.axhline(sp, color="k", ls="--", alpha=0.6, label="setpoint")
    ax.axhline(sp * 1.02, color="gray", ls=":", alpha=0.5)
    ax.axhline(sp * 0.98, color="gray", ls=":", alpha=0.5)
    for key, color in (("rise_time", "green"), ("settling_time", "orange")):
        v = metrics.get(key, float("nan"))
        if np.isfinite(v):
            ax.axvline(v, color=color, ls="--", alpha=0.6, label=f"{key}={v:.3f}s")
    if "percent_overshoot" in metrics:
        ax.set_title(f"{title} (overshoot {metrics['percent_overshoot']:.1f}%)")
    else:
        ax.set_title(title)
    ax.set_xlabel("time [s]"); ax.set_ylabel("output")
    ax.legend(); ax.grid(True, alpha=0.3)
    return fig


def plot_manipulability_ellipsoid(ellipsoid, center=(0.0, 0.0, 0.0), title: str = "Manipulability ellipsoid"):
    """Render an :class:`~manipulapy_tpu_torch.singularity.Ellipsoid`
    (radii + principal axes) as a 3D surface (reference
    ``manipulability_ellipsoid`` plotting, ``singularity.py:69-133``)."""
    plt = _plt()
    radii = _np(ellipsoid.radii)
    axes = _np(ellipsoid.axes)
    c = _np(center)
    u = np.linspace(0, 2 * np.pi, 40)
    v = np.linspace(0, np.pi, 20)
    x = np.outer(np.cos(u), np.sin(v))
    y = np.outer(np.sin(u), np.sin(v))
    z = np.outer(np.ones_like(u), np.cos(v))
    pts = np.stack([x, y, z], axis=-1) * radii  # scale in principal frame
    pts = pts @ axes.T + c  # rotate into world frame

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(pts[..., 0], pts[..., 1], pts[..., 2], alpha=0.4, cmap="viridis")
    ax.set_title(title)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    return fig


def plot_workspace(points, title: str = "Monte-Carlo workspace", max_points: int = 20000):
    """Scatter of (N, 3) reachable positions from
    :func:`~manipulapy_tpu_torch.singularity.monte_carlo_workspace`
    (reference trisurf plot, ``singularity.py:186-214``)."""
    plt = _plt()
    p = _np(points)
    if p.shape[0] > max_points:
        idx = np.linspace(0, p.shape[0] - 1, max_points).astype(int)
        p = p[idx]
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(p[:, 0], p[:, 1], p[:, 2], s=1, alpha=0.3)
    ax.set_title(f"{title} ({p.shape[0]} samples)")
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
    return fig
