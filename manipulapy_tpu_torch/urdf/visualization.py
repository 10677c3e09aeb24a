"""URDF robot visualization: matplotlib skeleton + optional PyBullet.

Counterpart of ``manipulapy_tpu/urdf/visualization.py``, the same code.

Counterpart of the reference's ``urdf/visualization/`` package
(``pybullet_viz.py``, ``trimesh_viz.py``; facade ``show_robot`` /
``animate_robot`` at ``visualization/__init__.py:19-94``). The always-
available backend here is matplotlib (a 3D line skeleton through the
kinematic tree with joint markers and geometry bounding hints); PyBullet
is an optional backend gated exactly like the reference's, erroring at
call time with an actionable message rather than at import.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["show_robot", "animate_robot", "show_pybullet", "animate_pybullet"]


def _skeleton_segments(urdf, cfg: Optional[Dict[str, float]] = None):
    """(parent_pos, child_pos) world-frame segments for every joint, plus
    per-link origins — the minimal wireframe of the kinematic tree."""
    fk = urdf.link_fk(cfg or {})
    segments = []
    for joint in urdf.joints:
        if joint.parent in fk and joint.child in fk:
            segments.append((fk[joint.parent][:3, 3], fk[joint.child][:3, 3]))
    origins = {name: T[:3, 3] for name, T in fk.items()}
    return segments, origins


def _draw(ax, urdf, cfg, show_names: bool):
    segments, origins = _skeleton_segments(urdf, cfg)
    for a, b in segments:
        ax.plot([a[0], b[0]], [a[1], b[1]], [a[2], b[2]], "-", color="tab:blue", lw=2)
    pts = np.array(list(origins.values()))
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color="tab:red", s=20)
    if show_names:
        for name, p in origins.items():
            ax.text(p[0], p[1], p[2], name, fontsize=7)
    # Equal-ish aspect so the arm isn't distorted.
    span = max(pts.max(axis=0) - pts.min(axis=0)) or 1.0
    mid = (pts.max(axis=0) + pts.min(axis=0)) / 2
    for setter, m in zip((ax.set_xlim, ax.set_ylim, ax.set_zlim), mid):
        setter(m - 0.6 * span, m + 0.6 * span)
    ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")


def show_robot(
    urdf,
    cfg: Optional[Dict[str, float]] = None,
    backend: str = "matplotlib",
    show_names: bool = False,
    title: Optional[str] = None,
):
    """Render the robot at configuration ``cfg``.

    ``backend="matplotlib"`` returns a Figure (headless-safe);
    ``backend="pybullet"`` opens a PyBullet client (requires pybullet).
    Reference: ``show_robot`` (``urdf/visualization/__init__.py:19``).
    """
    if backend == "pybullet":
        return show_pybullet(urdf, cfg)
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")
    _draw(ax, urdf, cfg, show_names)
    ax.set_title(title or urdf.name)
    return fig


def animate_robot(
    urdf,
    cfgs: Sequence[Dict[str, float]],
    backend: str = "matplotlib",
    interval_ms: int = 50,
):
    """Animate a sequence of configurations.

    Matplotlib backend returns a ``FuncAnimation`` (save with
    ``.save(path)``); PyBullet backend steps the GUI in real time.
    Reference: ``animate_robot`` (``urdf/visualization/__init__.py:53``).
    """
    if backend == "pybullet":
        return animate_pybullet(urdf, cfgs, dt=interval_ms / 1000.0)
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(111, projection="3d")

    def update(i):
        ax.cla()
        _draw(ax, urdf, cfgs[i], show_names=False)
        ax.set_title(f"{urdf.name}  frame {i + 1}/{len(cfgs)}")
        return ()

    return FuncAnimation(fig, update, frames=len(cfgs), interval=interval_ms, blit=False)


def _require_pybullet():
    try:
        import pybullet  # noqa: F401

        return pybullet
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "PyBullet visualization requires pybullet: pip install pybullet"
        ) from e


def show_pybullet(urdf, cfg=None, gui: bool = True):  # pragma: no cover - needs display
    """Load the URDF into a PyBullet client and pose it (reference
    ``show_pybullet``, ``urdf/visualization/pybullet_viz.py:26``)."""
    import tempfile

    p = _require_pybullet()
    client = p.connect(p.GUI if gui else p.DIRECT)
    from .modifiers import urdf_to_xml

    with tempfile.NamedTemporaryFile("w", suffix=".urdf", delete=False) as f:
        f.write(urdf_to_xml(urdf.robot))
        path = f.name
    body = p.loadURDF(path, useFixedBase=True, physicsClientId=client)
    if cfg:
        names = {p.getJointInfo(body, i)[1].decode(): i for i in range(p.getNumJoints(body))}
        for name, val in cfg.items():
            if name in names:
                p.resetJointState(body, names[name], val, physicsClientId=client)
    return client, body


def animate_pybullet(urdf, cfgs, dt: float = 0.05):  # pragma: no cover - needs display
    """Replay configurations in a PyBullet GUI (reference
    ``animate_pybullet``, ``urdf/visualization/pybullet_viz.py:46``)."""
    import time

    p = _require_pybullet()
    client, body = show_pybullet(urdf, cfgs[0] if cfgs else None)
    names = {p.getJointInfo(body, i)[1].decode(): i for i in range(p.getNumJoints(body))}
    for cfg in cfgs:
        for name, val in cfg.items():
            if name in names:
                p.resetJointState(body, names[name], val, physicsClientId=client)
        time.sleep(dt)
    return client, body
