"""Perception: detection + clustering composition over Vision.

Counterpart of ``manipulapy_tpu/perception.py``, the same host-side NumPy:
detect obstacles through a :class:`~manipulapy_tpu_torch.vision.Vision`
instance (whose unprojection runs on its device) and cluster them with
DBSCAN (scikit-learn when present, else a small native implementation so
the core path has no ML dependency).
"""

from __future__ import annotations

import importlib.util
from typing import Optional, Tuple

import numpy as np

from .vision import Vision

__all__ = ["Perception", "dbscan_native"]


def dbscan_native(points: np.ndarray, eps: float, min_samples: int) -> np.ndarray:
    """Minimal exact DBSCAN (O(N^2), fine for obstacle counts): returns
    labels with -1 for noise — sklearn-compatible semantics."""
    n = len(points)
    labels = np.full(n, -1, dtype=int)
    if n == 0:
        return labels
    d = np.linalg.norm(points[:, None, :] - points[None, :, :], axis=-1)
    neighbors = [np.nonzero(d[i] <= eps)[0] for i in range(n)]
    core = np.array([len(nb) >= min_samples for nb in neighbors])
    cluster = 0
    visited = np.zeros(n, dtype=bool)
    for i in range(n):
        if visited[i] or not core[i]:
            continue
        # BFS expansion of a new cluster.
        stack = [i]
        visited[i] = True
        labels[i] = cluster
        while stack:
            j = stack.pop()
            for k in neighbors[j]:
                if labels[k] == -1:
                    labels[k] = cluster
                if not visited[k]:
                    visited[k] = True
                    if core[k]:
                        stack.append(k)
        cluster += 1
    return labels


class Perception:
    """Obstacle perception pipeline (reference ``Perception``)."""

    def __init__(self, vision: Optional[Vision] = None):
        self.vision = vision or Vision()

    def detect_and_cluster_obstacles(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        camera_index: int = 0,
        *,
        eps: float = 0.1,
        min_samples: int = 3,
        **detect_kwargs,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Capture -> detect -> DBSCAN-cluster (reference
        ``perception.py:100-167``). Returns (positions (N, 3), labels (N,))."""
        positions, _ = self.vision.detect_obstacles(
            rgb, depth, camera_index, **detect_kwargs
        )
        labels = self.cluster_obstacles(positions, eps=eps, min_samples=min_samples)[0]
        return positions, labels

    def cluster_obstacles(
        self, positions: np.ndarray, eps: float = 0.1, min_samples: int = 3
    ) -> Tuple[np.ndarray, int]:
        """DBSCAN labels + cluster count (reference ``perception.py:227-270``)."""
        positions = np.asarray(positions, dtype=np.float64).reshape(-1, 3)
        if len(positions) == 0:
            return np.zeros((0,), dtype=int), 0
        if importlib.util.find_spec("sklearn") is not None:
            from sklearn.cluster import DBSCAN

            labels = DBSCAN(eps=eps, min_samples=min_samples).fit(positions).labels_
        else:
            labels = dbscan_native(positions, eps, min_samples)
        num = len(set(labels) - {-1})
        return labels, num

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        self.vision.release()
