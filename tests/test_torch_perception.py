"""The port's perception (``manipulapy_tpu_torch/perception.py``) against the
JAX package's: ``dbscan_native`` labels exactly equal on seeded clouds
(empty, one point, clumps with noise, an eps sweep), and
``cluster_obstacles`` / ``detect_and_cluster_obstacles`` equal on the same
inputs, through scikit-learn and through the native fallback."""

import importlib.util

import numpy as np
import pytest

from manipulapy_tpu import perception as jp
from manipulapy_tpu import vision as jv
from manipulapy_tpu_torch import perception as tp
from manipulapy_tpu_torch import vision as tv

CPU = "cpu"


def _cloud(seed, n_clumps=3, per=12, noise=5):
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-1.0, 1.0, (n_clumps, 3))
    pts = [rng.normal(c, 0.03, (per, 3)) for c in centres] + [rng.uniform(-2.0, 2.0, (noise, 3))]
    return rng.permutation(np.concatenate(pts))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("eps, min_samples", [(0.02, 2), (0.05, 3), (0.1, 3), (0.3, 5), (5.0, 3)])
def test_dbscan_native_labels_equal_jax(seed, eps, min_samples):
    pts = _cloud(seed)
    np.testing.assert_array_equal(tp.dbscan_native(pts, eps, min_samples), jp.dbscan_native(pts, eps, min_samples))


@pytest.mark.parametrize("pts", [np.zeros((0, 3)), np.zeros((1, 3)), np.array([[0.0, 0, 0], [0.05, 0, 0]])])
@pytest.mark.parametrize("min_samples", [1, 2, 3])
def test_dbscan_native_small_inputs_equal_jax(pts, min_samples):
    got, ref = tp.dbscan_native(pts, 0.1, min_samples), jp.dbscan_native(pts, 0.1, min_samples)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("sklearn", [True, False])
def test_cluster_obstacles_equals_jax(monkeypatch, sklearn):
    if not sklearn:
        real = importlib.util.find_spec
        monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "sklearn" else real(name, *a))
    pts = _cloud(9)
    for eps, ms in ((0.1, 3), (0.5, 2)):
        (tl, tn), (jl, jn) = tp.Perception(tv.Vision(device=CPU)).cluster_obstacles(pts, eps, ms), \
            jp.Perception().cluster_obstacles(pts, eps, ms)
        np.testing.assert_array_equal(tl, jl)
        assert tn == jn
    assert tp.Perception(tv.Vision(device=CPU)).cluster_obstacles(np.zeros((0, 3)))[1] == 0


@pytest.mark.parametrize("fallback", [False, True])
def test_detect_and_cluster_equals_jax(monkeypatch, fallback):
    if fallback:
        monkeypatch.setattr(jv, "_HAS_CV2", False)
        monkeypatch.setattr(tv, "_HAS_CV2", False)
    kw = dict(fx=500.0, fy=500.0, cx=160.0, cy=120.0, width=320, height=240)
    depth = np.full((240, 320), 5.0, dtype=np.float32)
    for rows, cols, z in (((60, 100), (50, 90), 1.2), ((140, 200), (200, 260), 2.0), ((30, 70), (240, 290), 2.6)):
        depth[rows[0]:rows[1], cols[0]:cols[1]] = z
    rgb = np.zeros((240, 320, 3), np.uint8)
    args = dict(depth_threshold=3.0, min_blob_area=100, eps=0.5, min_samples=1)
    with tp.Perception(tv.Vision([tv.CameraConfig(**kw)], device=CPU)) as per:
        tpos, tlab = per.detect_and_cluster_obstacles(rgb, depth, **args)
    jpos, jlab = jp.Perception(jv.Vision([jv.CameraConfig(**kw)])).detect_and_cluster_obstacles(rgb, depth, **args)
    assert tpos.shape == jpos.shape == ((1, 3) if fallback else (3, 3))
    np.testing.assert_allclose(tpos, jpos, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tlab, jlab)
