"""The port's vision (``manipulapy_tpu_torch/vision.py``) against the JAX
package's on the same inputs, made from a seeded NumPy generator: the
pinhole functions (float32, rtol and atol 1e-6), the depth-blob detector on
the cv2 branch and on the NumPy one-box fallback (positions at 1e-6,
labels equal), its sparse-blob and bad-index cases, ``capture_image``
through a fake PyBullet client, the stereo pipeline's point cloud, and the
YOLO extra's ImportError."""

import importlib.util

import numpy as np
import pytest
import torch

from manipulapy_tpu import vision as jv
from manipulapy_tpu_torch import vision as tv

CPU = "cpu"
TOL = dict(rtol=1e-6, atol=1e-6)


def _extrinsic(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    T = np.eye(4)
    T[:3, :3] = q * np.sign(np.linalg.det(q))
    T[:3, 3] = rng.uniform(-2.0, 2.0, 3)
    return T


def _cams(seed=0):
    kw = dict(fx=500.0, fy=400.0, cx=160.0, cy=120.0, width=320, height=240, extrinsic=_extrinsic(seed))
    return jv.CameraConfig(**kw), tv.CameraConfig(**kw)


def test_pinhole_functions_equal_jax():
    jcam, tcam = _cams()
    rng = np.random.default_rng(1)
    uv = rng.uniform([0, 0], [320, 240], (7, 9, 2))
    z = rng.uniform(0.3, 6.0, (7, 9))
    got = tv.pixel_to_camera(uv[..., 0], uv[..., 1], z, tcam, device=CPU)
    ref = np.asarray(jv.pixel_to_camera(uv[..., 0], uv[..., 1], z, jcam))
    assert got.dtype == torch.float32 and got.device.type == CPU and got.shape == (7, 9, 3)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    # Tensor inputs: their own device, no device argument.
    t_got = tv.pixel_to_camera(torch.from_numpy(uv[..., 0]), torch.from_numpy(uv[..., 1]), torch.from_numpy(z), tcam)
    assert torch.equal(t_got, got)
    np.testing.assert_allclose(tv.camera_to_pixel(got, tcam).numpy(), np.asarray(jv.camera_to_pixel(ref, jcam)), **TOL)
    np.testing.assert_allclose(tv.camera_to_world(got, tcam).numpy(), np.asarray(jv.camera_to_world(ref, jcam)), **TOL)
    # Scalars, one point and a point behind the clamp.
    np.testing.assert_allclose(tv.pixel_to_camera(200.0, 50.0, 2.0, tcam, device=CPU).numpy(),
                               np.asarray(jv.pixel_to_camera(200.0, 50.0, 2.0, jcam)), **TOL)
    p = np.array([[0.2, -0.1, 1.5], [0.1, 0.1, 0.0]])
    np.testing.assert_allclose(tv.camera_to_pixel(p, tcam, device=CPU).numpy(), np.asarray(jv.camera_to_pixel(p, jcam)), **TOL)
    np.testing.assert_allclose(tv.camera_to_world(p[0], tcam, device=CPU).numpy(), np.asarray(jv.camera_to_world(p[0], jcam)), **TOL)


def _scene(seed=0):
    rng = np.random.default_rng(seed)
    d = np.full((240, 320), 5.0, dtype=np.float32)
    d[60:100, 50:90] = 1.2
    d[140:200, 200:260] = 2.0 + rng.uniform(-0.05, 0.05, (60, 60)).astype(np.float32)
    d[30:70, 240:290] = 2.6
    d[5:7, 5:7] = 1.0  # a 4-pixel speck
    d[100, 100] = np.nan
    return d


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("threshold, min_area", [(3.0, 100), (3.0, 1), (2.2, 50), (1.0, 10)])
def test_detect_obstacles_equals_jax(monkeypatch, fallback, threshold, min_area):
    if fallback:
        monkeypatch.setattr(jv, "_HAS_CV2", False)
        monkeypatch.setattr(tv, "_HAS_CV2", False)
    else:
        assert tv._HAS_CV2 and jv._HAS_CV2, "this host has OpenCV"
    jcam, tcam = _cams(2)
    rgb = np.zeros((240, 320, 3), np.uint8)
    d = _scene()
    jpos, jlab = jv.Vision([jcam]).detect_obstacles(rgb, d, depth_threshold=threshold, min_blob_area=min_area)
    tpos, tlab = tv.Vision([tcam], device=CPU).detect_obstacles(rgb, d, depth_threshold=threshold, min_blob_area=min_area)
    assert tpos.shape == jpos.shape and tpos.dtype == jpos.dtype
    np.testing.assert_allclose(tpos, jpos, **TOL)
    np.testing.assert_array_equal(tlab, jlab)
    if threshold == 3.0 and min_area == 100:
        assert tpos.shape[0] == (1 if fallback else 3)


def test_sparse_blob_reports_obstacle_depth():
    cam = tv.CameraConfig(width=320, height=240, cx=160, cy=120)
    d = np.full((240, 320), 5.0, dtype=np.float32)
    for i in range(60):  # thin diagonal at 1.0 m
        d[80 + i, 80 + i] = 1.0
    rgb = np.zeros((240, 320, 3), np.uint8)
    pos, _ = tv.Vision([cam], device=CPU).detect_obstacles(rgb, d, depth_threshold=2.0, min_blob_area=10)
    jpos, _ = jv.Vision([jv.CameraConfig(width=320, height=240, cx=160, cy=120)]).detect_obstacles(
        rgb, d, depth_threshold=2.0, min_blob_area=10)
    assert pos.shape == (1, 3) and pos[0, 2] == pytest.approx(1.0, abs=1e-3)
    np.testing.assert_allclose(pos, jpos, **TOL)


def test_bad_camera_index_soft_fails():
    v = tv.Vision([tv.CameraConfig()], device=CPU)
    rgb = np.zeros((480, 640, 3), np.uint8)
    d = np.full((480, 640), 5.0, np.float32)
    for index in (3, -1):
        pos, lab = v.detect_obstacles(rgb, d, camera_index=index)
        assert pos.shape == (0, 3) and lab.shape == (0,)
    assert v.capture_image(camera_index=2, pb_module=object()) == (None, None)
    empty, labels = v.detect_obstacles(rgb, d)  # nothing near
    assert empty.shape == (0, 3) and labels.shape == (0,)


class FakePyBullet:
    """Records the camera calls and returns a seeded RGBA and z-buffer."""

    def __init__(self):
        self.calls = []

    def computeViewMatrix(self, **kw):
        self.calls.append(("view", kw))
        return [1.0] * 16

    def computeProjectionMatrixFOV(self, **kw):
        self.calls.append(("proj", kw))
        return [2.0] * 16

    def getCameraImage(self, width, height, viewMatrix, projectionMatrix):
        rng = np.random.default_rng(7)
        rgba = rng.integers(0, 255, (height, width, 4)).astype(np.uint8)
        zbuf = rng.uniform(0.0, 1.0, (height, width)).astype(np.float32)
        return width, height, rgba.reshape(-1), zbuf.reshape(-1), None


def test_capture_image_equals_jax():
    T = _extrinsic(5)
    kw = dict(fx=300.0, fy=300.0, cx=80.0, cy=60.0, width=160, height=120, near=0.2, far=8.0, extrinsic=T)
    jfake, tfake = FakePyBullet(), FakePyBullet()
    jrgb, jdepth = jv.Vision([jv.CameraConfig(**kw)]).capture_image(target=(0.1, 0.2, 0.3), pb_module=jfake)
    trgb, tdepth = tv.Vision([tv.CameraConfig(**kw)], device=CPU).capture_image(target=(0.1, 0.2, 0.3), pb_module=tfake)
    assert tfake.calls == jfake.calls
    np.testing.assert_array_equal(trgb, jrgb)
    assert tdepth.dtype == jdepth.dtype and np.array_equal(tdepth, jdepth)
    assert float(tdepth.min()) >= 0.2 - 1e-6 and float(tdepth.max()) <= 8.0 + 1e-5  # metric, inside [near, far]


def test_capture_image_without_pybullet_raises(monkeypatch):
    from manipulapy_tpu_torch import pybullet_bridge

    monkeypatch.setattr(pybullet_bridge, "pybullet_available", lambda: False)
    with pytest.raises(ImportError, match="PyBullet"):
        tv.Vision(device=CPU).capture_image()


def test_stereo_point_cloud_equals_jax():
    cv2 = tv.cv2
    assert cv2 is not None, "this host has OpenCV"
    rng = np.random.default_rng(0)
    base = (rng.uniform(0, 255, (120, 160)) > 127).astype(np.uint8) * 255
    base = cv2.GaussianBlur(base, (5, 5), 0)
    left, right = base, np.roll(base, -8, axis=1)
    K = np.array([[100.0, 0, 80], [0, 100.0, 60], [0, 0, 1]])
    configs = ({"intrinsic": K}, {"intrinsic": K, "translation": [0.1, 0, 0]})
    out = []
    for mod in (jv, tv):
        v = mod.Vision(stereo_configs=configs) if mod is jv else mod.Vision(stereo_configs=configs, device=CPU)
        v.compute_stereo_rectification_maps((160, 120))
        lr, rr = v.rectify_stereo_images(left, right)
        disp = v.compute_disparity(lr, rr, num_disparities=32, block_size=9)
        out.append((disp, v.disparity_to_pointcloud(disp)))
        v.release()
    (jd, jc), (td, tc) = out
    np.testing.assert_array_equal(td, jd)
    assert tc.shape == jc.shape and tc.shape[0] > 50 and tc.shape[1] == 3
    np.testing.assert_array_equal(tc, jc)


def test_yolo_raises_import_error(monkeypatch):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "ultralytics" else real(name, *a))
    v = tv.Vision(device=CPU)
    with pytest.raises(ImportError, match="ultralytics"):
        v.detect_obstacles(np.zeros((4, 4, 3), np.uint8), np.ones((4, 4), np.float32), method="yolo")
