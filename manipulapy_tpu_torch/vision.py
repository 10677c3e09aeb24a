"""Vision: camera models, stereo depth, and obstacle detection.

Counterpart of ``manipulapy_tpu/vision.py``:

* camera intrinsics/extrinsics and pinhole (un)projection are float32
  torch functions, batched, on their tensor inputs' device, and on the card
  when given NumPy arrays or floats unless the caller names a ``device``;
* the simulator capture, the depth-blob detector and the stereo pipeline
  (rectification maps, SGBM disparity, 3-D reprojection over OpenCV) are
  host-side NumPy copied from the JAX module; the detector unprojects all
  of a frame's blobs in one call, on the :class:`Vision`'s ``device``;
* YOLO-based detection is an optional extra gated at call time
  (``ultralytics`` absent => informative ImportError).

On CUDA, ``tensor / number`` multiplies by the number's reciprocal; the
unprojection divides by a tensor, so it rounds as JAX's IEEE division does.
"""

from __future__ import annotations

import importlib.util
import logging
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .pybullet_bridge import _resolve_pb

logger = logging.getLogger(__name__)

try:  # OpenCV is a hard dep of the vision extra, soft overall.
    import cv2

    _HAS_CV2 = True
except ImportError:
    cv2 = None
    _HAS_CV2 = False

__all__ = [
    "CameraConfig",
    "Vision",
    "pixel_to_camera",
    "camera_to_pixel",
    "camera_to_world",
]


@dataclass
class CameraConfig:
    """Intrinsics + pose (reference camera config dicts,
    ``vision.py:225-250``)."""

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    near: float = 0.1
    far: float = 10.0
    # Camera-to-world transform (4, 4).
    extrinsic: np.ndarray = field(default_factory=lambda: np.eye(4))

    @property
    def intrinsic_matrix(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]]
        )


def _device(device, *xs) -> torch.device:
    """``device``, else the first tensor input's, else the card."""
    if device is not None:
        return torch.device(device)
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cuda")


def pixel_to_camera(u, v, depth, cam: CameraConfig, device=None) -> torch.Tensor:
    """Pinhole unprojection (u, v, z) -> camera-frame xyz (..., 3), float32;
    batched (reference ``vision.py:721-751`` math)."""
    f32 = dict(dtype=torch.float32, device=_device(device, u, v, depth))
    u = torch.as_tensor(u, **f32)
    v = torch.as_tensor(v, **f32)
    z = torch.as_tensor(depth, **f32)
    cx, cy, fx, fy = torch.tensor([cam.cx, cam.cy, cam.fx, cam.fy], **f32)
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    return torch.stack([x, y, z], dim=-1)


def camera_to_pixel(points, cam: CameraConfig, device=None) -> torch.Tensor:
    """Camera-frame xyz -> (u, v) pixels (..., 2), float32; batched."""
    p = torch.as_tensor(points, dtype=torch.float32, device=_device(device, points))
    z = torch.maximum(p[..., 2], p.new_tensor(1e-6))
    u = p[..., 0] / z * cam.fx + cam.cx
    v = p[..., 1] / z * cam.fy + cam.cy
    return torch.stack([u, v], dim=-1)


def camera_to_world(points, cam: CameraConfig, device=None) -> torch.Tensor:
    """Camera-frame xyz -> world frame through the extrinsic, float32."""
    f32 = dict(dtype=torch.float32, device=_device(device, points))
    p = torch.as_tensor(points, **f32)
    T = torch.as_tensor(np.asarray(cam.extrinsic), **f32)
    return p @ T[:3, :3].T + T[:3, 3]


class Vision:
    """Camera + detection + stereo front end (reference ``Vision`` class).

    ``detect_obstacles`` runs either the optional YOLO path (``ultralytics``
    extra) or the native depth-blob detector; both reduce to the same
    output contract as the reference: (N, 3) world positions + labels.
    The detections are unprojected on ``device`` (the card unless the
    caller names the CPU).
    """

    def __init__(
        self,
        camera_configs: Optional[List[CameraConfig]] = None,
        stereo_configs: Optional[Tuple[Dict, Dict]] = None,
        device=None,
    ):
        self.cameras = camera_configs or [CameraConfig()]
        self.stereo_configs = stereo_configs
        self.device = torch.device("cuda" if device is None else device)
        self._stereo_maps = None
        self._yolo = None

    # -- simulator capture -----------------------------------------------------

    def capture_image(
        self,
        camera_index: int = 0,
        target=(0.0, 0.0, 0.5),
        up=(0.0, 0.0, 1.0),
        pb_module=None,
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        """RGB + *metric* depth from a PyBullet virtual camera (reference
        ``vision.py:616-655``).

        The camera eye comes from this camera's extrinsic translation; the
        projection from its intrinsics/near/far. The PyBullet depth buffer
        is a NONLINEAR OpenGL z-buffer in [0, 1]; metric depth is its
        perspective inversion ``far * near / (far - (far - near) * buf)``.
        (The reference linearizes with ``near + (far - near) * buf``,
        ``vision.py:649-653`` — with near=0.1/far=10 that reports an
        object at 1 m as 9.1 m; this is an upstream bug we deliberately
        do NOT mirror, so downstream unprojection sees real distances.)

        Note: PyBullet's FOV projection implies fx == fy and a centered
        principal point; a config with fx != fy (or off-center cx/cy)
        renders with fy's focal length — use real sensors or pre-rendered
        depth for full-intrinsics fidelity.

        Returns (None, None) when the camera index is unknown — the
        reference's soft-failure contract. Raises ImportError without
        pybullet (optional-dep gating, reference ``sim.py:84-97``; the
        client is resolved by the port's ``pybullet_bridge``).
        ``pb_module`` injects a fake client for tests.
        """
        if not 0 <= camera_index < len(self.cameras):
            return None, None
        pb_module = _resolve_pb(pb_module)

        cam = self.cameras[camera_index]
        eye = np.asarray(cam.extrinsic, dtype=np.float64)[:3, 3]
        view = pb_module.computeViewMatrix(
            cameraEyePosition=[float(x) for x in eye],
            cameraTargetPosition=[float(x) for x in target],
            cameraUpVector=[float(x) for x in up],
        )
        fov_deg = float(np.degrees(2.0 * np.arctan2(cam.height / 2.0, cam.fy)))
        proj = pb_module.computeProjectionMatrixFOV(
            fov=fov_deg,
            aspect=cam.width / float(cam.height),
            nearVal=cam.near,
            farVal=cam.far,
        )
        out = pb_module.getCameraImage(
            cam.width, cam.height, viewMatrix=view, projectionMatrix=proj
        )
        rgba, depth_buf = out[2], out[3]
        rgb = np.asarray(rgba, dtype=np.uint8).reshape(cam.height, cam.width, -1)[:, :, :3]
        depth = np.asarray(depth_buf, dtype=np.float32).reshape(cam.height, cam.width)
        depth = (cam.far * cam.near) / (cam.far - (cam.far - cam.near) * depth)
        return rgb, depth

    # -- detection -----------------------------------------------------------

    def _ensure_yolo(self, model_name: str = "yolov8n.pt"):
        if self._yolo is not None:
            return self._yolo
        if importlib.util.find_spec("ultralytics") is None:
            raise ImportError(
                "ultralytics is not installed; use detect_obstacles(..., "
                "method='depth') for the native geometric detector, or "
                "install the 'vision-ml' extra."
            )
        from ultralytics import YOLO  # pragma: no cover - optional dep

        self._yolo = YOLO(model_name)
        # MANIPULAPY_YOLO_DEVICE pins the torch device (reference contract,
        # vision.py:596-606): ultralytics otherwise auto-selects CUDA,
        # which can crash when another library owns the CUDA context in
        # the same process. Unset = ultralytics chooses.
        forced_device = os.environ.get("MANIPULAPY_YOLO_DEVICE")
        if forced_device:  # pragma: no cover - device-specific
            try:
                self._yolo.to(forced_device)
                logger.info("YOLO model pinned to %r via MANIPULAPY_YOLO_DEVICE", forced_device)
            except Exception as exc:
                logger.warning(
                    "Could not pin YOLO model to %r (%s); leaving auto-selection",
                    forced_device, exc,
                )
        return self._yolo

    def detect_obstacles(
        self,
        rgb: np.ndarray,
        depth: np.ndarray,
        camera_index: int = 0,
        *,
        method: str = "depth",
        depth_threshold: float = 2.0,
        min_blob_area: int = 50,
        conf: float = 0.3,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Detect obstacles and return (positions (N, 3) world frame,
        labels (N,)).

        ``method='depth'``: native detector — connected components of the
        thresholded depth image; each blob's median depth + centroid is
        unprojected through the pinhole model (the same ROI-median depth
        recipe as the reference's YOLO path, ``vision.py:721-751``).
        ``method='yolo'``: optional ultralytics path with identical
        unprojection.
        """
        # soft-failure contract like capture_image: an out-of-range index
        # returns an empty result rather than IndexError (and a negative
        # index must not silently select the last camera's intrinsics).
        if not (0 <= camera_index < len(self.cameras)):
            return np.zeros((0, 3)), np.zeros((0,), dtype=int)
        cam = self.cameras[camera_index]
        if method == "yolo":
            yolo = self._ensure_yolo()
            results = yolo(rgb, conf=conf, verbose=False)  # pragma: no cover
            boxes = []
            for r in results:
                for b in r.boxes:
                    x1, y1, x2, y2 = map(int, b.xyxy[0].tolist())
                    boxes.append((x1, y1, x2, y2, int(b.cls[0])))
        else:
            boxes = self._depth_blobs(depth, depth_threshold, min_blob_area)

        us, vs, zs, labels = [], [], [], []
        for (x1, y1, x2, y2, label) in boxes:
            roi = depth[max(y1, 0) : y2, max(x1, 0) : x2]
            valid = roi[np.isfinite(roi) & (roi > 0)]
            if method != "yolo":
                # depth path: the component's OWN pixels, not the whole
                # bbox — a sparse/diagonal blob's bbox is dominated by
                # background, so the bbox median reported the BACKGROUND
                # depth (e.g. a 1 m obstacle at z = 5 m).
                near = valid[valid < depth_threshold]
                valid = near if near.size else valid
            if valid.size == 0:
                continue
            z = float(np.median(valid))
            if method != "yolo" and z > depth_threshold:
                continue  # reference drops median-beyond-threshold boxes
            us.append((x1 + x2) / 2.0)
            vs.append((y1 + y2) / 2.0)
            zs.append(z)
            labels.append(label)
        if not labels:
            return np.zeros((0, 3)), np.zeros((0,), dtype=int)
        # Every blob of the frame in one unprojection.
        p_cam = pixel_to_camera(np.asarray(us), np.asarray(vs), np.asarray(zs), cam, device=self.device)
        return camera_to_world(p_cam, cam).cpu().numpy(), np.asarray(labels)

    @staticmethod
    def _depth_blobs(depth: np.ndarray, threshold: float, min_area: int):
        """Connected components of near-field depth pixels -> boxes."""
        mask = (np.isfinite(depth) & (depth > 0) & (depth < threshold)).astype(np.uint8)
        if _HAS_CV2:
            num, comp = cv2.connectedComponents(mask)
            boxes = []
            for label in range(1, num):
                ys, xs = np.nonzero(comp == label)
                if xs.size < min_area:
                    continue
                boxes.append((xs.min(), ys.min(), xs.max() + 1, ys.max() + 1, 0))
            return boxes
        # NumPy fallback: single bounding box of the mask.
        ys, xs = np.nonzero(mask)
        if xs.size < min_area:
            return []
        return [(xs.min(), ys.min(), xs.max() + 1, ys.max() + 1, 0)]

    # -- stereo --------------------------------------------------------------

    def compute_stereo_rectification_maps(self, image_size: Tuple[int, int]):
        """cv2.stereoRectify maps from the stereo config pair
        (reference ``vision.py:765-818``)."""
        if not _HAS_CV2:
            raise ImportError("OpenCV (cv2) required for the stereo pipeline")
        if self.stereo_configs is None:
            raise ValueError("no stereo_configs provided")
        left, right = self.stereo_configs
        K1 = np.asarray(left["intrinsic"], dtype=np.float64)
        K2 = np.asarray(right["intrinsic"], dtype=np.float64)
        d1 = np.asarray(left.get("distortion", np.zeros(5)), dtype=np.float64)
        d2 = np.asarray(right.get("distortion", np.zeros(5)), dtype=np.float64)
        R = np.asarray(right.get("rotation", np.eye(3)), dtype=np.float64)
        # OpenCV >= 5 requires the baseline as a 3x1 column vector.
        T = np.asarray(right.get("translation", [0.1, 0, 0]), dtype=np.float64).reshape(3, 1)
        image_size = (int(image_size[0]), int(image_size[1]))
        R1, R2, P1, P2, Q, _, _ = cv2.stereoRectify(K1, d1, K2, d2, image_size, R, T)
        m1 = cv2.initUndistortRectifyMap(K1, d1, R1, P1, image_size, cv2.CV_32FC1)
        m2 = cv2.initUndistortRectifyMap(K2, d2, R2, P2, image_size, cv2.CV_32FC1)
        self._stereo_maps = (m1, m2, Q)
        return self._stereo_maps

    def rectify_stereo_images(self, left: np.ndarray, right: np.ndarray):
        if self._stereo_maps is None:
            self.compute_stereo_rectification_maps((left.shape[1], left.shape[0]))
        (m1x, m1y), (m2x, m2y), _ = self._stereo_maps
        lrect = cv2.remap(left, m1x, m1y, cv2.INTER_LINEAR)
        rrect = cv2.remap(right, m2x, m2y, cv2.INTER_LINEAR)
        return lrect, rrect

    def compute_disparity(self, left: np.ndarray, right: np.ndarray, num_disparities=64, block_size=11):
        """SGBM disparity / 16 (reference ``vision.py:841-865``)."""
        if not _HAS_CV2:
            raise ImportError("OpenCV (cv2) required for the stereo pipeline")
        gray_l = cv2.cvtColor(left, cv2.COLOR_BGR2GRAY) if left.ndim == 3 else left
        gray_r = cv2.cvtColor(right, cv2.COLOR_BGR2GRAY) if right.ndim == 3 else right
        sgbm = cv2.StereoSGBM_create(
            minDisparity=0,
            numDisparities=num_disparities,
            blockSize=block_size,
            P1=8 * block_size**2,
            P2=32 * block_size**2,
        )
        return sgbm.compute(gray_l, gray_r).astype(np.float32) / 16.0

    def disparity_to_pointcloud(self, disparity: np.ndarray) -> np.ndarray:
        """reprojectImageTo3D + validity filter (reference
        ``vision.py:867-885``)."""
        if self._stereo_maps is None:
            raise ValueError("compute_stereo_rectification_maps first")
        _, _, Q = self._stereo_maps
        pts = cv2.reprojectImageTo3D(disparity, Q)
        mask = (disparity > 0) & np.isfinite(pts).all(axis=-1)
        return pts[mask]

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def release(self) -> None:
        self._yolo = None
        self._stereo_maps = None
