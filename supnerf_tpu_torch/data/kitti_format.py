"""KITTI-format file loader in numpy; the port of
supnerf_tpu/data/kitti_format.py, with the images decoded by the port's own
PNG reader instead of PIL.

The subset of the reference's vendored kitti_object_vis loaders that it
uses (kitti_object.py: get_image :66, get_lidar :71, get_calibration :77,
get_label_objects :82, get_pred_objects :87, get_lidar_in_image_fov :320;
kitti_util.py: Object3d :51, Calibration :146): image / velodyne / calib /
label / prediction readers, the velo -> ref -> rect -> image projection
chain, and lidar-in-image-FOV selection. Also serves Waymo data stored in
KITTI format (reference waymo_object.py; only the directory names differ).
"""
from __future__ import annotations

import os

import numpy as np

from supnerf_tpu_torch.utils.image_io import read_png


class Object3d:
    """One KITTI label line: type truncated occluded alpha box2d(4) h w l
    t(3) ry [score]."""

    def __init__(self, label_file_line: str):
        data = label_file_line.split(" ")
        self.type = data[0]
        vals = [float(x) for x in data[1:]]
        self.truncation = vals[0]
        self.occlusion = int(vals[1])  # 0..3 (unknown)
        self.alpha = vals[2]
        self.xmin, self.ymin, self.xmax, self.ymax = vals[3:7]
        self.box2d = np.array([self.xmin, self.ymin, self.xmax, self.ymax])
        self.h, self.w, self.l = vals[7], vals[8], vals[9]
        self.t = (vals[10], vals[11], vals[12])
        self.ry = vals[13]
        self.score = vals[14] if len(vals) > 14 else None

    def to_kitti_line(self) -> str:
        fields = [self.type, f"{self.truncation:.2f}", str(self.occlusion),
                  f"{self.alpha:.2f}"] + [f"{v:.2f}" for v in self.box2d] + [
                  f"{self.h:.2f}", f"{self.w:.2f}", f"{self.l:.2f}",
                  f"{self.t[0]:.2f}", f"{self.t[1]:.2f}", f"{self.t[2]:.2f}",
                  f"{self.ry:.2f}"]
        if self.score is not None:
            fields.append(f"{self.score:.4f}")
        return " ".join(fields)


def read_label(path: str):
    with open(path) as f:
        lines = [ln.rstrip() for ln in f if ln.strip()]
    return [Object3d(ln) for ln in lines]


class Calibration:
    """KITTI calibration: P2 (rect cam projection), R0_rect, Tr_velo_to_cam.

    3D points: velo -(V2C)-> ref -(R0)-> rect -(P)-> image.
    """

    def __init__(self, calib_filepath: str):
        calibs = self._read_calib_file(calib_filepath)
        self.P = calibs["P2"].reshape(3, 4)
        v2c = calibs.get("Tr_velo_to_cam", calibs.get("Tr_velo_cam"))
        self.V2C = v2c.reshape(3, 4) if v2c is not None else np.eye(3, 4)
        r0 = calibs.get("R0_rect", calibs.get("R_rect"))
        self.R0 = r0.reshape(3, 3) if r0 is not None else np.eye(3)
        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]

    @staticmethod
    def _read_calib_file(filepath: str) -> dict:
        data = {}
        with open(filepath) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                key, value = line.split(":", 1)
                try:
                    data[key.strip()] = np.array([float(x) for x in value.split()])
                except ValueError:
                    pass
        return data

    @staticmethod
    def _to_hom(pts):
        return np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)

    def project_velo_to_ref(self, pts_velo):
        return self._to_hom(pts_velo) @ self.V2C.T

    def project_ref_to_rect(self, pts_ref):
        return pts_ref @ self.R0.T

    def project_velo_to_rect(self, pts_velo):
        return self.project_ref_to_rect(self.project_velo_to_ref(pts_velo))

    def project_rect_to_image(self, pts_rect):
        uvw = self._to_hom(pts_rect) @ self.P.T
        return uvw[:, :2] / uvw[:, 2:3]

    def project_velo_to_image(self, pts_velo):
        return self.project_rect_to_image(self.project_velo_to_rect(pts_velo))

    def project_image_to_rect(self, uv_depth):
        """(N, 3) [u, v, depth] -> (N, 3) rect-frame points."""
        u, v, z = uv_depth[:, 0], uv_depth[:, 1], uv_depth[:, 2]
        b_x = self.P[0, 3] / (-self.f_u)
        b_y = self.P[1, 3] / (-self.f_v)
        x = (u - self.c_u) * z / self.f_u + b_x
        y = (v - self.c_v) * z / self.f_v + b_y
        return np.stack([x, y, z], axis=1)


def get_lidar_in_image_fov(pc_velo, calib: Calibration, xmin, ymin, xmax, ymax,
                           return_more: bool = False, clip_distance: float = 2.0):
    """Select lidar points projecting inside the image rectangle and farther
    than clip_distance along +x (reference kitti_object.py:320-335)."""
    pts_2d = calib.project_velo_to_image(pc_velo)
    fov_inds = (
        (pts_2d[:, 0] < xmax) & (pts_2d[:, 0] >= xmin)
        & (pts_2d[:, 1] < ymax) & (pts_2d[:, 1] >= ymin)
    )
    fov_inds = fov_inds & (pc_velo[:, 0] > clip_distance)
    imgfov_pc_velo = pc_velo[fov_inds, :]
    if return_more:
        return imgfov_pc_velo, pts_2d, fov_inds
    return imgfov_pc_velo


class KittiObjectDataset:
    """Directory-level loader for KITTI-format data (also Waymo-as-KITTI).

    layout='kitti': image_2/ label_2/ calib/ velodyne/ pred/
    layout='waymo': image/ label/ calib/ velodyne/ pred/
    """

    def __init__(self, root_dir: str, split: str = "training",
                 layout: str = "kitti"):
        self.root_dir = root_dir
        self.split = split
        self.split_dir = os.path.join(root_dir, split)
        if layout == "kitti":
            img_d, lbl_d = "image_2", "label_2"
        else:
            img_d, lbl_d = "image", "label"
        self.image_dir = os.path.join(self.split_dir, img_d)
        self.label_dir = os.path.join(self.split_dir, lbl_d)
        self.calib_dir = os.path.join(self.split_dir, "calib")
        self.lidar_dir = os.path.join(self.split_dir, "velodyne")
        self.pred_dir = os.path.join(self.split_dir, "pred")

    def get_image(self, idx: int) -> np.ndarray:
        """RGB uint8 (H, W, 3), as PIL's Image.open(...).convert("RGB")."""
        return read_png(os.path.join(self.image_dir, "%06d.png" % idx), mode="RGB")

    def get_lidar(self, idx: int, dtype=np.float32, n_vec: int = 4) -> np.ndarray:
        path = os.path.join(self.lidar_dir, "%06d.bin" % idx)
        return np.fromfile(path, dtype=dtype).reshape(-1, n_vec)

    def get_calibration(self, idx: int) -> Calibration:
        return Calibration(os.path.join(self.calib_dir, "%06d.txt" % idx))

    def get_label_objects(self, idx: int):
        return read_label(os.path.join(self.label_dir, "%06d.txt" % idx))

    def get_pred_objects(self, idx: int):
        path = os.path.join(self.pred_dir, "%06d.txt" % idx)
        return read_label(path) if os.path.exists(path) else []
