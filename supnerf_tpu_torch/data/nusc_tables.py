"""nuScenes table reader: the subset of the nuscenes-devkit that
data/nuscenes.py calls, in numpy, so the port reads a nuScenes dataroot on
a machine without the devkit (tests/nusc_devkit_shim.py lists the same
surface for the JAX package's tests).

NuScenes(version, dataroot) reads <dataroot>/<version>/*.json in nuScenes'
own schema (scene, log, sample, sample_data, sample_annotation, instance,
category, calibrated_sensor, ego_pose, sensor; visibility where the file
exists, for the dataset QA) and builds the devkit's
reverse index: sample_data["channel"] and ["sensor_modality"] through
calibrated_sensor -> sensor, sample["data"] = {channel: token} over the
key-frame sample_data, and sample["anns"]. It offers get, field2token
(indexed per table and field), .instance, .sample_data, get_sample_data (of
a camera, at BoxVisibility.ALL) and explorer.map_pointcloud_to_image with
the devkit's arithmetic: quaternions are [w, x, y, z] and become rotation
matrices as pyquaternion's do, boxes move global -> ego -> camera in
float64, and lidar points stay float32 between the steps of lidar -> ego ->
global -> ego -> camera, as the devkit's LidarPointCloud keeps them.
"""
from __future__ import annotations

import json
import os

import numpy as np

TABLES = ("category", "sensor", "calibrated_sensor", "ego_pose", "log", "scene", "sample",
          "sample_data", "sample_annotation", "instance")
# read where present: the dataset QA's visibility level (data/debug.py)
OPTIONAL_TABLES = ("visibility",)


class BoxVisibility:
    """The devkit's visibility level that data/nuscenes.py asks for: every
    corner of the box in the image (the devkit's ANY and NONE are not
    offered)."""
    ALL = 0


class Quaternion:
    """A [w, x, y, z] quaternion with pyquaternion's arithmetic."""

    def __init__(self, q):
        self.q = np.array(q, dtype=np.float64).reshape(4)

    def _q_matrix(self):
        w, x, y, z = self.q
        return np.array([[w, -x, -y, -z], [x, w, -z, y], [y, z, w, -x], [z, -y, x, w]])

    def _q_bar_matrix(self):
        w, x, y, z = self.q
        return np.array([[w, -x, -y, -z], [x, w, z, -y], [y, -z, w, x], [z, y, -x, w]])

    @property
    def rotation_matrix(self):
        ss = float(np.dot(self.q, self.q))
        if abs(1.0 - ss) >= 1e-14 and ss > 0:      # pyquaternion normalises in place
            self.q = self.q / np.sqrt(ss)
        return np.dot(self._q_matrix(), self._q_bar_matrix().T)[1:][:, 1:]

    @property
    def inverse(self):
        ss = float(np.dot(self.q, self.q))
        return Quaternion(self.q * np.array([1.0, -1.0, -1.0, -1.0]) / ss)

    def __mul__(self, other):
        return Quaternion(np.dot(self._q_matrix(), other.q))


class Box:
    """The devkit's Box: centre, wlh and orientation, in some frame."""

    def __init__(self, center, size, orientation: Quaternion, token=None):
        self.center = np.array(center, dtype=np.float64)
        self.wlh = np.array(size, dtype=np.float64)
        self.orientation = orientation
        self.token = token

    def translate(self, x):
        self.center += x

    def rotate(self, quaternion: Quaternion):
        self.center = np.dot(quaternion.rotation_matrix, self.center)
        self.orientation = quaternion * self.orientation

    def corners(self):
        w, l, h = self.wlh
        x = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
        corners = np.dot(self.orientation.rotation_matrix, np.vstack((x, y, z)))
        return corners + self.center[:, None]


def view_points(points, intrinsic):
    """The devkit's perspective projection (view_points, normalize=True) of
    (3, N) points by 3 x 3 intrinsics: (3, N) pixels, row 2 equal to 1."""
    viewpad = np.eye(4)
    viewpad[:3, :3] = intrinsic
    n = points.shape[1]
    out = np.dot(viewpad, np.concatenate((points, np.ones((1, n)))))[:3, :]
    return out / out[2:3, :].repeat(3, 0).reshape(3, n)


def box_in_image(box: Box, intrinsic, imsize) -> bool:
    """The devkit's box_in_image at BoxVisibility.ALL: every corner projects
    inside (0, width) x (0, height) with depth > 1 and lies in front of the
    camera (depth > 0.1)."""
    corners_3d = box.corners()
    corners_img = view_points(corners_3d, intrinsic)[:2, :]
    visible = (corners_img[0] > 0) & (corners_img[0] < imsize[0])
    visible &= (corners_img[1] < imsize[1]) & (corners_img[1] > 0)
    visible &= corners_3d[2] > 1
    return bool(visible.all() and (corners_3d[2] > 0.1).all())


class NuScenes:
    """The tables of one nuScenes version under dataroot."""

    def __init__(self, version: str, dataroot: str):
        self.version, self.dataroot = version, dataroot
        table_root = os.path.join(dataroot, version)
        if not os.path.isdir(table_root):
            raise FileNotFoundError(f"no nuScenes tables at {table_root}")
        names = list(TABLES) + [n for n in OPTIONAL_TABLES
                                if os.path.exists(os.path.join(table_root, n + ".json"))]
        for name in names:
            with open(os.path.join(table_root, name + ".json")) as f:
                setattr(self, name, json.load(f))
        self._token2row = {name: {r["token"]: r for r in getattr(self, name)} for name in names}
        self._field_index = {}
        for rec in self.sample_data:
            cs = self.get("calibrated_sensor", rec["calibrated_sensor_token"])
            sensor = self.get("sensor", cs["sensor_token"])
            rec["sensor_modality"] = sensor["modality"]
            rec["channel"] = sensor["channel"]
        for rec in self.sample:
            rec["data"], rec["anns"] = {}, []
        for rec in self.sample_data:
            if rec["is_key_frame"]:
                self.get("sample", rec["sample_token"])["data"][rec["channel"]] = rec["token"]
        for rec in self.sample_annotation:
            self.get("sample", rec["sample_token"])["anns"].append(rec["token"])
        self.explorer = NuScenesExplorer(self)

    def get(self, table_name: str, token: str) -> dict:
        return self._token2row[table_name][token]

    def field2token(self, table_name: str, field: str, query) -> list:
        """Tokens of the rows whose `field` equals `query`, in table order."""
        key = (table_name, field)
        if key not in self._field_index:
            index = {}
            for rec in getattr(self, table_name):
                index.setdefault(rec[field], []).append(rec["token"])
            self._field_index[key] = index
        return list(self._field_index[key].get(query, []))

    def get_sample_data(self, sample_data_token: str, box_vis_level: int,
                        selected_anntokens: list):
        """For a camera's sample_data: (image path, the selected annotations'
        boxes in the camera frame that pass box_in_image, the camera's
        intrinsics). The boxes are the annotations' own (key-frame) boxes;
        box_vis_level must be BoxVisibility.ALL."""
        sd = self.get("sample_data", sample_data_token)
        if sd["sensor_modality"] != "camera" or box_vis_level != BoxVisibility.ALL:
            raise ValueError("get_sample_data reads camera sample_data at BoxVisibility.ALL")
        cs = self.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = self.get("ego_pose", sd["ego_pose_token"])
        intrinsic = np.array(cs["camera_intrinsic"])
        boxes = []
        for token in selected_anntokens:
            rec = self.get("sample_annotation", token)
            box = Box(rec["translation"], rec["size"], Quaternion(rec["rotation"]), token)
            box.translate(-np.array(pose["translation"]))
            box.rotate(Quaternion(pose["rotation"]).inverse)
            box.translate(-np.array(cs["translation"]))
            box.rotate(Quaternion(cs["rotation"]).inverse)
            if box_in_image(box, intrinsic, (sd["width"], sd["height"])):
                boxes.append(box)
        return os.path.join(self.dataroot, sd["filename"]), boxes, intrinsic


def _rotate(points, R):
    points[:3] = np.dot(R, points[:3])


def _translate(points, t):
    for i in range(3):
        points[i] = points[i] + t[i]


class NuScenesExplorer:
    """explorer.map_pointcloud_to_image of the devkit."""

    def __init__(self, nusc: NuScenes):
        self.nusc = nusc

    def map_pointcloud_to_image(self, pointsensor_token: str, camera_token: str,
                                min_dist: float = 1.0):
        """The lidar sweep's points in the camera image: (points (3, N) float64
        pixel coordinates with row 2 = 1, depths (N,) float32, None). Points
        keep depth > min_dist and 1 < u < width - 1, 1 < v < height - 1."""
        nusc = self.nusc
        cam = nusc.get("sample_data", camera_token)
        lidar = nusc.get("sample_data", pointsensor_token)
        scan = np.fromfile(os.path.join(nusc.dataroot, lidar["filename"]), dtype=np.float32)
        points = scan.reshape((-1, 5))[:, :4].T.copy()                # (4, N) float32
        cs = nusc.get("calibrated_sensor", lidar["calibrated_sensor_token"])
        _rotate(points, Quaternion(cs["rotation"]).rotation_matrix)
        _translate(points, np.array(cs["translation"]))
        pose = nusc.get("ego_pose", lidar["ego_pose_token"])
        _rotate(points, Quaternion(pose["rotation"]).rotation_matrix)
        _translate(points, np.array(pose["translation"]))
        pose = nusc.get("ego_pose", cam["ego_pose_token"])
        _translate(points, -np.array(pose["translation"]))
        _rotate(points, Quaternion(pose["rotation"]).rotation_matrix.T)
        cs = nusc.get("calibrated_sensor", cam["calibrated_sensor_token"])
        _translate(points, -np.array(cs["translation"]))
        _rotate(points, Quaternion(cs["rotation"]).rotation_matrix.T)
        depths = points[2, :]
        uv = view_points(points[:3, :], np.array(cs["camera_intrinsic"]))
        keep = ((depths > min_dist) & (uv[0] > 1) & (uv[0] < cam["width"] - 1)
                & (uv[1] > 1) & (uv[1] < cam["height"] - 1))
        return uv[:, keep], depths[keep], None
