"""Waymo data stored in KITTI format (front camera); the port of
supnerf_tpu/data/waymo.py (reference data_waymo.py WaymoData :206): the
KITTI reader over the 'image'/'label' directory layout."""
from __future__ import annotations

from supnerf_tpu_torch.data.kitti import KittiData


class WaymoData(KittiData):
    LAYOUT = "waymo"
    NAME = "waymo"
