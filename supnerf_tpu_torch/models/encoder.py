"""Multi-head ResNet34 image encoder; the port of supnerf_tpu/models/encoder.py
with the reference's parameter names (model_supnerf.py:17-152).

conv7x7/2 + BN + ReLU + maxpool3x3/2, BasicBlock stages [3, 4, 6, 3] at
widths [64, 128, 256, 512]; the last stage is replicated per head (shape,
texture, pose), each head average-pools and projects 512 -> latent_dim, and
a 16-d box-corner regressor (fc_uv) hangs off the pose code. With the pose
shortcut the pose features are subtracted from the shape and texture
features. BatchNorm always uses batch statistics (layers.BatchStatNorm2d).
The public input is NHWC (B, H, W, 3), as in the JAX package.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from supnerf_tpu_torch.models.layers import BatchStatNorm2d


class BasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchStatNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchStatNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, planes, 1, stride, 0, bias=False), BatchStatNorm2d(planes))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


def _stage(inplanes: int, planes: int, blocks: int, stride: int):
    return nn.Sequential(BasicBlock(inplanes, planes, stride),
                         *[BasicBlock(planes, planes) for _ in range(1, blocks)])


class ImgEncoder(nn.Module):
    """forward(img (B, H, W, 3)) -> dict of per-head codes (B, latent_dim),
    "uv" (B, 16) when there is a pose head, "wlh" (B, 3) when pred_wlh."""

    def __init__(self, latent_dim: int = 256, layers=(3, 4, 6, 3),
                 heads=("shape", "texture", "pose"), pred_wlh: bool = False,
                 pose_shortcut: bool = False):
        super().__init__()
        self.heads, self.pred_wlh, self.pose_shortcut = tuple(heads), pred_wlh, pose_shortcut
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchStatNorm2d(64)
        self.layer1 = _stage(64, 64, layers[0], 1)
        self.layer2 = _stage(64, 128, layers[1], 2)
        self.layer3 = _stage(128, 256, layers[2], 2)
        for h in self.heads:
            setattr(self, f"layer4_{h}", _stage(256, 512, layers[3], 2))
            setattr(self, f"fc_{h}", nn.Linear(512, latent_dim))
        if "pose" in self.heads:
            self.fc_uv = nn.Linear(latent_dim, 16)
        if pred_wlh:
            self.layer4_wlh = _stage(256, 512, layers[3], 2)
            self.fc_wlh = nn.Sequential(nn.Linear(512, latent_dim), nn.ReLU(),
                                        nn.Linear(latent_dim, 3))

    def forward(self, img):
        x = img.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        x = self.layer3(self.layer2(self.layer1(x)))
        feats = {h: getattr(self, f"layer4_{h}")(x) for h in self.heads}
        if self.pose_shortcut and "pose" in feats:
            for h in ("shape", "texture"):
                if h in feats:
                    feats[h] = feats[h] - feats["pose"]
        out = {h: getattr(self, f"fc_{h}")(feats[h].mean((2, 3))) for h in self.heads}
        if "pose" in self.heads:
            out["uv"] = self.fc_uv(out["pose"])
        if self.pred_wlh:
            out["wlh"] = self.fc_wlh(self.layer4_wlh(x).mean((2, 3)))
        return out
