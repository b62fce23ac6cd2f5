"""The AutoRF baselines; the port of supnerf_tpu/models/autorf.py
(reference model_autorf.py) with the reference's parameter names.

AutoRF    = two-head ResNet34 encoder + the original feature-averaging
            decoder (nerf_mlp.AutoRFDecoder).
AutoRFMix = two-head ResNet34 encoder + the CodeNeRF-style decoder (the
            published AutoRF baseline, reference model_autorf.py:190-250).

As in SUPNeRF (models/supnerf.py), the decoder layers sit at the top level
and the encoder under img_encoder, as in the reference's state_dict; so
AutoRFMix is a CodeNeRFDecoder, which ops.render reads unchanged. Neither
model has a pose refiner or a wlh head.
"""
from __future__ import annotations

from supnerf_tpu_torch.models.encoder import ImgEncoder
from supnerf_tpu_torch.models.nerf_mlp import AutoRFDecoder, CodeNeRFDecoder

HEADS = ("shape", "texture")


class AutoRF(AutoRFDecoder):
    """forward(xyz, viewdir, shape_feat, texture_feat) is the field;
    encode_img(img) -> (shape_feat, texture_feat)."""

    def __init__(self, shape_blocks: int = 5, texture_blocks: int = 5, latent_dim: int = 128,
                 num_xyz_freq: int = 10, num_dir_freq: int = 4,
                 norm_layer_type: str = "BatchNorm2d"):
        super().__init__(shape_blocks, texture_blocks, latent_dim, num_xyz_freq, num_dir_freq)
        self.latent_dim = latent_dim
        self.img_encoder = ImgEncoder(latent_dim, heads=HEADS, norm_layer_type=norm_layer_type)

    def encode_img(self, img):
        out = self.img_encoder(img)
        return out["shape"], out["texture"]


class AutoRFMix(CodeNeRFDecoder):
    """forward(xyz, viewdir, shapecode, texturecode) is the field (W =
    latent_dim); encode_img(img) -> (shapecode, texturecode)."""

    def __init__(self, shape_blocks: int = 5, texture_blocks: int = 5, latent_dim: int = 128,
                 num_xyz_freq: int = 10, num_dir_freq: int = 4,
                 norm_layer_type: str = "BatchNorm2d"):
        super().__init__(shape_blocks, texture_blocks, latent_dim, latent_dim, num_xyz_freq,
                         num_dir_freq)
        self.latent_dim = latent_dim
        self.img_encoder = ImgEncoder(latent_dim, heads=HEADS, norm_layer_type=norm_layer_type)

    def encode_img(self, img):
        out = self.img_encoder(img)
        return out["shape"], out["texture"]
