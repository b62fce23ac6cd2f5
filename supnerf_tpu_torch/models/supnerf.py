"""SUPNeRF: encoder + pose refiner + conditioned decoder; the port of
supnerf_tpu/models/supnerf.py. The decoder and refiner layers sit at the top
level under the reference's names (model_supnerf.py:165-269), as in the
reference's state_dict."""
from __future__ import annotations

from supnerf_tpu_torch.models.encoder import ImgEncoder
from supnerf_tpu_torch.models.nerf_mlp import (
    CodeNeRFDecoder,
    add_refiner_layers,
    decode,
    refine,
)


class SUPNeRF(CodeNeRFDecoder):
    """forward(xyz, viewdir, shapecode, texturecode) is the NeRF field;
    encode_img and pose_update are the other two entry points. field_dtype
    ("float32" or "bfloat16", net_hyperparams' key) is the precision of the
    field: of this module's forward (nerf_mlp.decode) and of the render
    kernels that ops.render.pack_decoder_params packs it for."""

    def __init__(self, shape_blocks: int = 5, texture_blocks: int = 5,
                 pose_blocks: int = 3, regress_blocks: int = 3, latent_dim: int = 256,
                 num_xyz_freq: int = 10, num_dir_freq: int = 4,
                 pose_shortcut: bool = False, pred_wlh: bool = False,
                 norm_layer_type: str = "BatchNorm2d", field_dtype: str = "float32"):
        super().__init__(shape_blocks, texture_blocks, latent_dim, latent_dim,
                         num_xyz_freq, num_dir_freq, field_dtype)
        self.latent_dim = latent_dim
        self.pred_wlh = pred_wlh
        self.img_encoder = ImgEncoder(latent_dim, pred_wlh=pred_wlh,
                                      pose_shortcut=pose_shortcut,
                                      norm_layer_type=norm_layer_type)
        add_refiner_layers(self, pose_blocks, regress_blocks, latent_dim, 16, latent_dim)

    def forward(self, xyz, viewdir, shapecode, texturecode):
        return decode(self, xyz, viewdir, shapecode, texturecode)

    def encode_img(self, img):
        """img (B, H, W, 3) -> (shapecode, texturecode, posecode, uv (B, 16),
        wlh (B, 3) or None)."""
        out = self.img_encoder(img)
        return out["shape"], out["texture"], out["pose"], out["uv"], out.get("wlh")

    def pose_update(self, im_feat, box_uv):
        """(B, latent) pose code + (B, 16) normalised corners -> (B, 6) raw delta."""
        return refine(self, im_feat, box_uv)
