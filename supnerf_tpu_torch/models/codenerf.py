"""CodeNeRF, the decoder-only baseline; the port of
supnerf_tpu/models/codenerf.py (reference model_codenerf.py:13-63). Its
codes come from the per-instance tables (training) or are the mean codes
(test-time optimization): it has no encoder."""
from __future__ import annotations

from supnerf_tpu_torch.models.nerf_mlp import CodeNeRFDecoder


class CodeNeRF(CodeNeRFDecoder):
    def __init__(self, shape_blocks: int = 2, texture_blocks: int = 1, W: int = 256,
                 latent_dim: int = 256, num_xyz_freq: int = 10, num_dir_freq: int = 4):
        super().__init__(shape_blocks, texture_blocks, W, latent_dim, num_xyz_freq, num_dir_freq)
        self.latent_dim = latent_dim
