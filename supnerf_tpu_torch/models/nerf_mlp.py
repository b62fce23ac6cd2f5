"""Latent-conditioned NeRF decoders and pose refiner; the port of
supnerf_tpu/models/nerf_mlp.py (positional encodings, CodeNeRFDecoder,
AutoRFDecoder, PoseRefinerMLP) with the reference's torch parameter names
(model_codenerf.py:13-63, model_autorf.py:123-186, model_supnerf.py:155-264),
so that its state_dicts load strictly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# net_hyperparams' field_dtype values (the JAX factory's): "bfloat16" rounds
# the operands of every dense layer of the field to bfloat16 and sums in
# float32; "float32" (or absent) is the reference's float32 field
FIELD_DTYPES = ("float32", "bfloat16")


def bf16_round(t):
    """t rounded to bfloat16 (to nearest, ties to even), in t's own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def positional_encoding(x, degree: int):
    """PE(x, L) = [x, sin(2^i x)..., cos(2^i x)...] with the frequencies
    stacked over the whole vector (reference model_supnerf.py:155-161):
    (..., D) -> (..., D (2L + 1))."""
    freqs = 2.0 ** torch.arange(degree, dtype=x.dtype, device=x.device)
    y = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], degree * x.shape[-1])
    return torch.cat([x, torch.sin(y), torch.cos(y)], -1)


def positional_encoding_doubling(x, degree: int):
    """positional_encoding through the double-angle recurrence (sin and cos of
    x are the only transcendentals). Rounding grows about 2x per doubling:
    ~3e-4 absolute at degree 10, below a bf16 cast of the result; for the
    bf16 render path (the float32 path uses the exact form)."""
    s, c = torch.sin(x), torch.cos(x)
    sins, coss = [s], [c]
    for _ in range(1, degree):
        s, c = 2.0 * s * c, 1.0 - 2.0 * s * s
        sins.append(s)
        coss.append(c)
    return torch.cat([x] + sins + coss, -1)


def _lin_relu(i, o):
    return nn.Sequential(nn.Linear(i, o), nn.ReLU())


class CodeNeRFDecoder(nn.Module):
    """Conditioned NeRF MLP: sigma from a shape-conditioned trunk, rgb from a
    view-direction and texture-conditioned branch.

    forward(xyz (..., 3), viewdir (..., 3), shapecode, texturecode) ->
    (sigmas (..., 1), rgbs (..., 3)); codes broadcast against the leading
    dims of xyz. The latent projections depend only on the code, so they are
    evaluated once per code and broadcast-added."""

    def __init__(self, shape_blocks: int = 3, texture_blocks: int = 1, W: int = 256,
                 latent_dim: int = 256, num_xyz_freq: int = 10, num_dir_freq: int = 4,
                 field_dtype: str = "float32"):
        super().__init__()
        if field_dtype not in FIELD_DTYPES:
            raise ValueError(f"field_dtype {field_dtype!r}: one of {FIELD_DTYPES}")
        self.field_dtype = field_dtype
        self.shape_blocks, self.texture_blocks = shape_blocks, texture_blocks
        self.num_xyz_freq, self.num_dir_freq = num_xyz_freq, num_dir_freq
        d_xyz, d_dir = 3 + 6 * num_xyz_freq, 3 + 6 * num_dir_freq
        self.encoding_xyz = _lin_relu(d_xyz, W)
        for j in range(1, shape_blocks + 1):
            setattr(self, f"shape_latent_layer_{j}", _lin_relu(latent_dim, W))
            setattr(self, f"shape_layer_{j}", _lin_relu(W, W))
        self.encoding_shape = nn.Linear(W, W)
        self.sigma = nn.Sequential(nn.Linear(W, 1), nn.Softplus())
        self.encoding_viewdir = _lin_relu(W + d_dir, W)
        for j in range(1, texture_blocks + 1):
            setattr(self, f"texture_latent_layer_{j}", _lin_relu(latent_dim, W))
            setattr(self, f"texture_layer_{j}", _lin_relu(W, W))
        self.rgb = nn.Sequential(nn.Linear(W, W // 2), nn.ReLU(), nn.Linear(W // 2, 3))

    def forward(self, xyz, viewdir, shapecode, texturecode):
        return decode(self, xyz, viewdir, shapecode, texturecode)


def decode(m, xyz, viewdir, shapecode, texturecode):
    """The CodeNeRF decoder chain on any module `m` that holds its layers
    under the reference names (CodeNeRFDecoder, SUPNeRF); in m's
    field_dtype (decode_bf16 for "bfloat16")."""
    if m.field_dtype == "bfloat16":
        return decode_bf16(m, xyz, viewdir, shapecode, texturecode)
    y = m.encoding_xyz(positional_encoding(xyz, m.num_xyz_freq))
    for j in range(1, m.shape_blocks + 1):
        y = y + getattr(m, f"shape_latent_layer_{j}")(shapecode)
        y = getattr(m, f"shape_layer_{j}")(y)
    y = m.encoding_shape(y)
    sigmas = m.sigma(y)
    dir_pe = positional_encoding(viewdir, m.num_dir_freq)
    y = m.encoding_viewdir(torch.cat([y, dir_pe.expand(*y.shape[:-1], -1)], -1))
    for j in range(1, m.texture_blocks + 1):
        y = y + getattr(m, f"texture_latent_layer_{j}")(texturecode)
        y = getattr(m, f"texture_layer_{j}")(y)
    return sigmas, m.rgb(y)


def decode_bf16(m, xyz, viewdir, shapecode, texturecode):
    """decode with flax TorchDense's bfloat16 contract
    (supnerf_tpu/models/layers.py TorchDense(dtype=bfloat16), the JAX
    decoder with field_dtype "bfloat16"): every layer, the latent
    projections included, takes its input and weight rounded to bfloat16,
    sums in float32 and adds its float32 bias; the encodings are the exact
    ones. Not the kernels' contract (ops/render.py decoder_chain_bf16)."""

    def dense(lin, x):
        return F.linear(bf16_round(x), bf16_round(lin.weight), lin.bias)

    def dense_relu(block, x):          # a _lin_relu block
        return F.relu(dense(block[0], x))

    y = dense_relu(m.encoding_xyz, positional_encoding(xyz, m.num_xyz_freq))
    for j in range(1, m.shape_blocks + 1):
        y = y + dense_relu(getattr(m, f"shape_latent_layer_{j}"), shapecode)
        y = dense_relu(getattr(m, f"shape_layer_{j}"), y)
    y = dense(m.encoding_shape, y)
    sigmas = F.softplus(dense(m.sigma[0], y))
    dir_pe = positional_encoding(viewdir, m.num_dir_freq)
    y = dense_relu(m.encoding_viewdir, torch.cat([y, dir_pe.expand(*y.shape[:-1], -1)], -1))
    for j in range(1, m.texture_blocks + 1):
        y = y + dense_relu(getattr(m, f"texture_latent_layer_{j}"), texturecode)
        y = dense_relu(getattr(m, f"texture_layer_{j}"), y)
    return sigmas, dense(m.rgb[2], F.relu(dense(m.rgb[0], y)))


class AutoRFDecoder(nn.Module):
    """The original AutoRF feature-averaging decoder (reference
    model_autorf.py:123-186): the shape and texture features are averaged
    with the positional feature between layers, rgb passes a sigmoid. No
    latent projections: the codes enter as features of width latent_dim.

    forward(xyz (..., 3), viewdir (..., 3), shape_feat, texture_feat) ->
    (sigmas (..., 1), rgbs (..., 3)); the features broadcast against the
    leading dims of xyz."""

    def __init__(self, shape_blocks: int = 5, texture_blocks: int = 5, latent_dim: int = 128,
                 num_xyz_freq: int = 10, num_dir_freq: int = 4):
        super().__init__()
        add_autorf_layers(self, shape_blocks, texture_blocks, latent_dim, num_xyz_freq,
                          num_dir_freq)

    def forward(self, xyz, viewdir, shape_feat, texture_feat):
        return autorf_decode(self, xyz, viewdir, shape_feat, texture_feat)


def add_autorf_layers(m, shape_blocks, texture_blocks, latent_dim, num_xyz_freq, num_dir_freq):
    """AutoRFDecoder's layers under the reference names, with its index
    quirks: shape_layer_{0..n-2}; texture_layer_{0..n-3} on the feature and
    texture_layer_{n-2} on the feature concatenated with the direction
    encoding, as is rgb."""
    m.shape_blocks, m.texture_blocks = shape_blocks, texture_blocks
    m.num_xyz_freq, m.num_dir_freq = num_xyz_freq, num_dir_freq
    d_xyz, d_dir, W = 3 + 6 * num_xyz_freq, 3 + 6 * num_dir_freq, latent_dim
    m.encoding_xyz = _lin_relu(d_xyz, W)
    for j in range(shape_blocks - 1):
        setattr(m, f"shape_layer_{j}", _lin_relu(W, W))
    m.sigma = nn.Sequential(nn.Linear(W, 1), nn.Softplus())
    for j in range(texture_blocks - 2):
        setattr(m, f"texture_layer_{j}", _lin_relu(W, W))
    setattr(m, f"texture_layer_{texture_blocks - 2}", _lin_relu(W + d_dir, W))
    m.rgb = nn.Sequential(nn.Linear(W + d_dir, 3), nn.Sigmoid())


def autorf_decode(m, xyz, viewdir, shape_feat, texture_feat):
    """The AutoRF decoder chain on any module holding add_autorf_layers'
    layers (AutoRFDecoder, AutoRF)."""
    pos = m.encoding_xyz(positional_encoding(xyz, m.num_xyz_freq))
    dir_pe = positional_encoding(viewdir, m.num_dir_freq).expand(*pos.shape[:-1], -1)
    sf = shape_feat.expand_as(pos)
    for j in range(m.shape_blocks - 1):
        sf = getattr(m, f"shape_layer_{j}")((sf + pos) / 2)
    sigmas = m.sigma((sf + pos) / 2)
    tf = texture_feat.expand_as(pos)
    for j in range(m.texture_blocks - 2):
        tf = getattr(m, f"texture_layer_{j}")((tf + pos) / 2)
    tf = (tf + sf + pos) / 3
    tf = getattr(m, f"texture_layer_{m.texture_blocks - 2}")(torch.cat([tf, dir_pe], -1))
    return sigmas, m.rgb(torch.cat([(tf + pos) / 2, dir_pe], -1))


class PoseRefinerMLP(nn.Module):
    """Projected-box pose refiner (reference model_supnerf.py:201-239): encodes
    the 8 ROI-normalised projected box corners (16-d) and regresses a 6-d pose
    delta against the image pose code.
    forward(im_feat (B, latent), box_uv (B, 16)) -> delta (B, 6)."""

    def __init__(self, pose_blocks: int = 3, regress_blocks: int = 3, W: int = 256,
                 pose_dim: int = 16, latent_dim: int = 256):
        super().__init__()
        add_refiner_layers(self, pose_blocks, regress_blocks, W, pose_dim, latent_dim)

    def forward(self, im_feat, box_uv):
        return refine(self, im_feat, box_uv)


def add_refiner_layers(m, pose_blocks, regress_blocks, W, pose_dim, latent_dim):
    m.pose_blocks, m.regress_blocks = pose_blocks, regress_blocks
    for j in range(pose_blocks):
        setattr(m, f"pose_layer_{j}", _lin_relu(pose_dim if j == 0 else W, W))
    for j in range(regress_blocks):
        setattr(m, f"regress_layer_{j}", _lin_relu(latent_dim + W if j == 0 else W, W))
    m.out_delta_layer = nn.Linear(W, 6)


def refine(m, im_feat, box_uv):
    """The refiner chain on any module holding its layers under the reference names."""
    p = box_uv
    for j in range(m.pose_blocks):
        p = getattr(m, f"pose_layer_{j}")(p)
    d = torch.cat([im_feat, p], -1)
    for j in range(m.regress_blocks):
        d = getattr(m, f"regress_layer_{j}")(d)
    return m.out_delta_layer(d)
