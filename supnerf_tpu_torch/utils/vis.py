"""The visualisation helpers that draw on arrays, in numpy; the port of
supnerf_tpu/utils/vis.py: the TTO panels (reference utils.py: render_box
:1200 and the optimizer's save_img3 panel layout :1597-1641,
save_virtual_img :1643-1655), colorize_depth, and the KITTI debug images
(compute_box_3d, draw_projected_box3d, show_image_with_boxes,
show_lidar_on_image). The drawing is utils/draw.py's, which gives cv2's
pixels, and the colour tables utils/colormaps.py's, which are
matplotlib's. The JAX module's draw_lidar_3d, draw_boxes3d_on_axes and
show_lidar_with_boxes_3d draw on matplotlib axes and are not ported."""
from __future__ import annotations

import numpy as np

from supnerf_tpu_torch.data.kitti_format import get_lidar_in_image_fov
from supnerf_tpu_torch.utils.colormaps import HSV_255, MAGMA_BYTES
from supnerf_tpu_torch.utils.draw import circles, line, put_text, rectangle


def render_box(im: np.ndarray, corners_2d: np.ndarray,
               colors=((0, 0, 1), (1, 0, 0), (0, 0, 0)), linewidth: int = 2) -> np.ndarray:
    """Draw a projected 3D box's wireframe on a contiguous copy of im.
    corners_2d: (2 or 3, 8), the first four corners the front face; colors
    (front, rear, sides) as RGB, drawn channel-reversed as cv2's BGR; the
    corners truncate toward zero. The heading tick runs from the bottom's
    centre to the bottom-front edge's centre. Returns the copy."""
    im = np.ascontiguousarray(im)

    def pt(c):
        return int(c[0]), int(c[1])

    def draw_rect(pts, color):
        prev = pts[-1]
        for corner in pts:
            line(im, pt(prev), pt(corner), color, linewidth)
            prev = corner

    c = np.asarray(corners_2d).T
    for i in range(4):
        line(im, pt(c[i]), pt(c[i + 4]), tuple(colors[2])[::-1], linewidth)
    draw_rect(c[:4], tuple(colors[0])[::-1])
    draw_rect(c[4:], tuple(colors[1])[::-1])
    front = np.mean(c[2:4], axis=0)
    bottom = np.mean(c[[2, 3, 7, 6]], axis=0)
    line(im, pt(bottom), pt(front), tuple(colors[0])[::-1], linewidth)
    return im


def colorize_depth(depth: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """Depth -> uint8 RGB through matplotlib's magma table, as its lookup
    with bytes=True: the values scaled to [0, 1] between vmin and vmax
    (default the finite values' 2nd and 98th percentiles), index int(x *
    256) with 1.0 at 255, NaN black (the table's "bad" colour)."""
    d = np.asarray(depth, np.float64)
    finite = np.isfinite(d)
    vmin = np.percentile(d[finite], 2) if vmin is None else vmin
    vmax = np.percentile(d[finite], 98) if vmax is None else vmax
    if vmax - vmin < 1e-9:
        vmax = vmin + 1e-9
    x = np.clip((d - vmin) / (vmax - vmin), 0, 1) * 256
    x[x == 256] = 255
    bad = np.isnan(x)
    out = np.asarray(MAGMA_BYTES, np.uint8)[np.where(bad, 0, x).astype(int)]
    out[bad] = 0
    return out


def normalize_for_vis(img: np.ndarray) -> np.ndarray:
    """Z-normalise, then min-max to [0, 1] (the depth panel's normalisation,
    reference optimizer_nuscenes.py:1607-1609)."""
    img = np.asarray(img, np.float64)
    img = (img - img.mean()) / (img.std() + 1e-9)
    img = img - img.min()
    return img / (img.max() - img.min() + 1e-9)


def panel_rgb_depth_gt(rendered: np.ndarray, depth: np.ndarray, gt: np.ndarray,
                       psnr=None, depth_err=None, rot_err=None, trans_err=None) -> np.ndarray:
    """[render | normalised depth | target] uint8 panel, (H, 3W, 3), with the
    metrics printed in black at the top left."""
    H, W = rendered.shape[:2]
    out = np.zeros((H, 3 * W, 3), np.float32)
    out[:, :W] = np.clip(rendered, 0, 1)
    out[:, W:2 * W] = np.repeat(normalize_for_vis(depth)[..., None], 3, axis=-1)
    out[:, 2 * W:] = np.clip(gt, 0, 1)
    out = (out * 255).astype(np.uint8)
    ratio = H / 128
    thickness = max(int(ratio), 1)
    if psnr is not None and depth_err is not None:
        put_text(out, f"PSNR: {psnr:.3f},  DE: {depth_err:.3f}",
                 (int(5 * ratio), int(10 * ratio)), 0.35 * ratio, (0, 0, 0), thickness)
    if rot_err is not None and trans_err is not None:
        put_text(out, f"RE: {rot_err:.3f},  TE: {trans_err:.3f}",
                 (int(5 * ratio), int(21 * ratio)), 0.35 * ratio, (0, 0, 0), thickness)
    return out


def virtual_view_sheet(views: np.ndarray) -> np.ndarray:
    """(N, H, W, 3) ring of virtual views -> a two-row uint8 sheet, the
    second row padded white when N is odd."""
    n, H, W = views.shape[:3]
    half = (n + 1) // 2
    rows = []
    for r in range(2):
        imgs = views[r * half:(r + 1) * half]
        if len(imgs) < half:
            pad = np.ones((half - len(imgs), H, W, 3), views.dtype)
            imgs = np.concatenate([imgs, pad]) if len(imgs) else pad
        rows.append(np.concatenate(list(imgs), axis=1))
    sheet = np.concatenate(rows, axis=0)
    return (np.clip(sheet, 0, 1) * 255).astype(np.uint8)


# --------------------------------------------------------------------------
# KITTI debug images (the JAX module's headless equivalents of the
# reference's kitti_object_vis helpers: compute_box_3d kitti_util.py:601,
# show_image_with_boxes kitti_object.py:186, show_lidar_on_image :676)
# --------------------------------------------------------------------------

# 2D box colours per KITTI category (kitti_object.py:196-217)
_KITTI_BOX_COLORS = {"Car": (0, 255, 0), "Pedestrian": (255, 255, 0),
                     "Cyclist": (0, 255, 255)}


def compute_box_3d(obj, P: np.ndarray):
    """A KITTI label's 3D box (yaw ry about +y, t at the bottom face's
    centre, y down) -> (corners_2d (8, 2), or None if a corner lies less
    than 0.1 in front of the camera; corners_3d (8, 3) in rect camera
    coordinates), in float64."""
    c, s = np.cos(obj.ry), np.sin(obj.ry)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    l, w, h = obj.l, obj.w, obj.h
    x = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    y = np.array([0, 0, 0, 0, -h, -h, -h, -h], np.float64)
    z = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    corners_3d = (R @ np.vstack([x, y, z])).T + np.asarray(obj.t)
    if np.any(corners_3d[:, 2] < 0.1):
        return None, corners_3d
    uvw = corners_3d @ np.asarray(P)[:3, :3].T + np.asarray(P)[:3, 3]
    return uvw[:, :2] / uvw[:, 2:3], corners_3d


def draw_projected_box3d(image: np.ndarray, qs: np.ndarray, color=(0, 255, 0),
                         thickness: int = 2) -> np.ndarray:
    """A projected box's wireframe on a contiguous copy of image: the bottom
    ring (corners 0-3), the top ring (4-7) and the pillars, the corners
    truncated to integers. Returns the copy."""
    image = np.ascontiguousarray(image)
    qs = np.asarray(qs).astype(np.int32)
    for k in range(4):
        i, j = k, (k + 1) % 4
        line(image, qs[i], qs[j], color, thickness)
        line(image, qs[k + 4], qs[(k + 1) % 4 + 4], color, thickness)
        line(image, qs[k], qs[k + 4], color, thickness)
    return image


def show_image_with_boxes(img: np.ndarray, objects, calib, show3d: bool = True):
    """(img with the labels' 2D boxes, img with their projected 3D
    wireframes) for a KITTI frame; objects: data.kitti_format.Object3d
    list, calib with .P. Categories without a colour are skipped."""
    img1, img2 = np.copy(img), np.copy(img)
    for obj in objects:
        color = _KITTI_BOX_COLORS.get(obj.type)
        if color is None:
            continue
        rectangle(img1, (int(obj.xmin), int(obj.ymin)), (int(obj.xmax), int(obj.ymax)),
                  color, 2)
        if show3d:
            box3d_pts_2d, _ = compute_box_3d(obj, calib.P)
            if box3d_pts_2d is not None:
                img2 = draw_projected_box3d(img2, box3d_pts_2d, color=color)
    return img1, img2


def show_lidar_on_image(pc_velo: np.ndarray, img: np.ndarray, calib, img_width: int,
                        img_height: int) -> np.ndarray:
    """A copy of img with the lidar returns in the image splatted as filled
    circles of radius 2, coloured from matplotlib's hsv table at index
    int(clip(640 / depth, 0, 255)), in the points' order."""
    img = np.copy(img)
    pc_velo = np.asarray(pc_velo)[:, :3]
    _, pts_2d, fov_inds = get_lidar_in_image_fov(pc_velo, calib, 0, 0, img_width, img_height,
                                                 return_more=True)
    uv = pts_2d[fov_inds, :]
    depth = np.maximum(calib.project_velo_to_rect(pc_velo[fov_inds])[:, 2].astype(np.float64),
                       1e-3)
    colors = np.asarray(HSV_255)[np.clip(640.0 / depth, 0, 255).astype(int)]
    return circles(img, np.rint(uv[:, :2]).astype(np.int64), 2, colors, -1)
