"""Camera and pose geometry, matched to the JAX package's ``ops/geometry.py``
(reference utils/utils.py:466-558, networks/manobranch.py:9-22)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def soft_argmax(heatmaps: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W) heatmap volume -> (B, 1, 3) expected (x, y, z) in voxels:
    softmax over the flattened volume, then per-axis expectation."""
    b, d, h, w = heatmaps.shape
    probs = torch.softmax(heatmaps.reshape(b, 1, d * h * w), dim=2)
    probs = probs.reshape(b, 1, d, h, w)

    def ramp(k):
        return torch.arange(k, dtype=heatmaps.dtype, device=heatmaps.device)[None, None]

    accu_x = probs.sum(dim=(2, 3)) * ramp(w)
    accu_y = probs.sum(dim=(2, 4)) * ramp(h)
    accu_z = probs.sum(dim=(3, 4)) * ramp(d)
    return torch.stack(
        [accu_x.sum(dim=2), accu_y.sum(dim=2), accu_z.sum(dim=2)], dim=2)


def get_obj_trans(
    obj_center: torch.Tensor,
    center3d: torch.Tensor,
    cam_intr: torch.Tensor,
    obj_rot: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Back-project the soft-argmax object center to a hand-root-relative
    (B, 4, 4): x/y upsampled x4 to image pixels, z bin mapped to the root
    depth +/- 0.28 m.  Returns (obj_trans, camera-frame center (B, 3))."""
    batch = obj_center.shape[0]
    xy = obj_center[:, 0, :2] * 4.0
    z = (obj_center[:, 0, 2] / 64.0 * 2.0 - 1.0) * 0.28 + center3d[:, 0, 2]

    fx, fy = cam_intr[:, 0, 0], cam_intr[:, 1, 1]
    cx, cy = cam_intr[:, 0, 2], cam_intr[:, 1, 2]
    cam_x = (xy[:, 0] - cx) / fx * z
    cam_y = (xy[:, 1] - cy) / fy * z
    cam_obj_center = torch.stack([cam_x, cam_y, z], dim=1)
    obj_t = cam_obj_center - center3d[:, 0, :]

    if obj_rot is None:
        obj_rot = torch.eye(3, dtype=obj_t.dtype, device=obj_t.device).expand(batch, 3, 3)
    top = torch.cat([obj_rot, obj_t[:, :, None]], dim=2)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=obj_t.dtype,
                          device=obj_t.device).expand(batch, 1, 4)
    return torch.cat([top, bottom], dim=1), cam_obj_center


def recover_3d_proj(
    objpoints3d: torch.Tensor,
    camintr: torch.Tensor,
    est_scale: torch.Tensor,
    est_trans: torch.Tensor,
    off_z: float = 0.4,
    input_res: Tuple[int, int] = (256, 256),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weak-perspective scale/trans -> absolute camera-frame points."""
    batch = objpoints3d.shape[0]
    focal = camintr[:, 0:1, 0]
    est_z0 = focal * est_scale.reshape(batch, 1) + off_z
    cam_centers = camintr[:, :2, 2]
    img_centers = torch.tensor(input_res, dtype=camintr.dtype,
                               device=camintr.device).expand(batch, 2) / 2.0
    est_xy0 = (est_trans.reshape(batch, 2) + img_centers - cam_centers) * est_z0 / focal
    est_c3d = torch.cat([est_xy0, est_z0], dim=-1)[:, None]
    return est_c3d + objpoints3d, est_c3d


def keys_cubic_taps(t: torch.Tensor) -> torch.Tensor:
    """(..., 4) Keys cubic weights (A = -0.75, torch's bicubic kernel) of the
    taps floor(p) - 1 .. floor(p) + 2 at fraction t = p - floor(p)."""
    a = -0.75

    def near(s):
        return ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0

    def far(s):
        return (((s - 5.0) * s + 8.0) * s - 4.0) * a

    return torch.stack([far(1.0 + t), near(t), near(1.0 - t), far(2.0 - t)], dim=-1)


def keys_cubic_grad(t: torch.Tensor) -> torch.Tensor:
    """d/dt of the Keys cubic K(t) (A = -0.75), continuous at |t| = 1 and 2
    (the JAX package's ``ops/decoder_train_pixel.py:_keys_cubic_grad``)."""
    a = -0.75
    s = t.abs()
    near = 3.0 * (a + 2.0) * s * s - 2.0 * (a + 3.0) * s
    far = a * ((3.0 * s - 10.0) * s + 8.0)
    mag = torch.where(s <= 1.0, near, torch.where(s < 2.0, far, torch.zeros_like(s)))
    return torch.sign(t) * mag


def pixel_coords(xyz: torch.Tensor, cam_intr: torch.Tensor, pred_root: torch.Tensor,
                 image_size: int, sdf_scale_factor: float, hf: int, wf: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(xp, yp, mask), each (B, N): the feature-map column and row of each
    point's projection and 1.0 where it lies in the image (else 0.0, with
    xp = yp = 0; a non-finite projection fails the in-image test).  ``xyz``
    (B*N, 3) half-scaled points, ``cam_intr`` (B, 3, 3+), ``pred_root``
    (B, 1, 3).

    The operations run in the order of the JAX package's pixel train decoder
    (``ops/decoder_train_pixel.py`` decode): a reassociated formula moves
    xp by ~1e-6 px, enough to flip single units at ReLU's edge downstream.
    Differentiable in ``pred_root`` (and ``xyz``, ``cam_intr``)."""
    b = cam_intr.shape[0]
    xyz_cam = xyz.reshape(b, -1, 3) * 2.0 / sdf_scale_factor + pred_root
    hom = torch.einsum("bij,bnj->bni", cam_intr[:, :3, :3], xyz_cam)
    xy_img = hom[..., :2] / hom[..., 2:3]
    uv = xy_img / image_size * 2.0 - 1.0
    in_img = ((uv[..., 0] >= -1.0) & (uv[..., 0] <= 1.0)
              & (uv[..., 1] >= -1.0) & (uv[..., 1] <= 1.0))
    xp = (uv[..., 0] + 1.0) * 0.5 * (wf - 1)
    yp = (uv[..., 1] + 1.0) * 0.5 * (hf - 1)
    zero = torch.zeros_like(xp)
    return torch.where(in_img, xp, zero), torch.where(in_img, yp, zero), in_img.to(xp.dtype)


def bicubic_gather(table: torch.Tensor, xp: torch.Tensor, yp: torch.Tensor,
                   hf: int, wf: int, weight_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bicubic sample of a channel-contiguous map at pixel coordinates.

    ``table`` (B, >= hf * wf, C) holds row-major pixels; ``xp``, ``yp`` (B, N)
    are column / row coordinates.  Sums the 4 x 4 taps around each point;
    a tap outside the map contributes zero (padding_mode='zeros').
    Non-finite coordinates sample as if 10 pixels off the map (zero).
    Each tap's weight ky kx is rounded to ``weight_dtype`` (bfloat16: the
    bf16 grid kernel K3's taps).  Returns (B, N, C).
    """
    b, n = xp.shape
    c = table.shape[-1]

    def guard(p, size):
        # non-finite -> off the map (the JAX package's -10 guard); clamping
        # to [-3, size + 2] changes no weight, since every tap of a point
        # past -2 or size + 1 is off the map, and keeps the int cast defined
        p = torch.where(torch.isfinite(p), p, torch.full_like(p, -10.0))
        return p.clamp(-3.0, size + 2.0)

    xp, yp = guard(xp, wf), guard(yp, hf)
    x0, y0 = torch.floor(xp), torch.floor(yp)
    wx, wy = keys_cubic_taps(xp - x0), keys_cubic_taps(yp - y0)
    x0, y0 = x0.long(), y0.long()
    flat = table.reshape(-1, c)
    offset = (torch.arange(b, device=table.device) * table.shape[1])[:, None]
    out = torch.zeros(b, n, c, dtype=table.dtype, device=table.device)
    for i in range(4):
        row = y0 + (i - 1)
        for j in range(4):
            col = x0 + (j - 1)
            valid = (row >= 0) & (row < hf) & (col >= 0) & (col < wf)
            idx = torch.where(valid, row * wf + col, 0) + offset
            w = torch.where(valid, wy[..., i] * wx[..., j], 0.0)
            if weight_dtype != torch.float32:
                w = w.to(weight_dtype).to(torch.float32)
            out += w[..., None] * flat.index_select(0, idx.reshape(-1)).reshape(b, n, c)
    return out


def grid_sample_bicubic(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bicubic sampling of (B, C, H, W) features at (B, N, 2) normalized
    coordinates: the function of ``F.grid_sample(feat, uv[:, None],
    mode='bicubic', align_corners=True, padding_mode='zeros')`` (reference
    utils/utils.py:550), computed from the 16 taps directly.  Returns
    (B, N, C)."""
    b, c, h, w = feat.shape
    x = (uv[..., 0] + 1.0) * 0.5 * (w - 1)
    y = (uv[..., 1] + 1.0) * 0.5 * (h - 1)
    table = feat.reshape(b, c, h * w).transpose(1, 2)
    return bicubic_gather(table, x, y, h, w)


def pixel_alignment(img_feat: torch.Tensor, xyz: torch.Tensor, cam_intr: torch.Tensor,
                    pred_root: torch.Tensor, image_size: int,
                    scale_factor: float) -> torch.Tensor:
    """Project SDF query points into the image and sample per-point features
    bicubically; points outside the image take the map's mean feature
    (reference utils/utils.py:536-558).

    ``img_feat`` (B, C, Hf, Wf); ``xyz`` (B*N, 3) half-scaled points;
    ``cam_intr`` (B, 3, 3+); ``pred_root`` (B, 1, 3) camera-frame hand root.
    Returns (B*N, C)."""
    batch = img_feat.shape[0]
    xyz = xyz.reshape(batch, -1, 3)
    xyz_cam = xyz * 2.0 / scale_factor + pred_root
    xy_hom = torch.einsum("bij,bnj->bni", cam_intr[:, :3, :3], xyz_cam)
    xy_img = xy_hom[..., :2] / xy_hom[..., 2:3]
    uv = xy_img / image_size * 2.0 - 1.0
    sampled = grid_sample_bicubic(img_feat, uv)
    in_img = ((uv[..., 0] >= -1.0) & (uv[..., 0] <= 1.0)
              & (uv[..., 1] >= -1.0) & (uv[..., 1] <= 1.0))
    mean_feat = img_feat.mean(dim=(2, 3))
    out = torch.where(in_img[..., None], sampled, mean_feat[:, None, :])
    return out.reshape(batch * xyz.shape[1], -1)
