"""Host-side point order for K4's band (``cli.train --pixel_band``): the
JAX package's ``data/pixel_sort.py`` (``pixel_row_order`` :41,
``pixel_row_sort_batch`` :73), numpy only, with the same permutations bit
for bit.

K4's banded tap stage sums a 64-point tile's d(table) over a window of
``band`` feature-map rows in shared memory; a tile fits only where its
points' taps fall in few rows.  So the loader's workers sort each scene's
points by their approximate projected feature row before the step, where
the sort overlaps the device:

* the whole scene is sorted (not each half), stably;
* points that project outside the image (with a 4-pixel margin) go last;
  a point inside the margin sorts by its clamped row;
* the row is taken at the ground-truth hand root (``mano_root``): the
  predicted one is not known on the host;
* every per-point column (xyz, the SDF targets, the labels) moves with its
  point, and ``point_is_hand`` (B*N,) float32 records which points came
  from the hand half, in place of the positional [hand | obj] layout
  (``training/train_step.build_batch_masks`` reads it).

The kernel bounds each tile from the projection it is given and takes the
per-tap route where a tile does not fit, so a stale order costs time, not
correctness.  Reference projection: utils/utils.py:536-549.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

MARGIN = 4.0  # pixels around the image whose points still sort by row
PER_POINT = ("xyz", "sdf_gt_hand", "sdf_gt_obj", "labels")


def pixel_row_order(xyz: np.ndarray, cam_intr: np.ndarray, root: np.ndarray,
                    image_size: float, sdf_scale_factor: float,
                    feat_rows: int = 64) -> np.ndarray:
    """perm (N,): one scene's points (N, 3) ordered by approximate feature
    row, ascending and stable, those outside the image and its margin last.
    ``cam_intr`` (3, 3+), ``root`` (3,) the hand root in camera space."""
    cam = np.asarray(cam_intr, np.float32)[:3, :3]
    xyz_cam = xyz.astype(np.float32) * (2.0 / sdf_scale_factor) + \
        np.asarray(root, np.float32).reshape(1, 3)
    hom = xyz_cam @ cam.T
    with np.errstate(divide="ignore", invalid="ignore"):
        xi = hom[:, 0] / hom[:, 2]
        yi = hom[:, 1] / hom[:, 2]
    lo, hi = -MARGIN, image_size + MARGIN
    near = ((xi >= lo) & (xi <= hi) & (yi >= lo) & (yi <= hi)
            & np.isfinite(xi) & np.isfinite(yi))
    row = np.clip(yi * ((feat_rows - 1) / image_size), 0.0, feat_rows - 1.0)
    return np.argsort(np.where(near, row, np.float32(1e9)), kind="stable")


def pixel_row_sort_batch(batch: Dict[str, np.ndarray], image_size: float,
                         sdf_scale_factor: float,
                         feat_rows: int = 64) -> Dict[str, np.ndarray]:
    """A copy of the train batch with each scene's per-point arrays (xyz
    (B*N, 3), sdf_gt_hand / sdf_gt_obj (B*N, 1), labels (B*N,)) in
    ``pixel_row_order`` and ``point_is_hand`` (B*N,) added; the other keys
    unchanged.  Scene s's order uses ``cam_intr[s]`` and ``mano_root[s]``."""
    xyz = np.asarray(batch["xyz"])
    cam = np.asarray(batch["cam_intr"])
    root = np.asarray(batch["mano_root"])
    b, m = cam.shape[0], xyz.shape[0]
    n = m // b
    perm = np.concatenate([
        s * n + pixel_row_order(xyz[s * n:(s + 1) * n], cam[s], root[s], image_size,
                                sdf_scale_factor, feat_rows)
        for s in range(b)]).astype(np.int64)
    half = n // 2
    is_hand = np.tile(np.concatenate([np.ones(half, np.float32),
                                      np.zeros(n - half, np.float32)]), b)
    out = dict(batch)
    for key in PER_POINT:
        if key in out and np.asarray(out[key]).shape[:1] == (m,):
            out[key] = np.asarray(out[key])[perm]
    out["point_is_hand"] = is_hand[perm]
    return out
