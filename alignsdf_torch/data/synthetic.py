"""Synthetic training batches for smoke runs and tests (the JAX package's
``data/synthetic.py:synthetic_train_batch``): numpy only, the same keys,
shapes and seeding, so both packages draw the same batch from one seed."""

from __future__ import annotations

from typing import Dict

import numpy as np

from alignsdf_torch.config import Specs


def synthetic_train_batch(specs: Specs, batch_size: int = 2,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """A random batch with the shapes and layout of a training batch: image
    (B, H, W, 3) float32 (already normalized), xyz (B*N, 3), per-point SDF
    targets (B*N, 1) and labels (B*N,), and the per-scene pose targets."""
    rng = np.random.RandomState(seed)
    n = specs.samples_per_scene
    h, w = specs.image_size
    total = batch_size * n
    cam = np.tile(
        np.concatenate(
            [np.array([[480.0, 0, 128], [0, 480.0, 128], [0, 0, 1]], np.float32),
             np.zeros((3, 1), np.float32)], axis=1,
        )[None], (batch_size, 1, 1),
    )
    return {
        "image": rng.rand(batch_size, h, w, 3).astype(np.float32),
        "xyz": (rng.randn(total, 3) * 0.3).astype(np.float32),
        "sdf_gt_hand": (rng.randn(total, 1) * 0.03).astype(np.float32),
        "sdf_gt_obj": (rng.randn(total, 1) * 0.03).astype(np.float32),
        "labels": rng.randint(-1, specs.network_specs.num_class, total).astype(np.int32),
        "cam_intr": cam,
        "mano_root": (rng.randn(batch_size, 3) * 0.05
                      + np.array([0, 0, 0.6], np.float32)).astype(np.float32),
        "rest_obj_corners": (rng.randn(batch_size, 8, 3) * 0.05).astype(np.float32),
        "hand_joints_3d": (rng.randn(batch_size, 21, 3) * 0.05
                           + np.array([0, 0, 0.6], np.float32)).astype(np.float32),
        "obj_center": (rng.rand(batch_size, 3) * 64).astype(np.float32),
        "obj_corners": (rng.randn(batch_size, 8, 3) * 0.05).astype(np.float32),
    }
