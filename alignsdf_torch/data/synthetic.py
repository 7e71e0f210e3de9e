"""Synthetic training data for smoke runs and tests, numpy only: batches
(the JAX package's ``data/synthetic.py:synthetic_train_batch``, the same
keys, shapes and seeding, so both packages draw the same batch from one
seed) and an on-disk LMDB dataset (``write_synthetic_lmdb``)."""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from alignsdf_torch.config import Specs
from alignsdf_torch.data.lmdb_format import LmdbWriter

SDF_ROWS = 20000  # fixed SDF block height (reference tools/create_lmdb.py:205)
_OBMAN_INTR = np.array([[480.0, 0, 128], [0, 480.0, 128], [0, 0, 1]], np.float32)


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


def _write_lmdb(path: str, records: Dict[str, np.ndarray], meta_info: Dict) -> None:
    with LmdbWriter(path) as w:
        for key, value in records.items():
            w.put(key, np.ascontiguousarray(value))
    with open(os.path.join(path, "meta_info.json"), "w") as f:
        json.dump(meta_info, f, indent=2)


def write_synthetic_lmdb(root: str, keys: List[str], dataset: str = "obman",
                         n_points: int = 4000, seed: int = 0, image_hw: int = 256,
                         split: str = "train") -> str:
    """A synthetic dataset in the reference's five-LMDB layout under
    ``<root>/<dataset>/<split>`` (returned): rgb, norm, meta, sdf_hand and
    sdf_obj, each with its meta_info.json (reference
    tools/create_lmdb.py:21-310).

    It draws what the JAX package's ``write_synthetic_dataset`` draws, in the
    same order from one ``RandomState(seed)``, and packs it as the JAX
    package's ``tools/create_lmdb.py:create_lmdbs`` does: the norm, meta and
    SDF databases are byte for byte theirs.  The images are stored raw
    (uniform random RGB, BGR on disk) where theirs pass through a JPEG file
    first."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, dataset, split)
    rgb, norm, meta = {}, {}, {}
    sdf = {"sdf_hand": {}, "sdf_obj": {}}
    counts = {"sdf_hand": ([], []), "sdf_obj": ([], [])}
    half = n_points // 2

    def sdf_block(sign):
        xyz = rng.randn(half, 3).astype(np.float32) * 0.4
        dist = (np.abs(rng.randn(half, 1)) * 0.2 * sign).astype(np.float32)
        return np.concatenate([xyz, dist], axis=1)

    for key in keys:
        img = (rng.rand(image_hw, image_hw, 3) * 255).astype(np.uint8)
        rgb[key] = img[:, :, ::-1]
        scale = np.float32(rng.uniform(4.0, 6.0))
        offset = rng.randn(3).astype(np.float32) * 0.1
        norm[key] = np.concatenate([offset, [scale]]).astype(np.float32)
        for sub in ("sdf_hand", "sdf_obj"):
            pos, neg = sdf_block(1.0), sdf_block(-1.0)
            pos_other = (rng.randn(half, 1) * 0.2).astype(np.float32)
            neg_other = (rng.randn(half, 1) * 0.2).astype(np.float32)
            labs = [rng.randint(0, 4, (half, 4)).astype(np.float32) for _ in range(4)]
            if sub == "sdf_hand":  # lab_pos, lab_neg: column 0
                pos_rows = np.concatenate([pos, pos_other, labs[0][:, [0]]], axis=1)
                neg_rows = np.concatenate([neg, neg_other, labs[1][:, [0]]], axis=1)
            else:  # the hand's sdf in column 3; lab_pos_other, lab_neg_other
                pos_rows = np.concatenate([pos[:, :3], pos_other, pos[:, [3]], labs[2][:, [0]]],
                                          axis=1)
                neg_rows = np.concatenate([neg[:, :3], neg_other, neg[:, [3]], labs[3][:, [0]]],
                                          axis=1)
            block = np.zeros((SDF_ROWS, 6), np.float32)
            block[:2 * half] = np.concatenate([pos_rows, neg_rows], axis=0)
            sdf[sub][key] = block
            counts[sub][0].append(half)
            counts[sub][1].append(half)
        block = np.zeros((61, 3), np.float32)
        block[:21] = rng.randn(21, 3).astype(np.float32) * 0.05 + np.array([0, 0.0, -0.6],
                                                                             np.float32)
        block[21:30] = rng.randn(9, 3).astype(np.float32) * 0.05 + np.array([0, 0.0, -0.6],
                                                                              np.float32)
        block[30:39] = rng.randn(9, 3).astype(np.float32) * 0.05
        block[39:54] = (rng.randn(45).astype(np.float32) * 0.1).reshape(-1, 3)
        block[54:58] = np.eye(4, dtype=np.float32)[:3, :].reshape(-1, 3)
        block[58:61] = _OBMAN_INTR  # the pkl's cam_intr, which the packer also writes for obman
        meta[key] = block

    keys = list(keys)
    _write_lmdb(os.path.join(base, "rgb.lmdb"), rgb, {"name": f"{dataset}_rgb_{split}"})
    _write_lmdb(os.path.join(base, "norm.lmdb"), norm,
                {"name": f"{dataset}_norm_{split}", "keys": keys})
    _write_lmdb(os.path.join(base, "meta.lmdb"), meta,
                {"name": f"{dataset}_meta_{split}", "keys": keys})
    for sub in ("sdf_hand", "sdf_obj"):
        _write_lmdb(os.path.join(base, f"{sub}.lmdb"), sdf[sub], {
            "name": f"{dataset}_{sub}_{split}", "pos_num": counts[sub][0],
            "neg_num": counts[sub][1], "dim": 6, "keys": keys})
    return base
