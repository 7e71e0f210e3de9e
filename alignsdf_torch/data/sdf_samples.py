"""SDF sample unpacking and sampling in numpy (the JAX package's
``data/sdf_samples.py``; reference utils/sdf_utils.py).

Static-shape by construction: the pos/neg split-half sampling draws exactly
``subsample/2`` indices with replacement from the filtered sets (reference
utils/sdf_utils.py:144-152 does the same via ``(rand*len).long()``), so every
scene yields the same array shapes regardless of NaN/dist filtering.  The
per-file layout's readers (``unpack_normal_params``, ``unpack_meta_params``,
``unpack_test_params``) read its ``.npz`` files with numpy and its ``.pkl``
files with pickle.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Tuple

import numpy as np

# ObMan's fixed camera: its intrinsics, and the extrinsic flip from its
# frame (y, z) to the camera's (reference utils/sdf_utils.py:88-116)
OBMAN_INTR = np.array([[480.0, 0, 128], [0, 480.0, 128], [0, 0, 1]], np.float32)
OBMAN_EXTR = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)


def remove_nans(arr: np.ndarray) -> np.ndarray:
    """Drop rows whose sdf (col 3) is NaN (reference utils/sdf_utils.py:7-9)."""
    return arr[~np.isnan(arr[:, 3])]


def filter_invalid_sdf(arr: np.ndarray, lab: Optional[np.ndarray], dist: float):
    """Keep rows with |sdf_self| < dist and |sdf_other| < dist
    (reference utils/sdf_utils.py:12-19)."""
    keep = (np.abs(arr[:, 3]) < abs(dist)) & (np.abs(arr[:, 4]) < abs(dist))
    if lab is None:
        return arr[keep], None
    return arr[keep], lab[keep]


def _sample_half(
    pos: np.ndarray,
    neg: np.ndarray,
    lab_pos: Optional[np.ndarray],
    lab_neg: Optional[np.ndarray],
    half: int,
    uniforms: Tuple[np.ndarray, np.ndarray],
):
    """Split-half sampling with uniform draws in [0,1) mapped to indices
    (reference utils/sdf_utils.py:144-152).  ``uniforms`` injectable for
    deterministic tests."""
    u_pos, u_neg = uniforms
    idx_pos = (u_pos * max(pos.shape[0], 1)).astype(np.int64) % max(pos.shape[0], 1)
    idx_neg = (u_neg * max(neg.shape[0], 1)).astype(np.int64) % max(neg.shape[0], 1)
    sample_pos = pos[idx_pos] if pos.shape[0] else np.zeros((half, pos.shape[1]), pos.dtype)
    sample_neg = neg[idx_neg] if neg.shape[0] else np.zeros((half, neg.shape[1]), neg.dtype)
    out_lab = None
    if lab_pos is not None:
        lp = lab_pos[idx_pos] if lab_pos.shape[0] else np.zeros((half,) + lab_pos.shape[1:], lab_pos.dtype)
        ln = lab_neg[idx_neg] if lab_neg.shape[0] else np.zeros((half,) + lab_neg.shape[1:], lab_neg.dtype)
        out_lab = np.concatenate([lp, ln], axis=0)
    return np.concatenate([sample_pos, sample_neg], axis=0), out_lab


def unpack_sdf_samples(
    data_source: str,
    key: str,
    subsample: int,
    hand: bool,
    clamp: Optional[float],
    filter_dist: bool,
    rng: Optional[np.random.Generator] = None,
    uniforms: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference-compatible npz path (reference utils/sdf_utils.py:166-232).

    Returns (samples (subsample, 5) [xyz, sdf_hand, sdf_obj], labels (subsample,)).
    """
    sub = "sdf_hand" if hand else "sdf_obj"
    npz = np.load(os.path.join(data_source, sub, key + ".npz"))

    pos = remove_nans(np.asarray(npz["pos"], np.float32))
    neg = remove_nans(np.asarray(npz["neg"], np.float32))
    pos_other = np.asarray(npz["pos_other"], np.float32)
    neg_other = np.asarray(npz["neg_other"], np.float32)
    if hand:
        lab_pos = np.asarray(npz["lab_pos"], np.float32)
        lab_neg = np.asarray(npz["lab_neg"], np.float32)
    else:
        lab_pos = np.asarray(npz["lab_pos_other"], np.float32)
        lab_neg = np.asarray(npz["lab_neg_other"], np.float32)

    # column order: always [xyz, sdf_hand, sdf_obj]
    if hand:
        pos = np.concatenate([pos, pos_other], axis=1)
        neg = np.concatenate([neg, neg_other], axis=1)
    else:
        pos = np.concatenate([pos[:, :3], pos_other, pos[:, 3:4]], axis=1)
        neg = np.concatenate([neg[:, :3], neg_other, neg[:, 3:4]], axis=1)

    if filter_dist:
        pos, lab_pos = filter_invalid_sdf(pos, lab_pos, 2.0)
        neg, lab_neg = filter_invalid_sdf(neg, lab_neg, 2.0)

    half = subsample // 2
    if uniforms is None:
        rng = rng or np.random.default_rng()
        uniforms = (rng.random(half, np.float32), rng.random(half, np.float32))
    samples, labs = _sample_half(pos, neg, lab_pos, lab_neg, half, uniforms)

    # hand part label: column 0 of the (N, 4) label block
    labels = labs[:, 0].copy() if labs is not None and labs.ndim == 2 else (
        labs.copy() if labs is not None else np.zeros(subsample, np.float32))

    if clamp:
        labels[samples[:, 3] < -clamp] = -1
        labels[samples[:, 3] > clamp] = -1
    if not hand:
        labels[:] = -1

    return samples, labels


def meta_from_block(block: np.ndarray, dataset: str) -> Dict[str, np.ndarray]:
    """Decode the packed (61, 3) meta block (layout from the reference LMDB
    packer, tools/create_lmdb.py:106-115; decode per utils/sdf_utils.py:41-62):
    joints(21) | corners(9) | rest corners(9) | pose(15x3) | affine(4x3 ->
    reshape (3,4)) | intrinsics(3x3)."""
    block = np.asarray(block, np.float32).reshape(61, 3)
    info: Dict[str, np.ndarray] = {
        "joints_3d": block[:21].copy(),
        "obj_corners_3d": block[21:30].copy(),
        "obj_rest_corners_3d": block[30:39].copy(),
        "hand_pose": block[39:54].reshape(-1).copy(),
    }
    affine = np.zeros((4, 4), np.float32)
    affine[3, 3] = 1.0
    affine[:3, :4] = block[54:58].reshape(3, 4)
    info["affine_transform"] = affine
    cam_intr = np.zeros((3, 4), np.float32)
    if dataset == "obman":
        cam_intr[:3, :3] = OBMAN_INTR
    else:
        cam_intr[:3, :3] = block[58:61]
    info["cam_intr"] = cam_intr
    return info


def unpack_normal_params(data_source: str, key: str) -> Tuple[np.ndarray, np.ndarray]:
    """norm/<key>.npz {scale, offset} (reference utils/sdf_utils.py:33-38)."""
    npz = np.load(os.path.join(data_source, "norm", key + ".npz"))
    return np.asarray(npz["scale"], np.float32), np.asarray(npz["offset"], np.float32)


def unpack_meta_params(data_source: str, key: str, dataset: str) -> Dict[str, np.ndarray]:
    """meta/<key>.pkl as the dict ``meta_from_block`` gives (reference
    utils/sdf_utils.py:65-85)."""
    with open(os.path.join(data_source, "meta", key + ".pkl"), "rb") as f:
        pkl = pickle.load(f)
    info: Dict[str, np.ndarray] = {
        "joints_3d": np.asarray(pkl["coords_3d"], np.float32),
        "obj_corners_3d": np.asarray(pkl["obj_corners_3d"], np.float32),
        "obj_rest_corners_3d": np.asarray(pkl["obj_rest_corners_3d"], np.float32),
        "hand_pose": np.asarray(pkl["hand_pose"], np.float32).reshape(-1),
    }
    affine = np.zeros((4, 4), np.float32)
    affine[3, 3] = 1.0
    affine[:3, :4] = np.asarray(pkl["affine_transform"], np.float32)[:3, :]
    info["affine_transform"] = affine
    cam_intr = np.zeros((3, 4), np.float32)
    cam_intr[:3, :3] = (OBMAN_INTR if "obman" in dataset
                        else np.asarray(pkl["cam_intr"], np.float32)[:3, :3])
    info["cam_intr"] = cam_intr
    return info


def unpack_test_params(path: str, task: str):
    """A test split's meta pkl -> (cam_intr (3, 4), mano_root (1, 3), the
    object's rest corners (8, 3)), the root and corners in the camera frame
    after the extrinsic flip of ObMan and HO3D (reference
    utils/sdf_utils.py:88-116)."""
    cam_extr = OBMAN_EXTR if ("obman" in task or "ho3d" in task) else np.eye(3, dtype=np.float32)
    with open(path, "rb") as f:
        pkl = pickle.load(f)
    cam_intr = np.zeros((3, 4), np.float32)
    if "obman" in task:
        cam_intr[:3, :3] = OBMAN_INTR
        mano_root = np.asarray(pkl["coords_3d"], np.float32)[[0]]
    elif "ho3d" in task:
        cam_intr[:3, :3] = np.asarray(pkl["camMat"], np.float32)[:3, :3]
        mano_root = np.asarray(pkl["handJoints3D"], np.float32)[None]
    else:  # dexycb
        cam_intr[:3, :3] = np.asarray(pkl["cam_intr"], np.float32)[:3, :3]
        mano_root = np.asarray(pkl["coords_3d"], np.float32)[[0]]
    mano_root = (cam_extr @ mano_root.T).T
    corners = np.asarray(pkl["obj_rest_corners_3d"], np.float32)[1:, :]
    corners = (cam_extr @ corners.T).T
    return cam_intr, mano_root, corners
