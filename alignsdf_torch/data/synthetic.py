"""Synthetic data for smoke runs and tests, numpy only: batches (the JAX
package's ``data/synthetic.py:synthetic_train_batch``, the same keys, shapes
and seeding, so both packages draw the same batch from one seed), an
on-disk LMDB dataset of random rows (``write_synthetic_lmdb``) and the
geometric dataset of analytically known scenes with its test split
(``write_geometric_lmdb``)."""

from __future__ import annotations

import functools
import json
import os
import pickle
import zlib
from typing import Dict, List

import numpy as np
import torch

from alignsdf_torch.config import Specs
from alignsdf_torch.data.lmdb_format import LmdbWriter
from alignsdf_torch.geom.meshlib import TriMesh
from alignsdf_torch.mano.layer import load_mano_model, mano_forward

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


def _sdf_block(arrays: Dict[str, np.ndarray], hand: bool) -> np.ndarray:
    """One branch's SDF arrays (the reference's npz keys: pos, neg (n, 4),
    pos_other, neg_other (n, 1), lab_pos, lab_neg, lab_pos_other,
    lab_neg_other (n, 4)) as the JAX package's ``tools/create_lmdb.py``
    packs them: (SDF_ROWS, 6) rows [xyz, hand sdf, object sdf, label],
    zero-padded."""
    lab = "lab_{}" if hand else "lab_{}_other"
    rows = []
    for name in ("pos", "neg"):
        xyzs, other = arrays[name], arrays[name + "_other"]
        labels = arrays[lab.format(name)][:, [0]].astype(np.float32)
        cols = ([xyzs, other] if hand  # the hand's sdf always in column 3
                else [xyzs[:, :3], other, xyzs[:, [3]]])
        rows.append(np.concatenate(cols + [labels], axis=1))
    rows = np.concatenate(rows, axis=0)
    block = np.zeros((SDF_ROWS, 6), np.float32)
    block[:len(rows)] = rows
    return block


def _meta_block(meta: Dict[str, np.ndarray], dataset: str) -> np.ndarray:
    """A meta pkl's dict as the packer's (61, 3) block: joints, corners, rest
    corners, pose, affine, intrinsics (the ObMan constant for obman)."""
    block = np.zeros((61, 3), np.float32)
    block[:21] = meta["coords_3d"]
    block[21:30] = meta["obj_corners_3d"]
    block[30:39] = meta["obj_rest_corners_3d"]
    block[39:54] = np.asarray(meta["hand_pose"], np.float32).reshape(-1, 3)
    block[54:58] = np.asarray(meta["affine_transform"], np.float32)[:3, :].reshape(-1, 3)
    block[58:61] = _OBMAN_INTR if dataset == "obman" else np.asarray(meta["cam_intr"])[:3, :3]
    return block


def _write_lmdbs(base: str, dataset: str, split: str, keys: List[str], half: int,
                 rgb: Dict, norm: Dict, meta: Dict, sdf: Dict[str, Dict]) -> None:
    """The five LMDBs and their meta_info.json under ``base``, every scene
    with ``half`` positive and ``half`` negative SDF rows."""
    keys = list(keys)
    _write_lmdb(os.path.join(base, "rgb.lmdb"), rgb, {"name": f"{dataset}_rgb_{split}"})
    _write_lmdb(os.path.join(base, "norm.lmdb"), norm,
                {"name": f"{dataset}_norm_{split}", "keys": keys})
    _write_lmdb(os.path.join(base, "meta.lmdb"), meta,
                {"name": f"{dataset}_meta_{split}", "keys": keys})
    for sub in ("sdf_hand", "sdf_obj"):
        _write_lmdb(os.path.join(base, f"{sub}.lmdb"), sdf[sub], {
            "name": f"{dataset}_{sub}_{split}", "pos_num": [half] * len(keys),
            "neg_num": [half] * len(keys), "dim": 6, "keys": keys})


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
            arrays = {"pos": sdf_block(1.0), "neg": sdf_block(-1.0)}
            arrays["pos_other"] = (rng.randn(half, 1) * 0.2).astype(np.float32)
            arrays["neg_other"] = (rng.randn(half, 1) * 0.2).astype(np.float32)
            for name in ("lab_pos", "lab_neg", "lab_pos_other", "lab_neg_other"):
                arrays[name] = rng.randint(0, 4, (half, 4)).astype(np.uint8)
            sdf[sub][key] = _sdf_block(arrays, sub == "sdf_hand")
        meta[key] = _meta_block({
            "coords_3d": rng.randn(21, 3).astype(np.float32) * 0.05
            + np.array([0, 0.0, -0.6], np.float32),
            "obj_corners_3d": rng.randn(9, 3).astype(np.float32) * 0.05
            + np.array([0, 0.0, -0.6], np.float32),
            "obj_rest_corners_3d": rng.randn(9, 3).astype(np.float32) * 0.05,
            "hand_pose": rng.randn(45).astype(np.float32) * 0.1,
            "affine_transform": np.eye(4, dtype=np.float32),
            "cam_intr": _OBMAN_INTR,  # the pkl's, which the packer writes for obman too
        }, dataset)

    _write_lmdbs(base, dataset, split, keys, half, rgb, norm, meta, sdf)
    return base


def geometric_scene_params(key: str, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic per-scene geometry of the geometric dataset (the JAX
    package's): hand and object spheres in the work frame (the camera frame
    after the ObMan extrinsic flip, where ``cam_extr @ coords_3d`` lands).
    Seeded by crc32, not hash(): Python's hash() is salted per process."""
    rng = np.random.RandomState((zlib.crc32(key.encode()) ^ seed) & 0x7FFFFFFF)
    root = np.array([0.0, 0.0, 0.55], np.float32) + rng.uniform(-0.04, 0.04, 3).astype(np.float32)
    direction = rng.randn(3).astype(np.float32)
    direction /= np.linalg.norm(direction)
    obj_center = root + direction * rng.uniform(0.08, 0.11)
    return {
        "root": root,
        "hand_radius": np.float32(0.06),
        "obj_center": obj_center.astype(np.float32),
        "obj_radius": np.float32(0.04),
    }


def _icosphere(center, radius: float, subdiv: int = 3):
    """Octahedron-subdivision sphere mesh (verts, faces)."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float64)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int64)
    for _ in range(subdiv):
        edge_mid: Dict[tuple, int] = {}
        new_faces = []
        verts_list = list(verts)

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                edge_mid[k] = len(verts_list)
                verts_list.append(m)
            return edge_mid[k]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return (verts * radius + np.asarray(center)).astype(np.float32), faces


def geometric_part_label(pts: np.ndarray, hand_center: np.ndarray) -> np.ndarray:
    """Analytic hand-part label (0..5) of a point: the azimuthal sextant of
    its direction from the hand sphere's centre.  For a sphere the nearest
    surface point lies on that ray, so this is the label of the nearest
    hand-surface point that the reference stores (PreprocessMesh.cpp:269-280)."""
    d = np.asarray(pts, np.float64) - np.asarray(hand_center, np.float64)
    az = np.arctan2(d[:, 1], d[:, 0])  # [-pi, pi]
    lab = np.floor((az + np.pi) / (np.pi / 3.0)).astype(np.int64)
    return np.clip(lab, 0, 5).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _mano_model():
    return load_mano_model(ncomps=15)


def _mano_joints(pose_coeffs: np.ndarray) -> np.ndarray:
    """(1, 3 + 15) pose -> (21, 3) joints centred at the root, through the
    port's MANO layer on the CPU (the flagship's ncomps 15, center_idx 0)."""
    with torch.no_grad():
        out = mano_forward(_mano_model(), torch.as_tensor(pose_coeffs), center_idx=0)
    return out.joints[0].numpy().astype(np.float32)


def _geometric_scene(key: str, seed: int, n_points: int, image_hw: int,
                     sdf_scale_factor: float):
    """One scene of the geometric dataset, drawn in the JAX package's order
    (``write_geometric_dataset``): the image, each branch's shell, the pose.
    Returns (image HWC RGB uint8, {sub: the sdf npz's arrays}, meta dict,
    {mesh_hand / mesh_obj: TriMesh in the half-scaled decoder frame})."""
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    corner_offsets = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    scene = geometric_scene_params(key, seed)
    rng = np.random.RandomState((zlib.crc32(key.encode()) ^ seed ^ 0x5A17) & 0x7FFFFFFF)
    img = (rng.rand(image_hw, image_hw, 3) * 255).astype(np.uint8)

    centers = {"sdf_hand": (scene["root"], float(scene["hand_radius"]),
                            scene["obj_center"], float(scene["obj_radius"])),
               "sdf_obj": (scene["obj_center"], float(scene["obj_radius"]),
                           scene["root"], float(scene["hand_radius"]))}
    half = n_points // 2
    sdf = {}
    for sub, (c, r, c_other, r_other) in centers.items():
        # 85% near-surface shell + 15% uniform box
        n_near = int(n_points * 0.85)
        u = rng.randn(n_points, 3)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        radii = r + rng.randn(n_points) * 0.02
        pts = c + u * np.maximum(radii, 0.005)[:, None]
        pts[n_near:] = c + rng.uniform(-0.18, 0.18, (n_points - n_near, 3))
        dist = (np.linalg.norm(pts - c, axis=1) - r).astype(np.float32)
        dist_other = (np.linalg.norm(pts - c_other, axis=1) - r_other).astype(np.float32)
        # hand-part labels relative to the hand's centre in both branches
        part = geometric_part_label(pts, scene["root"])
        pos = dist >= 0
        blocks = {}
        for name, m in (("pos", pos), ("neg", ~pos)):
            take = np.where(m)[0][:half]
            if len(take) == 0:
                raise ValueError(f"{key}/{sub}: no {name} samples (a degenerate scene)")
            if len(take) < half:  # pad by repetition where one side is short
                take = np.concatenate([take, np.resize(take, half - len(take))])
            blocks[name] = np.concatenate([pts[take], dist[take, None]], axis=1).astype(np.float32)
            blocks[name + "_other"] = dist_other[take, None].astype(np.float32)
            lab = np.zeros((half, 4), np.uint8)
            lab[:, 0] = part[take]
            blocks["lab_" + name] = lab
            blocks["lab_" + name + "_other"] = lab.copy()
        sdf[sub] = blocks

    # meta in the stored (pre-flip) frame: work = flip @ stored; GT joints
    # from a MANO forward pass (small random PCA pose, zero shape)
    pose = np.zeros((1, 18), np.float32)
    pose[0, 3:] = rng.randn(15).astype(np.float32) * 0.3
    joints_w = scene["root"] + _mano_joints(pose)
    obj_pts_w = np.concatenate([scene["obj_center"][None],
                                scene["obj_center"] + corner_offsets * scene["obj_radius"]])
    rest_w = np.concatenate([np.zeros((1, 3), np.float32), corner_offsets * scene["obj_radius"]])
    meta = {
        "coords_3d": (flip @ joints_w.T).T.astype(np.float32),
        "obj_corners_3d": (flip @ obj_pts_w.T).T.astype(np.float32),
        "obj_rest_corners_3d": (flip @ rest_w.T).T.astype(np.float32),
        "hand_pose": np.zeros(45, np.float32),
        "affine_transform": np.eye(4, dtype=np.float32),
        "cam_intr": _OBMAN_INTR.copy(),
        "camMat": _OBMAN_INTR.copy(),
        "handJoints3D": (flip @ joints_w[0]).astype(np.float32),
    }

    # GT meshes in the half-scaled decoder frame, as the reference's eval
    # meshes (its reconstructions are exported with scale=None,
    # reconstruct.py:93 -> utils/mesh.py:126, and chamfered directly)
    meshes = {}
    for sub, (c, r) in (("mesh_hand", (scene["root"], float(scene["hand_radius"]))),
                        ("mesh_obj", (scene["obj_center"], float(scene["obj_radius"])))):
        v, fcs = _icosphere(c, r)
        meshes[sub] = TriMesh((v - scene["root"]) * (sdf_scale_factor / 2.0), fcs)
    return img, sdf, meta, meshes


def write_geometric_lmdb(root: str, keys: List[str], dataset: str = "obman",
                         n_points: int = 20000, seed: int = 0, image_hw: int = 256,
                         sdf_scale_factor: float = 7.018621123357809) -> Dict[str, str]:
    """The geometric dataset (the JAX package's ``write_geometric_dataset``)
    for a proof of learning: per scene, the hand is a sphere at the MANO
    root and the object a sphere nearby, the SDF rows carry the exact sphere
    distances in both columns, the meta's joints (a MANO forward pass) and
    corners fit the spheres, and the GT meshes are the spheres.  Writes

    - ``<root>/<dataset>/train``: the five LMDBs the train loader reads, as
      the JAX package's ``tools/create_lmdb.py`` packs that writer's files
      (norm scale 1, offset 0, so stored coordinates are work-frame);
    - ``<root>/<dataset>/test``: ``meta/<key>.pkl`` and the GT meshes
      ``mesh_hand`` / ``mesh_obj/<key>.obj`` in the half-scaled decoder
      frame, which ``cli/reconstruct.py --eval_mode`` (``DataSource`` =
      ``root``) and ``cli/evaluate.py --data_root`` read;
    - ``<root>/<dataset>_geometric_samples.npz``: the same scenes as
      ``cli/reconstruct.py --samples`` input (image RGB uint8 at
      ``image_hw``, which must be the spec's ImageSize; cam_intr (3, 4),
      mano_root and the rest corners as ``ImagesDataset`` reads them from the
      meta).

    Each scene draws its numbers in the JAX writer's order, so the SDF rows,
    labels, meta and GT meshes are that writer's for the same keys and seed
    (its MANO joints to float32 rounding).  The images are stored raw (BGR
    in rgb.lmdb), where the JAX writer's pass through a lossy JPEG file.
    Train and test hold the same keys.  Returns the paths under "train",
    "test" and "samples"."""
    half = n_points // 2
    if 2 * half > SDF_ROWS:
        raise ValueError(f"n_points {n_points}: an SDF block holds {SDF_ROWS} rows")
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    cam_extr = flip if ("obman" in dataset or "ho3d" in dataset) else np.eye(3, dtype=np.float32)
    train = os.path.join(root, dataset, "train")
    test = os.path.join(root, dataset, "test")
    for sub in ("meta", "mesh_hand", "mesh_obj"):
        os.makedirs(os.path.join(test, sub), exist_ok=True)
    rgb, norm, meta_rows = {}, {}, {}
    sdf = {"sdf_hand": {}, "sdf_obj": {}}
    samples = {k: [] for k in ("image", "cam_intr", "mano_root", "rest_obj_corners")}
    for key in keys:
        img, arrays, meta, meshes = _geometric_scene(key, seed, n_points, image_hw,
                                                     sdf_scale_factor)
        rgb[key] = img[:, :, ::-1]
        norm[key] = np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # offset(3), scale
        for sub, a in arrays.items():
            sdf[sub][key] = _sdf_block(a, sub == "sdf_hand")
        meta_rows[key] = _meta_block(meta, dataset)
        with open(os.path.join(test, "meta", key + ".pkl"), "wb") as f:
            pickle.dump(meta, f)
        for sub, mesh in meshes.items():
            mesh.export(os.path.join(test, sub, key + ".obj"))
        cam_intr = np.zeros((3, 4), np.float32)
        cam_intr[:3, :3] = meta["cam_intr"]
        samples["image"].append(img)
        samples["cam_intr"].append(cam_intr)
        samples["mano_root"].append(cam_extr @ meta["coords_3d"][0])
        samples["rest_obj_corners"].append((cam_extr @ meta["obj_rest_corners_3d"][1:].T).T)

    _write_lmdbs(train, dataset, "train", keys, half, rgb, norm, meta_rows, sdf)
    samples_path = os.path.join(root, f"{dataset}_geometric_samples.npz")
    np.savez(samples_path, key=np.array(keys),
             **{k: np.stack(v).astype(np.uint8 if k == "image" else np.float32)
                for k, v in samples.items()})
    return {"train": train, "test": test, "samples": samples_path}

