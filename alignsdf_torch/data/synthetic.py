"""Synthetic data for smoke runs and tests, numpy only: batches (the JAX
package's ``data/synthetic.py:synthetic_train_batch``, the same keys, shapes
and seeding, so both packages draw the same batch from one seed), on-disk
datasets of random rows in the reference's per-file layout
(``write_synthetic_dataset``) and its five-LMDB layout
(``write_synthetic_lmdb``), and the geometric dataset of analytically known
scenes with its test split (``write_geometric_lmdb``).  JPEGs are written
with PIL at quality 95, the file ``cv2.imwrite``'s default writes."""

from __future__ import annotations

import functools
import json
import os
import pickle
import zlib
from typing import Dict, List

import numpy as np
import torch
from PIL import Image

from alignsdf_torch.config import Specs
from alignsdf_torch.data.img_utils import load_img
from alignsdf_torch.data.lmdb_backend import SDF_ROWS, meta_record, sdf_record, write_lmdb
from alignsdf_torch.data.sdf_samples import OBMAN_INTR
from alignsdf_torch.geom.meshlib import TriMesh
from alignsdf_torch.mano.layer import load_mano_model, mano_forward

JPEG_QUALITY = 95  # cv2.imwrite's default


def write_jpeg(path: str, img: np.ndarray) -> None:
    """An RGB uint8 HWC image as a baseline 4:2:0 JPEG of JPEG_QUALITY."""
    Image.fromarray(np.ascontiguousarray(img)).save(path, quality=JPEG_QUALITY)


def synthetic_train_batch(specs: Specs, batch_size: int = 2,
                          seed: int = 0) -> Dict[str, np.ndarray]:
    """A random batch with the shapes and layout of a training batch: image
    (B, H, W, 3) float32 (already normalized), xyz (B*N, 3), per-point SDF
    targets (B*N, 1) and labels (B*N,), and the per-scene pose targets."""
    rng = np.random.RandomState(seed)
    n = specs.samples_per_scene
    h, w = specs.image_size
    total = batch_size * n
    cam = np.tile(np.concatenate([OBMAN_INTR, np.zeros((3, 1), np.float32)], axis=1)[None],
                  (batch_size, 1, 1))
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


def _write_lmdbs(base: str, dataset: str, split: str, keys: List[str], half: int,
                 rgb: Dict, norm: Dict, meta: Dict, sdf: Dict[str, Dict]) -> None:
    """The five LMDBs and their meta_info.json under ``base``, every scene
    with ``half`` positive and ``half`` negative SDF rows."""
    keys = list(keys)
    write_lmdb(os.path.join(base, "rgb.lmdb"), rgb.items(), {"name": f"{dataset}_rgb_{split}"})
    write_lmdb(os.path.join(base, "norm.lmdb"), norm.items(),
               {"name": f"{dataset}_norm_{split}", "keys": keys})
    write_lmdb(os.path.join(base, "meta.lmdb"), meta.items(),
               {"name": f"{dataset}_meta_{split}", "keys": keys})
    for sub in ("sdf_hand", "sdf_obj"):
        write_lmdb(os.path.join(base, f"{sub}.lmdb"), sdf[sub].items(), {
            "name": f"{dataset}_{sub}_{split}", "pos_num": [half] * len(keys),
            "neg_num": [half] * len(keys), "dim": 6, "keys": keys})


def _synthetic_scenes(keys: List[str], n_points: int, seed: int, image_hw: int):
    """Each key's random scene, drawn as the JAX package's
    ``write_synthetic_dataset`` draws it, in the same order from one
    ``RandomState(seed)``: (key, image RGB uint8, scale, offset, {sdf_hand /
    sdf_obj: the sdf npz's arrays}, the meta pkl's dict)."""
    rng = np.random.RandomState(seed)
    half = n_points // 2

    def sdf_block(sign):
        xyz = rng.randn(half, 3).astype(np.float32) * 0.4
        dist = (np.abs(rng.randn(half, 1)) * 0.2 * sign).astype(np.float32)
        return np.concatenate([xyz, dist], axis=1)

    for key in keys:
        img = (rng.rand(image_hw, image_hw, 3) * 255).astype(np.uint8)
        scale = np.float32(rng.uniform(4.0, 6.0))
        offset = rng.randn(3).astype(np.float32) * 0.1
        sdf = {}
        for sub in ("sdf_hand", "sdf_obj"):
            arrays = {"pos": sdf_block(1.0), "neg": sdf_block(-1.0)}
            arrays["pos_other"] = (rng.randn(half, 1) * 0.2).astype(np.float32)
            arrays["neg_other"] = (rng.randn(half, 1) * 0.2).astype(np.float32)
            for name in ("lab_pos", "lab_neg", "lab_pos_other", "lab_neg_other"):
                arrays[name] = rng.randint(0, 4, (half, 4)).astype(np.uint8)
            sdf[sub] = arrays
        joints = (rng.randn(21, 3).astype(np.float32) * 0.05
                  + np.array([0, 0.0, -0.6], np.float32))
        meta = {
            "coords_3d": joints,
            "obj_corners_3d": rng.randn(9, 3).astype(np.float32) * 0.05
            + np.array([0, 0.0, -0.6], np.float32),
            "obj_rest_corners_3d": rng.randn(9, 3).astype(np.float32) * 0.05,
            "hand_pose": rng.randn(45).astype(np.float32) * 0.1,
            "affine_transform": np.eye(4, dtype=np.float32),
            "cam_intr": OBMAN_INTR.copy(),
            # HO3D's keys too, so that every task's reader finds its own
            "camMat": np.array([[614.6, 0, 320.0], [0, 614.1, 240.0], [0, 0, 1]], np.float32),
            "handJoints3D": joints[0],
        }
        yield key, img, scale, offset, sdf, meta


def write_synthetic_dataset(root: str, keys: List[str], dataset: str = "obman",
                            n_points: int = 4000, seed: int = 0, image_hw: int = 256,
                            split: str = "train") -> str:
    """A synthetic dataset in the reference's per-file layout under
    ``<root>/<dataset>/<split>`` (returned): ``rgb/<key>.jpg``,
    ``norm/<key>.npz`` {scale, offset}, ``sdf_hand`` and ``sdf_obj/<key>.npz``
    (the reference's keys: pos, neg, pos_other, neg_other, lab_pos, lab_neg,
    lab_pos_other, lab_neg_other; reference
    scripts/sample_points/src/PreprocessMesh.cpp:218-287) and
    ``meta/<key>.pkl`` (reference utils/sdf_utils.py:65-85), plus the empty
    mesh directories: the JAX package's ``write_synthetic_dataset``'s files."""
    base = os.path.join(root, dataset, split)
    for sub in ("rgb", "norm", "meta", "sdf_hand", "sdf_obj", "mesh_hand", "mesh_obj",
                "mesh_obj_rest"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    for key, img, scale, offset, sdf, meta in _synthetic_scenes(keys, n_points, seed, image_hw):
        write_jpeg(os.path.join(base, "rgb", key + ".jpg"), img)
        np.savez(os.path.join(base, "norm", key + ".npz"),
                 scale=np.array([scale], np.float32), offset=offset)
        for sub, arrays in sdf.items():
            np.savez(os.path.join(base, sub, key + ".npz"), **arrays)
        with open(os.path.join(base, "meta", key + ".pkl"), "wb") as f:
            pickle.dump(meta, f)
    return base


def write_synthetic_lmdb(root: str, keys: List[str], dataset: str = "obman",
                         n_points: int = 4000, seed: int = 0, image_hw: int = 256,
                         split: str = "train") -> str:
    """A synthetic dataset in the reference's five-LMDB layout under
    ``<root>/<dataset>/<split>`` (returned): rgb, norm, meta, sdf_hand and
    sdf_obj, each with its meta_info.json (reference
    tools/create_lmdb.py:21-310).

    It holds ``write_synthetic_dataset``'s scenes packed as the JAX
    package's ``tools/create_lmdb.py:create_lmdbs`` packs them: the norm,
    meta and SDF databases are byte for byte theirs.  The images are stored
    raw (uniform random RGB, BGR on disk) where theirs pass through a JPEG
    file first."""
    base = os.path.join(root, dataset, split)
    rgb, norm, meta_rows = {}, {}, {}
    sdf = {"sdf_hand": {}, "sdf_obj": {}}
    for key, img, scale, offset, arrays, meta in _synthetic_scenes(keys, n_points, seed,
                                                                    image_hw):
        rgb[key] = img[:, :, ::-1]
        norm[key] = np.concatenate([offset, [scale]]).astype(np.float32)
        for sub, a in arrays.items():
            sdf[sub][key] = sdf_record(a, sub == "sdf_hand")[0]
        meta_rows[key] = meta_record(meta, dataset)
    _write_lmdbs(base, dataset, split, keys, n_points // 2, rgb, norm, meta_rows, sdf)
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
        "cam_intr": OBMAN_INTR.copy(),
        "camMat": OBMAN_INTR.copy(),
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
    - ``<root>/<dataset>/test``: ``rgb/<key>.jpg`` (the image as a JPEG
      file, ``write_jpeg``: the JAX writer's file byte for byte),
      ``meta/<key>.pkl`` and the GT meshes
      ``mesh_hand`` / ``mesh_obj/<key>.obj`` in the half-scaled decoder
      frame, which ``cli/reconstruct.py -s`` and ``--eval_mode``
      (``DataSource`` = ``root``) and ``cli/evaluate.py --data_root`` read;
    - ``<root>/<dataset>_geometric_split.json``: the test split,
      ``{"filenames": ["<key>.jpg", ...]}``, for ``cli/reconstruct.py -s``;
    - ``<root>/<dataset>_geometric_samples.npz``: the same scenes as
      ``cli/reconstruct.py --samples`` input (image RGB uint8 at
      ``image_hw``, which must be the spec's ImageSize; cam_intr (3, 4),
      mano_root and the rest corners as ``ImagesDataset`` reads them from
      the meta).

    Each scene draws its numbers in the JAX writer's order, so the SDF rows,
    labels, meta and GT meshes are that writer's for the same keys and seed
    (its MANO joints to float32 rounding).  Each image is its JPEG file
    decoded (``load_img``), in rgb.lmdb (BGR) and in the samples npz alike,
    as the JAX writer's files packed by its ``tools/create_lmdb.py`` give
    it: training and both test inputs see the same pixels (the images are
    noise, which JPEG changes by tens of levels).  Train and test hold the
    same keys.  Returns the paths under "train",
    "test", "split" and "samples"."""
    half = n_points // 2
    if 2 * half > SDF_ROWS:
        raise ValueError(f"n_points {n_points}: an SDF block holds {SDF_ROWS} rows")
    flip = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    cam_extr = flip if ("obman" in dataset or "ho3d" in dataset) else np.eye(3, dtype=np.float32)
    train = os.path.join(root, dataset, "train")
    test = os.path.join(root, dataset, "test")
    for sub in ("rgb", "meta", "mesh_hand", "mesh_obj"):
        os.makedirs(os.path.join(test, sub), exist_ok=True)
    rgb, norm, meta_rows = {}, {}, {}
    sdf = {"sdf_hand": {}, "sdf_obj": {}}
    samples = {k: [] for k in ("image", "cam_intr", "mano_root", "rest_obj_corners")}
    for key in keys:
        img, arrays, meta, meshes = _geometric_scene(key, seed, n_points, image_hw,
                                                     sdf_scale_factor)
        # every split sees the image as its JPEG file decodes, as the JAX
        # writer's files packed by tools/create_lmdb.py give it
        jpeg = os.path.join(test, "rgb", key + ".jpg")
        write_jpeg(jpeg, img)
        img = load_img(jpeg)
        rgb[key] = img[:, :, ::-1]
        norm[key] = np.array([0.0, 0.0, 0.0, 1.0], np.float32)  # offset(3), scale
        for sub, a in arrays.items():
            sdf[sub][key] = sdf_record(a, sub == "sdf_hand")[0]
        meta_rows[key] = meta_record(meta, dataset)
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
    split_path = os.path.join(root, f"{dataset}_geometric_split.json")
    with open(split_path, "w") as f:
        json.dump({"filenames": [key + ".jpg" for key in keys]}, f)
    samples_path = os.path.join(root, f"{dataset}_geometric_samples.npz")
    np.savez(samples_path, key=np.array(keys),
             **{k: np.stack(v).astype(np.uint8 if k == "image" else np.float32)
                for k, v in samples.items()})
    return {"train": train, "test": test, "split": split_path, "samples": samples_path}

