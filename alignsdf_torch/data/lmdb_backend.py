"""LMDB dataset backend (the JAX package's ``data/lmdb_backend.py``):
reference-compatible decode of the rgb/norm/meta/sdf_hand/sdf_obj LMDBs
produced by the reference's tools/create_lmdb.py, and the encoders of its
meta and SDF records (``meta_record``, ``sdf_record``) and databases
(``write_lmdb``) that the port's writers and packer share.

Uses the ``lmdb`` package when installed, else the bundled pure-python LMDB
engine (data.lmdb_format) — either way the on-disk format is real LMDB.
Buffer layouts decoded here:
  norm:  f32[4] = [offset(3), scale] (reference utils/sdf_utils.py:22-30)
  meta:  f32 (61, 3) block (reference utils/sdf_utils.py:41-62)
  rgb:   raw uint8 HWC, BGR on disk (reference utils/img_utils.py:15-27)
  sdf:   f32 (20000, 6) rows [xyz, sdf_self, sdf_other, label] with pos/neg
         counts from the side-car meta_info.json
         (reference utils/sdf_utils.py:119-163, tools/create_lmdb.py:203-262)
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from alignsdf_torch.data.sdf_samples import OBMAN_INTR

SDF_ROWS = 20000  # fixed SDF block height (reference tools/create_lmdb.py:205)


def write_lmdb(path: str, records: Iterable[Tuple[str, np.ndarray]], meta_info: Dict) -> None:
    """The (key, array) pairs as one LMDB of raw array bytes, then its
    meta_info.json (written after the records, so lists in it that the
    records fill are complete)."""
    from alignsdf_torch.data.lmdb_format import LmdbWriter

    with LmdbWriter(path) as w:
        for key, value in records:
            w.put(key, np.ascontiguousarray(value))
    with open(os.path.join(path, "meta_info.json"), "w") as f:
        json.dump(meta_info, f, indent=2)


def meta_record(meta: Dict, dataset: str) -> np.ndarray:
    """A meta pkl's dict as the packer's (61, 3) float32 block: joints,
    corners, rest corners, pose, affine, intrinsics (the ObMan constant for
    obman) (reference tools/create_lmdb.py:72-128)."""
    block = np.zeros((61, 3), np.float32)
    block[:21] = np.asarray(meta["coords_3d"], np.float32)
    block[21:30] = np.asarray(meta["obj_corners_3d"], np.float32)
    block[30:39] = np.asarray(meta["obj_rest_corners_3d"], np.float32)
    block[39:54] = np.asarray(meta["hand_pose"], np.float32).reshape(-1, 3)
    block[54:58] = np.asarray(meta["affine_transform"], np.float32)[:3, :].reshape(-1, 3)
    block[58:61] = (OBMAN_INTR if dataset == "obman"
                    else np.asarray(meta["cam_intr"], np.float32)[:3, :3])
    return block


def sdf_record(arrays, hand: bool) -> Tuple[np.ndarray, int, int]:
    """One branch's SDF arrays (the reference's npz keys: pos, neg (n, 4),
    pos_other, neg_other (n, 1), lab_pos, lab_neg, lab_pos_other,
    lab_neg_other (n, 4)) as the packer's (SDF_ROWS, 6) float32 block of
    rows [xyz, hand sdf, object sdf, label], zero-padded, with the positive
    and negative row counts (reference tools/create_lmdb.py:183-260)."""
    lab = "lab_{}" if hand else "lab_{}_other"
    rows = []
    for name in ("pos", "neg"):
        xyzs = np.asarray(arrays[name], np.float32)
        other = np.asarray(arrays[name + "_other"], np.float32).reshape(-1, 1)
        labels = np.asarray(arrays[lab.format(name)], np.float32).reshape(len(xyzs), -1)
        cols = ([xyzs, other] if hand  # the hand's sdf always in column 3
                else [xyzs[:, :3], other, xyzs[:, [3]]])
        rows.append(np.concatenate(cols + [labels[:, [0]]], axis=1))
    block = np.zeros((SDF_ROWS, 6), np.float32)
    block[:len(rows[0]) + len(rows[1])] = np.concatenate(rows, axis=0)
    return block, len(rows[0]), len(rows[1])


class LmdbStore:
    """Read-only handles on one dataset's five LMDBs."""

    def __init__(self, data_source: str, hand_branch: bool = True,
                 obj_branch: bool = True):
        # the real lmdb package when installed, else the pure-python engine
        from alignsdf_torch.data.lmdb_format import open_env as _open

        def open_env(name):
            return _open(os.path.join(data_source, name), readonly=True,
                         lock=False, readahead=False, meminit=False)

        self.img_env = open_env("rgb.lmdb")
        self.norm_env = open_env("norm.lmdb")
        self.meta_env = open_env("meta.lmdb")
        self.hand_env = open_env("sdf_hand.lmdb") if hand_branch else None
        self.obj_env = open_env("sdf_obj.lmdb") if obj_branch else None
        self.hand_meta = self.obj_meta = None
        if hand_branch:
            with open(os.path.join(data_source, "sdf_hand.lmdb", "meta_info.json")) as f:
                self.hand_meta = json.load(f)
        if obj_branch:
            with open(os.path.join(data_source, "sdf_obj.lmdb", "meta_info.json")) as f:
                self.obj_meta = json.load(f)

    @staticmethod
    def _get(env, key: str) -> bytes:
        with env.begin(write=False) as txn:
            return txn.get(key.encode("ascii"))

    def image(self, key: str, size=None) -> np.ndarray:
        buf = np.frombuffer(self._get(self.img_env, key), np.uint8)
        if size is None:  # raw square RGB (reference stores 3x256x256 raw)
            hw = int(round((buf.size // 3) ** 0.5))
            c, h, w = 3, hw, hw
        else:
            c, h, w = size
        return buf.reshape(h, w, c)[:, :, ::-1].copy()  # BGR -> RGB

    def normal_params(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        norm = np.frombuffer(self._get(self.norm_env, key), np.float32)
        return norm[[3]].copy(), norm[0:3].copy()  # (scale, offset)

    def meta(self, key: str) -> np.ndarray:
        return np.frombuffer(self._get(self.meta_env, key), np.float32).reshape(-1, 3)

    def sdf_raw(self, key: str, hand: bool) -> Tuple[np.ndarray, int, int]:
        env = self.hand_env if hand else self.obj_env
        meta = self.hand_meta if hand else self.obj_meta
        idx = meta["keys"].index(key)
        pos_num = meta["pos_num"][idx]
        neg_num = meta["neg_num"][idx]
        dim = meta["dim"]
        buf = np.frombuffer(self._get(env, key), np.float32)
        rows = buf.reshape(-1, dim)[: pos_num + neg_num]
        return rows, pos_num, neg_num


def unpack_sdf_samples_lmdb(store: LmdbStore, key: str, hand: bool,
                            subsample: int, clamp: Optional[float],
                            filter_dist: bool,
                            rng: Optional[np.random.Generator] = None,
                            uniforms=None):
    """Reference utils/sdf_utils.py:119-163 with numpy RNG (``uniforms``
    injectable for deterministic golden tests)."""
    rows, pos_num, neg_num = store.sdf_raw(key, hand)
    pos = rows[:pos_num]
    neg = rows[pos_num:]
    pos = pos[~np.isnan(pos[:, 3])]
    neg = neg[~np.isnan(neg[:, 3])]
    if filter_dist:
        keep_p = (np.abs(pos[:, 3]) < 2.0) & (np.abs(pos[:, 4]) < 2.0)
        keep_n = (np.abs(neg[:, 3]) < 2.0) & (np.abs(neg[:, 4]) < 2.0)
        pos, neg = pos[keep_p], neg[keep_n]

    half = subsample // 2
    if uniforms is None:
        rng = rng or np.random.default_rng()
        uniforms = (rng.random(half, np.float32),
                    rng.random(subsample - half, np.float32))
    u_pos, u_neg = uniforms
    idx_p = (u_pos * max(len(pos), 1)).astype(np.int64) % max(len(pos), 1)
    idx_n = (u_neg * max(len(neg), 1)).astype(np.int64) % max(len(neg), 1)
    both = np.concatenate([pos[idx_p], neg[idx_n]], axis=0)
    samples = both[:, :-1].copy()
    labels = both[:, -1].copy()
    if clamp:
        labels[samples[:, 3] < -clamp] = -1
        labels[samples[:, 3] > clamp] = -1
    if not hand:
        labels[:] = -1
    return samples, labels
