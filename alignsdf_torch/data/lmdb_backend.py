"""LMDB dataset backend (the JAX package's ``data/lmdb_backend.py``):
reference-compatible decode of the rgb/norm/meta/sdf_hand/sdf_obj LMDBs
produced by the reference's tools/create_lmdb.py.

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
from typing import Dict, Optional, Tuple

import numpy as np


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
