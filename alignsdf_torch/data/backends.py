"""Record backends of the train dataset (the JAX package's
``data/backends.py``; reference utils/data.py:62-101,118-129).

One sample-math implementation (``data/dataset.py:SDFDataset``) over a
storage backend, chosen by the spec's ``LMDB`` as the reference chooses:

  * ``LmdbBackend`` - the reference's five-LMDB format (reference
    tools/create_lmdb.py:21-310; the port's packer is
    ``tools/create_lmdb_torch.py``), images stored decoded;
  * ``NpzBackend`` - the reference's per-file layout: ``<ImageSource>/``
    JPEGs (decoded by ``img_utils.load_img``, PIL), ``norm/`` and the two
    ``sdf_*/`` directories of npz files and ``meta/`` pickles.

An explicit pack file takes precedence over both:

  * ``PackedBackend`` - the ASDF-pack, one mmap'd file
    (``tools/pack_dataset_torch.py``), read by the native reader
    (``data/packed.py``), which also builds whole batches.

A backend returns raw reference-frame records; augmentation and the
normalization chain live in the dataset.  ``sample_sdf`` returns rows in the
global column convention [xyz, sdf_hand, sdf_obj] with hand-part labels.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from alignsdf_torch.data import img_utils as I
from alignsdf_torch.data import sdf_samples as S
from alignsdf_torch.data.lmdb_backend import LmdbStore, unpack_sdf_samples_lmdb
from alignsdf_torch.data.packed import PackReader


class NpzBackend:
    """Reference per-file npz/pkl/jpg layout (reference utils/data.py:93-101)."""

    def __init__(self, data_source: str, dataset: str, image_source: str = "rgb"):
        self.data_source = data_source
        self.dataset = dataset
        self.image_source = os.path.join(data_source, image_source)

    def keys(self) -> Optional[List[str]]:
        return None  # keys come from the split file

    def normal_params(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        return S.unpack_normal_params(self.data_source, key)

    def meta_params(self, key: str) -> Dict[str, np.ndarray]:
        return S.unpack_meta_params(self.data_source, key, self.dataset)

    def image(self, key: str) -> np.ndarray:
        return I.load_img(os.path.join(self.image_source, key + ".jpg"))

    def sample_sdf(self, key: str, hand: bool, subsample: int,
                   clamp: Optional[float], filter_dist: bool,
                   rng: np.random.Generator,
                   uniforms=None) -> Tuple[np.ndarray, np.ndarray]:
        return S.unpack_sdf_samples(self.data_source, key, subsample, hand=hand, clamp=clamp,
                                    filter_dist=filter_dist, rng=rng, uniforms=uniforms)


class LmdbBackend:
    """Reference LMDB format (reference utils/data.py:62-91,118-129)."""

    def __init__(self, data_source: str, dataset: str,
                 hand_branch: bool = True, obj_branch: bool = True):
        self.store = LmdbStore(data_source, hand_branch, obj_branch)
        self.dataset = dataset

    def keys(self) -> Optional[List[str]]:
        meta = self.store.hand_meta or self.store.obj_meta
        return list(meta["keys"]) if meta else None

    def normal_params(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        return self.store.normal_params(key)

    def meta_params(self, key: str) -> Dict[str, np.ndarray]:
        return S.meta_from_block(self.store.meta(key), self.dataset)

    def image(self, key: str) -> np.ndarray:
        return self.store.image(key)  # raw square RGB, shape inferred

    def sample_sdf(self, key: str, hand: bool, subsample: int,
                   clamp: Optional[float], filter_dist: bool,
                   rng: np.random.Generator,
                   uniforms=None) -> Tuple[np.ndarray, np.ndarray]:
        return unpack_sdf_samples_lmdb(
            self.store, key, hand, subsample, clamp, filter_dist, rng=rng,
            uniforms=uniforms,
        )


class PackedBackend:
    """ASDF-pack file with native record decode and sampling (the JAX
    package's ``PackedBackend``)."""

    def __init__(self, pack_path: str, dataset: str):
        self.reader = PackReader(pack_path)
        self.dataset = dataset
        self._all_keys = [self.reader.key(i) for i in range(len(self.reader))]
        self._key_to_idx = {k: i for i, k in enumerate(self._all_keys)}

    def keys(self) -> List[str]:
        return list(self._all_keys)

    def _meta(self, key: str):
        return self.reader.meta(self._key_to_idx[key])

    def normal_params(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        scale, offset, _ = self._meta(key)
        return np.asarray([scale], np.float32), offset

    def meta_params(self, key: str) -> Dict[str, np.ndarray]:
        return S.meta_from_block(self._meta(key)[2], self.dataset)

    def image(self, key: str) -> np.ndarray:
        return self.reader.image(self._key_to_idx[key])

    def sample_sdf(self, key: str, hand: bool, subsample: int,
                   clamp: Optional[float], filter_dist: bool,
                   rng: np.random.Generator,
                   uniforms=None) -> Tuple[np.ndarray, np.ndarray]:
        # the native sampler draws its own uniforms from a 64-bit seed
        seed = int(rng.integers(0, 2 ** 63 - 1))
        return self.reader.sample_sdf(self._key_to_idx[key], hand, subsample, clamp or 0.0,
                                      filter_dist, seed)

    def build_batch(self, keys: List[str], seeds, specs) -> Optional[Dict[str, np.ndarray]]:
        """The native whole-batch path (``PackReader.build_batch``), or None
        where the spec asks for live synthetic occlusion, which only the
        per-item path draws: the caller then builds the batch item by item,
        as the JAX package routes it.  Both paths run on the host."""
        if specs.occlusion_aug and not specs.disable_aug:
            return None
        recs = np.asarray([self._key_to_idx[k] for k in keys], np.int64)
        return self.reader.build_batch(recs, np.asarray(seeds, np.uint64), specs)


def make_backend(specs, data_root: Optional[str], pack_path: Optional[str] = None):
    """The storage backend, with the JAX package's priority: the pack file
    ``pack_path`` where given, else at ``data_root`` the five LMDBs for
    ``LMDB: true`` (as the reference selects lmdb per spec, reference
    utils/data.py:118-129), else the per-file layout."""
    if pack_path:
        return PackedBackend(pack_path, specs.dataset)
    if data_root is None:
        raise ValueError("a dataset needs data_root or pack_path")
    if specs.lmdb:
        return LmdbBackend(data_root, specs.dataset,
                           hand_branch=specs.hand_branch, obj_branch=specs.obj_branch)
    return NpzBackend(data_root, specs.dataset, specs.image_source)
