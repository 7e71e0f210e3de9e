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

The ASDF-pack (the JAX package's ``PackedBackend``) needs a native reader
and is not ported yet (ROADMAP.md §1 item 2).

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


def make_backend(specs, data_root: str):
    """The spec's storage backend at ``data_root``, as the reference selects
    lmdb per spec (reference utils/data.py:118-129): the five LMDBs for
    ``LMDB: true``, else the per-file layout."""
    if specs.lmdb:
        return LmdbBackend(data_root, specs.dataset,
                           hand_branch=specs.hand_branch, obj_branch=specs.obj_branch)
    return NpzBackend(data_root, specs.dataset, specs.image_source)
