"""Record backends of the train dataset (the JAX package's
``data/backends.py``; reference utils/data.py:62-101,118-129).

One sample-math implementation (``data/dataset.py:SDFDataset``) over a
storage backend.  The port reads the reference's five-LMDB format
(``LmdbBackend``), whose images are raw RGB, so no image codec is needed.
The per-file npz/jpg layout (the JAX package's ``NpzBackend``) needs a JPEG
decoder, and the ASDF-pack (``PackedBackend``) a native reader; neither is
ported yet (ROADMAP.md §1 item 2).

A backend returns raw reference-frame records; augmentation and the
normalization chain live in the dataset.  ``sample_sdf`` returns rows in the
global column convention [xyz, sdf_hand, sdf_obj] with hand-part labels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from alignsdf_torch.data import sdf_samples as S
from alignsdf_torch.data.lmdb_backend import LmdbStore, unpack_sdf_samples_lmdb


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
    lmdb per spec (reference utils/data.py:118-129); only the LMDB format is
    ported."""
    if not specs.lmdb:
        raise NotImplementedError(
            "LMDB: false selects the per-file npz/jpg layout (NpzBackend), which needs a JPEG "
            "decoder and is not ported yet (ROADMAP.md §1 item 2); pack the dataset into "
            "LMDBs (tools/create_lmdb.py) and train with LMDB: true")
    return LmdbBackend(data_root, specs.dataset,
                       hand_branch=specs.hand_branch, obj_branch=specs.obj_branch)
