"""The ASDF-pack dataset: one mmap'd file per dataset, read by the port's
native reader (``csrc/packed_reader.cpp``, built at first use by
``native.py``; the JAX package's ``data/packed.py``).

``PackReader`` binds the reader: a record's key, raw image, meta block and
split-half SDF sampling, and ``build_batch``, which builds a whole train
batch in one call that releases the GIL (the rotation draw, the bilinear
warp, the SDF sampling, the normalization chain and ``to_train_batch``'s
[hand-half | obj-half] layout) over a thread pool.  The pack is written by
``tools/pack_dataset_torch.py`` (or the JAX package's packer: the format
is one).  The reader assumes square RGB images and a square train patch
and raises where either is not.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional

import numpy as np

from alignsdf_torch.config import Specs
from alignsdf_torch.data.dataset import SDFDataset
from alignsdf_torch.native import load_library

READER_VERSION = 2
META_FLOATS = 4 + 61 * 3  # [scale, offset(3)] + the (61, 3) meta block

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _bind(lib: ctypes.CDLL) -> None:
    i64, c_int, c_float, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    sigs = {
        "packed_open": (vp, [ctypes.c_char_p]),
        "packed_close": (None, [vp]),
        "packed_count": (i64, [vp]),
        "packed_key": (i64, [vp, i64, ctypes.c_char_p, i64]),
        "packed_image_len": (i64, [vp, i64]),
        "packed_image": (None, [vp, i64, _u8p]),
        "packed_meta": (None, [vp, i64, _f32p]),
        "packed_sample_sdf": (c_int, [vp, i64, c_int, i64, c_float, c_int, ctypes.c_uint64,
                                      _f32p, _f32p]),
        "packed_build_batch": (c_int, [vp, i64, ctypes.POINTER(i64),
                                       ctypes.POINTER(ctypes.c_uint64), i64, c_int, c_int,
                                       c_float, c_float, c_int, c_int, c_int, c_float, c_int,
                                       _u8p, *[_f32p] * 10, c_int]),
        "packed_reader_version": (c_int, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


class PackReader:
    """ctypes wrapper over the native pack reader (the JAX package's
    ``PackReader``)."""

    def __init__(self, path: str):
        lib = load_library("packed_reader")
        _bind(lib)
        if lib.packed_reader_version() != READER_VERSION:
            raise RuntimeError(f"packed_reader version {lib.packed_reader_version()}, "
                               f"expected {READER_VERSION}")
        self._lib = lib
        self._h = lib.packed_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open pack file {path}")
        self._n = int(lib.packed_count(self._h))
        self.image_side = [self._side(i) for i in range(self._n)]

    def _side(self, i: int) -> int:
        n = int(self._lib.packed_image_len(self._h, i))
        side = math.isqrt(n // 3)
        if side * side * 3 != n:
            raise ValueError(f"pack record {i}: an image of {n} bytes is not square RGB")
        return side

    def __len__(self) -> int:
        return self._n

    def _check(self, i: int) -> int:
        if not 0 <= i < self._n:
            raise IndexError(f"pack record {i} of {self._n}")
        return i

    def key(self, i: int) -> str:
        buf = ctypes.create_string_buffer(256)
        self._lib.packed_key(self._h, self._check(i), buf, 256)
        return buf.value.decode()

    def image(self, i: int) -> np.ndarray:
        side = self.image_side[self._check(i)]
        out = np.empty((side, side, 3), np.uint8)
        self._lib.packed_image(self._h, i, out.ctypes.data_as(_u8p))
        return out

    def meta(self, i: int):
        """(scale, offset (3,), the (61, 3) meta block)."""
        out = np.empty(META_FLOATS, np.float32)
        self._lib.packed_meta(self._h, self._check(i), out.ctypes.data_as(_f32p))
        return out[0], out[1:4].copy(), out[4:].reshape(61, 3)

    def sample_sdf(self, i: int, hand: bool, subsample: int, clamp: float,
                   filter_dist: bool, seed: int):
        samples = np.empty((subsample, 5), np.float32)
        labels = np.empty(subsample, np.float32)
        rc = self._lib.packed_sample_sdf(
            self._h, self._check(i), int(hand), subsample, clamp, int(filter_dist),
            seed & 0xFFFFFFFFFFFFFFFF, samples.ctypes.data_as(_f32p),
            labels.ctypes.data_as(_f32p))
        if rc != 0:
            raise RuntimeError(f"packed_sample_sdf failed for record {i}")
        return samples, labels

    def build_batch(self, indices, seeds, specs: Specs, num_threads: int = 0):
        """The whole-batch native pipeline (augmentation, sampling, the
        normalization chain and the train-batch layout) in one GIL-free call
        over ``num_threads`` threads (0: one a core).  Returns
        ``to_train_batch``'s dict with a uint8 image tensor."""
        size = int(specs.image_size[0])
        if specs.image_size[1] != size:
            raise ValueError(f"the pack's native batch needs a square patch, not "
                             f"{tuple(specs.image_size)}")
        idx = np.ascontiguousarray(indices, np.int64)
        sds = np.ascontiguousarray(seeds, np.uint64)
        if idx.ndim != 1 or sds.shape != idx.shape:
            raise ValueError(f"indices {idx.shape} and seeds {sds.shape} must be one per scene")
        for i in idx:
            self._check(int(i))
        batch, n = len(idx), specs.samples_per_scene
        images = np.empty((batch, size, size, 3), np.uint8)
        xyz = np.empty((batch * n, 3), np.float32)
        sdf_hand = np.empty((batch * n, 1), np.float32)
        sdf_obj = np.empty((batch * n, 1), np.float32)
        labels = np.empty(batch * n, np.float32)
        cam_intr = np.empty((batch, 3, 4), np.float32)
        mano_root = np.empty((batch, 3), np.float32)
        rest_corners = np.empty((batch, 8, 3), np.float32)
        joints = np.empty((batch, 21, 3), np.float32)
        obj_center = np.empty((batch, 3), np.float32)
        obj_corners = np.empty((batch, 8, 3), np.float32)
        obman = "obman" in specs.dataset
        rc = self._lib.packed_build_batch(
            self._h, batch, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n, int(specs.hand_branch), int(specs.obj_branch),
            specs.clamping_distance or 0.0, specs.sdf_scale_factor,
            int(specs.disable_aug), int(specs.occlusion_aug), size,
            45.0 if obman else 15.0, int(obman), images.ctypes.data_as(_u8p),
            *(a.ctypes.data_as(_f32p) for a in (xyz, sdf_hand, sdf_obj, labels, cam_intr,
                                                 mano_root, rest_corners, joints, obj_center,
                                                 obj_corners)),
            num_threads)
        if rc != 0:
            raise RuntimeError("packed_build_batch failed")
        return {
            "image": images,
            "xyz": xyz,
            "sdf_gt_hand": sdf_hand,
            "sdf_gt_obj": sdf_obj,
            "labels": labels.astype(np.int32),
            "cam_intr": cam_intr,
            "mano_root": mano_root,
            "rest_obj_corners": rest_corners,
            "hand_joints_3d": joints,
            "obj_center": obj_center,
            "obj_corners": obj_corners,
        }

    def close(self) -> None:
        if self._h:
            self._lib.packed_close(self._h)
            self._h = None


class PackedSDFDataset(SDFDataset):
    """``SDFDataset`` over an ASDF-pack file (``PackedBackend``): the same
    sample math, the record decode and split-half sampling native, and the
    native whole-batch path for ``raw_image=True``.  The JAX package's
    class, kept so that its tests' parity holds class for class; the train
    CLI builds the same dataset through ``make_train_dataset(...,
    pack_path=...)``."""

    def __init__(self, specs: Specs, pack_path: str, keys: Optional[List[str]] = None,
                 raw_image: bool = False):
        from alignsdf_torch.data.backends import PackedBackend

        backend = PackedBackend(pack_path, specs.dataset)
        super().__init__(specs, keys if keys is not None else backend.keys(), backend,
                         raw_image=raw_image)
        self.reader = backend.reader
