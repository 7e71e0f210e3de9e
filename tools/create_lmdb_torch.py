"""Pack a dataset in the reference's per-file layout into the reference's
five-LMDB layout, with the PyTorch port's modules only (no OpenCV, no JAX):
the databases ``tools/create_lmdb.py`` writes, byte for byte, but for a
CMYK JPEG, whose conversion to BGR differs from cv2's by up to one level.

Schema (reference tools/create_lmdb.py:21-310):
  rgb.lmdb      the decoded image per key as ``cv2.imread(IMREAD_UNCHANGED)``
                gives it (uint8 HWC BGR for a colour JPEG), raw bytes
  segm.lmdb     the segmentation images the same way (when a segm/ dir exists)
  norm.lmdb     f32[4] = [offset(3), scale]
  meta.lmdb     f32 (61,3) block: joints(21) | corners(9) | rest corners(9) |
                pose(15x3) | affine(4x3) | intrinsics(3x3)
  sdf_hand.lmdb f32 (20000,6) rows [xyz, sdf_hand, sdf_obj, label], zero-padded
  sdf_obj.lmdb  the same rows, the object's own sdf in column 4
plus each LMDB's meta_info.json ({name, keys} and, for sdf,
{pos_num, neg_num, dim}).  Images are decoded by PIL
(``alignsdf_torch/data/img_utils.py:read_image_unchanged``; gray, colour,
RGBA, gray with alpha and palette images are held to cv2's
``IMREAD_UNCHANGED`` in ``tests/test_torch_files.py``).

Usage:
    python tools/create_lmdb_torch.py <data_source> [--dataset obman] \\
        [--mode train] [--keys k ...]
    # data_source = .../<dataset>/<mode> with rgb/ norm/ meta/ sdf_hand/ sdf_obj/
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alignsdf_torch.data.img_utils import read_image_unchanged  # noqa: E402
from alignsdf_torch.data.lmdb_backend import meta_record, sdf_record, write_lmdb  # noqa: E402


def _keys_from(folder: str) -> list:
    return sorted(os.path.splitext(f)[0] for f in os.listdir(folder))


def pack_images(folder: str, lmdb_path: str, name: str, keys: list) -> None:
    """Each key's .jpg (else .png) decoded as IMREAD_UNCHANGED, raw
    (reference tools/create_lmdb.py:267-310)."""
    def records():
        for key in keys:
            for ext in (".jpg", ".png"):
                path = os.path.join(folder, key + ext)
                if os.path.isfile(path):
                    break
            yield key, read_image_unchanged(path)

    write_lmdb(lmdb_path, records(), {"name": name})


def pack_norm(folder: str, lmdb_path: str, name: str, keys: list) -> None:
    """f32[4] = offset(3) + scale (reference tools/create_lmdb.py:131-180)."""
    def records():
        for key in keys:
            data = np.load(os.path.join(folder, key + ".npz"))
            sample = np.zeros(4, np.float32)
            sample[0:3] = data["offset"]
            sample[3] = np.asarray(data["scale"]).reshape(-1)[0]
            yield key, sample

    write_lmdb(lmdb_path, records(), {"name": name, "keys": keys})


def pack_meta(folder: str, lmdb_path: str, name: str, keys: list, dataset: str) -> None:
    """(61, 3) f32 blocks (reference tools/create_lmdb.py:72-128)."""
    def records():
        for key in keys:
            with open(os.path.join(folder, key + ".pkl"), "rb") as f:
                yield key, meta_record(pickle.load(f), dataset)

    write_lmdb(lmdb_path, records(), {"name": name, "keys": keys})


def pack_sdf(folder: str, lmdb_path: str, name: str, keys: list, is_hand: bool) -> None:
    """(20000, 6) f32 blocks and the pos / neg counts; the object's rows swap
    the sdf columns, so column 3 is always the hand's field (reference
    tools/create_lmdb.py:183-260)."""
    pos_num, neg_num = [], []

    def records():
        for key in keys:
            block, n_pos, n_neg = sdf_record(np.load(os.path.join(folder, key + ".npz")),
                                             is_hand)
            pos_num.append(n_pos)
            neg_num.append(n_neg)
            yield key, block

    # the counts fill in as the records are written, before the json
    write_lmdb(lmdb_path, records(), {"name": name, "pos_num": pos_num, "neg_num": neg_num,
                                      "dim": 6, "keys": keys})


def create_lmdbs(data_source: str, dataset: str = "obman", mode: str = "train",
                 keys: list = None) -> None:
    """Every LMDB of ``data_source``, for ``keys`` (default: every file of
    ``sdf_hand/``)."""
    if keys is None:
        keys = _keys_from(os.path.join(data_source, "sdf_hand"))

    def at(sub):
        return os.path.join(data_source, sub), os.path.join(data_source, sub + ".lmdb")

    pack_images(*at("rgb"), f"{dataset}_rgb_{mode}", keys)
    if os.path.isdir(os.path.join(data_source, "segm")):
        pack_images(*at("segm"), f"{dataset}_segm_{mode}", keys)
    pack_norm(*at("norm"), f"{dataset}_norm_{mode}", keys)
    pack_meta(*at("meta"), f"{dataset}_meta_{mode}", keys, dataset)
    pack_sdf(*at("sdf_hand"), f"{dataset}_sdf_hand_{mode}", keys, is_hand=True)
    pack_sdf(*at("sdf_obj"), f"{dataset}_sdf_obj_{mode}", keys, is_hand=False)
    print(f"wrote 5 LMDBs for {len(keys)} keys under {data_source}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("data_source")
    parser.add_argument("--dataset", default="obman")
    parser.add_argument("--mode", default="train")
    parser.add_argument("--keys", nargs="*", default=None)
    args = parser.parse_args(argv)
    create_lmdbs(args.data_source, args.dataset, args.mode, args.keys)


if __name__ == "__main__":
    main()
