"""Pack a dataset in the reference's per-file layout into one ASDF-pack
file, with the PyTorch port's modules only (no OpenCV, no JAX): the file
``tools/pack_dataset.py`` writes, byte for byte, but for a CMYK JPEG, whose
conversion to RGB differs from cv2's by up to one level
(``alignsdf_torch/data/img_utils.py:load_img``).

One mmap-able file holding, per sample, the decoded RGB image, a [scale,
offset, (61,3) meta] float block (the layout of the reference's meta
LMDB, tools/create_lmdb.py:106-115) and both SDF sample blocks with their
pos / neg counts inline.  Read by the port's native reader
(``alignsdf_torch/csrc/packed_reader.cpp``, through
``alignsdf_torch/data/packed.py``) and by the JAX package's.  The reader
takes square images only.

Usage:
    python tools/pack_dataset_torch.py <data_source> <out.pack> [--dataset obman] \\
        [--keys key1 ...]
    # data_source = .../<dataset>/train with rgb/ norm/ meta/ sdf_hand/ sdf_obj/
"""

from __future__ import annotations

import argparse
import os
import struct
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from alignsdf_torch.data import sdf_samples as S  # noqa: E402
from alignsdf_torch.data.img_utils import load_img  # noqa: E402

MAGIC = b"ASDFPK01"


def meta_block(data_source: str, key: str, dataset: str) -> np.ndarray:
    scale, offset = S.unpack_normal_params(data_source, key)
    meta = S.unpack_meta_params(data_source, key, dataset)
    block = np.zeros((61, 3), np.float32)
    block[:21] = meta["joints_3d"][:, :3]
    block[21:30] = meta["obj_corners_3d"][:, :3]
    block[30:39] = meta["obj_rest_corners_3d"][:, :3]
    block[39:54] = meta["hand_pose"].reshape(15, 3)
    # row-major (3,4)->(4,3), the layout of the reference meta lmdb
    # (reference tools/create_lmdb.py:110)
    block[54:58] = meta["affine_transform"][:3, :4].reshape(4, 3)
    block[58:61] = meta["cam_intr"][:3, :3]
    head = np.concatenate([[float(np.asarray(scale).reshape(-1)[0])], offset]).astype(np.float32)
    return np.concatenate([head, block.reshape(-1)])


def sdf_block(data_source: str, key: str, hand: bool) -> bytes:
    sub = "sdf_hand" if hand else "sdf_obj"
    npz = np.load(os.path.join(data_source, sub, key + ".npz"))
    pos = np.asarray(npz["pos"], np.float32)
    neg = np.asarray(npz["neg"], np.float32)
    pos_other = np.asarray(npz["pos_other"], np.float32).reshape(-1, 1)
    neg_other = np.asarray(npz["neg_other"], np.float32).reshape(-1, 1)
    lab_key = ("lab_pos", "lab_neg") if hand else ("lab_pos_other", "lab_neg_other")
    lab_pos = np.asarray(npz[lab_key[0]], np.float32).reshape(len(pos), -1)[:, 0:1]
    lab_neg = np.asarray(npz[lab_key[1]], np.float32).reshape(len(neg), -1)[:, 0:1]

    # rows: [xyz, sdf_self, sdf_other, label]
    pos_rows = np.concatenate([pos[:, :4], pos_other, lab_pos], axis=1)
    neg_rows = np.concatenate([neg[:, :4], neg_other, lab_neg], axis=1)
    rows = np.concatenate([pos_rows, neg_rows]).astype(np.float32)
    return struct.pack("<II", len(pos), len(neg)) + rows.tobytes()


def pack(data_source: str, out_path: str, keys: list, dataset: str) -> None:
    index = []
    with open(out_path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<QQ", len(keys), 0))  # index offset patched later

        for key in keys:
            entry = {}
            kb = key.encode()
            entry["key_off"], entry["key_len"] = f.tell(), len(kb)
            f.write(kb)

            img = load_img(os.path.join(data_source, "rgb", key + ".jpg"))
            raw = np.ascontiguousarray(img[:, :, :3], np.uint8)
            entry["img_off"], entry["img_len"] = f.tell(), raw.nbytes
            f.write(raw.tobytes())

            mb = meta_block(data_source, key, dataset)
            entry["meta_off"] = f.tell()
            f.write(mb.tobytes())

            entry["sdf_hand_off"] = f.tell()
            f.write(sdf_block(data_source, key, True))
            entry["sdf_obj_off"] = f.tell()
            f.write(sdf_block(data_source, key, False))
            index.append(entry)

        index_offset = f.tell()
        for e in index:
            f.write(struct.pack(
                "<7Q", e["key_off"], e["key_len"], e["img_off"], e["img_len"],
                e["meta_off"], e["sdf_hand_off"], e["sdf_obj_off"],
            ))
        f.seek(16)
        f.write(struct.pack("<Q", index_offset))
    print(f"packed {len(keys)} records -> {out_path} "
          f"({os.path.getsize(out_path) / 1e6:.1f} MB)")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("data_source")
    parser.add_argument("out")
    parser.add_argument("--dataset", default="obman")
    parser.add_argument("--keys", nargs="*", default=None)
    args = parser.parse_args(argv)

    keys = args.keys
    if not keys:
        keys = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(os.path.join(args.data_source, "sdf_hand"))
            if f.endswith(".npz")
        )
    pack(args.data_source, args.out, keys, args.dataset)


if __name__ == "__main__":
    main()
