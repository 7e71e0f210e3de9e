"""The train dataset in numpy (the JAX package's ``data/dataset.py``;
reference utils/data.py parity).

``SDFDataset.__getitem__`` reproduces the sample math of the reference
``SDFSamples`` (reference utils/data.py:110-206): camera-extrinsic flip,
augmentation rotation applied to points/joints/corners, recentering at the
MANO root, the SdfScaleFactor multiply and the final /2 into decoder space.
With a seed it draws from ``random.Random(seed)``,
``np.random.RandomState(seed)`` and a ``default_rng`` seeded from the
latter, in the JAX package's order, so both packages give the same item.

Output arrays are static-shape, so items stack into fixed-size batches.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np

from alignsdf_torch.config import Specs
from alignsdf_torch.data import img_utils as I

_OBMAN_EXTR = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]], np.float32)
_IDENT_EXTR = np.eye(3, dtype=np.float32)


class SDFDataset:
    """Map-style train dataset; storage comes from a backend
    (``data/backends.py``) while the sample math lives here."""

    def __init__(self, specs: Specs, split_keys: List[str], backend, raw_image: bool = False):
        self.specs = specs
        self.keys = list(split_keys)
        # raw_image=True returns the augmented patch as uint8 HWC, which the
        # model normalizes on the device (models/alignsdf.py:
        # normalize_image_on_device); False normalizes here
        self.raw_image = raw_image
        self.backend = backend

    def __len__(self) -> int:
        return len(self.keys)

    def num_samples_per_branch(self) -> int:
        specs = self.specs
        if specs.hand_branch and specs.obj_branch:
            return specs.samples_per_scene // 2
        return specs.samples_per_scene

    def __getitem__(self, idx: int, seed: Optional[int] = None,
                    sample_uniforms=None) -> Dict[str, np.ndarray]:
        """``sample_uniforms``: optional ((u_pos, u_neg) hand, (u_pos, u_neg)
        obj) uniform draws injected into the SDF sampling — lets golden tests
        drive this chain and the reference ``SDFSamples`` with identical
        randomness."""
        specs = self.specs
        key = self.keys[idx]
        rng = random.Random(seed) if seed is not None else random
        np_rng = np.random.RandomState(seed) if seed is not None else np.random

        cam_extr = _OBMAN_EXTR if "obman" in specs.dataset else _IDENT_EXTR

        scale, offset = self.backend.normal_params(key)
        meta = self.backend.meta_params(key)
        cam_intr = meta["cam_intr"].copy()

        img = self.backend.image(key)

        if specs.disable_aug:
            rot, do_flip = 0.0, False
        else:
            # the occlusion draw is made and dropped, as in the reference
            # (utils/data.py:132,142), so the random sequence matches it
            _, rot, do_flip, _, _ = I.get_aug_config(
                specs.dataset, enable_flip=False, rng=rng, np_rng=np_rng
            )
        img_scale = 1.0

        rot_aug_mat = np.array(
            [
                [np.cos(np.deg2rad(-rot)), -np.sin(np.deg2rad(-rot)), 0],
                [np.sin(np.deg2rad(-rot)), np.cos(np.deg2rad(-rot)), 0],
                [0, 0, 1],
            ],
            np.float32,
        )
        image_size = specs.image_size
        crop_box = [
            (img.shape[1] - image_size[1]) // 2,
            (img.shape[0] - image_size[0]) // 2,
            image_size[1],
            image_size[0],
        ]
        # intrinsics rescale (reference utils/data.py:138-141)
        cam_intr[0, 0] /= img_scale
        cam_intr[0, 2] = cam_intr[0, 2] / img.shape[1] * image_size[1]
        cam_intr[1, 1] /= img_scale
        cam_intr[1, 2] = cam_intr[1, 2] / img.shape[0] * image_size[0]

        patch, _ = I.generate_patch_image(img, crop_box, image_size, do_flip, img_scale, rot)
        encoder_input = patch if self.raw_image else I.normalize_image(patch)

        joints = (cam_extr @ meta["joints_3d"][:, :3].T).T.astype(np.float32)
        obj_corners = (cam_extr @ meta["obj_corners_3d"][:, :3].T).T.astype(np.float32)
        rest_corners = (cam_extr @ meta["obj_rest_corners_3d"][:, :3].T).T.astype(np.float32)

        num_sample = self.num_samples_per_branch()
        gen = np.random.default_rng(np_rng.randint(0, 2 ** 31)) if seed is not None else np.random.default_rng()

        if specs.hand_branch:
            hand_samples, hand_labels = self.backend.sample_sdf(
                key, True, num_sample, specs.clamping_distance, True, gen,
                uniforms=sample_uniforms[0] if sample_uniforms else None,
            )
        else:
            hand_samples = np.zeros((num_sample, 5), np.float32)
            hand_labels = -np.ones(num_sample, np.float32)
        if specs.obj_branch:
            obj_samples, obj_labels = self.backend.sample_sdf(
                key, False, num_sample, specs.clamping_distance, True, gen,
                uniforms=sample_uniforms[1] if sample_uniforms else None,
            )
        else:
            obj_samples = np.zeros((num_sample, 5), np.float32)
            obj_labels = -np.ones(num_sample, np.float32)

        # normalization chain (reference utils/data.py:176-199)
        for samples in (hand_samples, obj_samples):
            samples[:, 0:3] = samples[:, 0:3] / scale - offset
        if do_flip:
            hand_samples[:, 0] *= -1
            obj_samples[:, 0] *= -1
            joints[:, 0] *= -1
            obj_corners[:, 0] *= -1

        for arr in (hand_samples, obj_samples):
            arr[:, 0:3] = (rot_aug_mat @ arr[:, 0:3].T).T
        joints[:, 0:3] = (rot_aug_mat @ joints[:, 0:3].T).T
        obj_corners[:, 0:3] = (rot_aug_mat @ obj_corners[:, 0:3].T).T

        mano_root = joints[0].copy()
        for arr in (hand_samples, obj_samples):
            arr[:, 0:3] = (arr[:, 0:3] - mano_root) * specs.sdf_scale_factor
            arr[:, 3:] = arr[:, 3:] / scale * specs.sdf_scale_factor
            arr[:, 0:5] /= 2.0

        return {
            "image": encoder_input,
            "pc_hand": hand_samples,
            "cls_hand": hand_labels,
            "pc_obj": obj_samples,
            "cls_obj": obj_labels,
            "hand_joints_3d": joints,
            "obj_corners": obj_corners[1:, :] - obj_corners[[0], :],
            "obj_center": obj_corners[0, :],
            "cam_intr": cam_intr,
            "mano_root": mano_root,
            "rest_obj_corners": rest_corners[1:, :],
            "key": key,
        }


def collate(batch_items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack per-sample dicts into batched arrays (strings collected as lists)."""
    out: Dict[str, np.ndarray] = {}
    for field in batch_items[0]:
        vals = [item[field] for item in batch_items]
        if isinstance(vals[0], str):
            out[field] = vals  # type: ignore[assignment]
        else:
            out[field] = np.stack(vals, axis=0)
    return out


def to_train_batch(specs: Specs, stacked: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Assemble the flat (B*N, ...) arrays the jitted train step consumes
    (reference train.py:467-507 host-side tensor plumbing)."""
    if specs.hand_branch and specs.obj_branch:
        samples = np.concatenate([stacked["pc_hand"], stacked["pc_obj"]], axis=1)
        labels = np.concatenate([stacked["cls_hand"], stacked["cls_obj"]], axis=1)
    elif specs.hand_branch:
        samples, labels = stacked["pc_hand"], stacked["cls_hand"]
    else:
        samples, labels = stacked["pc_obj"], stacked["cls_obj"]

    batch_size, n = samples.shape[0], samples.shape[1]
    sdf_data = samples.reshape(batch_size * n, -1)
    return {
        "image": stacked["image"],
        "xyz": sdf_data[:, 0:3],
        "sdf_gt_hand": sdf_data[:, 3:4],
        "sdf_gt_obj": sdf_data[:, 4:5],
        "labels": labels.reshape(batch_size * n).astype(np.int32),
        "cam_intr": stacked["cam_intr"],
        "mano_root": stacked["mano_root"],
        "rest_obj_corners": stacked["rest_obj_corners"],
        "hand_joints_3d": stacked["hand_joints_3d"],
        "obj_center": stacked["obj_center"],
        "obj_corners": stacked["obj_corners"],
    }
