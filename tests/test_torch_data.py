"""The port's dataset path against the JAX package's: the LMDB engine both
ways, ``write_synthetic_lmdb`` against the JAX writer and packer, dataset
items, the cv2-free warp against cv2, the epoch order and a loader batch."""

import os
import sys

import cv2
import numpy as np
import pytest
import torch

from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.data import img_utils as jax_img
from alignsdf_tpu.data import make_train_dataset as jax_make_train_dataset
from alignsdf_tpu.data.dataset import to_train_batch as jax_to_train_batch
from alignsdf_tpu.data.lmdb_format import LmdbWriter as JaxWriter
from alignsdf_tpu.data.lmdb_format import MiniLmdb as JaxReader
from alignsdf_tpu.data.loader import DataLoader as JaxLoader
from alignsdf_tpu.data.loader import epoch_indices as jax_epoch_indices
from alignsdf_tpu.data.sdf_samples import unpack_sdf_samples as jax_unpack_sdf_samples
from alignsdf_tpu.data.synthetic import write_synthetic_dataset
from alignsdf_torch.config import Specs
from alignsdf_torch.data import img_utils, make_train_dataset
from alignsdf_torch.data.dataset import to_train_batch
from alignsdf_torch.data.lmdb_format import LmdbWriter, MiniLmdb
from alignsdf_torch.data.loader import DataLoader, epoch_indices
from alignsdf_torch.data.sdf_samples import unpack_sdf_samples
from alignsdf_torch.data.synthetic import write_synthetic_lmdb

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = [f"{i:08d}" for i in range(4)]
# the warp against cv2's: exact on the same matrix; the port's own matrix
# (a 6x6 LU solve, as cv2.getAffineTransform's) differs from cv2's in the
# last bit or two, which moves a pixel by one level at ~6e-5 of the values
WARP_LEVELS, WARP_SHARE = 1, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_parity.torch_threads(1):
        yield


@pytest.fixture(scope="module")
def lmdb_root(tmp_path_factory):
    """JAX's lmdb_root fixture (tests/test_lmdb.py): the synthetic
    reference-layout dataset packed by tools/create_lmdb.py, 4 keys, 1200
    points a scene."""
    root = tmp_path_factory.mktemp("lmdbds")
    base = write_synthetic_dataset(str(root), KEYS, n_points=1200, image_hw=256)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import create_lmdb

    create_lmdb.create_lmdbs(base, "obman", "train", KEYS)
    return base


def _items():
    rng = np.random.RandomState(0)
    items = {}
    for i in range(300):
        size = rng.randint(40000, 120000) if i % 29 == 0 else rng.randint(1, 1800)
        items[f"{i:08d}"] = rng.bytes(size)
    return items


@pytest.mark.parametrize("writer,reader", [(LmdbWriter, MiniLmdb), (JaxWriter, MiniLmdb),
                                           (LmdbWriter, JaxReader)],
                         ids=["port-port", "jax-port", "port-jax"])
def test_lmdb_round_trip(tmp_path, writer, reader):
    """Inline and overflow values over a two-level tree: the keys, in order,
    and every value read back as written."""
    items = _items()
    path = str(tmp_path / "db.lmdb")
    with writer(path) as w:
        for k in sorted(items, key=lambda k: items[k][:4]):  # not in key order
            w.put(k, items[k])
    db = reader(path)
    assert len(db) == len(items) and db.depth >= 2
    assert [k.decode() for k, _ in db.items()] == sorted(items)
    for k, v in items.items():
        assert db.get(k) == v
    assert db.get("missing") is None


def test_write_synthetic_lmdb_matches_jax_writer_and_packer(lmdb_root, tmp_path):
    """norm, meta and both SDF databases byte for byte, every meta_info.json
    equal; the images raw, where the JAX writer's went through a JPEG."""
    base = write_synthetic_lmdb(str(tmp_path), KEYS, n_points=1200, image_hw=256)
    assert base == os.path.join(str(tmp_path), "obman", "train")
    for name in ("rgb", "norm", "meta", "sdf_hand", "sdf_obj"):
        with open(os.path.join(lmdb_root, f"{name}.lmdb", "meta_info.json")) as f:
            want = f.read()
        with open(os.path.join(base, f"{name}.lmdb", "meta_info.json")) as f:
            assert f.read() == want, name
        a, b = MiniLmdb(os.path.join(lmdb_root, f"{name}.lmdb")), \
            MiniLmdb(os.path.join(base, f"{name}.lmdb"))
        assert [k for k, _ in a.items()] == [k for k, _ in b.items()]
        if name != "rgb":
            with open(os.path.join(lmdb_root, f"{name}.lmdb", "data.mdb"), "rb") as f:
                want = f.read()
            with open(os.path.join(base, f"{name}.lmdb", "data.mdb"), "rb") as f:
                assert f.read() == want, name
    rng = np.random.RandomState(0)
    raw = (rng.rand(256, 256, 3) * 255).astype(np.uint8)  # key 0's image
    stored = np.frombuffer(MiniLmdb(os.path.join(base, "rgb.lmdb")).get(KEYS[0]), np.uint8)
    np.testing.assert_array_equal(stored.reshape(256, 256, 3), raw[:, :, ::-1])


def _specs(cls, **over):
    base = dict(dataset="obman", sdf_scale_factor=7.0186, samples_per_scene=64,
                image_size=(256, 256), clamping_distance=0.05, lmdb=True)
    return cls(**dict(base, **over))


def _assert_items_equal(a, b, exact_image: bool):
    assert set(a) == set(b)
    for field in sorted(set(a) - {"key", "image"}):
        np.testing.assert_array_equal(a[field], b[field], err_msg=field)
    assert a["image"].dtype == b["image"].dtype == np.uint8
    diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
    if exact_image:
        assert diff.max() == 0
    else:
        assert diff.max() <= WARP_LEVELS and (diff > 0).mean() <= WARP_SHARE


@pytest.mark.parametrize("no_aug", [False, True], ids=["aug", "no_aug"])
def test_dataset_items_match_jax(lmdb_root, no_aug):
    """The same key and seed through both packages' SDFDataset over JAX's
    LMDBs, uint8 images: every array exact but the augmented image (the warp
    tolerance); with DisableAug (--no_aug) the image is exact too.  The
    seeds cover rotated and unrotated draws."""
    port = make_train_dataset(_specs(Specs, disable_aug=no_aug), lmdb_root, raw_image=True)
    ref = jax_make_train_dataset(_specs(JaxSpecs, disable_aug=no_aug), None,
                                 data_root=lmdb_root, raw_image=True)
    assert port.keys == ref.keys == KEYS
    rotated = 0
    for idx, seed in ((0, 3), (2, 11), (1, 5), (3, 8), (1, 0)):
        a, b = port.__getitem__(idx, seed=seed), ref.__getitem__(idx, seed=seed)
        _assert_items_equal(a, b, exact_image=no_aug)
        rotated += int(not a["image"][:4, :4].any())
    assert rotated == 0 if no_aug else rotated > 0


@pytest.mark.parametrize("hand", [True, False], ids=["hand", "obj"])
def test_unpack_sdf_samples_matches_jax(lmdb_root, hand):
    """The per-file npz sampler (what the npz/jpg layout will read) on the
    fixture's npz files: the same rows and labels from the same draws."""
    for seed in (0, 7):
        a = unpack_sdf_samples(lmdb_root, KEYS[1], 300, hand=hand, clamp=0.05,
                               filter_dist=True, rng=np.random.default_rng(seed))
        b = jax_unpack_sdf_samples(lmdb_root, KEYS[1], 300, hand=hand, clamp=0.05,
                                   filter_dist=True, rng=np.random.default_rng(seed))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert a[0].shape == (300, 5)


@pytest.mark.parametrize("rot", [60.0, -60.0])
def test_warp_matches_cv2(rot):
    """The numpy bilinear warp with a constant-0 border against
    cv2.warpAffine at +-60 degrees: exact on cv2's matrix, within the warp
    tolerance on the port's own (getAffineTransform without cv2)."""
    rng = np.random.RandomState(int(rot) % 7)
    img = (rng.rand(256, 256, 3) * 255).astype(np.uint8)
    m_cv = jax_img.gen_trans_from_patch_cv(128.0, 128.0, 256.0, 256.0, 256, 256, 1.1, rot)
    m_port = img_utils.gen_trans_from_patch_cv(128.0, 128.0, 256.0, 256.0, 256, 256, 1.1, rot)
    np.testing.assert_allclose(m_port, m_cv, rtol=0, atol=1e-12)
    want = cv2.warpAffine(img, m_cv, (256, 256), flags=cv2.INTER_LINEAR)
    assert not want[:8, :8].any()  # the rotated corners are black
    np.testing.assert_array_equal(img_utils.warp_affine_linear(img, m_cv, 256, 256), want)
    diff = np.abs(img_utils.warp_affine_linear(img, m_port, 256, 256).astype(int) - want)
    assert diff.max() <= WARP_LEVELS and (diff > 0).mean() <= WARP_SHARE


@pytest.mark.parametrize("n,epoch,seed", [(4, 2, 0), (131, 7, 3)])
def test_epoch_indices_match_jax(n, epoch, seed):
    np.testing.assert_array_equal(epoch_indices(n, epoch, seed),
                                  jax_epoch_indices(n, epoch, 1, 0, True, seed))


def test_loader_first_batch_of_epoch_2_matches_jax(lmdb_root):
    """Both loaders (2 threads, 2 scenes a batch, seed 5) in epoch 2: the
    same scenes in the same order, the same per-sample seeds, so every array
    of the train batch equal, the images within the warp tolerance."""
    pspecs, jspecs = _specs(Specs), _specs(JaxSpecs)
    port = DataLoader(make_train_dataset(pspecs, lmdb_root, raw_image=True),
                      batch_size=2, num_workers=2, seed=5,
                      to_batch=lambda s: to_train_batch(pspecs, s))
    ref = JaxLoader(jax_make_train_dataset(jspecs, None, data_root=lmdb_root, raw_image=True),
                    batch_size=2, num_workers=2, seed=5,
                    to_batch=lambda s: jax_to_train_batch(jspecs, s))
    assert len(port) == len(ref) == 2
    port.set_epoch(2)
    ref.set_epoch(2)
    a, b = next(iter(port)), next(iter(ref))
    _assert_items_equal(a, b, exact_image=False)
    assert a["xyz"].shape == (2 * 64, 3) and a["image"].shape == (2, 256, 256, 3)
    assert isinstance(a["image"], np.ndarray) and not isinstance(a["image"], torch.Tensor)


@pytest.mark.parametrize("value", [False, True])
def test_occlusion_aug_refused_when_on(value):
    """The JAX package's opt-in synthetic occlusion is not ported: the spec
    key is accepted off (the reference's behaviour) and refused on."""
    from alignsdf_torch.config import specs_from_dict

    if value:
        with pytest.raises(NotImplementedError, match="OcclusionAug"):
            specs_from_dict({"OcclusionAug": value})
    else:
        assert specs_from_dict({"OcclusionAug": value}) == Specs()
