"""The ASDF pack in the port, against the JAX package: the cv2-free packer
against ``tools/pack_dataset.py`` byte for byte, the port's native reader
against the JAX package's (built by the same g++ with the same flags from
its own ``csrc/packed/packed_reader.cpp``), the whole-batch native path
bit for bit with augmentation on and off, pack items against the per-file
ones, ``OcclusionAug`` against the JAX package's occlusion, and
``cli.train --packed`` on the CPU at small sizes."""

import dataclasses
import json
import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest

import alignsdf_tpu.native as jax_native
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.data import img_utils as jax_img
from alignsdf_tpu.data import make_train_dataset as jax_make_train_dataset
from alignsdf_tpu.data.dataset import to_train_batch as jax_to_train_batch
from alignsdf_tpu.data.loader import DataLoader as JaxLoader
from alignsdf_tpu.data.packed import PackedSDFDataset as JaxPackedSDFDataset
from alignsdf_torch import native
from alignsdf_torch.cli import train as train_cli
from alignsdf_torch.config import Specs, load_specs
from alignsdf_torch.data import img_utils, make_train_dataset
from alignsdf_torch.data.backends import NpzBackend, PackedBackend
from alignsdf_torch.data.dataset import SDFDataset, to_train_batch
from alignsdf_torch.data.loader import DataLoader
from alignsdf_torch.data.packed import PackedSDFDataset
from alignsdf_torch.data.synthetic import write_synthetic_dataset

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import pack_dataset  # noqa: E402
import pack_dataset_torch  # noqa: E402

KEYS = [f"{i:08d}" for i in range(6)]
HW = 96
WARP_LEVELS, WARP_SHARE = 1, 1e-3  # the port's augmentation warp (tests/test_torch_data.py)
DETERMINISTIC = ("hand_joints_3d", "obj_center", "obj_corners", "cam_intr", "mano_root",
                 "rest_obj_corners")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_parity.torch_threads(1):
        yield


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """Six scenes in the per-file layout (96x96 JPEGs, 800 SDF rows a
    branch) packed by both packers; the JAX package's reader built from its
    own source with the port's flags into a directory its loader searches."""
    root = tmp_path_factory.mktemp("packed")
    base = write_synthetic_dataset(str(root), KEYS, n_points=800, image_hw=HW)
    port_pack, jax_pack = str(root / "port.pack"), str(root / "jax.pack")
    pack_dataset_torch.pack(base, port_pack, KEYS, "obman")
    pack_dataset.pack(base, jax_pack, KEYS, "obman")
    lib_dir = root / "jaxlib"
    lib_dir.mkdir()
    gxx = [shutil.which("g++"), *native.GXX_FLAGS, "-o", str(lib_dir / "libpacked_reader.so"),
           os.path.join(REPO, "csrc", "packed", "packed_reader.cpp")]
    subprocess.run(gxx, check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_SEARCH_DIRS", (str(lib_dir),))
        yield base, port_pack, jax_pack


def _specs(cls, **over):
    base = dict(dataset="obman", sdf_scale_factor=7.0186, samples_per_scene=64,
                image_size=(HW, HW), clamping_distance=0.05, lmdb=False)
    return cls(**dict(base, **over))


def test_packer_matches_jax_packer(packs):
    """tools/pack_dataset_torch.py writes tools/pack_dataset.py's pack byte
    for byte (the same JPEGs decoded by PIL and by cv2)."""
    _, port_pack, jax_pack = packs
    with open(port_pack, "rb") as f, open(jax_pack, "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("hand", [True, False], ids=["hand", "obj"])
def test_reader_matches_jax_reader(packs, hand):
    """Each record's key, image, meta block and split-half SDF sampling
    through the port's reader and the JAX package's, on the JAX pack."""
    from alignsdf_tpu.data.packed import PackReader as JaxPackReader

    from alignsdf_torch.data.packed import PackReader

    _, _, jax_pack = packs
    port, ref = PackReader(jax_pack), JaxPackReader(jax_pack)
    assert len(port) == len(ref) == len(KEYS)
    for i in range(len(KEYS)):
        assert port.key(i) == ref.key(i) == KEYS[i]
        np.testing.assert_array_equal(port.image(i), ref.image(i))
        assert port.image(i).shape == (HW, HW, 3)
        for a, b in zip(port.meta(i), ref.meta(i)):
            np.testing.assert_array_equal(a, b)
        for seed in (0, 2 ** 63 + 5):
            for a, b in zip(port.sample_sdf(i, hand, 300, 0.05, True, seed),
                            ref.sample_sdf(i, hand, 300, 0.05, True, seed)):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(IndexError):
        port.image(len(KEYS))


@pytest.mark.parametrize("branches", ["both", "hand_only"])
@pytest.mark.parametrize("aug", [True, False], ids=["aug", "no_aug"])
def test_build_batch_matches_jax(packs, aug, branches):
    """The whole-batch native path against the JAX package's, bit for bit,
    at 1 and 4 threads (and the two thread counts against each other):
    every array, the rotated images included, and the rotation draw does
    rotate some scenes when augmentation is on."""
    _, port_pack, jax_pack = packs
    over = dict(disable_aug=not aug, obj_branch=branches == "both")
    port = PackedSDFDataset(_specs(Specs, **over), port_pack, raw_image=True)
    ref = JaxPackedSDFDataset(_specs(JaxSpecs, **over), jax_pack, raw_image=True)
    idx, seeds = np.array([3, 0, 5, 1, 4, 2]), [11, 22, 33, 44, 55, 66]
    want = ref.reader.build_batch(idx, np.asarray(seeds, np.uint64), ref.specs, num_threads=1)
    for threads in (1, 4):
        got = port.reader.build_batch(idx, seeds, port.specs, num_threads=threads)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} at {threads} threads")
    batch = port.build_batch(list(idx), seeds)  # the dataset's route: all threads
    for k in want:
        np.testing.assert_array_equal(batch[k], want[k], err_msg=k)
    assert batch["image"].dtype == np.uint8 and batch["xyz"].shape == (6 * 64, 3)
    corners = batch["image"][:, :2, :2].reshape(6, -1).any(axis=1)
    assert corners.all() if not aug else not corners.all()
    if branches == "hand_only":
        assert (batch["labels"] >= 0).any()
    else:
        assert (batch["labels"][32:64] == -1).all()  # the object half


def test_packed_items_match_per_file_and_jax(packs):
    """A pack item (augmentation off) against the per-file item of the same
    key on every deterministic field (the JAX package's
    tests/test_native.py), and against the JAX package's pack item on every
    field."""
    base, port_pack, jax_pack = packs
    specs = _specs(Specs, disable_aug=True)
    from_pack = PackedSDFDataset(specs, port_pack, KEYS)
    from_files = SDFDataset(specs, KEYS, NpzBackend(base, "obman"))
    ref = JaxPackedSDFDataset(_specs(JaxSpecs, disable_aug=True), jax_pack, KEYS)
    for idx, seed in ((1, 5), (4, 9)):
        a, b = from_pack.__getitem__(idx, seed=seed), from_files.__getitem__(idx, seed=seed)
        for field in ("image", *DETERMINISTIC):
            np.testing.assert_allclose(a[field], b[field], atol=1e-5, err_msg=field)
        assert a["pc_hand"].shape == b["pc_hand"].shape == (32, 5)
        assert set(np.unique(a["cls_obj"]).astype(int).tolist()) == {-1}
        c = ref.__getitem__(idx, seed=seed)
        assert set(a) == set(c)
        for field in set(a) - {"key"}:
            np.testing.assert_array_equal(a[field], c[field], err_msg=field)


def test_make_train_dataset_prefers_the_pack(packs):
    """The JAX package's backend priority: a pack path over the spec's LMDB
    or per-file backend; every key of the pack by default."""
    base, port_pack, _ = packs
    for lmdb in (True, False):
        ds = make_train_dataset(_specs(Specs, lmdb=lmdb), base, raw_image=True,
                                pack_path=port_pack)
        assert isinstance(ds.backend, PackedBackend) and ds.keys == KEYS
    with pytest.raises(ValueError, match="square patch"):
        ds.backend.reader.build_batch([0], [1], _specs(Specs, image_size=(HW, 64)))


@pytest.mark.parametrize("rot", [0.0, 35.0], ids=["before_warp", "after_warp"])
def test_occlusion_matches_jax(rot):
    """generate_patch_image with the synthetic occlusion on, the same
    draws: without rotation over the whole image the warp is a copy, so
    the occluded image itself is compared, bit for bit; rotated, within the
    warp's tolerance.  Both generators end in the same state."""
    rng0 = np.random.RandomState(4)
    img = (rng0.rand(HW, HW, 3) * 255).astype(np.uint8)
    box = [0, 0, HW, HW] if rot == 0 else [8, 8, 80, 80]
    out = {}
    for name, mod in (("port", img_utils), ("jax", jax_img)):
        rng, np_rng = random.Random(7), np.random.RandomState(7)
        patch, _ = mod.generate_patch_image(img, box, (box[3], box[2]), False, 1.0, rot, True,
                                            rng=rng, np_rng=np_rng)
        out[name] = (patch, rng.random(), np_rng.rand())
    (a, ra, na), (b, rb, nb) = out["port"], out["jax"]
    assert (ra, na) == (rb, nb)
    if rot == 0:
        np.testing.assert_array_equal(a, b)
        assert (a != img).any()
    else:
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= WARP_LEVELS and (diff > 0).mean() <= WARP_SHARE


def test_occlusion_aug_items_and_loader_match_jax(packs):
    """OcclusionAug: true through the item path, from the per-file layout
    and from a pack, whose native batch declines it so that the loader
    builds the batch item by item, as the JAX package routes it: every
    array equal to the JAX package's, the images within the warp
    tolerance, and the occlusion seen (noise boxes differ from the scene
    without it)."""
    base, port_pack, jax_pack = packs
    specs, jspecs = _specs(Specs, occlusion_aug=True), _specs(JaxSpecs, occlusion_aug=True)
    port = make_train_dataset(specs, base, KEYS, raw_image=True)
    ref = jax_make_train_dataset(jspecs, KEYS, data_root=base, raw_image=True)
    plain = make_train_dataset(dataclasses.replace(specs, occlusion_aug=False), base, KEYS,
                               raw_image=True)
    occluded = 0
    for idx, seed in ((0, 3), (2, 11), (1, 5), (3, 8)):
        a, b = port.__getitem__(idx, seed=seed), ref.__getitem__(idx, seed=seed)
        assert set(a) == set(b)
        for field in set(a) - {"key", "image"}:
            np.testing.assert_array_equal(a[field], b[field], err_msg=field)
        diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
        assert diff.max() <= WARP_LEVELS and (diff > 0).mean() <= WARP_SHARE
        occluded += int((a["image"] != plain.__getitem__(idx, seed=seed)["image"]).any())
    assert occluded > 0

    pack_ds = PackedSDFDataset(specs, port_pack, raw_image=True)
    assert pack_ds.build_batch([0, 1], [1, 2]) is None
    loader = DataLoader(pack_ds, batch_size=3, num_workers=2, seed=5,
                        to_batch=lambda s: to_train_batch(specs, s))
    jloader = JaxLoader(JaxPackedSDFDataset(jspecs, jax_pack, raw_image=True), batch_size=3,
                        num_workers=2, seed=5, to_batch=lambda s: jax_to_train_batch(jspecs, s))
    loader.set_epoch(2)
    jloader.set_epoch(2)
    for a, b in zip(loader, jloader):
        for k in set(a) - {"image"}:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
        assert diff.max() <= WARP_LEVELS and (diff > 0).mean() <= WARP_SHARE


def test_train_cli_packed_two_steps(packs, tmp_path):
    """cli.train --packed on the CPU at a narrow width: one epoch of the
    pack's scenes, 3 a batch, 2 steps through the native batches, the
    losses finite, the backend logged."""
    _, port_pack, _ = packs
    spec = dict(torch_parity.FLAGSHIP_NARROW, ImageSize=[HW, HW], LatentSize=16,
                SamplesPerScene=128, ScenesPerBatch=3, DataLoaderThreads=2, TrainSplit="",
                LogFrequency=1, LogFrequencyStep=1, NumEpochs=1,
                NetworkSpecs=dict(torch_parity.FLAGSHIP_NARROW["NetworkSpecs"], dims=[32, 32],
                                  dropout=[0, 1], norm_layers=[0, 1], latent_in=[1]))
    path, out = str(tmp_path / "spec.json"), str(tmp_path / "out")
    with open(path, "w") as f:
        json.dump(spec, f)
    train_cli.main(["-e", path, "--packed", port_pack, "--device", "cpu", "--output_root", out,
                    "--no_init_guard", "--skip_test"])
    exp = os.path.join(out, load_specs(path).experiment_name())
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [ln for ln in map(json.loads, f) if "step" in ln]
    assert [(s["epoch"], s["step"]) for s in steps] == [(1, 1), (1, 2)]
    assert all(np.isfinite(v) for s in steps for v in s.values())
