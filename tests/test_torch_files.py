"""The reference's file layouts in the port, against the JAX package and
OpenCV: the PIL image readers against cv2, the per-file layout's readers,
``ImagesDataset`` and ``SDFDataset`` over ``NpzBackend``, the per-file
writer, the cv2-free LMDB packer against ``tools/create_lmdb.py`` byte for
byte, ``cli.reconstruct -s`` against ``--samples`` and the train CLI's
post-training test, on the CPU at small sizes."""

import json
import os
import pickle
import shutil
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.data import img_utils as jax_img
from alignsdf_tpu.data import make_train_dataset as jax_make_train_dataset
from alignsdf_tpu.data import sdf_samples as jax_sdf
from alignsdf_tpu.data.dataset import ImagesDataset as JaxImagesDataset
from alignsdf_tpu.data.synthetic import write_synthetic_dataset as jax_write_synthetic_dataset
from alignsdf_torch.cli import reconstruct as reconstruct_cli
from alignsdf_torch.cli import train as train_cli
from alignsdf_torch.config import Specs, specs_from_dict, specs_to_dict
from alignsdf_torch.data import img_utils, make_train_dataset
from alignsdf_torch.data import sdf_samples
from alignsdf_torch.data.dataset import ImagesDataset
from alignsdf_torch.data.synthetic import (write_geometric_lmdb, write_jpeg,
                                           write_synthetic_dataset)
from alignsdf_torch.inference.grid import make_grid_evaluator
from alignsdf_torch.models.alignsdf import build_model

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import create_lmdb  # noqa: E402
import create_lmdb_torch  # noqa: E402

KEYS = [f"{i:08d}" for i in range(3)]
WARP_LEVELS, WARP_SHARE = 1, 1e-3  # the port's augmentation warp (tests/test_torch_data.py)
NARROW = dict(torch_parity.FLAGSHIP_NARROW, ImageSize=[64, 64], LatentSize=16,
              SamplesPerScene=128, ScenesPerBatch=2, DataLoaderThreads=1,
              NetworkSpecs=dict(torch_parity.FLAGSHIP_NARROW["NetworkSpecs"], dims=[32, 32],
                                dropout=[0, 1], norm_layers=[0, 1], latent_in=[1]))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_parity.torch_threads(1):
        yield


def _pattern(h: int, w: int, seed: int = 0) -> np.ndarray:
    """An RGB image with edges, gradients and noise, so every JPEG mode
    has real work in each block."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 5) % 256, (yy * 3 + xx) % 256, ((xx // 8 + yy // 8) % 2) * 200],
                   axis=2)
    return np.clip(img + rng.randint(-20, 21, img.shape), 0, 255).astype(np.uint8)


def _jpeg(path: str, kind: str) -> str:
    img = Image.fromarray(_pattern(72, 104))
    if kind == "420":
        img.save(path, quality=90)
    elif kind == "422":
        img.save(path, quality=90, subsampling=1)
    elif kind == "444":
        img.save(path, quality=90, subsampling=0)
    elif kind == "progressive":
        img.save(path, quality=90, progressive=True)
    elif kind == "gray":
        img.convert("L").save(path, quality=90)
    elif kind == "exif6":  # rotate 90 degrees on display; both readers ignore it
        exif = Image.Exif()
        exif[0x0112] = 6
        img.save(path, quality=90, exif=exif)
    elif kind == "cmyk":
        img.convert("CMYK").save(path, quality=90)
    return path


@pytest.mark.parametrize("kind", ["420", "422", "444", "progressive", "gray", "exif6", "cmyk"])
def test_load_img_matches_cv2(tmp_path, kind):
    """PIL's decode against JAX's load_img (cv2's IMREAD_COLOR |
    IMREAD_IGNORE_ORIENTATION): bit for bit, but a CMYK file within one
    level; BGR order the same."""
    path = _jpeg(str(tmp_path / f"{kind}.jpg"), kind)
    ours, theirs = img_utils.load_img(path), jax_img.load_img(path)
    assert ours.dtype == theirs.dtype == np.uint8 and ours.shape == theirs.shape == (72, 104, 3)
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    assert diff.max() <= (1 if kind == "cmyk" else 0), diff.max()
    np.testing.assert_array_equal(img_utils.load_img(path, order="BGR"), ours[:, :, ::-1])


def test_load_img_missing_or_broken_file_raises(tmp_path):
    broken = tmp_path / "broken.jpg"
    broken.write_bytes(b"\xff\xd8 not a JPEG")
    for path in (str(tmp_path / "missing.jpg"), str(broken)):
        for load in (img_utils.load_img, jax_img.load_img):
            with pytest.raises(IOError, match="Fail to read"):
                load(path)


@pytest.mark.parametrize("kind", ["rgb_jpeg", "gray_jpeg", "cmyk_jpeg", "rgba_png", "la_png",
                                  "palette_png", "palette_trns_png", "palette_alpha_png"])
def test_read_image_unchanged_matches_cv2(tmp_path, kind):
    """What the packer stores: cv2's IMREAD_UNCHANGED (BGR, 2-D gray, BGRA
    for gray with alpha and for a palette with transparency), bit for bit,
    but a CMYK JPEG's conversion within one level."""
    img = _pattern(40, 56, seed=1)
    alpha = np.random.RandomState(2).randint(0, 256, (40, 56, 1)).astype(np.uint8)
    path = str(tmp_path / ("a.jpg" if kind.endswith("jpeg") else "a.png"))
    if kind == "rgb_jpeg":
        _jpeg(path, "420")
    elif kind == "gray_jpeg":
        _jpeg(path, "gray")
    elif kind == "cmyk_jpeg":
        _jpeg(path, "cmyk")
    elif kind == "rgba_png":
        Image.fromarray(np.concatenate([img, alpha], axis=2)).save(path)
    elif kind == "la_png":
        gray = np.asarray(Image.fromarray(img).convert("L"))[:, :, None]
        Image.fromarray(np.concatenate([gray, alpha], axis=2), "LA").save(path)
    elif kind == "palette_png":
        Image.fromarray(img).quantize(32).save(path)
    elif kind == "palette_trns_png":  # one palette entry transparent
        Image.fromarray(img).quantize(32).save(path, transparency=3)
    else:  # an alpha value for every palette entry
        Image.fromarray(np.concatenate([img, alpha], axis=2)).quantize(32).save(path)
    with Image.open(path) as im:
        assert im.mode == {"rgb_jpeg": "RGB", "gray_jpeg": "L", "cmyk_jpeg": "CMYK",
                           "rgba_png": "RGBA", "la_png": "LA"}.get(kind, "P"), im.mode
    ours, theirs = img_utils.read_image_unchanged(path), cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    assert diff.max() <= (1 if kind == "cmyk_jpeg" else 0), diff.max()


@pytest.fixture(scope="module")
def jax_tree(tmp_path_factory):
    """The JAX writer's per-file train and test sets, 3 keys, 64x64."""
    root = str(tmp_path_factory.mktemp("files"))
    train = jax_write_synthetic_dataset(root, KEYS, n_points=600, image_hw=64)
    test = jax_write_synthetic_dataset(root, KEYS, n_points=600, image_hw=64, seed=1,
                                       split="test")
    return root, train, test


@pytest.mark.parametrize("task", ["obman", "dexycb", "ho3d"])
def test_file_readers_match_jax(jax_tree, task):
    """unpack_normal_params, unpack_meta_params and unpack_test_params on
    the same files: every array exact."""
    _, train, test = jax_tree
    for key in KEYS:
        for a, b in zip(sdf_samples.unpack_normal_params(train, key),
                        jax_sdf.unpack_normal_params(train, key)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        a, b = (sdf_samples.unpack_meta_params(train, key, task),
                jax_sdf.unpack_meta_params(train, key, task))
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        path = os.path.join(test, "meta", key + ".pkl")
        for a, b in zip(sdf_samples.unpack_test_params(path, task),
                        jax_sdf.unpack_test_params(path, task)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("task,shape", [("obman", (64, 64)), ("ho3d", (80, 104)),
                                        ("dexycb", (71, 90))])
def test_images_dataset_matches_jax(jax_tree, tmp_path, task, shape):
    """The test item of both packages' ImagesDataset, a square source and
    non-square ones (the centre crop, the principal point rescaled): the
    image within 1e-6 after normalization (the port's raw patch normalized
    as the model does), everything else exact."""
    root, _, test = jax_tree
    data_root = str(tmp_path / "test")
    shutil.copytree(os.path.join(test, "meta"), os.path.join(data_root, "meta"))
    os.makedirs(os.path.join(data_root, "rgb"))
    for i, key in enumerate(KEYS):
        write_jpeg(os.path.join(data_root, "rgb", key + ".jpg"), _pattern(*shape, seed=i))
    files = [f"rgb/{key}.jpg" for key in KEYS]
    jspecs = JaxSpecs(image_size=(64, 64), data_source=root)
    ref = JaxImagesDataset(files, jspecs, task, data_root=data_root)
    specs = Specs(image_size=(64, 64), data_source=root)
    port = ImagesDataset(files, specs, task, data_root=data_root)
    assert len(port) == len(ref) == 3
    for i in range(3):
        a, b = port[i], ref[i]
        assert set(a) == set(b)
        assert a["key"] == b["key"] == KEYS[i] and a["img_id"] == b["img_id"] == files[i]
        for k in ("cam_intr", "mano_root", "rest_obj_corners"):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["image"].dtype == np.uint8 and a["image"].shape == (64, 64, 3)
        np.testing.assert_allclose(img_utils.normalize_image(a["image"]), b["image"], rtol=0,
                                   atol=1e-6)
    # the default root is <DataSource>/<task>/test
    assert ImagesDataset(files, specs, "obman").image_source == os.path.join(
        root, "obman", "test", "rgb")


@pytest.mark.parametrize("no_aug", [False, True], ids=["aug", "no_aug"])
def test_sdf_dataset_over_npz_matches_jax(jax_tree, no_aug):
    """SDFDataset over NpzBackend (LMDB: false) against JAX's
    make_train_dataset(lmdb=False), seeds 3 and 11: every array within 1e-6;
    the image exact without augmentation, within the warp's tolerance with
    it (the port's warp against cv2's, tests/test_torch_data.py)."""
    _, train, _ = jax_tree
    over = dict(dataset="obman", sdf_scale_factor=7.0186, samples_per_scene=64,
                image_size=(64, 64), clamping_distance=0.05, lmdb=False, disable_aug=no_aug)
    port = make_train_dataset(Specs(**over), train, KEYS, raw_image=True)
    ref = jax_make_train_dataset(JaxSpecs(**over), KEYS, data_root=train, raw_image=True)
    assert type(port.backend).__name__ == type(ref.backend).__name__ == "NpzBackend"
    for idx, seed in ((0, 3), (2, 11)):
        a, b = port.__getitem__(idx, seed=seed), ref.__getitem__(idx, seed=seed)
        assert set(a) == set(b) and a["key"] == b["key"]
        for field in sorted(set(a) - {"key", "image"}):
            np.testing.assert_allclose(a[field], b[field], rtol=0, atol=1e-6, err_msg=field)
        diff = np.abs(a["image"].astype(int) - b["image"].astype(int))
        if no_aug:
            assert diff.max() == 0
        else:
            assert diff.max() <= WARP_LEVELS and (diff > 0).mean() <= WARP_SHARE
    with pytest.raises(ValueError, match="split_keys required"):
        make_train_dataset(Specs(**over), train)


def test_image_source_selects_the_image_directory(jax_tree, tmp_path):
    """ImageSource goes both ways through the spec dict, as in JAX, and
    NpzBackend reads <data_root>/<ImageSource>/<key>.jpg."""
    from alignsdf_torch.data.backends import make_backend

    _, train, _ = jax_tree
    specs = specs_from_dict({"ImageSource": "rgb_alt", "LMDB": False})
    assert specs.image_source == "rgb_alt" and specs_to_dict(specs)["ImageSource"] == "rgb_alt"
    assert specs_from_dict({}).image_source == "rgb"
    root = str(tmp_path / "train")
    shutil.copytree(train, root)
    os.rename(os.path.join(root, "rgb"), os.path.join(root, "rgb_alt"))
    backend = make_backend(specs, root)
    np.testing.assert_array_equal(backend.image(KEYS[1]),
                                  jax_img.load_img(os.path.join(train, "rgb", KEYS[1] + ".jpg")))
    with pytest.raises(IOError, match="Fail to read"):
        make_backend(specs_from_dict({"LMDB": False}), root).image(KEYS[1])


def test_write_synthetic_dataset_matches_jax(jax_tree, tmp_path):
    """The same files as the JAX writer's: npz and pkl contents equal, the
    JPEGs byte for byte (PIL at quality 95 against cv2.imwrite's default)
    and so their pixels."""
    root, train, _ = jax_tree
    ours = write_synthetic_dataset(str(tmp_path), KEYS, n_points=600, image_hw=64)
    assert ours == os.path.join(str(tmp_path), "obman", "train")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(train))
    for key in KEYS:
        for sub in ("norm", "sdf_hand", "sdf_obj"):
            with np.load(os.path.join(ours, sub, key + ".npz")) as a, \
                    np.load(os.path.join(train, sub, key + ".npz")) as b:
                assert list(a) == list(b)
                for k in a:
                    assert a[k].dtype == b[k].dtype, k
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        with open(os.path.join(ours, "meta", key + ".pkl"), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(train, "meta", key + ".pkl"), "rb") as f:
            b = pickle.load(f)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        ours_jpg, theirs_jpg = (os.path.join(d, "rgb", key + ".jpg") for d in (ours, train))
        np.testing.assert_array_equal(cv2.imread(ours_jpg), cv2.imread(theirs_jpg))
        with open(ours_jpg, "rb") as a, open(theirs_jpg, "rb") as b:
            assert a.read() == b.read()


def test_packer_matches_create_lmdb(tmp_path):
    """tools/create_lmdb_torch.py (its CLI) against tools/create_lmdb.py on
    copies of one per-file tree with a segm/ dir of PNGs: every data.mdb and
    meta_info.json byte for byte."""
    base = jax_write_synthetic_dataset(str(tmp_path / "src"), KEYS, n_points=600, image_hw=64)
    os.makedirs(os.path.join(base, "segm"))
    for i, key in enumerate(KEYS):
        Image.fromarray(_pattern(64, 64, seed=10 + i)).save(os.path.join(base, "segm",
                                                                        key + ".png"))
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    shutil.copytree(base, ours)
    shutil.copytree(base, theirs)
    create_lmdb_torch.main([ours, "--dataset", "obman", "--mode", "train"])
    create_lmdb.create_lmdbs(theirs, "obman", "train")
    names = ("rgb", "segm", "norm", "meta", "sdf_hand", "sdf_obj")
    for name in names:
        for f in ("data.mdb", "meta_info.json"):
            with open(os.path.join(ours, f"{name}.lmdb", f), "rb") as a, \
                    open(os.path.join(theirs, f"{name}.lmdb", f), "rb") as b:
                assert a.read() == b.read(), (name, f)
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))


def _experiment(tmp_path, root: str, name: str) -> str:
    """A narrow flagship's experiment directory on the geometric data, its
    final biases shifted so a fifth of scene 0's coarse field is inside
    (seeded weights)."""
    specs = specs_from_dict(dict(NARROW, DataSource=root, Dataset="obman"))
    model = build_model(specs, seed=0).eval()
    samples = np.load(os.path.join(root, "obman_geometric_samples.npz"))
    with torch.no_grad():
        lat, mano, obj = model.encode_scene(*(torch.from_numpy(samples[k][:1]) for k in
                                              ("image", "cam_intr", "mano_root",
                                               "rest_obj_corners")))
        ctx = {"decoder": model.decoder, "latent": lat, "rot_center": mano["rot_center"],
               "global_trans": mano["global_trans"], "obj_trans": obj["obj_trans"]}
        first = make_grid_evaluator(lambda c, r: c["decoder"](r), specs, 16, two_pass=False)(ctx)
        for branch, field in (("hand", first.sdf_hand), ("obj", first.sdf_obj)):
            lin = getattr(model.decoder, f"lin{branch[0]}{len(specs.network_specs.dims)}")
            lin.bias -= float(np.arctanh(np.quantile(field.numpy(), 0.2)))
    exp = str(tmp_path / name)
    os.makedirs(os.path.join(exp, "ModelParameters"))
    with open(os.path.join(exp, "specs.json"), "w") as f:
        json.dump(specs_to_dict(specs), f)
    torch.save({"epoch": 1, "model_state_dict": model.state_dict()},
               os.path.join(exp, "ModelParameters", "latest.pth"))
    return exp


def _tree(path: str) -> dict:
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), path)] = fh.read()
    return out


def test_reconstruct_split_matches_samples(tmp_path):
    """cli.reconstruct -s <split> --data_root <test> at 16^3 against
    --samples fed the split's own patches (the decoded JPEGs): the same
    timings' keys and, file for file, the same meshes and parameters; with
    --start_point / --end_point the slice."""
    root = str(tmp_path / "data")
    keys = ["00000000", "00000001"]
    paths = write_geometric_lmdb(root, keys, n_points=600, image_hw=64)
    by_split, by_samples = (_experiment(tmp_path, root, n) for n in ("split", "samples"))
    specs = specs_from_dict(dict(NARROW, DataSource=root))
    with open(paths["split"]) as f:
        split = json.load(f)
    assert split == {"filenames": ["00000000.jpg", "00000001.jpg"]}
    items = ImagesDataset(split["filenames"], specs, "obman", data_root=paths["test"])
    npz = str(tmp_path / "patches.npz")
    np.savez(npz, key=np.array(keys), **{k: np.stack([items[i][k] for i in range(2)])
                                         for k in ("image", "cam_intr", "rest_obj_corners")},
             mano_root=np.stack([items[i]["mano_root"][0] for i in range(2)]))
    common = ["--cube_dim", "16", "--device", "cpu"]
    a = reconstruct_cli.main(["-e", by_split, "-s", paths["split"], "--data_root",
                              paths["test"], *common])
    b = reconstruct_cli.main(["-e", by_samples, "--samples", npz, *common])
    assert [t["key"] for t in a] == [t["key"] for t in b] == keys
    ta, tb = _tree(os.path.join(by_split, "Eval_obman")), _tree(os.path.join(by_samples,
                                                                               "Eval_obman"))
    assert any(k.startswith("meshes") for k in ta), sorted(ta)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k] == tb[k], k
    one = reconstruct_cli.main(["-e", by_split, "-s", paths["split"], "--data_root",
                                paths["test"], "--start_point", "1", *common])
    assert [t["key"] for t in one] == keys[1:]
    with pytest.raises(SystemExit):
        reconstruct_cli.main(["-e", by_split, "-s", paths["split"], "--samples", npz, *common])


@pytest.fixture(scope="module")
def per_file(tmp_path_factory):
    """A per-file train set of 4 scenes and a test split of 2, 64x64, and a
    narrow flagship spec with LMDB false and a TrainSplit json."""
    root = str(tmp_path_factory.mktemp("perfile"))
    keys = [f"{i:08d}" for i in range(4)]
    train = write_synthetic_dataset(root, keys, n_points=400, image_hw=64)
    test = write_synthetic_dataset(root, keys[:2], n_points=400, image_hw=64, seed=5,
                                   split="test")
    split = os.path.join(root, "train_split.json")
    with open(split, "w") as f:
        json.dump({"train": keys}, f)
    test_split = os.path.join(root, "test_split.json")
    with open(test_split, "w") as f:
        json.dump({"filenames": [f"{k}.jpg" for k in keys[:2]]}, f)
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump(dict(NARROW, DataSource=root, TrainSplit=split, LMDB=False, NumEpochs=1,
                       LogFrequency=1, LogFrequencyStep=1, SnapshotFrequency=0,
                       AdditionalSnapshots=[]), f)
    return train, test, test_split, spec


@pytest.mark.parametrize("skip", [False, True], ids=["test", "skip_test"])
def test_train_per_file_then_post_training_test(per_file, tmp_path, skip, capfd):
    """cli.train --data_root over the per-file layout (LMDB: false): one
    epoch of 2 steps through NpzBackend, then the post-training test of the
    2-image split at 16^3 into <experiment>/Eval_obman (each image's MANO
    parameters); --skip_test skips it."""
    train, test, test_split, spec = per_file
    out = str(tmp_path / "out")
    train_cli.main(["-e", spec, "--data_root", train, "--device", "cpu", "--output_root", out,
                    "--no_init_guard", "--test_split", test_split, "--test_data_root", test,
                    "--test_cube_dim", "16", *(["--skip_test"] if skip else [])])
    (name,) = os.listdir(out)
    exp = os.path.join(out, name)
    log = capfd.readouterr().err
    assert "via NpzBackend" in log
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [ln for ln in map(json.loads, f) if "step" in ln]
    assert len(steps) == 2 and all(np.isfinite(v) for s in steps for v in s.values())
    pred = os.path.join(exp, "Eval_obman", "pred_mano")
    if skip:
        assert not os.path.exists(pred)
    else:
        assert sorted(os.listdir(pred)) == ["00000000.json", "00000000.ply",
                                            "00000001.json", "00000001.ply"]
        assert "post-training test: 2 images" in log


def test_post_training_test_without_split_warns(per_file, tmp_path, caplog):
    """A split file that does not exist: a warning, no reconstruction."""
    _, test, _, spec = per_file
    specs = specs_from_dict(dict(NARROW, DataSource=os.path.dirname(spec)))
    model = build_model(specs, seed=0)
    done = train_cli.run_post_training_test(model, specs, str(tmp_path), torch.device("cpu"),
                                            split_filename=str(tmp_path / "none.json"),
                                            data_root=test, cube_dim=16)
    assert done == 0 and "post-training test skipped" in caplog.text
    assert not os.path.exists(os.path.join(str(tmp_path), "Eval_obman"))


@pytest.mark.parametrize("flag", [["--skip_test"], ["--test_split", "s.json"],
                                  ["--test_data_root", "d"], ["--test_cube_dim", "32"]],
                         ids=lambda f: f[0])
def test_test_flags_need_data_root(per_file, flag, capsys):
    """Without --data_root there is no epoch loop, so no post-training test:
    its flags are refused by name."""
    spec = per_file[3]
    with pytest.raises(SystemExit):
        train_cli.main(["-e", spec, "--smoke", "--device", "cpu", *flag])
    assert flag[0] in capsys.readouterr().err
