"""The evaluation layer of the port against the JAX package on the same
seeded inputs: mesh sampling and readers, Procrustes / ICP registration,
the chamfer, the evaluate function in its four modes, the ICP-aligned export
of ``--eval_mode``, the geometric dataset's writer; then a tiny chain on
the CPU (2 geometric scenes, a narrow spec, 3 train steps, ``cli.reconstruct
--eval_mode`` at 16^3, ``cli.evaluate``).  Evaluation is numpy and scipy in
both packages, so most results are equal, not close."""

import json
import os
import pickle
import shutil

import cv2
import numpy as np
import pytest
import torch

from alignsdf_tpu.config import specs_from_dict as jax_specs_from_dict
from alignsdf_tpu.data.dataset import ImagesDataset
from alignsdf_tpu.data.synthetic import write_geometric_dataset
from alignsdf_tpu.eval import chamfer as jax_chamfer
from alignsdf_tpu.eval import evaluate as jax_evaluate
from alignsdf_tpu.eval import icp as jax_icp
from alignsdf_tpu.geom import meshlib as jax_meshlib
from alignsdf_tpu.inference.reconstruct import export_with_optional_icp as jax_export
from alignsdf_torch.cli import evaluate as evaluate_cli
from alignsdf_torch.cli import reconstruct as reconstruct_cli
from alignsdf_torch.cli import train as train_cli
from alignsdf_torch.config import specs_from_dict
from alignsdf_torch.data.lmdb_backend import LmdbStore
from alignsdf_torch.data.synthetic import write_geometric_lmdb
from alignsdf_torch.eval import chamfer, evaluate, icp
from alignsdf_torch.geom import meshlib
from alignsdf_torch.inference.grid import make_grid_evaluator
from alignsdf_torch.inference import reconstruct as recon_mod
from alignsdf_torch.inference.reconstruct import export_with_optional_icp
from alignsdf_torch.models.alignsdf import build_model

import torch_parity

SSF = 7.018621123357809


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_parity.torch_threads(1):
        yield


def _ball(rng, c, r, n=30):
    """A ring-strip mesh on a sphere of radius r (the JAX eval tests')."""
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([[i, (i + 1) % n, (i + 2) % n] for i in range(n - 2)], np.int64)
    return meshlib.TriMesh(v * r + np.asarray(c), f)


def _clouds(seed=0, n=800):
    """Two clouds related by scale, translation and noise."""
    rng = np.random.RandomState(seed)
    tgt = rng.randn(n, 3)
    tgt /= np.linalg.norm(tgt, axis=1, keepdims=True)
    tgt *= 0.08 + 0.01 * rng.rand(n, 1)
    src = tgt * 1.17 + np.array([0.02, -0.035, 0.05]) + rng.randn(n, 3) * 1e-3
    return src, tgt


@pytest.mark.parametrize("fmt", ["ply", "obj", "ascii_ply"])
def test_meshlib_readers_and_sampling_match_jax(tmp_path, fmt):
    mesh = _ball(np.random.RandomState(2), [0.01, -0.02, 0.3], 0.07, n=60)
    path = str(tmp_path / f"m.{'obj' if fmt == 'obj' else 'ply'}")
    if fmt == "ascii_ply":
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\nelement vertex %d\nproperty float x\n"
                    "property float y\nproperty float z\nelement face %d\n"
                    "property list uchar int vertex_indices\nend_header\n"
                    % (len(mesh.vertices), len(mesh.faces)))
            for v in mesh.vertices:
                f.write("%.9g %.9g %.9g\n" % tuple(v))
            for fc in mesh.faces:
                f.write("3 %d %d %d\n" % tuple(fc))
    else:
        mesh.export(path)
    ours, theirs = meshlib.load_mesh(path), jax_meshlib.load_mesh(path)
    np.testing.assert_array_equal(ours.vertices, theirs.vertices)
    np.testing.assert_array_equal(ours.faces, theirs.faces)
    if fmt == "ply":
        np.testing.assert_array_equal(meshlib.read_ply(path).vertices,
                                      jax_meshlib.read_ply(path).vertices)
    # the same draws from the same generator: choice, then random twice
    a = meshlib.sample_surface(ours, 5000, np.random.default_rng(7))
    b = jax_meshlib.sample_surface(theirs, 5000, np.random.default_rng(7))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (5000, 3)


@pytest.mark.parametrize("name", ["procrustes", "procrustes_no_reflection",
                                  "procrustes_without_rot", "icp", "icp_rot",
                                  "registration_icp"])
def test_registration_matches_jax(name):
    src, tgt = _clouds(3)
    calls = {
        "procrustes": lambda m: m.procrustes(src, tgt),
        "procrustes_no_reflection": lambda m: m.procrustes(src, tgt, reflection=False),
        "procrustes_without_rot": lambda m: m.procrustes_without_rot(src, tgt),
        "icp": lambda m: m.icp(src, tgt),
        "icp_rot": lambda m: m.icp(src, tgt, rot=True),
        "registration_icp": lambda m: m.registration_icp(src, tgt),
    }
    for ours, theirs in zip(calls[name](chamfer), calls[name](jax_chamfer)):
        np.testing.assert_allclose(ours, theirs, atol=1e-10, rtol=0)


def test_icp_trans_scale_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    src = _ball(rng, [0.02, -0.03, 0.35], 0.09, n=80)
    tgt = _ball(rng, [0.0, 0.0, 0.33], 0.08, n=80)
    solvers = []
    for mod, mesh_mod in ((icp, meshlib), (jax_icp, jax_meshlib)):
        solver = mod.ICPTransScale(mesh_mod.TriMesh(src.vertices, src.faces),
                                   mesh_mod.TriMesh(tgt.vertices, tgt.faces))
        solver.sample_mesh(4000, "both", np.random.default_rng(0))
        solver.run_icp_f(max_iter=100)
        solvers.append(solver)
    ours, theirs = solvers
    for a, b in zip(ours.get_trans_scale(), theirs.get_trans_scale()):
        np.testing.assert_allclose(a, b, atol=1e-10, rtol=0)
    assert float(np.asarray(ours.get_trans_scale()[1]).reshape(-1)[0]) != 1.0  # ICP moved it
    ours.export_source_mesh(str(tmp_path / "ours.ply"))
    theirs.export_source_mesh(str(tmp_path / "theirs.ply"))
    np.testing.assert_allclose(meshlib.read_ply(str(tmp_path / "ours.ply")).vertices,
                               jax_meshlib.read_ply(str(tmp_path / "theirs.ply")).vertices,
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("optim,rot", [(False, False), (True, False), (True, True)])
def test_compute_chamfer_matches_jax(tmp_path, optim, rot):
    rng = np.random.RandomState(5)
    gt, pred = str(tmp_path / "gt.obj"), str(tmp_path / "pred.ply")
    _ball(rng, [0.0, 0.0, 0.1], 0.08, n=60).export(gt)
    _ball(rng, [0.01, 0.0, 0.1], 0.085, n=60).export(pred)
    ours = chamfer.compute_chamfer(gt, pred, optim=optim, rot=rot, n_samples=6000)
    theirs = jax_chamfer.compute_chamfer(gt, pred, optim=optim, rot=rot, n_samples=6000)
    assert np.isfinite(ours) and ours > 0
    np.testing.assert_allclose(ours, theirs, rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Eval workspace and GT tree as the JAX package's tests/test_eval.py
    builds them for the four modes: 2 keys, hand / object / MANO meshes,
    meta, the MANO and object JSONs."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.RandomState(1)
    out, gt = str(root / "Eval_obman"), str(root / "gt")
    for d in ("meshes", "pred_mano", "object"):
        os.makedirs(os.path.join(out, d))
    for d in ("mesh_hand", "mesh_obj", "meta", "rgb"):
        os.makedirs(os.path.join(gt, d))
    for key in ("00000001", "00000002"):
        _ball(rng, [0, 0, 0.1], 0.08).export(os.path.join(out, "meshes", key + "_hand.ply"))
        _ball(rng, [0, 0, 0.1], 0.081).export(os.path.join(gt, "mesh_hand", key + ".obj"))
        _ball(rng, [0.1, 0, 0.1], 0.05).export(os.path.join(out, "meshes", key + "_obj.ply"))
        _ball(rng, [0.1, 0, 0.1], 0.052).export(os.path.join(gt, "mesh_obj", key + ".obj"))
        _ball(rng, [0, 0, 0.1], 0.079).export(os.path.join(out, "pred_mano", key + ".ply"))
        _ball(rng, [0, 0, 0.1], 0.08).export(os.path.join(out, "pred_mano", key + "_hand.ply"))
        meta = {
            "coords_3d": rng.randn(21, 3) * 0.05,
            "verts_3d": rng.randn(778, 3) * 0.05,
            "affine_transform": np.vstack([
                np.hstack([np.eye(3), rng.randn(3, 1) * 0.1]), [[0, 0, 0, 1]]]),
            "obj_corners_3d": rng.randn(9, 3) * 0.08,
        }
        with open(os.path.join(gt, "meta", key + ".pkl"), "wb") as f:
            pickle.dump(meta, f)
        with open(os.path.join(out, "pred_mano", key + ".json"), "w") as f:
            json.dump({"joints": (rng.randn(21, 3) * 0.05).tolist(),
                       "vertices": (rng.randn(778, 3) * 0.05).tolist()}, f)
        with open(os.path.join(out, "object", key + ".json"), "w") as f:
            json.dump({"obj_corners": (rng.randn(8, 3) * 0.08).tolist(),
                       "obj_trans": np.vstack([np.hstack([np.eye(3), rng.randn(3, 1) * 0.1]),
                                               [[0, 0, 0, 1]]]).tolist()}, f)
    return out, gt


MODES = {"hand": ({}, "chamfer_hand.txt", "best_hand"),
         "mano": ({"mano": True}, "chamfer_mano.txt", "best_mano"),
         "obj": ({"obj": True, "optim": True}, "chamfer_obj.txt", "best_obj"),
         "fit": ({"fit": True}, "fit.txt", None)}


@pytest.mark.parametrize("mode", list(MODES))
def test_evaluate_matches_jax(tmp_path, workspace, mode):
    out, gt = workspace
    flags, txt, best = MODES[mode]
    runs = {}
    for name, fn in (("torch", evaluate.evaluate), ("jax", jax_evaluate.evaluate)):
        ws = str(tmp_path / name)
        shutil.copytree(out, ws)
        runs[name] = (fn(ws, "obman", keys=None, data_root=gt, workers=1, **flags), ws)
    (ours, ws_ours), (theirs, ws_theirs) = runs["torch"], runs["jax"]
    assert ours == theirs
    assert ours["chamfer_count"] == 2 and ours["failure_count"] == 0
    if mode == "mano":
        assert ours["joint_err_count"] == 2 and ours["vert_err_count"] == 2
    if mode == "obj":
        assert ours["obj_center_err_count"] == 2 and ours["obj_corner_err_count"] == 2
    for name in (txt, f"eval_obman_{mode}.json"):
        with open(os.path.join(ws_ours, name), "rb") as a, \
                open(os.path.join(ws_theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    if best is not None:  # the best/worst-20 copies: 2 keys are both among the worst 20
        for sub in (best, best.replace("best", "worst")):
            assert sorted(os.listdir(os.path.join(ws_ours, sub))) == \
                sorted(os.listdir(os.path.join(ws_theirs, sub)))
        assert os.listdir(os.path.join(ws_ours, best.replace("best", "worst")))


def test_error_formulas_match_jax(workspace):
    out, gt = workspace
    extr = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    meta = os.path.join(gt, "meta", "00000001.pkl")
    mano_json = os.path.join(out, "pred_mano", "00000001.json")
    obj_json = os.path.join(out, "object", "00000001.json")
    for cam_extr in (extr, np.eye(3)):
        assert (evaluate._mano_errors(mano_json, meta, cam_extr)
                == jax_evaluate._mano_errors(mano_json, meta, cam_extr))
        assert (evaluate._obj_errors(obj_json, meta, cam_extr)
                == jax_evaluate._obj_errors(obj_json, meta, cam_extr))


@pytest.mark.parametrize("with_gt", [True, False])
def test_export_with_optional_icp_matches_jax(tmp_path, with_gt):
    rng = np.random.RandomState(8)
    mesh = _ball(rng, [0.01, 0.02, 0.1], 0.09, n=60)
    gt = str(tmp_path / "gt.obj")
    _ball(rng, [0.0, 0.0, 0.1], 0.08, n=60).export(gt)
    ours_path, theirs_path = str(tmp_path / "ours.ply"), str(tmp_path / "theirs.ply")
    timings = dict.fromkeys(("icp_ms", "export_ms"), 0.0)
    ours = export_with_optional_icp(mesh, ours_path, gt if with_gt else None, timings)
    theirs = jax_export(jax_meshlib.TriMesh(mesh.vertices, mesh.faces), theirs_path,
                        gt if with_gt else None)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a, b, atol=1e-10, rtol=0)
    with open(ours_path, "rb") as a, open(theirs_path, "rb") as b:
        assert a.read() == b.read()
    assert (timings["icp_ms"] > 0) == with_gt and timings["export_ms"] > 0


def test_geometric_writer_matches_jax(tmp_path):
    keys = ["00000000", "00000001"]
    ours = write_geometric_lmdb(str(tmp_path / "torch"), keys, n_points=600, image_hw=64)
    base = write_geometric_dataset(str(tmp_path / "jax"), keys, n_points=600, image_hw=64,
                                   split="test", sdf_scale_factor=SSF)
    store = LmdbStore(ours["train"])
    samples = np.load(ours["samples"])
    jspecs = jax_specs_from_dict({"ImageSize": [64, 64], "DataSource": str(tmp_path / "jax")})
    images = ImagesDataset(keys, jspecs, "obman")
    for i, key in enumerate(keys):
        for sub, hand in (("sdf_hand", True), ("sdf_obj", False)):
            rows, pos_num, neg_num = store.sdf_raw(key, hand)
            with np.load(os.path.join(base, sub, key + ".npz")) as z:
                lab = "lab_{}" if hand else "lab_{}_other"
                want = []
                for name in ("pos", "neg"):
                    xyzs, other = z[name], z[name + "_other"]
                    labels = z[lab.format(name)][:, [0]].astype(np.float32)
                    cols = ([xyzs, other] if hand else [xyzs[:, :3], other, xyzs[:, [3]]])
                    want.append(np.concatenate(cols + [labels], axis=1))
            assert (pos_num, neg_num) == (300, 300)
            np.testing.assert_array_equal(rows, np.concatenate(want))
        np.testing.assert_array_equal(store.normal_params(key)[0], [1.0])
        np.testing.assert_array_equal(store.normal_params(key)[1], np.zeros(3))
        with open(os.path.join(ours["test"], "meta", key + ".pkl"), "rb") as f:
            meta = pickle.load(f)
        with open(os.path.join(base, "meta", key + ".pkl"), "rb") as f:
            jmeta = pickle.load(f)
        assert sorted(meta) == sorted(jmeta)
        for k in meta:
            if k in ("coords_3d", "handJoints3D"):  # MANO joints: float32 rounding
                np.testing.assert_allclose(meta[k], jmeta[k], atol=1e-5, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(meta[k], jmeta[k], err_msg=k)
        block = store.meta(key)
        np.testing.assert_allclose(block[:21], jmeta["coords_3d"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(block[21:30], jmeta["obj_corners_3d"])
        np.testing.assert_array_equal(block[30:39], jmeta["obj_rest_corners_3d"])
        for sub in ("mesh_hand", "mesh_obj"):
            with open(os.path.join(ours["test"], sub, key + ".obj"), "rb") as a, \
                    open(os.path.join(base, sub, key + ".obj"), "rb") as b:
                assert a.read() == b.read(), sub
        # the raw image is the JAX writer's draw: JPEG-encoded as that writer
        # does, it gives its file byte for byte
        image = store.image(key)
        np.testing.assert_array_equal(image, samples["image"][i])
        enc = str(tmp_path / "enc.jpg")
        cv2.imwrite(enc, image[:, :, ::-1])
        with open(enc, "rb") as a, open(os.path.join(base, "rgb", key + ".jpg"), "rb") as b:
            assert a.read() == b.read()
        item = images[i]
        assert str(samples["key"][i]) == key
        np.testing.assert_array_equal(samples["cam_intr"][i], item["cam_intr"])
        np.testing.assert_allclose(samples["mano_root"][i], item["mano_root"][0], atol=1e-5)
        np.testing.assert_array_equal(samples["rest_obj_corners"][i], item["rest_obj_corners"])


class _FewSamplesICP(icp.ICPTransScale):
    """The chain's ICP on 3,000 samples a mesh instead of 30,000: on an
    untrained mesh it runs all 100 iterations, ~15 s a mesh at 30,000 on the
    CPU (the export at 30,000 is held against JAX's above)."""

    def sample_mesh(self, n=30000, mesh_id="both", rng=None):
        super().sample_mesh(3000, mesh_id, rng)


def test_geometric_chain_on_cpu(tmp_path, monkeypatch):
    """2 geometric scenes, a narrow flagship, 3 steps of cli.train from the
    LMDBs, cli.reconstruct --eval_mode at 16^3 (final biases shifted so the
    fields cross zero), then cli.evaluate in hand, object and MANO modes."""
    root = str(tmp_path / "data")
    paths = write_geometric_lmdb(root, ["00000000", "00000001"], n_points=2000, image_hw=64)
    spec = dict(torch_parity.FLAGSHIP_NARROW, ImageSize=[64, 64], LatentSize=16,
                SamplesPerScene=128, ScenesPerBatch=2, DataLoaderThreads=1, TrainSplit="",
                DataSource=root, Dataset="obman", LMDB=True, DisableAug=True, NumEpochs=3,
                LogFrequency=3, LogFrequencyStep=1, SnapshotFrequency=0, AdditionalSnapshots=[],
                NetworkSpecs=dict(torch_parity.FLAGSHIP_NARROW["NetworkSpecs"], dims=[32, 32],
                                  dropout=[0, 1], norm_layers=[0, 1], latent_in=[1]),
                LearningRateSchedule=[{"Type": "Step", "Initial": 1e-3, "Interval": 500,
                                       "Factor": 0.5}])
    spec_path = str(tmp_path / "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out = str(tmp_path / "outputs")
    train_cli.main(["-e", spec_path, "--data_root", paths["train"], "--device", "cpu",
                    "--output_root", out, "--no_init_guard"])
    (name,) = os.listdir(out)
    exp = os.path.join(out, name)
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [ln for ln in map(json.loads, f) if "step" in ln]
    assert len(steps) == 3 and all(np.isfinite(v) for s in steps for v in s.values())

    # shift the final biases so a fifth of scene 0's coarse field is inside
    weights = os.path.join(exp, "ModelParameters", "latest.pth")
    saved = torch.load(weights, map_location="cpu", weights_only=False)
    with open(os.path.join(exp, "specs.json")) as f:
        specs = specs_from_dict(json.load(f))
    assert specs.data_source == root
    model = build_model(specs)
    model.load_state_dict(saved["model_state_dict"])
    model.eval()
    samples = np.load(paths["samples"])
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
    torch.save({"epoch": saved["epoch"], "model_state_dict": model.state_dict()}, weights)

    monkeypatch.setattr(recon_mod, "ICPTransScale", _FewSamplesICP)
    per_image = reconstruct_cli.main(["-e", exp, "--samples", paths["samples"], "--cube_dim",
                                      "16", "--device", "cpu", "--eval_mode"])
    assert [t["key"] for t in per_image] == ["00000000", "00000001"]
    for t in per_image:
        assert t["icp_ms"] > 0 and all(np.isfinite(v) for k, v in t.items() if k != "key")
        split = sum(t[k] for k in ("marching_ms", "lcc_ms", "icp_ms", "export_ms"))
        assert split <= t["host_ms"], t
    for flags in ([], ["--obj"], ["--mano"]):
        summary = evaluate_cli.main(["-e", exp, "--data_root", paths["test"], "--workers", "2",
                                     *flags])
        assert summary["failure_count"] == 0 and summary["chamfer_count"] == 2, summary
        assert all(np.isfinite(v) for v in summary.values()), summary
    assert summary["joint_err_count"] == 2
