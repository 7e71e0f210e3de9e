"""The pixel-aligned reconstruction slice: the port's
``Reconstructor(device="cpu")`` (K3's route, through its plain version)
against the JAX Reconstructor, which on the CPU runs the generic pixel path
of ``make_grid_evaluator`` (pixel_alignment + decoder), on the same sample
and converted weights of the --pa_feat flagship at a narrow decoder width,
in both projection modes.  Both passes' fields, origin and voxel agree
within 1e-4 (float32 ResNet + HeadNet + MANO rounding, carried through the
grid).  The port's K3 route also agrees with its own generic route, and
the CLI reconstructs a pixel-aligned experiment."""

import json
import os

import numpy as np
import pytest
import torch

from alignsdf_tpu.inference.grid import make_grid_evaluator as jax_grid_evaluator
from alignsdf_tpu.inference.reconstruct import Reconstructor as JaxReconstructor
from alignsdf_torch.cli.reconstruct import main as cli_main
from alignsdf_torch.config import specs_from_dict
from alignsdf_torch.inference.grid import make_grid_evaluator
from alignsdf_torch.inference.reconstruct import Reconstructor, make_output_dirs, run_pipelined
from alignsdf_torch.models.alignsdf import build_model
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

import torch_parity

ATOL = 1e-4
N = 16
FACES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "alignsdf_torch", "assets", "closed_fmano.npy")


def _port_ctx(model, sample):
    """The context the port's Reconstructor builds for one sample."""
    args = [torch.as_tensor(np.asarray(sample[k]))[None]
            for k in ("image", "cam_intr", "mano_root", "rest_obj_corners")]
    fmap, mano, obj = model.encode_scene(*args)
    return {"decoder": model.decoder, "latent": fmap, "cam_intr": args[1],
            "pred_root": mano["joints"][:, 0:1], "rot_center": mano["rot_center"],
            "global_trans": mano["global_trans"], "obj_trans": obj["obj_trans"]}


def _shift_final_biases(model, specs, sample, variables=None, n=N):
    """Shift the final biases so a fifth of the first pass is inside: the
    seeded field then crosses zero and meshes come out."""
    first = make_grid_evaluator(lambda c, r: c["decoder"](r), specs, n,
                                two_pass=False)(_port_ctx(model, sample))
    for branch, field in (("hand", first.sdf_hand), ("obj", first.sdf_obj)):
        name = f"lin{branch[0]}4"
        shift = float(np.arctanh(np.quantile(field.numpy(), 0.2)))
        if variables is not None:
            jlast = variables["params"]["decoder"][branch][name]
            jlast["bias"] = jlast["bias"] - np.float32(shift)
        with torch.no_grad():
            getattr(model.decoder, name).bias -= shift


@pytest.fixture(scope="module")
def pair():
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair(
        torch_parity.PIXEL_NARROW, seed=1)
    sample = torch_parity.make_sample(3)
    _shift_final_biases(pmodel, pspecs, sample, variables)
    return jmodel, variables, pmodel, jspecs, pspecs, sample


@pytest.fixture(scope="module", params=[False, True], ids=["raw_xyz", "ref_projection"])
def recons(request, pair, tmp_path_factory):
    ref = request.param
    jmodel, variables, pmodel, jspecs, pspecs, sample = pair
    faces = np.load(FACES)
    jrec = JaxReconstructor(jmodel, variables, jspecs, cube_dim=N, mano_faces=faces,
                            pixel_ref_projection=ref)
    jpending = jrec.submit(sample)

    pdirs = make_output_dirs(str(tmp_path_factory.mktemp("torch")))
    prec = Reconstructor(pmodel, pspecs, cube_dim=N, device="cpu", mano_faces=faces,
                         pixel_ref_projection=ref)
    done = []
    assert run_pipelined(prec, [sample], pdirs, on_done=lambda i, p: done.append(p)) == 1
    return ref, jpending, done[0], pdirs, sample["key"]


def test_both_passes_match_jax(recons, pair):
    ref, jpending, ppending, _, _ = recons
    jmodel, variables, pmodel, jspecs, pspecs, sample = pair
    # pass 1: the JAX generic pixel path and the port's K3 route, one pass
    jfirst = jax_grid_evaluator(
        lambda c, rows: jmodel.apply({"params": c["params"]}, rows, method=jmodel.decode_points),
        jspecs, N, chunk=N ** 3, two_pass=False, pixel_ref_projection=ref)(jpending["ctx"])
    pfirst = make_grid_evaluator(None, pspecs, N, two_pass=False,
                                 grid_decode_fn=make_pixel_grid_decode_fn(pspecs, N, ref))(
        _port_ctx(pmodel, sample))
    for name in ("sdf_hand", "sdf_obj"):
        np.testing.assert_allclose(getattr(pfirst, name).numpy(),
                                   np.asarray(getattr(jfirst, name)), atol=ATOL, rtol=0,
                                   err_msg=f"pass 1 {name}")
    # pass 2, as the Reconstructors return it
    jgrid, host = jpending["grid"], ppending["host"]
    for jname, pname in (("sdf_hand", "sdf_hand"), ("sdf_obj", "sdf_obj"),
                         ("origin", "origin"), ("voxel_size", "voxel")):
        np.testing.assert_allclose(host[pname].numpy(), np.asarray(getattr(jgrid, jname)),
                                   atol=ATOL, rtol=0, err_msg=f"pass 2 {jname}")
    assert 0.0 < float((host["sdf_hand"] < 0).float().mean()) < 1.0
    assert abs(float(host["voxel"]) - 2.0 / (N - 1)) > 1e-3  # pass 2 has its own cube


def test_k3_route_matches_the_generic_route(recons, pair):
    ref, _, ppending, _, _ = recons
    _, _, pmodel, _, pspecs, sample = pair
    generic = make_grid_evaluator(lambda c, rows: c["decoder"](rows), pspecs, N,
                                  pixel_ref_projection=ref)(_port_ctx(pmodel, sample))
    host = ppending["host"]
    for name, pname in (("sdf_hand", "sdf_hand"), ("sdf_obj", "sdf_obj"),
                        ("origin", "origin"), ("voxel_size", "voxel")):
        np.testing.assert_allclose(host[pname].numpy(), getattr(generic, name).numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)


def test_meshes_are_written(recons):
    _, _, ppending, pdirs, key = recons
    for branch in ("hand", "obj"):
        assert ppending["meshes"][branch] is not None
        assert os.path.isfile(os.path.join(pdirs["meshes"], f"{key}_{branch}.ply"))


def test_projection_modes_differ(pair):
    """The two modes project points a centimetre-scale shift apart, so their
    fields must differ (else the mode switch would be untested)."""
    _, _, pmodel, _, pspecs, sample = pair
    ctx = _port_ctx(pmodel, sample)
    fields = [make_grid_evaluator(None, pspecs, N, two_pass=False,
                                  grid_decode_fn=make_pixel_grid_decode_fn(pspecs, N, ref))(ctx)
              for ref in (False, True)]
    assert float((fields[0].sdf_hand - fields[1].sdf_hand).abs().max()) > 1e-4


@pytest.mark.parametrize("ref", [False, True])
def test_cli_reconstructs_a_pixel_align_experiment(tmp_path, ref):
    """The CLI reads a PixelAlign specs.json, a reference-schema checkpoint
    and an npz of samples, and writes hand and object meshes."""
    exp = tmp_path / "exp"
    (exp / "ModelParameters").mkdir(parents=True)
    with open(exp / "specs.json", "w") as f:
        json.dump(torch_parity.PIXEL_NARROW, f)
    specs = specs_from_dict(torch_parity.PIXEL_NARROW)
    model = build_model(specs, seed=0)
    samples = [torch_parity.make_sample(i, key=f"s{i}") for i in range(2)]
    _shift_final_biases(model, specs, samples[1], n=12)
    torch.save({"epoch": 1, "model_state_dict": model.state_dict()},
               exp / "ModelParameters" / "latest.pth")
    np.savez(tmp_path / "samples.npz",
             **{k: np.stack([s[k] for s in samples]) for k in samples[0]})
    cli_main(["-e", str(exp), "--samples", str(tmp_path / "samples.npz"), "--cube_dim", "12",
              "--device", "cpu", "--start_point", "1"]
             + (["--ref_pixel_projection"] if ref else []))
    out = exp / "Eval_obman"
    assert sorted(os.listdir(out / "meshes")) == ["s1_hand.ply", "s1_obj.ply"]
    assert sorted(os.listdir(out / "pred_mano")) == ["s1.json", "s1.ply"]
