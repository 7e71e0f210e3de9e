"""The port's model on a pixel-aligned spec (the flagship with --pa_feat at a
narrow decoder width) against the JAX AlignSDF with the same converted
weights: the HeadNet map that encode_scene returns, the MANO and object
outputs, the per-point latents of decoder_inputs, the converter on an
encoder without ``fc``; and pixel-aligned training through the CLI."""

import math
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.models.torch_import import convert_alignsdf
from alignsdf_torch.cli.reconstruct import load_reference_weights
from alignsdf_torch.cli.train import main as train_main
from alignsdf_torch.config import specs_from_dict
from alignsdf_torch.models.alignsdf import build_model
from alignsdf_torch.ops.pixel_train_plan import make_pixel_train_decoder

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4  # float32 ResNet18 + HeadNet + MANO in two frameworks


@pytest.fixture(scope="module")
def pair():
    return torch_parity.build_pair(torch_parity.PIXEL_NARROW)


def _args(seed):
    s = torch_parity.make_sample(seed)
    return [s["image"][None], s["cam_intr"][None], s["mano_root"][None],
            s["rest_obj_corners"][None]]


def test_encode_scene_returns_the_headnet_map(pair):
    jmodel, variables, pmodel, _, _ = pair
    args = _args(7)
    j_lat, j_mano, j_obj = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method=jmodel.encode_scene))(variables, *map(jnp.asarray, args))
    p_lat, p_mano, p_obj = pmodel.encode_scene(*map(torch.from_numpy, args))
    assert p_lat.shape == (1, 256, 64, 64) and p_lat.dtype == torch.float32
    # the JAX map is NHWC
    np.testing.assert_allclose(p_lat.numpy(), np.asarray(j_lat).transpose(0, 3, 1, 2),
                               atol=ATOL, rtol=0)
    assert float(p_lat.abs().max()) > 1e-3
    for k in ("joints", "verts", "global_trans", "rot_center", "center3d"):
        np.testing.assert_allclose(p_mano[k].numpy(), np.asarray(j_mano[k]), atol=ATOL, rtol=0)
    for k in ("obj_trans", "obj_corners", "obj_center"):
        np.testing.assert_allclose(p_obj[k].numpy(), np.asarray(j_obj[k]), atol=ATOL, rtol=0)


def test_decoder_inputs_sample_the_map_per_point(pair):
    """[pixel-aligned latent, kinematic embedding] rows, in eval mode, at
    points of which only part project into the image."""
    jmodel, variables, pmodel, _, _ = pair
    args = _args(8)
    cond = {"cam_intr": args[1], "mano_root": args[2], "rest_obj_corners": args[3]}
    xyz = np.random.RandomState(4).uniform(-1, 1, (300, 3)).astype(np.float32)
    j_rows, _, _ = jax.jit(lambda v, img, x, c: jmodel.apply(
        v, img, x, c, method=jmodel.decoder_inputs, train=False))(
        variables, jnp.asarray(args[0]), jnp.asarray(xyz),
        {k: jnp.asarray(v) for k, v in cond.items()})
    with torch.no_grad():
        p_rows, _, _ = pmodel.decoder_inputs(torch.from_numpy(args[0]), torch.from_numpy(xyz),
                                             {k: torch.from_numpy(v) for k, v in cond.items()})
    assert p_rows.shape == (300, 256 + 9)
    np.testing.assert_allclose(p_rows.numpy(), np.asarray(j_rows), atol=ATOL, rtol=0)
    # some points take the map's mean feature, the others a sample
    fmap, _, _ = pmodel.encode_scene(*map(torch.from_numpy, args))
    mean_rows = torch.isclose(p_rows[:, :256], fmap.mean(dim=(2, 3)), atol=1e-6).all(dim=1)
    assert 0 < int(mean_rows.sum()) < 300


def test_converter_takes_an_encoder_without_fc(pair):
    """from_jax of a pixel-aligned model holds no encoder.fc (the encoder
    has none) and round-trips through the JAX package's reference
    importer."""
    _, variables, pmodel, jspecs, _ = pair
    sd = pmodel.state_dict()
    assert pmodel.encoder.fc is None
    assert not any(k.startswith("encoder.fc") for k in sd)
    params, stats = convert_alignsdf(sd, jspecs, (2, 2, 2, 2))
    flat_j = jax.tree_util.tree_leaves_with_path(
        {"params": variables["params"], "batch_stats": variables["batch_stats"]})
    flat_p = dict(jax.tree_util.tree_leaves_with_path({"params": params, "batch_stats": stats}))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_p[path]), np.asarray(leaf))


def test_loader_ignores_an_fc_the_pixel_encoder_lacks(tmp_path):
    """A checkpoint that carries an fc anyway still loads."""
    specs = specs_from_dict(torch_parity.PIXEL_NARROW)
    src = build_model(specs, seed=0)
    sd = dict(src.state_dict())
    sd["encoder.fc.weight"] = torch.zeros(256, 512)
    sd["encoder.fc.bias"] = torch.zeros(256)
    torch.save({"epoch": 1, "model_state_dict": sd}, tmp_path / "latest.pth")
    dst = build_model(specs, seed=1)
    load_reference_weights(dst, str(tmp_path / "latest.pth"))
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_training_refuses_pixel_align_naming_k4(capsys):
    """Pixel-aligned training runs through kernel K4 (its plain version on
    the CPU): the CLI's smoke run of the full-width --pa_feat flagship takes
    two steps with finite losses.  The factored front half still refuses a
    per-point latent."""
    train_main(["-e", os.path.join(REPO, "experiments", "obman_30k.json"), "--mano",
                "--obj_pose", "--encode", "both", "--point_size", "9", "--pa_feat",
                "--smoke", "--device", "cpu"])
    log = capsys.readouterr().err  # the CLI logs to stderr
    losses = [float(line.split("loss=")[1]) for line in log.splitlines() if "smoke step" in line]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses), log
    assert "smoke OK" in log
    specs = specs_from_dict(torch_parity.PIXEL_NARROW)
    assert make_pixel_train_decoder(specs).pixel
    model = build_model(specs, seed=0)
    args = [torch.from_numpy(a) for a in _args(1)]
    cond = {"cam_intr": args[1], "mano_root": args[2], "rest_obj_corners": args[3]}
    with pytest.raises(ValueError, match="per point"):
        model.decoder_inputs_factored(args[0], torch.zeros(8, 3), cond)


def test_pixel_align_needs_the_mano_branch():
    specs = specs_from_dict({**torch_parity.PIXEL_NARROW, "ManoBranch": False,
                             "ObjectPoseBranch": False, "EncodeStyle": "nerf",
                             "PointFeatSize": 3})
    with pytest.raises(ValueError, match="ManoBranch"):
        build_model(specs)
