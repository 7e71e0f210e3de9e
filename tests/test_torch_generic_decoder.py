"""Kernel K6's plain version (the generic decoder on materialized rows)
against the JAX package's generic Pallas decoder,
``make_pallas_decode_fn(specs, block=128, interpret=True)``, as the JAX
package's own tests/test_decoder_kernel.py holds it to its XLA decoder: to
1e-5 abs, for the four encode styles' column splits, NeRF PE at
point_size 63 and 9, the combined trunk with a classifier, twin trunks at C
= 6, latent_in (0, 2) and a latent input at the final layer.  Then the
two-pass grid with K6 as its decode_fn against JAX's, a pixel-aligned NeRF
spec (which K3 declines) through the generic path, and the CLI's --pallas.

Last, the repaired layer-0 fold of K1 and K3: with 0 in latent_in, layer 0
reads [input, input], and both halves of its weight must multiply the input.
K1's and K3's plain versions match JAX's generic decoder over a 16^3
two-pass grid to 2e-5 (the latent folded into biases reorders float32
sums), where JAX's own K1, which folds only the first half
(``decoder_kernel.py:334-335``), differs by more than 1e-3.

Weights come from the port's seeded init through the JAX package's
reference importer, so no JAX init compiles."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.inference.grid import make_grid_evaluator as jax_grid_evaluator
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.models.torch_import import convert_combined_decoder, convert_separate_decoder
from alignsdf_tpu.ops.decoder_kernel import make_fused_grid_decode_fn, make_pallas_decode_fn
from alignsdf_torch.cli.reconstruct import main as cli_main
from alignsdf_torch.config import NetworkSpecs, Specs, specs_from_dict
from alignsdf_torch.inference.grid import make_grid_evaluator
from alignsdf_torch.inference.reconstruct import Reconstructor
from alignsdf_torch.kernels.generic_decoder import generic_decode
from alignsdf_torch.models.alignsdf import build_model
from alignsdf_torch.models.decoder import make_decoder
from alignsdf_torch.ops.decoder_plan import make_generic_decode_fn
from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

import torch_parity
from test_torch_pixel_kernel import HW, _transforms

ATOL = 1e-5        # K6's plain version against JAX's generic kernel
FOLD_ATOL = 2e-5   # K1 / K3 with the latent folded into biases, against JAX's XLA decoder
LATENT = 32
CAM = np.asarray([[[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _pair(model_type, style, pfs, latent_in=(2,), num_class=0, dims=(128,) * 4,
          latent=LATENT, pixel=False):
    """(JAX specs, port specs, port decoder, JAX decoder), the port's
    decoder from its seeded init."""
    ns = dict(dims=dims, dropout=(), latent_in=latent_in, num_class=num_class or 6)
    kw = dict(model_type=model_type, encode_style=style, point_feat_size=pfs, latent_size=latent,
              classifier_branch=bool(num_class), mano_branch=True, object_pose_branch=True,
              sdf_scale_factor=7.018621123357809, pixel_align=pixel, image_size=(256, 256))
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw)
    pspecs = Specs(network_specs=NetworkSpecs(**ns), **kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        pdec = make_decoder(model_type, latent, pfs, style, pspecs.network_specs,
                            use_classifier=bool(num_class))
    jdec = jax_make_decoder(model_type, latent, pfs, style, jspecs.network_specs,
                            bool(num_class))
    return jspecs, pspecs, pdec, jdec


def _jax_params(pdec, jspecs):
    convert = (convert_combined_decoder if jspecs.model_type == "1encoder1decoder"
               else convert_separate_decoder)
    return jax.tree_util.tree_map(np.asarray, convert(pdec.state_dict(), jspecs.network_specs,
                                                      jspecs.classifier_branch))


@pytest.mark.parametrize("model_type,style,pfs,latent_in,num_class", [
    ("1encoder2decoder", "nerf", 63, (2,), 0),
    ("1encoder2decoder", "nerf", 9, (2,), 0),
    ("1encoder2decoder", "hand", 51, (2,), 0),
    ("1encoder2decoder", "both", 9, (2,), 0),
    ("1encoder2decoder", "obj", 9, (2,), 0),
    ("1encoder1decoder", "nerf", 9, (2,), 6),
    ("1encoder2decoder", "both", 9, (2,), 6),
    ("1encoder2decoder", "both", 9, (0, 2), 0),
    ("1encoder2decoder", "nerf", 9, (0, 4), 0),
])
def test_plain_k6_matches_jax_generic_kernel(model_type, style, pfs, latent_in, num_class):
    """300 rows (not a multiple of JAX's block) of seeded [latent,
    embedding] rows: both SDFs and the logits to 1e-5 abs; a CPU tensor
    takes the plain version (no launch counted)."""
    jspecs, pspecs, pdec, _ = _pair(model_type, style, pfs, latent_in, num_class)
    rows = (np.random.RandomState(3).randn(300, LATENT + pfs) * 0.5).astype(np.float32)
    j_h, j_o, j_c = make_pallas_decode_fn(jspecs, block=128, interpret=True)(
        {"decoder_params": _jax_params(pdec, jspecs)}, jnp.asarray(rows))
    before = generic_decode.launches
    with torch.no_grad():
        p_h, p_o, p_c = make_generic_decode_fn(pspecs)({"decoder": pdec}, torch.from_numpy(rows))
    assert generic_decode.launches == before
    assert p_h.shape == p_o.shape == (300, 1)
    np.testing.assert_allclose(p_h.numpy(), np.asarray(j_h), atol=ATOL, rtol=0)
    np.testing.assert_allclose(p_o.numpy(), np.asarray(j_o), atol=ATOL, rtol=0)
    assert (p_c is None) == (j_c is None) == (num_class == 0)
    if num_class:
        assert p_c.shape == (300, num_class)
        np.testing.assert_allclose(p_c.numpy(), np.asarray(j_c), atol=ATOL, rtol=0)


def test_generic_decode_fn_builds_the_plan_once_per_weights(monkeypatch):
    """make_generic_decode_fn keeps its plan (the weights split and tiled)
    over the runs of a pass, and builds it anew after an in-place update of
    the decoder's weights: the second answer follows the new weights."""
    import alignsdf_torch.ops.decoder_plan as decoder_plan

    _, pspecs, pdec, _ = _pair("1encoder2decoder", "nerf", 9)
    built = []
    make = decoder_plan.make_generic_plan
    monkeypatch.setattr(decoder_plan, "make_generic_plan",
                        lambda *args: built.append(1) or make(*args))
    decode = make_generic_decode_fn(pspecs)
    rows = torch.from_numpy((np.random.RandomState(4).randn(50, LATENT + 9) * 0.5)
                            .astype(np.float32))
    with torch.no_grad():
        first = decode({"decoder": pdec}, rows)
        assert torch.equal(decode({"decoder": pdec}, rows)[0], first[0])
        assert len(built) == 1
        pdec.linh4.bias += 0.5
        second = decode({"decoder": pdec}, rows)
        direct = pdec(rows)
    assert len(built) == 2
    np.testing.assert_allclose(second[0].numpy(), direct[0].numpy(), atol=ATOL, rtol=0)
    assert float((second[0] - first[0]).abs().max()) > 1e-2


def _shift_final_biases(pdec, field_h, field_o):
    """Shift the final biases so that a fifth of the given first pass is
    inside: the field crosses zero and the refinement runs."""
    with torch.no_grad():
        for col, field in enumerate((field_h, field_o)):
            shift = float(np.arctanh(np.quantile(np.asarray(field), 0.2)))
            if hasattr(pdec, "lin4"):
                pdec.lin4.bias[col] -= shift
            else:
                getattr(pdec, ("linh4", "lino4")[col]).bias -= shift


def test_plain_k6_grid_matches_jax():
    """The two-pass grid at n = 16 for NeRF PE at point_size 63 (the
    --pallas reconstruction config, narrow): the port's evaluator with K6's
    plain version as decode_fn against JAX's with make_pallas_decode_fn, to
    1e-5 on the fields, voxel size and origin."""
    n = 16
    jspecs, pspecs, pdec, _ = _pair("1encoder2decoder", "nerf", 63)
    latent = (np.random.RandomState(4).randn(1, LATENT) * 0.5).astype(np.float32)
    pctx = {"decoder": pdec, "latent": torch.from_numpy(latent)}
    assert make_grid_decode_fn(pspecs, n) is None  # K1 cannot fold NeRF PE
    first = make_grid_evaluator(lambda c, r: c["decoder"](r), pspecs, n, two_pass=False)(pctx)
    _shift_final_biases(pdec, first.sdf_hand, first.sdf_obj)
    pres = make_grid_evaluator(make_generic_decode_fn(pspecs), pspecs, n)(pctx)
    jres = jax_grid_evaluator(make_pallas_decode_fn(jspecs, block=128, interpret=True), jspecs,
                              n, chunk=n ** 3)({"decoder_params": _jax_params(pdec, jspecs),
                                                "latent": jnp.asarray(latent)})
    assert 0.0 < float((pres.sdf_hand < 0).float().mean()) < 1.0
    for name in ("sdf_hand", "sdf_obj", "voxel_size", "origin"):
        np.testing.assert_allclose(getattr(pres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_plain_k6_pixel_aligned_nerf_matches_jax():
    """A pixel-aligned NeRF spec (point_size 9), which K3 declines: the
    evaluator samples the map at each point's projection and K6's plain
    version decodes the rows, against JAX's evaluator with its generic
    kernel, over an 8^3 two-pass grid partly outside the image: 1e-5."""
    n = 8
    jspecs, pspecs, pdec, _ = _pair("1encoder2decoder", "nerf", 9, dims=(64,) * 4, pixel=True)
    assert make_pixel_grid_decode_fn(pspecs, n) is None
    rng = np.random.RandomState(11)
    ctx = {"latent": (rng.randn(1, LATENT, *HW) * 0.5).astype(np.float32), "cam_intr": CAM,
           "pred_root": np.asarray([[[0.01, -0.02, 0.6]]], np.float32)}
    pctx = {"decoder": pdec, **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    pres = make_grid_evaluator(make_generic_decode_fn(pspecs), pspecs, n)(pctx)
    jres = jax_grid_evaluator(make_pallas_decode_fn(jspecs, block=128, interpret=True), jspecs,
                              n, chunk=n ** 3)({"decoder_params": _jax_params(pdec, jspecs),
                                                **{k: jnp.asarray(v) for k, v in ctx.items()}})
    for name in ("sdf_hand", "sdf_obj", "voxel_size", "origin"):
        np.testing.assert_allclose(getattr(pres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_cli_pallas_reconstructs_a_nerf_experiment(tmp_path, capsys):
    """``cli.reconstruct --pallas --device cpu`` on a point_size 63 NeRF
    experiment (the bare obman config's encoding, narrow): the grid takes
    the generic path through K6 (its plain version on the CPU), says so, and
    the per-sample exports are written; without --pallas it names the plain
    decoder."""
    spec = dict(torch_parity.FLAGSHIP_NARROW, PointFeatSize=63, EncodeStyle="nerf",
                ManoBranch=False, ObjectPoseBranch=False,
                NetworkSpecs=dict(torch_parity.FLAGSHIP_NARROW["NetworkSpecs"], dims=[128] * 4))
    exp = tmp_path / "exp"
    (exp / "ModelParameters").mkdir(parents=True)
    with open(exp / "specs.json", "w") as f:
        json.dump(spec, f)
    specs = specs_from_dict(spec)
    model = build_model(specs, seed=0)
    assert not Reconstructor(model, specs, cube_dim=8, device="cpu").fused
    torch.save({"epoch": 1, "model_state_dict": model.state_dict()},
               exp / "ModelParameters" / "latest.pth")
    sample = torch_parity.make_sample(0, key="s0")
    np.savez(tmp_path / "samples.npz", **{k: np.stack([sample[k]]) for k in sample})
    args = ["-e", str(exp), "--samples", str(tmp_path / "samples.npz"), "--cube_dim", "8",
            "--device", "cpu"]
    cli_main(args + ["--pallas"])
    assert "through kernel K6 (--pallas)" in capsys.readouterr().err  # the CLI logs to stderr
    cli_main(args)
    assert "through the plain decoder" in capsys.readouterr().err
    assert os.path.isdir(exp / "Eval_obman" / "meshes")


def _kinematic_ctx(rng):
    return {"rot_center": (rng.randn(1, 1, 3) * 0.05).astype(np.float32),
            "global_trans": _transforms(rng, 16), "obj_trans": _transforms(rng, 1)[:, 0]}


@pytest.mark.parametrize("pixel", [False, True])
def test_k1_and_k3_fold_both_halves_of_layer_0(pixel):
    """latent_in (0, 2), the flagship's kinematic "both" embedding: K1's (or,
    for a pixel-aligned spec, K3's) plain version over a 16^3 two-pass grid
    against JAX's generic XLA decoder on materialized rows, to 2e-5; and,
    for K1, JAX's own fused K1 in interpret mode off by more than 1e-3 on
    the first pass of an 8^3 grid (it drops layer 0's second half)."""
    n = 16
    jspecs, pspecs, pdec, jdec = _pair("1encoder2decoder", "both", 9, (0, 2), dims=(64,) * 4,
                                       pixel=pixel)
    rng = np.random.RandomState(12)
    ctx = _kinematic_ctx(rng)
    if pixel:
        ctx.update(latent=(rng.randn(1, LATENT, *HW) * 0.5).astype(np.float32), cam_intr=CAM,
                   pred_root=np.asarray([[[0.01, -0.02, 0.6]]], np.float32))
        fused = make_pixel_grid_decode_fn(pspecs, n)
    else:
        ctx["latent"] = (rng.randn(1, LATENT) * 0.5).astype(np.float32)
        fused = make_grid_decode_fn(pspecs, n)
    pctx = {"decoder": pdec, **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    first = make_grid_evaluator(lambda c, r: c["decoder"](r), pspecs, n, two_pass=False)(pctx)
    _shift_final_biases(pdec, first.sdf_hand, first.sdf_obj)
    params = _jax_params(pdec, jspecs)
    jctx = {"decoder_params": params, "params": params,
            **{k: jnp.asarray(v) for k, v in ctx.items()}}

    def xla_decode(c, rows):
        return jdec.apply({"params": c["decoder_params"]}, rows)

    pres = make_grid_evaluator(None, pspecs, n, grid_decode_fn=fused)(pctx)
    jres = jax_grid_evaluator(xla_decode, jspecs, n, chunk=n ** 3)(jctx)
    assert 0.0 < float((pres.sdf_hand < 0).float().mean()) < 1.0
    for name in ("sdf_hand", "sdf_obj", "voxel_size", "origin"):
        np.testing.assert_allclose(getattr(pres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=FOLD_ATOL, rtol=0, err_msg=name)
    if not pixel:
        n = 8  # JAX's K1 in interpret mode is slow; its fault shows on any grid
        jk1 = make_fused_grid_decode_fn(jspecs, n, interpret=True, layout="lanes")
        j1 = jax_grid_evaluator(xla_decode, jspecs, n, chunk=n ** 3, two_pass=False,
                                grid_decode_fn=jk1)(jctx)
        j0 = jax_grid_evaluator(xla_decode, jspecs, n, chunk=n ** 3, two_pass=False)(jctx)
        err = max(float(np.abs(np.asarray(j1.sdf_hand) - np.asarray(j0.sdf_hand)).max()),
                  float(np.abs(np.asarray(j1.sdf_obj) - np.asarray(j0.sdf_obj)).max()))
        assert err > 1e-3, err
