"""The pixel-aligned classifier (``--pa_feat --cls``) at a narrow width
against the JAX package on seeded numpy inputs: K3's plain version with 2 +
C output rows against JAX's fused pixel grid kernel in interpret mode (block
128, ``band=None``) at C = 6 for the twin trunks and the combined trunk; at
C = 126, which JAX's K3 does not take, against the port's generic path; the
label query at mesh vertices (the HeadNet map sampled at each vertex's
projection) against JAX's ``Reconstructor._query_labels`` in both projection
modes; and one ``--pa_feat --cls`` train step past AdditionalLossStart
(K4's plain version with ``x_last`` on the port's side, JAX's pixel train
kernel in interpret mode on its side): every loss term and the gradients of
the classifier head and the hand trunk.

K4's ``x_last`` / ``dx_last`` are held against JAX's custom VJP by
``tests/test_torch_pixel_train_kernel.py``, whose pair runs with the
classifier.  Labels are compared apart from near-ties: where the top two
logits of the port lie within TIE of each other, float32 rounding may pick
either."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.inference.reconstruct import Reconstructor as JaxReconstructor
from alignsdf_tpu.models.torch_import import convert_combined_decoder, convert_separate_decoder
from alignsdf_tpu.ops.decoder_kernel import make_fused_pixel_grid_decode_fn
from alignsdf_tpu.ops.decoder_train_pixel import make_fused_train_decoder_pixel
from alignsdf_tpu.training import train_state as jax_train_state
from alignsdf_tpu.training import train_step as jax_train_step
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import from_jax
from alignsdf_torch.inference.grid import embed_points
from alignsdf_torch.inference.reconstruct import Reconstructor
from alignsdf_torch.kernels.grid_decoder import MAX_ROWS, grid_coords
from alignsdf_torch.kernels.pixel_grid_decoder import (
    pixel_grid_decode,
    pixel_grid_decode_reference,
    pixel_projection,
)
from alignsdf_torch.models.decoder import make_decoder
from alignsdf_torch.ops.geometry import pixel_alignment
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn
from alignsdf_torch.training.train_state import TrainState, make_optimizer
from alignsdf_torch.training.train_step import batch_to_device, make_train_step

import torch_parity
from test_torch_pixel_kernel import C, HW, NS, _transforms
from test_torch_pixel_train import TRAJ_SPECS, _batch, _keeping_grads

TIE = 1e-4
K3_ATOL = 5e-5  # the JAX package's own fused-vs-XLA tolerance for the pixel grid
# the --pa_feat trajectory spec with the classifier, its CE on from epoch 1
PIXEL_CLS = dict(TRAJ_SPECS, ClassifierBranch=True, AdditionalLossStart=1)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _labels_agree(port_logits: np.ndarray, labels: np.ndarray, ref: np.ndarray) -> None:
    """Port labels equal the reference's wherever the port's top two logits
    are more than TIE apart; and most of them are."""
    top2 = np.sort(port_logits, axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TIE
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[clear], ref[clear])


def _grid_scene(model_type, num_class):
    """A decoder with a classifier of num_class from the port's seeded init
    (imported into JAX by its reference importer, so no JAX init compiles),
    the head scaled x40 and its logits centred so that the labels vary, a
    feature map, camera and transforms, as JAX and port contexts; the
    camera puts part of the grid outside the image."""
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=C,
              mano_branch=True, object_pose_branch=True, classifier_branch=True,
              sdf_scale_factor=7.018621123357809, pixel_align=True, image_size=(256, 256))
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**NS, num_class=num_class), **kw)
    pspecs = Specs(network_specs=NetworkSpecs(**NS, num_class=num_class), **kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        pdec = make_decoder(model_type, C, 9, "both", pspecs.network_specs, use_classifier=True)
    rng = np.random.RandomState(11)
    ctx = {"latent": (rng.randn(1, C, *HW) * 0.5).astype(np.float32),
           "cam_intr": np.asarray([[[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]],
                                  np.float32),
           "pred_root": np.asarray([[[0.01, -0.02, 0.6]]], np.float32),
           "rot_center": (rng.randn(1, 1, 3) * 0.05).astype(np.float32),
           "global_trans": _transforms(rng, 16),
           "obj_trans": _transforms(rng, 1)[:, 0]}
    pctx = {"decoder": pdec, **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    pts = torch.from_numpy((rng.rand(400, 3) * 2.0 - 1.0).astype(np.float32))
    with torch.no_grad():
        pdec.classifier_head.weight *= 40
        pdec.classifier_head.bias -= _generic(pspecs, pctx, pts)[2].mean(0)
    convert = (convert_combined_decoder if model_type == "1encoder1decoder"
               else convert_separate_decoder)
    params = jax.tree_util.tree_map(np.asarray, convert(pdec.state_dict(), jspecs.network_specs,
                                                        True))
    jctx = {"decoder_params": params, "params": params,
            **{k: jnp.asarray(v) for k, v in ctx.items()}}
    return jspecs, pspecs, jctx, pctx


def _generic(pspecs, pctx, pts):
    """The generic path at (M, 3) points: the map sampled at each point's
    raw projection, the embedding, the decoder on materialized rows."""
    emb = embed_points(pspecs, pctx, pts)
    lat = pixel_alignment(pctx["latent"], pts, pctx["cam_intr"], pctx["pred_root"],
                          pspecs.image_size[0], pspecs.sdf_scale_factor)
    return pctx["decoder"](torch.cat([lat, emb], dim=1))


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
def test_plain_k3_class_rows_match_jax_kernel(model_type):
    """K3's plain version with 2 + 6 rows over a whole 8^3 grid, part of it
    outside the image, against JAX's K3 (interpret, block 128, unbanded):
    fields and logits to 5e-5 abs (the latent's products summed in another
    order than the sampling matmul's), labels equal apart from near-ties;
    the class rows come from the first trunk (the hand trunk or the
    combined one)."""
    n = 8
    jspecs, pspecs, jctx, pctx = _grid_scene(model_type, 6)
    origin, voxel = np.full(3, -1.0, np.float32), np.float32(2.0 / (n - 1))
    gd = make_fused_pixel_grid_decode_fn(jspecs, n, block=128, interpret=True, band=None)
    j_h, j_o, j_c = gd(jctx, jnp.arange(n ** 3, dtype=jnp.int32), jnp.asarray(origin),
                       jnp.asarray(voxel))
    plan = make_pixel_grid_decode_fn(pspecs, n)(pctx).plan
    assert plan.n_rows == 8
    o_t, v_t = torch.from_numpy(origin), torch.tensor(voxel)
    with torch.no_grad():
        out = pixel_grid_decode(plan, 0, n ** 3, o_t, v_t)
    share = float(pixel_projection(plan, 0, n ** 3, o_t, v_t)[3].float().mean())
    assert 0.1 < share < 0.9, share
    assert out.shape == (8, n ** 3)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(j_h)[:, 0], atol=K3_ATOL, rtol=0)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(j_o)[:, 0], atol=K3_ATOL, rtol=0)
    logits = out[2:].T.numpy()
    np.testing.assert_allclose(logits, np.asarray(j_c), atol=K3_ATOL, rtol=0)
    _labels_agree(logits, logits.argmax(1), np.asarray(j_c).argmax(1))
    assert len(np.unique(logits.argmax(1))) > 1


def test_plain_k3_takes_126_classes_and_no_more():
    """2 + 126 rows (JAX's K3 stops at 6 and hands more to XLA): fields and
    logits against the generic path (pixel_alignment + the decoder) to 1e-5
    abs, over a 6^3 grid and a run that starts mid-grid; 127 classes are
    refused by name."""
    n = 6
    _, pspecs, _, pctx = _grid_scene("1encoder2decoder", 126)
    plan = make_pixel_grid_decode_fn(pspecs, n)(pctx).plan
    origin, voxel = torch.full((3,), -1.0), torch.tensor(0.4)
    with torch.no_grad():
        out = pixel_grid_decode_reference(plan, 0, n ** 3, origin, voxel)
        part = pixel_grid_decode(plan, 37, 101, origin, voxel)
        h, o, logits = _generic(pspecs, pctx, grid_coords(0, n ** 3, n, origin, voxel))
    assert out.shape == (MAX_ROWS, n ** 3)
    np.testing.assert_allclose(out[0].numpy(), h[:, 0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[1].numpy(), o[:, 0].numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[2:].T.numpy(), logits.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(part.numpy(), out[:, 37:138].numpy(), atol=1e-6, rtol=0)
    _, pspecs, _, pctx = _grid_scene("1encoder2decoder", 127)
    with pytest.raises(ValueError, match="at most 128"):
        make_pixel_grid_decode_fn(pspecs, n)(pctx)


@pytest.fixture(scope="module")
def pair():
    """The narrow pixel-aligned classifier model in JAX and in the port (one
    build for the module, from the port's seeded init), the classifier head
    scaled x40 so that labels vary, and a 64-pixel sample whose camera is
    scaled to the image."""
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair_from_port(PIXEL_CLS)
    sample = torch_parity.make_sample(3)
    sample["image"] = np.random.RandomState(3).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    sample["cam_intr"][:2, :] *= 64 / 256.0
    # the seeded head gives one label everywhere: scale it and centre its
    # logits over points about the hand
    ctx = Reconstructor(pmodel, pspecs, cube_dim=6, device="cpu").submit(sample)["ctx"]
    pts = torch.from_numpy((np.random.RandomState(5).randn(400, 3) * 0.3).astype(np.float32))
    head = pmodel.decoder.classifier_head
    with torch.no_grad():
        head.weight *= 40
        head.bias.zero_()
        lat = pixel_alignment(ctx["latent"], pts, ctx["cam_intr"], ctx["pred_root"],
                              pspecs.image_size[0], pspecs.sdf_scale_factor)
        _, _, logits = pmodel.decode_points(torch.cat([lat, embed_points(pspecs, ctx, pts)], 1))
        head.bias -= logits.mean(0)
    variables["params"]["decoder"]["hand"]["classifier_head"] = {
        "kernel": head.weight.detach().numpy().T.copy(), "bias": head.bias.detach().numpy().copy()}
    return jmodel, variables, pmodel, jspecs, pspecs, sample


@pytest.mark.parametrize("ref", [False, True])
def test_query_labels_match_jax(pair, ref):
    """_query_labels at 400 vertices about the hand on one scene context
    (the port's encoding, handed to both): JAX's pixel branch samples the
    map at each vertex's projection (the raw vertex, or the embedding's
    first three columns under pixel_ref_projection), then decode_points and
    argmax; labels equal apart from near-ties, and both projection modes
    see vertices in and out of the image."""
    jmodel, variables, pmodel, jspecs, pspecs, sample = pair
    prec = Reconstructor(pmodel, pspecs, cube_dim=6, device="cpu", pixel_ref_projection=ref)
    ctx = prec.submit(sample)["ctx"]
    assert ctx["latent"].ndim == 4
    jrec = JaxReconstructor(jmodel, variables, jspecs, cube_dim=6, pixel_ref_projection=ref)
    jctx = {"params": jrec.variables["params"],
            **{k: jnp.asarray(ctx[k].numpy())
               for k in ("latent", "cam_intr", "pred_root", "rot_center", "global_trans",
                         "obj_trans")}}
    verts = (np.random.RandomState(4).randn(400, 3) * 0.3).astype(np.float32)
    j_labels = np.asarray(jrec._query_labels(jctx, verts))
    p_labels = prec._query_labels(ctx, verts)
    pts = torch.from_numpy(verts)
    emb = embed_points(pspecs, ctx, pts)
    with torch.no_grad():
        lat = pixel_alignment(ctx["latent"], emb[:, :3] if ref else pts, ctx["cam_intr"],
                              ctx["pred_root"], pspecs.image_size[0], pspecs.sdf_scale_factor)
        _, _, logits = pmodel.decode_points(torch.cat([lat, emb], dim=1))
    _labels_agree(logits.numpy(), p_labels, j_labels)
    assert len(np.unique(p_labels)) > 1
    # the vertices' share inside the image, in this projection mode
    proj = (emb[:, :3] if ref else pts) * 2.0 / pspecs.sdf_scale_factor + ctx["pred_root"][0]
    uv = (proj @ ctx["cam_intr"][0, :3, :3].T)
    uv = uv[:, :2] / uv[:, 2:3] / pspecs.image_size[0]
    share = float(((uv >= 0) & (uv <= 1)).all(dim=1).float().mean())
    assert 0.0 < share < 1.0, share


def test_pixel_classifier_step_matches_jax(pair):
    """One --pa_feat --cls train step at epoch 2, past AdditionalLossStart 1,
    from the same weights, batch and dropout seed: every loss term to 1e-4
    relative (1e-6 abs), the cross-entropy nonzero, and the gradients of
    the classifier head and of every hand-trunk tensor to 1e-4 of their
    largest entry (the pixel trajectory's first-step tolerance): the head's
    gradient reaches linh* through x_last's dx_last in K4's backward."""
    jmodel, variables, pmodel, jspecs, pspecs, _ = pair
    variables = jax.tree_util.tree_map(np.copy, variables)
    pmodel = copy.deepcopy(pmodel)
    # final biases at 0 put the predictions inside the clamp band, so the
    # SDF losses carry gradient into the trunks
    for trunk, name in (("hand", "linh4"), ("obj", "lino4")):
        bias = variables["params"]["decoder"][trunk][name]["bias"]
        variables["params"]["decoder"][trunk][name]["bias"] = np.zeros_like(bias)
        getattr(pmodel.decoder, name).bias.data.zero_()
    opt = _keeping_grads(jax_train_state.make_optimizer(jspecs))
    override = make_fused_train_decoder_pixel(jspecs, interpret=True)
    jstep = jax.jit(jax_train_step.make_train_step(jmodel, jspecs, opt, override))
    jstate = jax_train_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        consts=variables.get("consts", {}), opt_state=opt.init(variables["params"]),
        epoch=jnp.asarray(2, jnp.int32))
    batch = _batch(pspecs, 0)
    key = jax.random.PRNGKey(0)
    seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
    jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    pstate = TrainState(pmodel, make_optimizer(pspecs, pmodel.parameters()), epoch=2)
    pl = make_train_step(pspecs)(pstate, batch_to_device(batch, "cpu"), seed)
    assert set(jl) == set(pl)
    for k in jl:
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(pl["cls"]) > 0
    jg = from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state[1]),
                  jax.tree_util.tree_map(np.asarray, jstate.batch_stats), pspecs)
    names = [k for k, _ in pmodel.named_parameters()
             if k.startswith(("decoder.classifier_head.", "decoder.linh"))]
    assert len(names) == 2 + 5 * 3 - 1  # the head; linh0-3 (v, g, b) and linh4 (w, b)
    params = dict(pmodel.named_parameters())
    for k in names:
        g, ref = params[k].grad, jg[k]
        scale = float(ref.abs().max()) + 1e-30
        assert float((g - ref).abs().max()) <= 1e-4 * scale, k
    assert float(params["decoder.classifier_head.weight"].grad.abs().max()) > 0
