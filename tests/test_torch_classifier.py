"""The classifier family (the labelled DexYCB full model, ``--cls``) at a
narrow width against the JAX package on seeded numpy inputs: the decoder's
hand-part logits, the converter, K1's plain version with 2 + C output rows
against the JAX fused grid kernels in interpret mode (lanes-major at C = 6,
points-major at C = 8), the grid's ``cls``, the label re-query at mesh
vertices and its exports, K2's plain version with ``x_last`` against the
JAX scene-factored kernel with the classifier, and a 3-step train
trajectory that crosses AdditionalLossStart.  The pixel-aligned classifier
(K3's class rows, K4's x_last) is tests/test_torch_pixel_classifier.py's.

Labels are compared apart from near-ties: where the top two logits of the
port lie within TIE of each other, float32 rounding may pick either."""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.inference.grid import make_grid_evaluator as jax_grid_evaluator
from alignsdf_tpu.inference.reconstruct import Reconstructor as JaxReconstructor
from alignsdf_tpu.inference.reconstruct import make_output_dirs as jax_output_dirs
from alignsdf_tpu.inference.reconstruct import run_pipelined as jax_run_pipelined
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.ops.decoder_kernel import make_fused_grid_decode_fn
from alignsdf_tpu.ops.decoder_train_kernel import make_fused_train_decoder_factored
from alignsdf_tpu.ops.rotations import batch_rodrigues
from alignsdf_tpu.training import train_state as jax_train_state
from alignsdf_tpu.training import train_step as jax_train_step
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import decoder_from_jax, from_jax
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.inference.grid import embed_points, make_grid_evaluator
from alignsdf_torch.inference.reconstruct import (
    PART_COLORS,
    Reconstructor,
    make_output_dirs,
    run_pipelined,
)
from alignsdf_torch.kernels.grid_decoder import MAX_ROWS, grid_coords, grid_decode
from alignsdf_torch.kernels.train_decoder import (
    flatten_params,
    train_decode_backward_reference,
    train_decode_reference,
    unflatten_params,
)
from alignsdf_torch.models.decoder import make_decoder, trunk_prefixes
from alignsdf_torch.ops.embeddings import kinematic_embedding
from alignsdf_torch.ops.grid_plan import branch_columns, make_grid_decode_fn
from alignsdf_torch.ops.train_plan import make_train_decoder, trunk_operands
from alignsdf_torch.training.train_state import TrainState, make_optimizer
from alignsdf_torch.training.train_step import batch_to_device, make_train_step

import torch_parity
from test_torch_train import TRAJ_SPECS
from test_torch_train_kernel import _relu_margin

TIE = 1e-4
LATENT = 32
NS = dict(dims=(64, 64, 64, 64), dropout=(), latent_in=(2,))
FACES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "alignsdf_torch", "assets", "closed_fmano.npy")
# the narrow flagship with the classifier (DexYCB's --cls at the flagship's
# kinematic embedding)
CLS_NARROW = dict(torch_parity.FLAGSHIP_NARROW, ClassifierBranch=True)


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


def _jax_classifier_decoder(model_type, num_class, pfs=9, style="both", ns=NS, latent=LATENT,
                            seed=5):
    jns = JaxNetworkSpecs(**ns, num_class=num_class)
    jdec = jax_make_decoder(model_type, latent, pfs, style, jns, True)
    params = jax.tree_util.tree_map(np.asarray, jdec.init(
        jax.random.PRNGKey(seed), jnp.zeros((4, latent + pfs)))["params"])
    pdec = make_decoder(model_type, latent, pfs, style, NetworkSpecs(**ns, num_class=num_class),
                        use_classifier=True)
    pdec.load_state_dict(decoder_from_jax(params))
    return jdec, params, pdec


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
def test_decoder_logits_match_jax(model_type):
    """Both decoders return (sdf_hand, sdf_obj, logits) as JAX's do: 1e-5."""
    jdec, params, pdec = _jax_classifier_decoder(model_type, 6)
    rows = np.random.RandomState(3).randn(300, LATENT + 9).astype(np.float32)
    j_h, j_o, j_c = jdec.apply({"params": params}, jnp.asarray(rows))
    with torch.no_grad():
        p_h, p_o, p_c = pdec(torch.from_numpy(rows))
    for p, j in ((p_h, j_h), (p_o, j_o), (p_c, j_c)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=1e-5, rtol=0)
    assert p_c.shape == (300, 6) and float(p_c.std()) > 1e-2


def test_converter_maps_the_classifier_head():
    """hand/classifier_head (trunk/classifier_head when combined) becomes the
    reference's decoder.classifier_head.{weight, bias}."""
    for model_type, trunk in (("1encoder2decoder", "hand"), ("1encoder1decoder", "trunk")):
        _, params, pdec = _jax_classifier_decoder(model_type, 6)
        sd = decoder_from_jax(params, prefix="decoder.")
        head = params[trunk]["classifier_head"]
        np.testing.assert_array_equal(sd["decoder.classifier_head.weight"].numpy(),
                                      head["kernel"].T)
        np.testing.assert_array_equal(sd["decoder.classifier_head.bias"].numpy(), head["bias"])
        assert sd["decoder.classifier_head.weight"].shape == (6, 64)
        assert set(pdec.state_dict()) == {k[len("decoder."):] for k in sd}


def _transforms(rng, count):
    rot = np.asarray(batch_rodrigues(jnp.asarray(rng.randn(1, count, 3) * 0.8, jnp.float32)))
    tf = np.tile(np.eye(4, dtype=np.float32), (1, count, 1, 1))
    tf[..., :3, :3] = rot
    tf[..., :3, 3] = rng.randn(1, count, 3) * 0.05
    return tf


def _grid_scene(num_class, model_type="1encoder2decoder"):
    """Seeded decoder with a classifier of num_class, latent and kinematic
    transforms, as JAX and port contexts."""
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=LATENT,
              mano_branch=True, object_pose_branch=True, classifier_branch=True,
              sdf_scale_factor=6.205380387894951)
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**NS, num_class=num_class), **kw)
    pspecs = Specs(network_specs=NetworkSpecs(**NS, num_class=num_class), **kw)
    _, params, pdec = _jax_classifier_decoder(model_type, num_class)
    rng = np.random.RandomState(11)
    ctx = {"latent": rng.randn(1, LATENT).astype(np.float32),
           "rot_center": (rng.randn(1, 1, 3) * 0.05).astype(np.float32),
           "global_trans": _transforms(rng, 16), "obj_trans": _transforms(rng, 1)[:, 0]}
    jctx = {"decoder_params": params, "params": params,
            **{k: jnp.asarray(v) for k, v in ctx.items()}}
    pctx = {"decoder": pdec, **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    return jspecs, pspecs, jctx, pctx, params


@pytest.mark.parametrize("num_class,n,layout", [(6, 8, "lanes"), (8, 16, "points")])
def test_plain_k1_class_rows_match_jax_kernel(num_class, n, layout):
    """One pass of K1's plain version (2 + C rows) against the JAX fused
    grid kernel in interpret mode, block 128: the lanes-major kernel at C =
    6, the points-major one that JAX routes C > 6 to at C = 8.  Fields and
    logits to 1e-5; labels equal apart from near-ties."""
    jspecs, pspecs, jctx, pctx, _ = _grid_scene(num_class)
    origin, voxel = np.full(3, -1.0, np.float32), np.float32(2.0 / (n - 1))
    gd = make_fused_grid_decode_fn(jspecs, n, block=128, interpret=True, layout=layout)
    j_h, j_o, j_c = gd(jctx, jnp.arange(n ** 3, dtype=jnp.int32), jnp.asarray(origin),
                       jnp.asarray(voxel))
    plan = make_grid_decode_fn(pspecs, n)(pctx).plan
    assert plan.n_rows == 2 + num_class
    with torch.no_grad():
        out = grid_decode(plan, 0, n ** 3, torch.from_numpy(origin), torch.tensor(voxel))
    assert out.shape == (2 + num_class, n ** 3)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(j_h)[:, 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[1].numpy(), np.asarray(j_o)[:, 0], atol=1e-5, rtol=0)
    logits = out[2:].T.numpy()
    np.testing.assert_allclose(logits, np.asarray(j_c), atol=1e-5, rtol=0)
    _labels_agree(logits, logits.argmax(1), np.asarray(j_c).argmax(1))


@pytest.mark.parametrize("fused", [True, False])
def test_grid_cls_matches_jax(fused):
    """GridResult.cls over both passes, through K1's plain version or the
    generic decode, against the JAX evaluator's generic path."""
    n = 12
    jspecs, pspecs, jctx, pctx, params = _grid_scene(6)
    jdec = jax_make_decoder(jspecs.model_type, LATENT, 9, "both", jspecs.network_specs, True)
    jres = jax_grid_evaluator(lambda c, rows: jdec.apply({"params": c["decoder_params"]}, rows),
                              jspecs, n, chunk=n ** 3, two_pass=True)(jctx)
    pres = make_grid_evaluator(lambda c, rows: c["decoder"](rows), pspecs, n,
                               grid_decode_fn=make_grid_decode_fn(pspecs, n) if fused else None)(pctx)
    np.testing.assert_allclose(pres.origin.numpy(), np.asarray(jres.origin), atol=2e-5, rtol=0)
    assert pres.cls.shape == (n, n, n) and pres.cls.dtype == torch.int32
    # the port's logits at the refined pass's points, to find the near-ties
    pts = grid_coords(0, n ** 3, n, pres.origin, pres.voxel_size)
    emb = kinematic_embedding(pts, pts.shape[0], 9, pspecs.sdf_scale_factor, "both",
                              rot_center=pctx["rot_center"], global_trans=pctx["global_trans"],
                              obj_trans=pctx["obj_trans"])
    with torch.no_grad():
        _, _, logits = pctx["decoder"](torch.cat([pctx["latent"].expand(n ** 3, -1), emb], 1))
    _labels_agree(logits.numpy(), pres.cls.reshape(-1).numpy(), np.asarray(jres.cls).reshape(-1))
    assert len(np.unique(pres.cls.numpy())) > 1


def test_plain_k1_takes_126_classes_and_no_more():
    """2 + 126 rows (the points-major TPU tile's limit): the class rows equal
    the generic decoder's logits; 127 classes are refused."""
    n = 6
    _, pspecs, _, pctx, _ = _grid_scene(126)
    plan = make_grid_decode_fn(pspecs, n)(pctx).plan
    origin, voxel = torch.full((3,), -1.0), torch.tensor(0.4)
    with torch.no_grad():
        out = grid_decode(plan, 0, n ** 3, origin, voxel)
        pts = grid_coords(0, n ** 3, n, origin, voxel)
        emb = kinematic_embedding(pts, pts.shape[0], 9, pspecs.sdf_scale_factor, "both",
                                  rot_center=pctx["rot_center"],
                                  global_trans=pctx["global_trans"], obj_trans=pctx["obj_trans"])
        h, o, logits = pctx["decoder"](torch.cat([pctx["latent"].expand(n ** 3, -1), emb], 1))
    assert out.shape == (MAX_ROWS, n ** 3)
    np.testing.assert_allclose(out[2:].T.numpy(), logits.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out[0].numpy(), h[:, 0].numpy(), atol=1e-5, rtol=0)
    _, pspecs, _, pctx, _ = _grid_scene(127)
    with pytest.raises(ValueError, match="at most 128"):
        make_grid_decode_fn(pspecs, n)(pctx)


@pytest.fixture(scope="module")
def recons(tmp_path_factory):
    """The JAX and the port Reconstructor on the narrow classifier model
    and one sample, final biases shifted so a fifth of the first pass is
    inside and the classifier head scaled so that the labels vary over the
    hand; both run_pipelined with label_out and viz."""
    n = 12
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair_from_port(CLS_NARROW,
                                                                                  seed=1)
    sample = torch_parity.make_sample(3)
    faces = np.load(FACES)
    prec = Reconstructor(pmodel, pspecs, cube_dim=n, device="cpu", mano_faces=faces)
    ctx = prec.submit(sample)["ctx"]
    # the seeded head gives one label everywhere: scale it and centre its
    # logits over points about the hand
    pts = torch.from_numpy((np.random.RandomState(5).randn(400, 3) * 0.3).astype(np.float32))
    head = variables["params"]["decoder"]["hand"]["classifier_head"]
    with torch.no_grad():
        pmodel.decoder.classifier_head.weight *= 40
        pmodel.decoder.classifier_head.bias.zero_()
        _, _, logits = pmodel.decode_points(torch.cat(
            [ctx["latent"].expand(400, -1), embed_points(pspecs, ctx, pts)], 1))
        pmodel.decoder.classifier_head.bias -= logits.mean(0)
    head["kernel"] = pmodel.decoder.classifier_head.weight.detach().numpy().T.copy()
    head["bias"] = pmodel.decoder.classifier_head.bias.detach().numpy().copy()
    first = make_grid_evaluator(lambda c, r: c["decoder"](r), pspecs, n, two_pass=False)(ctx)
    for branch, field in (("hand", first.sdf_hand), ("obj", first.sdf_obj)):
        name = f"lin{branch[0]}4"
        shift = float(np.arctanh(np.quantile(field.numpy(), 0.2)))
        jlast = variables["params"]["decoder"][branch][name]
        jlast["bias"] = jlast["bias"] - np.float32(shift)
        with torch.no_grad():
            getattr(pmodel.decoder, name).bias -= shift
    jrec = JaxReconstructor(jmodel, variables, jspecs, cube_dim=n, mano_faces=faces)
    jdirs = jax_output_dirs(str(tmp_path_factory.mktemp("jax")))
    jpend = []
    jax_run_pipelined(jrec, [sample], jdirs, label_out=True, viz=True,
                      on_done=lambda i, p: jpend.append(p))
    pdirs = make_output_dirs(str(tmp_path_factory.mktemp("torch")))
    ppend = []
    assert run_pipelined(prec, [sample], pdirs, label_out=True, viz=True,
                         on_done=lambda i, p: ppend.append(p)) == 1
    return jrec, jpend[0], jdirs, prec, ppend[0], pdirs, sample["key"]


def test_query_labels_match_jax(recons):
    """_query_labels on the same vertices (embedded, latent broadcast,
    decode_points, argmax) against JAX's Reconstructor._query_labels."""
    jrec, jpending, _, prec, ppending, _, _ = recons
    verts = (np.random.RandomState(4).randn(400, 3) * 0.3).astype(np.float32)
    j_labels = np.asarray(jrec._query_labels(jpending["ctx"], verts))
    p_labels = prec._query_labels(ppending["ctx"], verts)
    ctx = ppending["ctx"]
    pts = torch.from_numpy(verts)
    emb = kinematic_embedding(pts, 400, 9, prec.specs.sdf_scale_factor, "both",
                              rot_center=ctx["rot_center"], global_trans=ctx["global_trans"],
                              obj_trans=ctx["obj_trans"])
    with torch.no_grad():
        _, _, logits = prec.model.decode_points(torch.cat([ctx["latent"].expand(400, -1), emb], 1))
    _labels_agree(logits.numpy(), p_labels, j_labels)
    assert len(np.unique(p_labels)) > 1


def test_pipelined_label_exports_match_jax(recons):
    """run_pipelined(label_out=True, viz=True) writes <key>_hand_label.npz
    (the hand mesh's vertices and one label per vertex, as float32 in
    [0, 6)) and <key>_hand_color.ply (the mesh colored by PART_COLORS), as
    the JAX package's does."""
    _, _, jdirs, _, _, pdirs, key = recons
    with np.load(os.path.join(jdirs["meshes"], f"{key}_hand_label.npz")) as f:
        j_pts, j_labels = f["points"], f["labels"]
    with np.load(os.path.join(pdirs["meshes"], f"{key}_hand_label.npz")) as f:
        p_pts, p_labels = f["points"], f["labels"]
    assert p_labels.dtype == np.float32 and p_pts.dtype == np.float32
    assert p_pts.shape == j_pts.shape and p_labels.shape == (len(p_pts),)
    assert set(np.unique(p_labels)) <= set(range(6))
    # marching cubes divides the fields' 1e-5 differences by a field step
    # that can be small along an edge
    np.testing.assert_allclose(p_pts, j_pts, atol=1e-3, rtol=0)
    assert float((p_labels == j_labels).mean()) > 0.98
    with open(os.path.join(pdirs["meshes"], f"{key}_hand_color.ply"), "rb") as f:
        header, body = f.read().split(b"end_header\n", 1)
    assert b"property uchar red" in header and f"element vertex {len(p_pts)}".encode() in header
    colors = np.frombuffer(body[:15 * len(p_pts)], dtype=[("xyz", np.float32, 3),
                                                         ("rgb", np.uint8, 3)])["rgb"]
    np.testing.assert_array_equal(colors, PART_COLORS[p_labels.astype(np.int64)])


@pytest.fixture(scope="module", params=["1encoder2decoder", "1encoder1decoder"])
def train_pair(request):
    """The JAX scene-factored train kernel with the classifier and the port's
    K2 plan, on the same converted decoder, latent and embedding."""
    model_type = request.param
    b, n, ls, pfs = 2, 128, 32, 9
    ns = dict(dims=(64,) * 4, dropout=(0, 1, 2, 3), dropout_prob=0.2,
              norm_layers=(0, 1, 2, 3), latent_in=(2,))
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=pfs, latent_size=ls,
              samples_per_scene=n, classifier_branch=True)
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw)
    pspecs = Specs(network_specs=NetworkSpecs(**ns), **kw)
    rng = np.random.RandomState(2)
    latent = (rng.randn(b, ls) * 0.5).astype(np.float32)
    emb = (rng.randn(b * n, pfs) * 0.5).astype(np.float32)
    labels = rng.randint(-1, 6, b * n)
    jdec = jax_make_decoder(model_type, ls, pfs, "both", jspecs.network_specs, True)
    x = np.concatenate([np.repeat(latent, n, axis=0), emb], axis=1)
    params = jax.tree_util.tree_map(np.asarray,
                                    jdec.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    fac = make_fused_train_decoder_factored(jspecs, interpret=True)
    pdec = make_decoder(model_type, ls, pfs, "both", pspecs.network_specs, use_classifier=True)
    pdec.load_state_dict(decoder_from_jax(params))
    return params, fac, pdec, make_train_decoder(pspecs), latent, emb, labels, pspecs


def _ce_jax(logits, labels):
    valid = labels >= 0
    lp = jax.nn.log_softmax(logits, axis=-1)[jnp.arange(len(labels)), jnp.maximum(labels, 0)]
    return -jnp.sum(jnp.where(valid, lp, 0.0)) / jnp.sum(valid)


def _ce_port(logits, labels):
    valid = labels >= 0
    lp = torch.log_softmax(logits, dim=-1)[torch.arange(len(labels)), labels.clamp(min=0)]
    return -torch.sum(torch.where(valid, lp, torch.zeros_like(lp))) / valid.sum()


def test_k2_x_last_matches_factored_pallas(train_pair):
    """In training (dropout live): SDFs and logits to 2e-6, and every
    gradient (weight-norm parameters, biases, the classifier head, the
    latent, the embedding) under an SDF + cross-entropy loss to 1e-4 of its
    largest entry, against JAX's scene-factored kernel with the classifier
    (x_last out, dx_last in)."""
    params, fac, pdec, decode, latent, emb, labels, specs = train_pair
    train = True
    assert _relu_margin(pdec, specs, latent, emb, 11, train) > 2e-7
    j_h, j_o, j_c = fac(params, jnp.asarray(latent), jnp.asarray(emb), jnp.int32(11), train=train)
    with torch.no_grad():
        p_h, p_o, p_c = decode(pdec, torch.from_numpy(latent), torch.from_numpy(emb), 11, train)
    for p, j in ((p_h, j_h), (p_o, j_o), (p_c, j_c)):
        np.testing.assert_allclose(p.numpy(), np.asarray(j), atol=2e-6, rtol=0)

    def loss(p, lat, e):
        h, o, c = fac(p, lat, e, jnp.int32(11), train=train)
        return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + 50.0 * _ce_jax(c, jnp.asarray(labels))

    gp, gl, ge = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(latent), jnp.asarray(emb))
    lat_t = torch.from_numpy(latent).requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    pdec.zero_grad()
    h, o, c = decode(pdec, lat_t, emb_t, 11, train)
    (torch.sum(torch.sin(h)) + torch.sum(o ** 2)
     + 50.0 * _ce_port(c, torch.from_numpy(labels))).backward()

    def close(port, ref):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max()) + 1e-8
        np.testing.assert_allclose(port / scale, ref / scale, atol=1e-4, rtol=0)

    close(lat_t.grad.numpy(), gl)
    close(emb_t.grad.numpy(), ge)
    count = 0
    for trunk in gp.values():
        for name, g in trunk.items():
            layer = getattr(pdec, name)
            if "v" in g:
                close(layer.weight_v.grad.numpy().T, g["v"])
                close(layer.weight_g.grad.numpy().reshape(-1), g["g"])
            else:
                close(layer.weight.grad.numpy().T, g["kernel"])
            close(layer.bias.grad.numpy(), g["bias"])
            count += 1
    assert count == 5 * len(gp) + 1  # the trunks' layers and the classifier head


@pytest.mark.parametrize("train", [False, True])
def test_plain_backward_with_dx_last_matches_autograd(train_pair, train):
    """K2's plain backward, fed the forward's own residuals, dy and a
    nonzero dx_last, against autograd through the plain forward with both
    outputs in the loss: every gradient to 1e-5 of its largest entry."""
    _, _, pdec, decode, latent, emb, _, specs = train_pair
    st = decode.statics._replace(train=train)
    first, second = trunk_prefixes(pdec)
    cols = branch_columns(specs)[0]
    with torch.no_grad():
        ws, xs, bs = trunk_operands(pdec, first, len(cols), torch.from_numpy(latent), specs,
                                    1 if second else 2)
    leaves = [t.detach().clone().requires_grad_()
              for t in [torch.from_numpy(emb)[:, cols], *flatten_params(ws, xs, bs)]]
    acts = []
    y, x_last = train_decode_reference(leaves[0], *unflatten_params(st, leaves[1:]), 3, st,
                                       acts=acts)
    rng = np.random.RandomState(4)
    dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    dx_last = torch.from_numpy(rng.randn(*x_last.shape).astype(np.float32))
    auto = torch.autograd.grad((y, x_last), leaves, (dy, dx_last))
    with torch.no_grad():
        demb, dws, dxs, dbs = train_decode_backward_reference(
            leaves[0], *unflatten_params(st, leaves[1:]), st, y, acts, dy, dx_last)
        base = train_decode_backward_reference(
            leaves[0], *unflatten_params(st, leaves[1:]), st, y, acts, dy)
    plain = [demb, *flatten_params(dws, dxs, dbs)]
    assert x_last is acts[-1] and x_last.shape == (emb.shape[0], 64)
    for a, p in zip(auto, plain):
        scale = float(a.abs().max()) + 1e-12
        np.testing.assert_allclose(p.numpy() / scale, a.numpy() / scale, atol=1e-5, rtol=0)
    assert float((base[0] - demb).abs().max()) > 1e-3  # dx_last reaches d(emb)


def test_trajectory_with_the_classifier_matches_jax():
    """Three steps of each package's train step on a --cls spec, epochs 1-3
    crossing AdditionalLossStart 3: the cross-entropy is 0 before and on
    after, and every loss term agrees with JAX's to 1e-4 relative (1e-6
    abs); after 3 steps the classifier head and the hand trunk's parameters
    agree to 1e-3, as the flagship's trajectory test holds them."""
    spec = dict(TRAJ_SPECS, ClassifierBranch=True)
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair(spec)
    for trunk, name in (("hand", "linh4"), ("obj", "lino4")):
        bias = variables["params"]["decoder"][trunk][name]["bias"]
        variables["params"]["decoder"][trunk][name]["bias"] = np.zeros_like(bias)
        getattr(pmodel.decoder, name).bias.data.zero_()
    opt = jax_train_state.make_optimizer(jspecs)
    override = make_fused_train_decoder_factored(jspecs, interpret=True)
    jstep = jax.jit(jax_train_step.make_train_step(jmodel, jspecs, opt, override))
    jstate = jax_train_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        consts=variables.get("consts", {}), opt_state=opt.init(variables["params"]),
        epoch=jnp.asarray(1, jnp.int32))
    pstate = TrainState(pmodel, make_optimizer(pspecs, pmodel.parameters()))
    pstep = make_train_step(pspecs)
    cls = []
    for i in range(3):
        batch = synthetic_train_batch(pspecs, batch_size=2, seed=i)
        key = jax.random.PRNGKey(i)
        seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
        jstate = jstate.replace(epoch=jnp.asarray(i + 1, jnp.int32))
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        pstate.epoch = i + 1
        pl = pstep(pstate, batch_to_device(batch, "cpu"), seed)
        assert set(jl) == set(pl)
        for k in jl:
            np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        cls.append(float(pl["cls"]))
    assert cls[0] == cls[1] == 0 and cls[2] > 0
    ref = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats), pspecs)
    state = pmodel.state_dict()
    for k in ("decoder.classifier_head.weight", "decoder.classifier_head.bias",
              "decoder.linh4.weight", "decoder.linh3.weight_v"):
        np.testing.assert_allclose(state[k].numpy(), ref[k].numpy(), atol=1e-3, rtol=0, err_msg=k)
