"""Kernel K4's plain version against the JAX package's pixel train kernel
(``make_fused_train_decoder_pixel``) in interpret mode: the Keys cubic's
derivative, the forward at train=False and train=True (the same hash gates,
the object trunk hashing layer + n_layers; the classifier's logits through
``x_last``), the gradients of every weight-norm parameter and bias, of the
classifier head, the feature map, the embedding and the predicted hand root
under an SDF + cross-entropy loss (so ``dx_last`` is live), and the plain
backward from residuals, ``dx_last`` included, against autograd; for the
twin trunks and the one combined trunk.

Shapes follow ``tests/test_decoder_train_pixel.py``: an 8 x 8 map of 32
channels, 2 scenes x 96 points, block 48 so that each scene spans two of the
TPU kernel's grid blocks, and the classifier on (6 classes), as there.
"""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.ops.decoder_train_kernel import _dropout_gate
from alignsdf_tpu.ops.decoder_train_pixel import _keys_cubic_grad, make_fused_train_decoder_pixel
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import decoder_from_jax
from alignsdf_torch.kernels.pixel_train_decoder import (
    flatten_pixel_params,
    pixel_train_decode,
    pixel_train_decode_backward,
    pixel_train_decode_backward_reference,
    pixel_train_decode_reference,
    sample_latent,
    unflatten_pixel_params,
)
from alignsdf_torch.kernels.train_decoder import dropout_gate
from alignsdf_torch.models.decoder import make_decoder
from alignsdf_torch.ops.geometry import keys_cubic_grad
from alignsdf_torch.ops.pixel_train_plan import (
    make_pixel_train_decoder,
    pixel_train_inputs,
    pixel_trunks,
)

B, N, HF, WF, LS, PFS = 2, 96, 8, 8, 32, 9
NS = dict(dims=(96, 96, 96, 96), dropout=(0, 1, 2, 3), dropout_prob=0.2,
          norm_layers=(0, 1, 2, 3), latent_in=(2,))
SPEC = dict(encode_style="both", point_feat_size=PFS, latent_size=LS, pixel_align=True,
            samples_per_scene=N, sdf_scale_factor=7.0186, image_size=(64, 64),
            classifier_branch=True)
# chosen so that no hidden pre-activation of the grads test lies within
# float32 rounding of zero (see _relu_margin)
DATA_SEED = 0


def _data(seed):
    """The JAX test's inputs: an NHWC map, embedding, points spread so that
    part of them project out of the image, camera and predicted root; and
    the points' part labels (-1 = none) for the cross-entropy."""
    rng = np.random.RandomState(seed)
    fmap = (rng.randn(B, HF, WF, LS) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    xyz = (rng.randn(B * N, 3) * 1.5).astype(np.float32)
    cam = np.zeros((B, 3, 4), np.float32)
    cam[:, 0, 0] = cam[:, 1, 1] = 80.0
    cam[:, 0, 2] = cam[:, 1, 2] = 32.0
    cam[:, 2, 2] = 1.0
    root = np.tile(np.asarray([0.02, -0.01, 0.55], np.float32), (B, 1, 1))
    labels = rng.randint(-1, 6, B * N)
    return fmap, emb, xyz, cam, root, labels


@pytest.fixture(scope="module", params=["1encoder2decoder", "1encoder1decoder"])
def pair(request):
    model_type = request.param
    jspecs = JaxSpecs(model_type=model_type, network_specs=JaxNetworkSpecs(**NS), **SPEC)
    pspecs = Specs(model_type=model_type, network_specs=NetworkSpecs(**NS), **SPEC)
    jdec = jax_make_decoder(model_type, LS, PFS, "both", jspecs.network_specs, True)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(0), jnp.zeros((8, LS + PFS)))["params"])
    fused = make_fused_train_decoder_pixel(jspecs, interpret=True, block_cap=48)
    assert fused is not None and fused.pixel and fused.block == 48  # 2 blocks a scene
    pdec = make_decoder(model_type, LS, PFS, "both", pspecs.network_specs, use_classifier=True)
    pdec.load_state_dict(decoder_from_jax(params))
    decode = make_pixel_train_decoder(pspecs)
    assert decode is not None and decode.pixel
    return params, fused, pdec, decode, pspecs, _data(DATA_SEED)


def _port(data):
    """The decoder's inputs as the port takes them: the map NCHW."""
    fmap, emb, xyz, cam, root = (torch.from_numpy(a) for a in data[:5])
    return fmap.permute(0, 3, 1, 2).contiguous(), emb, xyz, cam, root


def _ce_jax(logits, labels):
    valid = labels >= 0
    lp = jax.nn.log_softmax(logits, axis=-1)[jnp.arange(len(labels)), jnp.maximum(labels, 0)]
    return -jnp.sum(jnp.where(valid, lp, 0.0)) / jnp.sum(valid)


def _ce_port(logits, labels):
    valid = labels >= 0
    lp = torch.log_softmax(logits, dim=-1)[torch.arange(len(labels)), labels.clamp(min=0)]
    return -torch.sum(torch.where(valid, lp, torch.zeros_like(lp))) / valid.sum()


def _trunks(pdec, specs, c, double=False):
    return pixel_trunks(copy.deepcopy(pdec).double() if double else pdec, specs, c)


def _inputs(data, specs, double=False):
    """(table, mean, xp, yp, mask, emb) of the plan, from the data."""
    fmap, emb, xyz, cam, root = _port(data)
    out = (*pixel_train_inputs(fmap, xyz, cam, root, specs), emb)
    return tuple(t.double() for t in out) if double else out


def _relu_margin(pdec, decode, specs, data, seed, train) -> float:
    """The smallest |pre-activation| of any hidden unit of either trunk, in
    float64 on the float32 projection.  Where one lies within float32
    rounding of zero, the JAX kernel and the port may put it on either side
    of ReLU, and that row's gradients then differ by up to ~1e-3 of the
    largest entry."""
    table, mean, xp, yp, mask, emb = _inputs(data, specs, double=True)
    st = decode.statics._replace(feat_hw=(HF, WF), train=train)
    lat = sample_latent(table, mean, xp, yp, mask, st)
    rows = torch.arange(emb.shape[0])
    margin = float("inf")
    with torch.no_grad():
        for (ws, lats, xs, bs), off in zip(_trunks(pdec, specs, LS, double=True),
                                           st.layer_offsets):
            x = None
            for layer in range(len(bs) - 1):
                acc = bs[layer]
                if ws[layer] is not None:
                    acc = acc + x @ ws[layer]
                if lats[layer] is not None:
                    acc = acc + lat @ lats[layer] + emb @ xs[layer]
                margin = min(margin, float(acc.abs().min()))
                x = torch.relu(acc)
                if train and st.dropout[layer]:
                    x = x * dropout_gate(seed, layer + off, rows, x.shape[1], st.keep).double()
    return margin


def test_keys_cubic_grad_matches_jax():
    t = np.concatenate([np.linspace(-2.5, 2.5, 1001), [-2, -1, 0, 1, 2, -1.0 + 1e-7]])
    t = t.astype(np.float32)
    np.testing.assert_allclose(keys_cubic_grad(torch.from_numpy(t)).numpy(),
                               np.asarray(_keys_cubic_grad(jnp.asarray(t))), atol=1e-6, rtol=0)


def test_fixture_projects_partly_into_the_image(pair):
    """Both the taps and the mean fallback run: the in-image share lies
    strictly between 0 and 1, in each scene."""
    *_, specs, data = pair
    mask = _inputs(data, specs)[4].reshape(B, N)
    share = mask.mean(dim=1)
    assert bool(((share > 0) & (share < 1)).all()), share


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(pair, train):
    """y and the logits (x_last @ cw + cb) to 2e-6 abs: both sides sample
    the same map and run the same trunks in float32, with the same hash
    gates."""
    params, fused, pdec, decode, _, data = pair
    fmap, emb, xyz, cam, root, _ = data
    h1, o1, c1 = fused(params, jnp.asarray(fmap), jnp.asarray(emb), jnp.asarray(xyz),
                       jnp.asarray(cam), jnp.asarray(root), jnp.int32(7), train=train)
    before = pixel_train_decode.launches
    with torch.no_grad():
        h2, o2, c2 = decode(pdec, *_port(data), 7, train)
    assert pixel_train_decode.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(h2.numpy(), np.asarray(h1), atol=2e-6, rtol=0)
    np.testing.assert_allclose(o2.numpy(), np.asarray(o1), atol=2e-6, rtol=0)
    assert c2.shape == (B * N, 6) and float(c2.std()) > 1e-3
    np.testing.assert_allclose(c2.numpy(), np.asarray(c1), atol=2e-6, rtol=0)
    if train:  # dropout is live: the field moves against eval
        h0, _, _ = fused(params, jnp.asarray(fmap), jnp.asarray(emb), jnp.asarray(xyz),
                         jnp.asarray(cam), jnp.asarray(root), jnp.int32(7), train=False)
        assert float(np.abs(np.asarray(h0) - h2.numpy()).max()) > 1e-4


@pytest.mark.parametrize("train", [False, True])
def test_grads_match_jax(pair, train):
    """Every weight_v, weight_g and bias, the classifier head, the feature
    map, the embedding and the predicted root, to 2e-5 of the largest
    gradient of each, under an SDF + cross-entropy loss: the logits' gradient
    enters K4's backward as dx_last, as JAX's custom VJP takes it."""
    params, fused, pdec, decode, specs, data = pair
    assert _relu_margin(pdec, decode, specs, data, 11, train) > 2e-7
    fmap, emb, xyz, cam, root, labels = data

    def loss(p, fm, e, r):
        h, o, c = fused(p, fm, e, jnp.asarray(xyz), jnp.asarray(cam), r, jnp.int32(11),
                        train=train)
        return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + 50.0 * _ce_jax(c, jnp.asarray(labels))

    gp, gf, ge, gr = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(fmap), jnp.asarray(emb),
        jnp.asarray(root))

    fmap_t, emb_t, xyz_t, cam_t, root_t = _port(data)
    leaves = [t.requires_grad_() for t in (fmap_t, emb_t, root_t)]
    pdec.zero_grad()
    h, o, c = decode(pdec, fmap_t, emb_t, xyz_t, cam_t, root_t, 11, train)
    (torch.sum(torch.sin(h)) + torch.sum(o ** 2)
     + 50.0 * _ce_port(c, torch.from_numpy(labels))).backward()

    def close(port, ref):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max()) + 1e-8
        np.testing.assert_allclose(port / scale, ref / scale, atol=2e-5, rtol=0)

    close(leaves[0].grad.numpy(), np.asarray(gf).transpose(0, 3, 1, 2))
    close(leaves[1].grad.numpy(), ge)
    close(leaves[2].grad.numpy(), gr)
    assert float(np.abs(np.asarray(gr)).max()) > 1e-6  # d(pix) reaches the root
    count = 0
    for trunk in gp.values():
        for name, g in trunk.items():
            layer = getattr(pdec, name)
            if "v" in g:
                close(layer.weight_v.grad.numpy().T, g["v"])
                close(layer.weight_g.grad.numpy().reshape(-1), g["g"])
            else:  # the last layer is a plain Linear (norm_layers 0-3)
                close(layer.weight.grad.numpy().T, g["kernel"])
            close(layer.bias.grad.numpy(), g["bias"])
            count += 1
    assert count == 5 * len(gp) + 1  # the trunks' layers and the classifier head


@pytest.mark.parametrize("train", [False, True])
def test_plain_backward_matches_autograd(pair, train):
    """The plain version of K4's backward, fed the forward's own y, gated
    activations and latent (the kernel's contract), dy and a nonzero
    dx_last, against autograd through the plain forward with y and x_last
    in the loss: every gradient to 1e-5 of its largest entry; dx_last
    reaches d(table)."""
    _, _, pdec, decode, specs, data = pair
    st = decode.statics._replace(feat_hw=(HF, WF), train=train)
    with torch.no_grad():
        trunks = _trunks(pdec, specs, LS)
    table, mean, xp, yp, mask, emb = _inputs(data, specs)
    leaves = [t.detach().clone().requires_grad_()
              for t in (table, mean, xp, yp, emb, *flatten_pixel_params(trunks))]
    table_l, mean_l, xp_l, yp_l, emb_l = leaves[:5]
    params = unflatten_pixel_params(st, leaves[5:])
    acts, latent = [], []
    y, x_last = pixel_train_decode_reference(table_l, mean_l, xp_l, yp_l, mask, emb_l, params,
                                             3, st, acts=acts, latent=latent)
    assert x_last is acts[0][-1] and x_last.shape == (B * N, 96)
    rng = np.random.RandomState(4)
    dy = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    dx_last = torch.from_numpy(rng.randn(*x_last.shape).astype(np.float32))
    auto = torch.autograd.grad((y, x_last), leaves, (dy, dx_last))
    with torch.no_grad():
        dtable, dmean, dxp, dyp, demb, grads = pixel_train_decode_backward_reference(
            table_l, mean_l, xp_l, yp_l, mask, emb_l, params, st, y, acts, latent[0], dy,
            dx_last)
        without = pixel_train_decode_backward_reference(
            table_l, mean_l, xp_l, yp_l, mask, emb_l, params, st, y, acts, latent[0], dy)
    plain = [dtable, dmean, dxp, dyp, demb, *flatten_pixel_params(grads)]
    assert len(plain) == len(auto) == 5 + len(trunks) * (4 + 2 + 2 + 5)
    for a, p in zip(auto, plain):
        scale = float(a.abs().max()) + 1e-12
        np.testing.assert_allclose(p.numpy() / scale, a.numpy() / scale, atol=1e-5, rtol=0)
    assert float(dmean.abs().max()) > 0 and float(dxp.abs().max()) > 0
    assert float((without[0] - dtable).abs().max()) > 1e-3  # dx_last reaches d(table)


@pytest.mark.parametrize("seed", [3, 2 ** 31 - 2])
def test_object_trunk_gates_match_jax(seed):
    """The object trunk hashes layer + n_layers, as the TPU kernel's
    ``_trunk_forward(..., static.n_layers)``; rows are the points' global
    rows (block index x 48 + row in the block)."""
    specs = Specs(model_type="1encoder2decoder", network_specs=NetworkSpecs(**NS), **SPEC)
    st = make_pixel_train_decoder(specs).statics
    n_layers = len(NS["dims"]) + 1
    assert st.layer_offsets == (0, n_layers)
    for layer in range(4):
        for block_idx in (0, 1, 3):
            g_jax = np.asarray(_dropout_gate(jnp.int32(seed), layer + n_layers, 48, 96, st.keep,
                                             jnp.int32(block_idx)))
            rows = torch.arange(48 * block_idx, 48 * (block_idx + 1))
            g_port = dropout_gate(seed, layer + st.layer_offsets[1], rows, 96, st.keep)
            np.testing.assert_array_equal(g_port.numpy(), g_jax)


def test_statics_and_refusals():
    """K4's plan follows the flagship structure and declines what the kernel
    does not take (a latent input at the final layer it takes, as JAX's
    kernel does); a classifier spec takes it (x_last feeds the head); no
    backward launch happened on the CPU."""
    specs = Specs(network_specs=NetworkSpecs(), **dict(SPEC, samples_per_scene=2000))
    st = make_pixel_train_decoder(specs).statics
    assert st.has_x == (True, False, True, False, False)
    assert st.has_w == (False, True, True, True, True) and st.dropout == (True,) * 4
    assert abs(st.keep - 0.8) < 1e-12 and st.n_per_scene == 2000
    for kw in (dict(pixel_align=False),
               dict(network_specs=NetworkSpecs(latent_in=(0,))),
               dict(network_specs=NetworkSpecs(weight_norm=False))):
        assert make_pixel_train_decoder(Specs(**{**dict(SPEC, network_specs=NetworkSpecs()),
                                                 **kw})) is None
    last = make_pixel_train_decoder(Specs(**dict(SPEC, network_specs=NetworkSpecs(
        latent_in=(4,)))))
    assert last.statics.has_x == (True, False, False, False, True)
    plain = make_pixel_train_decoder(Specs(**dict(SPEC, network_specs=NetworkSpecs(),
                                                  samples_per_scene=2000,
                                                  classifier_branch=False)))
    assert plain.statics == st  # the classifier reads x_last; K4's structure is the same
    assert pixel_train_decode_backward.launches == 0
