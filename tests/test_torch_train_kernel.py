"""Kernel K2's plain version against the JAX package's scene-factored Pallas
kernel in interpret mode: the dropout gate bit for bit, the forward at
train=False and train=True, and the gradients of every weight-norm
parameter, bias, the latent and the embedding; for the twin trunks
(1encoder2decoder) and for the one combined trunk with two outputs
(1encoder1decoder).

The oracle at train=True is ``make_fused_train_decoder_factored``, not the
XLA decoder: the kernel's dropout stream is its own hash, not the XLA
decoder's jax.random masks.  That factory declines per-scene point counts
without a multiple-of-16 block >= 128, hence N = 256.
"""

import copy
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.ops.decoder_train_kernel import (
    _dropout_gate,
    make_fused_train_decoder_factored,
)
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import decoder_from_jax
from alignsdf_torch.kernels.train_decoder import (
    dropout_gate,
    flatten_params,
    gate_threshold,
    train_decode,
    train_decode_backward,
    train_decode_backward_reference,
    train_decode_reference,
    unflatten_params,
)
from alignsdf_torch.models.decoder import make_decoder, trunk_prefixes
from alignsdf_torch.ops.grid_plan import branch_columns
from alignsdf_torch.ops.train_plan import make_train_decoder, trunk_operands

B, N, LS, PFS = 3, 256, 64, 9
DIMS = (128, 128, 128, 128)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 2])
def test_gate_matches_jax_bit_for_bit(seed):
    """Layers 0-3, rows across four 128-row blocks (block indices 0, 1, 5
    and 17), 250 lanes: the same kept units and the same 1/keep value."""
    keep, blk, width = 0.8, 128, 250
    for layer in range(4):
        for block_idx in (0, 1, 5, 17):
            g_jax = np.asarray(_dropout_gate(jnp.int32(seed), layer, blk, width, keep,
                                             jnp.int32(block_idx)))
            rows = torch.arange(blk * block_idx, blk * (block_idx + 1))
            g_port = dropout_gate(seed, layer, rows, width, keep).numpy()
            np.testing.assert_array_equal(g_port, g_jax)
    assert gate_threshold(0.8) == 3435973837
    assert abs(float((g_port > 0).mean()) - keep) < 0.05


@pytest.fixture(scope="module", params=["1encoder2decoder", "1encoder1decoder"])
def pair(request):
    """Twin trunks, and the one combined trunk with two outputs."""
    model_type = request.param
    ns = dict(dims=DIMS, dropout=(0, 1, 2, 3), dropout_prob=0.2,
              norm_layers=(0, 1, 2, 3), latent_in=(2,))
    jspecs = JaxSpecs(model_type=model_type, encode_style="both",
                      point_feat_size=PFS, latent_size=LS, samples_per_scene=N,
                      network_specs=JaxNetworkSpecs(**ns))
    pspecs = Specs(model_type=model_type, encode_style="both", point_feat_size=PFS,
                   latent_size=LS, samples_per_scene=N, network_specs=NetworkSpecs(**ns))
    # seeded so that no hidden pre-activation of the grads test lies within
    # float32 rounding of zero (see _relu_margin)
    rng = np.random.RandomState(2)
    latent = (rng.randn(B, LS) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    jdec = jax_make_decoder(jspecs.model_type, LS, PFS, "both", jspecs.network_specs, False)
    x = np.concatenate([np.repeat(latent, N, axis=0), emb], axis=1)
    params = jax.tree_util.tree_map(np.asarray,
                                    jdec.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    fac = make_fused_train_decoder_factored(jspecs, interpret=True)
    assert fac is not None
    pdec = make_decoder(pspecs.model_type, LS, PFS, "both", pspecs.network_specs)
    pdec.load_state_dict(decoder_from_jax(params))
    decode = make_train_decoder(pspecs)
    assert decode is not None
    return params, fac, pdec, decode, latent, emb, pspecs


def _relu_margin(pdec, specs, latent, emb, seed, train) -> float:
    """The smallest |pre-activation| of any hidden unit of either trunk, in
    float64.  Where one lies within float32 rounding of zero, the JAX kernel
    and the port may put it on either side of ReLU, and that row's
    gradients then differ by up to ~1e-3 of the largest entry (seen at
    3e-8 with RandomState(0) on the combined trunk)."""
    dec = copy.deepcopy(pdec).double()
    st = make_train_decoder(specs).statics
    first, second = trunk_prefixes(dec)
    cols_h, cols_o = branch_columns(specs)
    rows = torch.arange(emb.shape[0])
    trunks = [(first, cols_h, seed, 1 if second else 2)] + ([(second, cols_o, seed + 1, 1)]
                                                            if second else [])
    margin = float("inf")
    with torch.no_grad():
        for prefix, cols, s, out_dim in trunks:
            ws, xs, bs = trunk_operands(dec, prefix, len(cols),
                                        torch.from_numpy(latent).double(), specs, out_dim)
            e = torch.from_numpy(emb).double()[:, list(cols)]
            x = None
            for layer in range(len(bs) - 1):
                acc = bs[layer][rows // st.n_per_scene] if st.scene_bias[layer] else bs[layer]
                if xs[layer] is not None:
                    acc = acc + e @ xs[layer]
                if ws[layer] is not None:
                    acc = acc + x @ ws[layer]
                margin = min(margin, float(acc.abs().min()))
                x = torch.relu(acc)
                if train and st.dropout[layer]:
                    x = x * dropout_gate(s, layer, rows, x.shape[1], st.keep).double()
    return margin


def _loss_jax(h, o):
    return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2)


def _loss_port(h, o):
    return torch.sum(torch.sin(h)) + torch.sum(o ** 2)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_factored_pallas(pair, train):
    """y to 2e-6 abs: both sides run the same folded trunk in float32."""
    params, fac, pdec, decode, latent, emb, _ = pair
    h1, o1, _ = fac(params, jnp.asarray(latent), jnp.asarray(emb), jnp.int32(7), train=train)
    before = train_decode.launches
    with torch.no_grad():
        h2, o2, _ = decode(pdec, torch.from_numpy(latent), torch.from_numpy(emb), 7, train)
    assert train_decode.launches == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(h2.numpy(), np.asarray(h1), atol=2e-6, rtol=0)
    np.testing.assert_allclose(o2.numpy(), np.asarray(o1), atol=2e-6, rtol=0)
    if train:  # dropout is live: the field moves against eval
        h0, _, _ = fac(params, jnp.asarray(latent), jnp.asarray(emb), jnp.int32(7), train=False)
        assert float(np.abs(np.asarray(h0) - h2.numpy()).max()) > 1e-4


@pytest.mark.parametrize("train", [False, True])
def test_grads_match_factored_pallas(pair, train):
    """Every weight_v, weight_g and bias, the latent and the embedding, to
    1e-4 of the largest gradient of its array."""
    params, fac, pdec, decode, latent, emb, specs = pair
    assert _relu_margin(pdec, specs, latent, emb, 11, train) > 2e-7

    def loss(p, lat, e):
        h, o, _ = fac(p, lat, e, jnp.int32(11), train=train)
        return _loss_jax(h, o)

    gp, gl, ge = jax.grad(loss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(latent), jnp.asarray(emb))

    lat_t = torch.from_numpy(latent).requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    pdec.zero_grad()
    h, o, _ = decode(pdec, lat_t, emb_t, 11, train)
    _loss_port(h, o).backward()

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
            else:  # the last layer is a plain Linear (norm_layers 0-3)
                close(layer.weight.grad.numpy().T, g["kernel"])
            close(layer.bias.grad.numpy(), g["bias"])
            count += 1
    assert count == 5 * len(gp)


@pytest.mark.parametrize("train", [False, True])
def test_plain_backward_matches_autograd(pair, train):
    """The plain version of K2's backward, fed the forward's own y and gated
    activations (the kernel's contract), against autograd through the plain
    forward: every gradient to 1e-5 of its largest entry."""
    _, _, pdec, decode, latent, emb, specs = pair
    st = decode.statics._replace(train=train)
    first, second = trunk_prefixes(pdec)
    cols = branch_columns(specs)[1]
    with torch.no_grad():
        ws, xs, bs = trunk_operands(pdec, second or first, len(cols), torch.from_numpy(latent),
                                    specs, 1 if second else 2)
    leaves = [t.detach().clone().requires_grad_()
              for t in [torch.from_numpy(emb)[:, cols], *flatten_params(ws, xs, bs)]]
    acts = []
    y, _ = train_decode_reference(leaves[0], *unflatten_params(st, leaves[1:]), 3, st, acts=acts)
    dy = torch.from_numpy(np.random.RandomState(4).randn(*y.shape).astype(np.float32))
    auto = torch.autograd.grad(y, leaves, dy)
    with torch.no_grad():
        demb, dws, dxs, dbs = train_decode_backward_reference(
            leaves[0], *unflatten_params(st, leaves[1:]), st, y, acts, dy)
    plain = [demb, *flatten_params(dws, dxs, dbs)]
    assert len(plain) == len(auto) == 1 + 4 + 2 + 5
    for a, p in zip(auto, plain):
        scale = float(a.abs().max()) + 1e-12
        np.testing.assert_allclose(p.numpy() / scale, a.numpy() / scale, atol=1e-5, rtol=0)


def test_statics_and_refusals():
    """K2's plan follows the flagship structure, and make_train_decoder
    declines what the kernel does not take (the JAX factory's refusals)."""
    ns = NetworkSpecs()
    specs = Specs(encode_style="both", point_feat_size=9, mano_branch=True,
                  object_pose_branch=True, network_specs=ns)
    st = make_train_decoder(specs).statics
    assert st.has_x == (True, False, True, False, False)
    assert st.scene_bias == st.has_x and st.dropout == (True,) * 4
    assert abs(st.keep - 0.8) < 1e-12 and st.n_per_scene == 2000
    for bad in (dataclasses.replace(specs, network_specs=NetworkSpecs(latent_in=(0,))),
                dataclasses.replace(specs, network_specs=NetworkSpecs(weight_norm=False)),
                dataclasses.replace(specs, pixel_align=True)):
        assert make_train_decoder(bad) is None
    assert train_decode_backward.launches == 0
