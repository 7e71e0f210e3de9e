"""Kernel K5's plain version (the generic train decoder on materialized
[latent, embedding] rows) against the JAX package's ``fused_branch`` and its
custom VJP in interpret mode (``make_fused_train_decoder(specs, block=128,
interpret=True)``): the forward with dropout on and every gradient, the
rows' (d(x0), which carries the latent's and the embedding's) and every
weight-norm parameter's, bias's and classifier weight's, under a loss that
reads the logits (so dx_last enters the backward), at latent_in (2,) and
(0, 2), twin and combined trunks.  Then one train step of the port through
K5's plain version against JAX's step with K5 as its override, at latent_in
(0, 2), and the route: K5 takes exactly the specs with 0 in latent_in, flat
or pixel-aligned.

Tolerances: y and the logits 2e-6 abs (both sides run the same trunk in
float32; the port sums layer 0's two halves before its product, JAX after),
gradients 1e-4 of their largest entry.  The data seed is chosen so that no
hidden pre-activation lies within 2e-7 of zero (``_relu_margin``)."""

import copy
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.torch_import import convert_combined_decoder, convert_separate_decoder
from alignsdf_tpu.ops.decoder_train_kernel import make_fused_train_decoder
from alignsdf_tpu.training import train_state as jax_train_state
from alignsdf_tpu.training import train_step as jax_train_step
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import from_jax
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.kernels.generic_train_decoder import (
    generic_train_decode,
    generic_train_decode_backward,
)
from alignsdf_torch.kernels.train_decoder import dropout_gate
from alignsdf_torch.models.decoder import make_decoder, separate_decoder_inputs, trunk_prefixes
from alignsdf_torch.ops.decoder_plan import trunk_input_widths
from alignsdf_torch.ops.generic_train_plan import generic_trunk_operands, make_generic_train_decoder
from alignsdf_torch.training.train_state import TrainState, make_optimizer
from alignsdf_torch.training.train_step import batch_to_device, make_train_step, train_decoder_kind

import torch_parity
from test_torch_pixel_train import _keeping_grads
from test_torch_train import TRAJ_SPECS

M, LS, PFS = 256, 32, 9
DIMS = (64, 64, 64, 64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _specs(model_type, latent_in):
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=PFS, latent_size=LS,
              classifier_branch=True)
    ns = dict(dims=DIMS, dropout=(0, 1, 2, 3), dropout_prob=0.2, norm_layers=(0, 1, 2, 3),
              latent_in=latent_in)
    return (JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw),
            Specs(network_specs=NetworkSpecs(**ns), **kw))


def _relu_margin(pdec, specs, rows, seed) -> float:
    """The smallest |pre-activation| of any hidden unit of either trunk in
    training, in float64.  Where one lies within float32 rounding of zero,
    JAX's kernel and the port may put it on either side of ReLU, and that
    row's gradients differ by up to ~1e-3 of the largest entry."""
    dec = copy.deepcopy(pdec).double()
    st = make_generic_train_decoder(specs).statics
    first, second = trunk_prefixes(dec)
    widths = trunk_input_widths(specs)
    x = torch.from_numpy(rows).double()
    inputs = ([x] if second is None
              else list(separate_decoder_inputs(specs.latent_size, specs.encode_style, x)))
    out_dim = 2 if second is None else 1
    m = torch.arange(x.shape[0])
    margin = float("inf")
    with torch.no_grad():
        for t, (prefix, x0) in enumerate(zip((first, second), inputs)):
            ws, xs, bs = generic_trunk_operands(dec, prefix, widths[t], specs, out_dim)
            a = None
            for layer in range(len(bs) - 1):
                acc = bs[layer] + (x0 @ xs[layer] if xs[layer] is not None else 0.0)
                if ws[layer] is not None:
                    acc = acc + a @ ws[layer]
                margin = min(margin, float(acc.abs().min()))
                a = torch.relu(acc) * dropout_gate(seed + t, layer, m, acc.shape[1],
                                                   st.keep).double()
    return margin


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
@pytest.mark.parametrize("latent_in", [(2,), (0, 2)])
def test_plain_k5_matches_jax_fused_branch(model_type, latent_in):
    """Forward (dropout on) and every gradient under sum(sin(h)) + sum(o^2)
    + <logits, R>: the rows', each weight-norm v and g, bias, and the
    classifier head's."""
    jspecs, pspecs = _specs(model_type, latent_in)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        pdec = make_decoder(model_type, LS, PFS, "both", pspecs.network_specs, use_classifier=True)
    rng = np.random.RandomState(8)  # the smallest margin of the four cases: 8.3e-7
    rows = (rng.randn(M, LS + PFS) * 0.5).astype(np.float32)
    proj = rng.randn(M, 6).astype(np.float32)
    seed = 11
    assert _relu_margin(pdec, pspecs, rows, seed) > 2e-7
    convert = convert_combined_decoder if model_type == "1encoder1decoder" else convert_separate_decoder
    params = jax.tree_util.tree_map(jnp.asarray, convert(pdec.state_dict(), jspecs.network_specs,
                                                         True))
    fused = make_fused_train_decoder(jspecs, block=128, interpret=True)

    def jax_loss(p, x):
        h, o, c = fused(p, x, jnp.int32(seed), train=True)
        return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + jnp.sum(c * proj), (h, o, c)

    (_, (j_h, j_o, j_c)), (gp, gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(rows))

    decode = make_generic_train_decoder(pspecs)
    x = torch.from_numpy(rows).requires_grad_()
    launches = generic_train_decode.launches, generic_train_decode_backward.launches
    h, o, c = decode(pdec, x, seed, train=True)
    (torch.sum(torch.sin(h)) + torch.sum(o ** 2) + torch.sum(c * torch.from_numpy(proj))).backward()
    assert (generic_train_decode.launches, generic_train_decode_backward.launches) == launches
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(j_h)[:, 0], atol=2e-6, rtol=0)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(j_o)[:, 0], atol=2e-6, rtol=0)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(j_c), atol=2e-6, rtol=0)

    def close(port, ref, name):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max()) + 1e-8
        np.testing.assert_allclose(port / scale, ref / scale, atol=1e-4, rtol=0, err_msg=name)

    close(x.grad.numpy(), gx, "rows")
    count = 0
    for trunk in gp.values():
        for name, g in trunk.items():
            layer = getattr(pdec, name)
            if "v" in g:
                close(layer.weight_v.grad.numpy().T, g["v"], name + ".v")
                close(layer.weight_g.grad.numpy().reshape(-1), g["g"], name + ".g")
            else:  # the last layer and the classifier head are plain Linears
                close(layer.weight.grad.numpy().T, g["kernel"], name + ".kernel")
            close(layer.bias.grad.numpy(), g["bias"], name + ".bias")
            count += 1
    assert count == 5 * len(gp) + 1
    assert float(np.abs(np.asarray(gp[next(iter(gp))]["classifier_head"]["kernel"])).max()) > 0


def test_k5_train_step_matches_jax():
    """One train step of the narrow flagship with latent_in (0, 2) (64-pixel
    images, which the flat spec's losses allow) from the same weights, batch
    and dropout seed: the port's step routes to K5 (its
    plain version on the CPU) on decoder_inputs' rows, JAX's runs its K5
    override on its materialized rows.  Every loss term to 1e-4 relative
    (1e-6 abs) and every decoder gradient to 1e-4 of its largest entry."""
    spec = dict(TRAJ_SPECS, ImageSize=[64, 64],
                NetworkSpecs=dict(TRAJ_SPECS["NetworkSpecs"], latent_in=[0, 2]))
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair_from_port(spec)
    # final biases at 0 put the predictions inside the clamp band, so the
    # SDF losses carry gradient into the trunks
    for trunk, name in (("hand", "linh4"), ("obj", "lino4")):
        bias = variables["params"]["decoder"][trunk][name]["bias"]
        variables["params"]["decoder"][trunk][name]["bias"] = np.zeros_like(bias)
        getattr(pmodel.decoder, name).bias.data.zero_()
    opt = _keeping_grads(jax_train_state.make_optimizer(jspecs))
    override = make_fused_train_decoder(jspecs, block=128, interpret=True)
    jstep = jax.jit(jax_train_step.make_train_step(jmodel, jspecs, opt, override))
    jstate = jax_train_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        consts=variables.get("consts", {}), opt_state=opt.init(variables["params"]),
        epoch=jnp.asarray(1, jnp.int32))
    batch = synthetic_train_batch(pspecs, batch_size=2, seed=0)
    key = jax.random.PRNGKey(0)
    seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
    jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    pstate = TrainState(pmodel, make_optimizer(pspecs, pmodel.parameters()))
    pstep = make_train_step(pspecs)
    assert train_decoder_kind(pstep.decode) == "materialized inputs (K5)"
    pl = pstep(pstate, batch_to_device(batch, "cpu"), seed)
    assert set(jl) == set(pl)
    for k in jl:
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    jg = from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state[1]),
                  jax.tree_util.tree_map(np.asarray, jstate.batch_stats), pspecs)
    names = [k for k, _ in pmodel.named_parameters() if k.startswith("decoder.")]
    assert len(names) == 2 * (4 * 3 + 2)
    params = dict(pmodel.named_parameters())
    for k in names:
        g, ref = params[k].grad, jg[k]
        scale = float(ref.abs().max()) + 1e-30
        assert float((g - ref).abs().max()) <= 1e-4 * scale, k
    assert float(params["decoder.linh0.weight_v"].grad.abs().max()) > 0


def test_route_takes_k5_for_layer_0_and_k2_or_k4_for_the_last_layer():
    """0 in latent_in: K2 and K4 decline, the step runs K5, flat or
    pixel-aligned; a latent input only at the last layer routes as JAX's
    CLI routes it, to K2 (K4 pixel-aligned), though K5 takes it too; the
    flagship keeps K2 and --pa_feat keeps K4."""
    base = Specs(encode_style="both", point_feat_size=9, mano_branch=True,
                 object_pose_branch=True, network_specs=NetworkSpecs())
    kinds = {}
    for name, specs in (("flat", base), ("pixel", dataclasses.replace(base, pixel_align=True))):
        kinds[name] = train_decoder_kind(make_train_step(specs).decode)
        zero = dataclasses.replace(specs, network_specs=NetworkSpecs(latent_in=(0, 2)))
        kinds[name + " (0, 2)"] = train_decoder_kind(make_train_step(zero).decode)
    assert kinds == {"flat": "scene-factored (K2)", "flat (0, 2)": "materialized inputs (K5)",
                     "pixel": "pixel-aligned (K4)", "pixel (0, 2)": "materialized inputs (K5)"}
    last = dataclasses.replace(base, network_specs=NetworkSpecs(latent_in=(4,)))
    assert train_decoder_kind(make_train_step(last).decode) == "scene-factored (K2)"
    pixel_last = dataclasses.replace(last, pixel_align=True)
    assert train_decoder_kind(make_train_step(pixel_last).decode) == "pixel-aligned (K4)"
    assert make_generic_train_decoder(last).statics.has_x[-1]
    assert generic_train_decode_backward.launches == 0
