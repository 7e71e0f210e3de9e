"""A latent input at the final layer: ``latent_in`` naming index
``len(dims)``, which JAX's train kernels (K2, K4, K5) and its pixel grid
kernel (K3) take.  The port's plans and plain versions against the JAX
package's kernels in interpret mode, on the CPU.

- K2 (latent_in (2, 4)), K4 (the same, pixel-aligned) and K5 (latent_in
  (0, 2, 4)), twin trunks with a classifier: the decoder as the train step
  builds it (the plan, the kernel's plain version, the logits) against
  JAX's ``make_fused_train_decoder_factored``, ``make_fused_train_decoder_pixel``
  and ``make_fused_train_decoder`` under an SDF + classifier loss, with
  dropout on.  In float32: the SDFs and logits to 2e-6 abs, every gradient
  (each parameter's, and the latent's, the map's, the rows', the
  embedding's, the predicted root's) to 1e-4 of its largest entry; the data
  seeds keep every hidden pre-activation more than 2e-7 from zero
  (``_relu_margin``).  In bf16: the bounds of tests/test_torch_bf16_train.py
  and tests/test_torch_bf16_pixel_train.py (the SDFs within TIGHT at >=
  SHARE of the points and LOOSE everywhere, gradients within GRAD_TOL of
  their largest, a cotangent that both sides round to bf16 within one bf16
  step, K2's weight_v of a layer that folds the latent within FOLD_TOL).
- K3's field over a 12^3 grid against JAX's K3 (band=None), the plan's
  final latent weights included: float32 to 5e-5 (tests/test_torch_pixel_
  kernel.py's bound: the sampling's products summed in another order), bf16
  within TIGHT / SHARE / LOOSE (tests/test_torch_bf16.py's).
- One float32 train step of each variant against JAX's step with JAX's
  kernel as its override: every loss term to 1e-4 relative (1e-6 abs) and
  every decoder gradient to 1e-4 of its largest entry.
- The routes: make_train_step and make_trainer take the full-width
  variants in both dtypes, and the reconstructor serves the pixel-aligned
  one on K3.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py's final-latent phase."""

import contextlib
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.torch_import import convert_separate_decoder
from alignsdf_tpu.ops.decoder_kernel import make_fused_pixel_grid_decode_fn
from alignsdf_tpu.ops.decoder_train_kernel import (
    make_fused_train_decoder,
    make_fused_train_decoder_factored,
)
from alignsdf_tpu.ops.decoder_train_pixel import make_fused_train_decoder_pixel
from alignsdf_tpu.training import train_state as jax_train_state
from alignsdf_tpu.training import train_step as jax_train_step
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import from_jax
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.kernels.generic_train_decoder import generic_train_decode_reference
from alignsdf_torch.kernels.grid_decoder import round_to
from alignsdf_torch.kernels.pixel_grid_decoder import pixel_grid_decode_reference, pixel_projection
from alignsdf_torch.kernels.pixel_train_decoder import pixel_train_decode_reference
from alignsdf_torch.kernels.train_decoder import train_decode_reference
from alignsdf_torch.models.decoder import make_decoder, separate_decoder_inputs, trunk_prefixes
from alignsdf_torch.ops.decoder_plan import trunk_input_widths
from alignsdf_torch.ops.generic_train_plan import generic_trunk_operands, make_generic_train_decoder
from alignsdf_torch.ops.grid_plan import branch_columns
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn
from alignsdf_torch.ops.pixel_train_plan import (
    make_pixel_train_decoder,
    pixel_train_inputs,
    pixel_trunks,
)
from alignsdf_torch.ops.train_plan import make_train_decoder, trunk_operands
from alignsdf_torch.training.train_state import TrainState, make_optimizer
from alignsdf_torch.training.train_step import batch_to_device, make_train_step, train_decoder_kind

import test_torch_pixel_train
import test_torch_train
import torch_parity
from test_torch_pixel_kernel import _scene

BF16 = torch.bfloat16
TIGHT = 1e-5        # bf16: the SDFs, port against JAX, at >= SHARE of the points
LOOSE = 2e-3        # ... and everywhere
SHARE = 0.99
GRAD_TOL = 2e-3     # bf16: every gradient, of its largest entry
FOLD_TOL = 2 ** -7  # bf16: K2's weight_v of a layer that folds the latent
B, N, LS, PFS, C, HF, WF = 2, 128, 32, 9, 32, 8, 8
DIMS = (96, 96, 96, 96)
NUM_CLASS = 6
FLAT, FLAT_ZERO = (2, 4), (0, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _specs(latent_in, dtype, pixel=False):
    ns = dict(dims=DIMS, dropout=(0, 1, 2, 3), dropout_prob=0.2, norm_layers=(0, 1, 2, 3),
              latent_in=latent_in)
    kw = dict(model_type="1encoder2decoder", encode_style="both", point_feat_size=PFS,
              latent_size=C if pixel else LS, samples_per_scene=N, classifier_branch=True,
              compute_dtype=dtype, pixel_align=pixel, sdf_scale_factor=7.0186,
              image_size=(64, 64))
    return (JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw),
            Specs(network_specs=NetworkSpecs(**ns), **kw))


def _decoder(pspecs, jspecs, seed=3):
    """The port's seeded twin decoder (the classifier head scaled x20, so
    that dx_last matters) and its JAX params."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        pdec = make_decoder(pspecs.model_type, pspecs.latent_size, PFS, "both",
                            pspecs.network_specs, use_classifier=True)
    with torch.no_grad():
        pdec.classifier_head.weight.mul_(20)
    params = jax.tree_util.tree_map(
        jnp.asarray, convert_separate_decoder(pdec.state_dict(), jspecs.network_specs, True))
    return pdec, params


@contextlib.contextmanager
def _relu_margin():
    """Record the smallest |pre-activation| that the plain versions hand to
    ReLU.  Where one lies within float32 rounding of zero, JAX's kernel and
    the port may put it on either side, and that row's gradients then differ
    by up to ~1e-3 of the largest entry."""
    seen = []
    relu = torch.relu

    def spy(x):
        seen.append(float(x.detach().abs().min()))
        return relu(x)

    torch.relu = spy
    try:
        yield seen
    finally:
        torch.relu = relu


def _close(port, ref, name, tol):
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) + 1e-12
    err = float(np.abs(np.asarray(port, np.float64) - ref).max()) / scale
    assert err <= tol, (name, err)


def _close_mostly(got, want, name):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    share = float((err <= TIGHT).mean())
    assert share >= SHARE, (name, share, float(err.max()))
    assert float(err.max()) <= LOOSE, (name, float(err.max()))


def _close_bf16(port, ref, name):
    """A cotangent that both sides round to bf16: each entry within one bf16
    step of JAX's beyond GRAD_TOL of the largest."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    slack = 2.0 ** -7 * np.maximum(np.abs(port), np.abs(ref))
    excess = float((np.abs(port - ref) - slack).max()) / (float(np.abs(ref).max()) + 1e-12)
    assert excess <= GRAD_TOL, (name, excess)


def _check_outputs(dtype, port, ref):
    """The SDFs (and logits) of the port against JAX's."""
    for name, p, r in zip(("sdf_hand", "sdf_obj", "logits"), port, ref):
        p, r = p.detach().numpy(), np.asarray(r).reshape(p.shape)
        if dtype == "float32":
            np.testing.assert_allclose(p, r, atol=2e-6, rtol=0, err_msg=name)
        elif name == "logits":
            _close(p, r, name, GRAD_TOL)
        else:
            _close_mostly(p, r, name)


def _check_params(pdec, gp, dtype, folds=()):
    """Each weight_v, weight_g (or kernel) and bias gradient of the port's
    decoder against JAX's ``gp``; in bf16 weight_v of the layers in
    ``folds`` within FOLD_TOL.  Returns the count of layers."""
    tol = 1e-4 if dtype == "float32" else GRAD_TOL
    count = 0
    for trunk in gp.values():
        for name, g in trunk.items():
            layer = getattr(pdec, name)
            if "v" in g:
                fold = dtype != "float32" and name[-1].isdigit() and int(name[-1]) in folds
                _close(layer.weight_v.grad.numpy().T, g["v"], name + ".v",
                       FOLD_TOL if fold else tol)
                _close(layer.weight_g.grad.numpy().reshape(-1), g["g"], name + ".g", tol)
            else:  # the last layer and the classifier head are plain Linears
                _close(layer.weight.grad.numpy().T, g["kernel"], name + ".kernel", tol)
            _close(layer.bias.grad.numpy(), g["bias"], name + ".bias", tol)
            count += 1
    return count


def _loss_parts(labels_proj):
    proj = labels_proj

    def jax_loss(h, o, c):
        return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + jnp.sum(c * proj)

    def port_loss(h, o, c):
        return torch.sum(torch.sin(h)) + torch.sum(o ** 2) + torch.sum(c * torch.from_numpy(proj))

    return jax_loss, port_loss


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_final_latent_matches_jax(dtype):
    """The scene-factored decoder with latent_in (2, 4): the final layer's
    scene table and embedding weights, forward and every gradient."""
    jspecs, pspecs = _specs(FLAT, dtype)
    pdec, params = _decoder(pspecs, jspecs)
    rng = np.random.RandomState(6)  # the smallest margin: 3.6e-6
    latent = (rng.randn(B, LS) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    jax_loss, port_loss = _loss_parts(rng.randn(B * N, NUM_CLASS).astype(np.float32))
    decode = make_train_decoder(pspecs)
    assert decode is not None and decode.statics.scene_bias[-1] and decode.statics.has_x[-1]
    if dtype == "float32":
        st = decode.statics
        with _relu_margin() as seen, torch.no_grad():
            dec = pdec.double()
            for t, (prefix, cols) in enumerate(zip(trunk_prefixes(dec), branch_columns(pspecs))):
                ws, xs, bs = trunk_operands(dec, prefix, len(cols),
                                            torch.from_numpy(latent).double(), pspecs, 1)
                train_decode_reference(torch.from_numpy(emb).double()[:, list(cols)], ws, xs,
                                       bs, 11 + t, st)
            pdec.float()
        assert min(seen) > 2e-7, min(seen)
    fac = make_fused_train_decoder_factored(jspecs, interpret=True)

    def loss(p, lat, e):
        h, o, c = fac(p, lat, e, jnp.int32(11), train=True)
        return jax_loss(h, o, c), (h, o, c)

    (_, outs), (gp, gl, ge) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(latent), jnp.asarray(emb))
    lat_t = torch.from_numpy(latent).requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    pdec.zero_grad()
    h, o, c = decode(pdec, lat_t, emb_t, 11, True)
    port_loss(h, o, c).backward()
    _check_outputs(dtype, (h, o, c), outs)
    tol = 1e-4 if dtype == "float32" else GRAD_TOL
    if dtype == "float32":
        _close(lat_t.grad.numpy(), gl, "latent", tol)
    else:  # the fold rounds the latent's cotangent, as JAX's autodiff does
        _close_bf16(lat_t.grad.numpy(), gl, "latent")
    _close(emb_t.grad.numpy(), ge, "emb", tol)
    assert _check_params(pdec, gp, dtype, folds=(0, 2, 4)) == 5 * 2 + 1
    w4 = pdec.linh4.weight_v.grad if hasattr(pdec.linh4, "weight_v") else pdec.linh4.weight.grad
    assert float(w4[:, -(LS + 6):].abs().max()) > 0  # the final layer's latent rows learn


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _pixel_data(seed=0):
    """An NHWC map, embedding, points spread so that part of them project
    out of the image, camera and predicted root."""
    rng = np.random.RandomState(seed)
    fmap = (rng.randn(B, HF, WF, C) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    xyz = (rng.randn(B * N, 3) * 1.5).astype(np.float32)
    cam = np.zeros((B, 3, 4), np.float32)
    cam[:, 0, 0] = cam[:, 1, 1] = 80.0
    cam[:, 0, 2] = cam[:, 1, 2] = 32.0
    cam[:, 2, 2] = 1.0
    root = np.tile(np.asarray([0.02, -0.01, 0.55], np.float32), (B, 1, 1))
    return fmap, emb, xyz, cam, root, rng.randn(B * N, NUM_CLASS).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_final_latent_matches_jax(dtype):
    """The pixel-aligned decoder with latent_in (2, 4): the final layer's
    bicubic latent and embedding terms, forward and every gradient, the
    map's (through d(table) and d(mean)) and the predicted root's (through
    d(xp), d(yp)) among them."""
    jspecs, pspecs = _specs(FLAT, dtype, pixel=True)
    pdec, params = _decoder(pspecs, jspecs)
    fmap, emb, xyz, cam, root, proj = _pixel_data(6)  # the smallest margin: 1.6e-6
    jax_loss, port_loss = _loss_parts(proj)
    decode = make_pixel_train_decoder(pspecs)
    assert decode is not None and decode.statics.has_x[-1]
    fm_t = torch.from_numpy(fmap).permute(0, 3, 1, 2)
    if dtype == "float32":
        st = decode.statics._replace(feat_hw=(HF, WF))
        with _relu_margin() as seen, torch.no_grad():
            ins = pixel_train_inputs(fm_t, torch.from_numpy(xyz), torch.from_numpy(cam),
                                     torch.from_numpy(root), pspecs)
            inside = float(ins[4].mean())
            pixel_train_decode_reference(*(t.double() for t in ins),
                                         torch.from_numpy(emb).double(),
                                         pixel_trunks(pdec.double(), pspecs, C), 11, st)
            pdec.float()
        assert min(seen) > 2e-7, min(seen)
        assert 0 < inside < 1, inside  # both the taps and the mean row carry gradient
    fused = make_fused_train_decoder_pixel(jspecs, interpret=True)
    assert fused is not None

    def loss(p, fm, e, r):
        h, o, c = fused(p, fm, e, jnp.asarray(xyz), jnp.asarray(cam), r, jnp.int32(11),
                        train=True)
        return jax_loss(h, o, c), (h, o, c)

    fm_j = jnp.asarray(fmap)
    if dtype == "bfloat16":
        fm_j = fm_j.astype(jnp.bfloat16)
        fm_t = torch.from_numpy(np.asarray(fm_j.astype(jnp.float32))).permute(0, 3, 1, 2)
        fm_t = fm_t.to(BF16)
    (_, outs), (gp, gf, ge, gr) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(params, fm_j, jnp.asarray(emb),
                                                   jnp.asarray(root))
    fm_t = fm_t.contiguous().requires_grad_()
    emb_t, root_t = torch.from_numpy(emb).requires_grad_(), torch.from_numpy(root).requires_grad_()
    pdec.zero_grad()
    h, o, c = decode(pdec, fm_t, emb_t, torch.from_numpy(xyz), torch.from_numpy(cam), root_t,
                     11, True)
    port_loss(h, o, c).backward()
    _check_outputs(dtype, (h, o, c), outs)
    tol = 1e-4 if dtype == "float32" else GRAD_TOL
    gf = np.asarray(gf.astype(jnp.float32)).transpose(0, 3, 1, 2)
    if dtype == "float32":
        _close(fm_t.grad.numpy(), gf, "map", tol)
    else:  # the cast of the bf16 map rounds its cotangent, in both frameworks
        _close_bf16(fm_t.grad.float().numpy(), gf, "map")
    _close(emb_t.grad.numpy(), ge, "emb", tol)
    _close(root_t.grad.numpy(), gr, "root", tol)
    assert _check_params(pdec, gp, dtype) == 5 * 2 + 1
    w4 = pdec.lino4.weight.grad if hasattr(pdec.lino4, "weight") else pdec.lino4.weight_v.grad
    assert float(w4[:, -(C + 6):].abs().max()) > 0  # the final layer's latent rows learn


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k5_final_latent_matches_jax(dtype):
    """The generic decoder on [latent, embedding] rows with latent_in (0, 2,
    4): the final layer's x0 term over the whole row, forward and every
    gradient; in bf16 the latent enters bf16, so its cotangent is rounded at
    the rows' cast, in both frameworks."""
    jspecs, pspecs = _specs(FLAT_ZERO, dtype)
    pdec, params = _decoder(pspecs, jspecs)
    rng = np.random.RandomState(5)  # the smallest margin: 5.8e-6
    rows = (rng.randn(B * N, LS + PFS) * 0.5).astype(np.float32)
    jax_loss, port_loss = _loss_parts(rng.randn(B * N, NUM_CLASS).astype(np.float32))
    decode = make_generic_train_decoder(pspecs)
    assert decode is not None and decode.statics.has_x[-1]
    assert make_train_decoder(pspecs) is None and make_pixel_train_decoder(pspecs) is None
    if dtype == "float32":
        st = decode.statics
        with _relu_margin() as seen, torch.no_grad():
            dec = pdec.double()
            x = torch.from_numpy(rows).double()
            for t, (prefix, width, x0) in enumerate(zip(
                    trunk_prefixes(dec), trunk_input_widths(pspecs),
                    separate_decoder_inputs(LS, "both", x))):
                ws, xs, bs = generic_trunk_operands(dec, prefix, width, pspecs, 1)
                generic_train_decode_reference(x0, ws, xs, bs, 11 + t, st)
            pdec.float()
        assert min(seen) > 2e-7, min(seen)
    fused = make_fused_train_decoder(jspecs, block=128, interpret=True)

    def loss(p, lat, e):
        h, o, c = fused(p, jnp.concatenate([lat, e], axis=1), jnp.int32(11), train=True)
        return jax_loss(h, o, c), (h, o, c)

    lat = jnp.asarray(rows[:, :LS])
    if dtype == "bfloat16":
        lat = lat.astype(jnp.bfloat16)
    (_, outs), (gp, gl, ge) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        params, lat, jnp.asarray(rows[:, LS:]))
    lat_t = torch.from_numpy(np.asarray(lat.astype(jnp.float32)))
    if dtype == "bfloat16":
        lat_t = lat_t.to(BF16)
    lat_t = lat_t.requires_grad_()
    emb_t = torch.from_numpy(rows[:, LS:].copy()).requires_grad_()
    pdec.zero_grad()
    h, o, c = decode(pdec, torch.cat([lat_t.to(torch.float32), emb_t], dim=1)
                     if dtype == "float32" else torch.cat([lat_t, emb_t.to(BF16)], dim=1),
                     11, True)
    port_loss(h, o, c).backward()
    _check_outputs(dtype, (h, o, c), (np.asarray(outs[0])[:, 0], np.asarray(outs[1])[:, 0],
                                      outs[2]))
    tol = 1e-4 if dtype == "float32" else GRAD_TOL
    gl = np.asarray(gl.astype(jnp.float32))
    if dtype == "float32":
        _close(lat_t.grad.numpy(), gl, "latent", tol)
        _close(emb_t.grad.numpy(), ge, "emb", tol)
    else:
        _close_bf16(lat_t.grad.float().numpy(), gl, "latent")
    assert _check_params(pdec, gp, dtype) == 5 * 2 + 1
    w4 = pdec.linh4.weight.grad if hasattr(pdec.linh4, "weight") else pdec.linh4.weight_v.grad
    assert float(w4[:, -(LS + 6):].abs().max()) > 0  # the final layer's input rows learn


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_final_latent_field_matches_jax(dtype):
    """The pixel grid field of a latent_in (2, 4) decoder over a 10^3 grid,
    part of which projects outside the image (the mean row): the plan keeps
    the final layer's latent weights (``fin_lat``) and the plain version
    adds their term, as JAX's K3 adds ``flat``'s."""
    n = 10
    ns = dict(dims=(64, 64, 64, 64), dropout=(), latent_in=FLAT)
    jspecs, pspecs, jctx, _, pctx = _scene("both", 9, ns=ns)
    origin, voxel = np.full(3, -1.0, np.float32), np.float32(2.0 / (n - 1))
    tdt = torch.float32 if dtype == "float32" else BF16
    plan = make_pixel_grid_decode_fn(pspecs, n, False, tdt)(pctx).plan
    assert all(f is not None for f in plan.fin_lats())
    args = (0, n ** 3, torch.from_numpy(origin), torch.tensor(voxel))
    got = pixel_grid_decode_reference(plan, *args).numpy()
    share = float(pixel_projection(plan, *args)[3].float().mean())
    assert 0.1 < share < 0.9, share
    gd = make_fused_pixel_grid_decode_fn(jspecs, n, block=128, interpret=True, band=None,
                                         dtype=jnp.float32 if dtype == "float32" else jnp.bfloat16)
    h, o, _ = jax.jit(gd)(jctx, jnp.arange(n ** 3, dtype=jnp.int32), jnp.asarray(origin),
                          jnp.asarray(voxel))
    want = np.stack([np.asarray(h)[:, 0], np.asarray(o)[:, 0]])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
        # without its final latent term the field moves: the term is live
        bare = dataclasses.replace(plan, flat=plan.flat.clone())
        for f in bare.fin_lats():
            f.zero_()
        off = pixel_grid_decode_reference(bare, *args).numpy()
        assert float(np.abs(off - want).max()) > 1e-3
    else:
        _close_mostly(got, want, "bf16 field")
        fin_lat = plan.fin_lats()[0]
        assert bool((fin_lat == round_to(fin_lat, BF16)).all())


# ---------------------------------------------------------------------------
# one train step of each variant, and the routes
# ---------------------------------------------------------------------------

STEPS = {
    "K2": (test_torch_train.TRAJ_SPECS, FLAT, "scene-factored (K2)"),
    "K4": (test_torch_pixel_train.TRAJ_SPECS, FLAT, "pixel-aligned (K4)"),
    "K5": (test_torch_train.TRAJ_SPECS, FLAT_ZERO, "materialized inputs (K5)"),
}


@pytest.mark.parametrize("variant", sorted(STEPS))
def test_train_step_matches_jax(variant):
    """One train step of the narrow flagship (64-pixel images) with the
    variant's latent_in from the same weights, batch and dropout seed: the
    port's step routes as JAX's CLI does and runs the kernel's plain
    version; JAX's runs that kernel in interpret mode as its override."""
    base, latent_in, kind = STEPS[variant]
    spec = dict(base, ImageSize=[64, 64],
                NetworkSpecs=dict(base["NetworkSpecs"], latent_in=list(latent_in)))
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair_from_port(spec)
    # final biases at 0 put the predictions inside the clamp band, so the
    # SDF losses carry gradient into the trunks
    for trunk, name in (("hand", "linh4"), ("obj", "lino4")):
        bias = variables["params"]["decoder"][trunk][name]["bias"]
        variables["params"]["decoder"][trunk][name]["bias"] = np.zeros_like(bias)
        getattr(pmodel.decoder, name).bias.data.zero_()
    opt = test_torch_pixel_train._keeping_grads(jax_train_state.make_optimizer(jspecs))
    override = (make_fused_train_decoder_pixel(jspecs, interpret=True)
                or make_fused_train_decoder_factored(jspecs, interpret=True)
                or make_fused_train_decoder(jspecs, block=128, interpret=True))
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
    assert train_decoder_kind(pstep.decode) == kind
    pl = pstep(pstate, batch_to_device(batch, "cpu"), seed)
    assert set(jl) == set(pl)
    for k in jl:
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    jg = from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state[1]),
                  jax.tree_util.tree_map(np.asarray, jstate.batch_stats), pspecs)
    params = dict(pmodel.named_parameters())
    names = [k for k in params if k.startswith("decoder.")]
    assert names
    for k in names:
        g, ref = params[k].grad, jg[k]
        scale = float(ref.abs().max()) + 1e-30
        assert float((g - ref).abs().max()) <= 1e-4 * scale, k
    last = params["decoder.linh4.weight_v"].grad if "decoder.linh4.weight_v" in params \
        else params["decoder.linh4.weight"].grad
    assert float(last.abs().max()) > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_width_variants_build_and_route(dtype):
    """The flagship (experiments/obman_30k.json --mano --obj_pose --encode
    both --point_size 9) with latent_in (2, 4) trains on K2, with --pa_feat
    on K4, with (0, 2, 4) on K5, as JAX's CLI routes them: make_train_step
    and make_trainer build each in the dtype, and the reconstructor serves
    the --pa_feat one on K3 (not the generic path)."""
    from alignsdf_torch.cli.train import make_trainer
    from alignsdf_torch.config import load_specs
    from alignsdf_torch.inference.reconstruct import Reconstructor

    flagship = load_specs("experiments/obman_30k.json")
    flagship = dataclasses.replace(flagship, encode_style="both", point_feat_size=9,
                                   mano_branch=True, object_pose_branch=True,
                                   compute_dtype=dtype)
    cases = (({}, FLAT, "K2"), ({"pixel_align": True}, FLAT, "K4"), ({}, FLAT_ZERO, "K5"))
    for extra, latent_in, kernel in cases:
        specs = dataclasses.replace(flagship, **extra, network_specs=dataclasses.replace(
            flagship.network_specs, latent_in=latent_in))
        for step in (make_train_step(specs),
                     make_trainer(specs, torch.device("cpu"), init_guard=False)[1]):
            assert f"({kernel})" in train_decoder_kind(step.decode)
            assert step.decode.statics.dtype == getattr(torch, dtype)
            assert step.decode.statics.has_x[-1]
        if kernel == "K4":
            state, _ = make_trainer(specs, torch.device("cpu"), init_guard=False)
            assert Reconstructor(state.model, specs, cube_dim=16, device="cpu").fused


def test_k3_plan_carries_both_trunks_final_latent():
    """A --pa_feat spec with latent_in (2, 4): K3's plan holds each trunk's
    final latent weights (fin_lat) in its rows, zeros in the other trunk's;
    a spec without a final latent input holds none."""
    for latent_in, count in ((FLAT, 2), ((2,), 0)):
        ns = dict(dims=(64, 64, 64, 64), dropout=(), latent_in=latent_in)
        _, pspecs, _, _, pctx = _scene("both", 9, ns=ns)
        plan = make_pixel_grid_decode_fn(pspecs, 8)(pctx).plan
        fins = [f for f in plan.fin_lats() if f is not None]
        assert len(fins) == count
        for row, f in enumerate(fins):
            assert float(f[row].abs().max()) > 0 and float(f[1 - row].abs().max()) == 0
