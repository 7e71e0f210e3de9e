"""bf16 training through K4 (the pixel-aligned train decoder) and K5 (the
generic train decoder on materialized rows, latent_in (0, ...)): the port's
plain bf16 versions against the JAX package's bf16 kernels, on the CPU.

- K4's plain bf16 version (``PixelTrainDecodeReference``: the plain forward
  and the plain backward on its residuals) against JAX's
  ``fused_pixel_decoder`` with cdtype bfloat16 in interpret mode on the same
  operands (an 8 x 8 map of 16 channels, 2 scenes x 128 points, block 128,
  three hidden layers of 64, latent_in (2,)), the twin trunks and the
  combined one, the first trunk's x_last and a random dx_last: y and x_last
  within TIGHT at >= SHARE of the entries and LOOSE everywhere, x_last's
  flips at ReLU's edge counted, every gradient (the table, the mean, xp, yp,
  the embedding, every weight and bias) within GRAD_TOL of its largest.
  Both sides round at the same points (the tap weight ky kx, the latent,
  each hidden activation; dpre into every product, dlat before the
  sampling's gradients) and sum in float32 in other orders, so now and then
  a value may round to the neighbouring bf16 one and the layers after it
  carry the step.  Measured at these widths: y and x_last within 6e-8 at
  every entry, no flip, gradients within 4.4e-6 of their largest.
- K5's plain bf16 version (K2's ``TrainDecodeReference`` on the stacked
  layer-0 weights) against JAX's ``fused_branch`` with cdtype bfloat16 on
  the same operands, latent_in (0, 2), twin and combined, the same bounds.
  JAX multiplies x0 by layer 0's two weights apart, each rounded to bf16;
  summing them first, as the float32 plan does, rounds once where JAX
  rounds twice, which test_summed_layer_0_weights_miss_jax_bf16 shows the
  bounds see.  Measured: y and x_last within 9.6e-7, no flip, gradients
  within 1.6e-6 of their largest.
- The decoders as a bf16 train step builds them (``make_pixel_train_decoder``
  and ``make_generic_train_decoder`` on a bf16 spec) against JAX's
  ``make_fused_train_decoder_pixel`` and ``make_fused_train_decoder``: the
  SDFs and logits, and the gradients of every parameter and input
  (measured: within 6e-8 and 5.4e-7 of the largest).
- Which cotangents leave bf16: none of the kernels'.  JAX's K4 and K5
  return float32 cotangents (``_fused_pixel_bwd`` :669-684,
  ``_fused_branch_bwd`` :315-320) for float32 primals: the weights come
  from ``build_branch_plan(..., dtype=float32)`` and are cast inside the
  custom VJP, the table is the map cast to float32 by the factory, the
  rows are float32.  The one rounding is at the cast of a bf16 input (the
  HeadNet map; the latent in the rows), whose transpose converts the
  float32 cotangent to bf16, in both frameworks alike.  Pinned here: a bf16
  map's and a bf16 latent's gradients are bf16 within one bf16 step of
  JAX's, the weights' are float32 and not bf16-representable.
- One bf16 train step of the narrow --pa_feat spec against JAX's bf16 step
  in a process whose XLA rounds where the code converts, as the
  flagship's step test does (tests/test_torch_bf16_train.py).
- The bf16 packs: K4's and K5's tiles untile to the rounded weights (K5's
  layer 0 of a stacked pair to [W_0; W_in]'s head rows), the table, the
  mean, the embedding and x0 rounded, their bf16 copies equal.
- make_train_step, make_trainer and ``cli.train --bf16 --smoke --device
  cpu`` build and step the K4 and K5 specs: tests/test_torch_bf16.py.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py's phase 21."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.ops.decoder_train_kernel import (
    _plan_statics,
    fused_branch,
    make_fused_train_decoder,
)
from alignsdf_tpu.ops.decoder_train_pixel import (
    PixelStatic,
    PixelTrunk,
    fused_pixel_decoder,
    make_fused_train_decoder_pixel,
)
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import decoder_from_jax
from alignsdf_torch.kernels import generic_train_decoder as k5
from alignsdf_torch.kernels.grid_decoder import round_to, untile_weights
from alignsdf_torch.kernels.pixel_train_decoder import (
    flatten_pixel_params,
    pack_pixel_trunks,
    pixel_train_decode,
    unflatten_pixel_params,
)
from alignsdf_torch.kernels.train_decoder import flatten_params, unflatten_params
from alignsdf_torch.models.decoder import make_decoder, separate_decoder_inputs, trunk_prefixes
from alignsdf_torch.ops.decoder_plan import trunk_input_widths
from alignsdf_torch.ops.generic_train_plan import generic_trunk_operands, make_generic_train_decoder
from alignsdf_torch.ops.pixel_train_plan import (
    make_pixel_train_decoder,
    pixel_train_inputs,
    pixel_trunks,
)

import torch_parity

BF16 = torch.bfloat16
TIGHT = 1e-5      # y and x_last, port against JAX, at >= SHARE of the entries
LOOSE = 2e-3      # ... and everywhere
SHARE = 0.99
GRAD_TOL = 2e-3   # every gradient, of its largest entry
FLIP_MAX = 2e-3   # a residual 0 on one side may be at most this on the other
B, N, HF, WF, C, PFS = 2, 128, 8, 8, 16, 9
DIMS = (64, 64, 64)
BLOCK = 128
NUM_CLASS = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _r128(n):
    return -(-n // 128) * 128


def _pad(a, rows, cols):
    a = np.asarray(a, np.float32)
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


def _np(ts):
    return [None if t is None else t.detach().numpy() for t in ts]


def _close_mostly(got, want, name):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    share = float((err <= TIGHT).mean())
    assert share >= SHARE, (name, share, float(err.max()))
    assert float(err.max()) <= LOOSE, (name, float(err.max()))
    return share, float(err.max())


def _close_grad(port, ref, name, tol=GRAD_TOL):
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) + 1e-12
    err = float(np.abs(np.asarray(port, np.float64) - ref).max()) / scale
    assert err <= tol, (name, err)
    return err


def _close_bf16_grad(port, ref, name):
    """A cotangent that both sides round to bf16: each entry within one bf16
    step of JAX's beyond GRAD_TOL of the largest."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    slack = 2.0 ** -7 * np.maximum(np.abs(port), np.abs(ref))
    excess = float((np.abs(port - ref) - slack).max()) / (float(np.abs(ref).max()) + 1e-12)
    assert excess <= GRAD_TOL, (name, excess)


def _flips(port_xl, jax_xl):
    """x_last entries 0 on one side and not on the other (a unit at ReLU's
    edge), each at most FLIP_MAX; returns their count."""
    flip = (port_xl > 0) != (jax_xl > 0)
    assert float(np.abs(port_xl - jax_xl)[flip].max(initial=0.0)) <= FLIP_MAX
    return int(flip.sum())


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def _pixel_specs(model_type, dtype="bfloat16", dims=DIMS):
    ns = dict(dims=dims, dropout=tuple(range(len(dims))), dropout_prob=0.2,
              norm_layers=tuple(range(len(dims))), latent_in=(2,))
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=PFS, latent_size=C,
              pixel_align=True, samples_per_scene=N, sdf_scale_factor=7.0186,
              image_size=(64, 64), classifier_branch=True, compute_dtype=dtype)
    return (JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw),
            Specs(network_specs=NetworkSpecs(**ns), **kw))


def _pixel_data(seed=0):
    """An NHWC map, embedding, points spread so that part of them project
    out of the image, camera and predicted root; part labels (-1 = none)."""
    rng = np.random.RandomState(seed)
    fmap = (rng.randn(B, HF, WF, C) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    xyz = (rng.randn(B * N, 3) * 1.5).astype(np.float32)
    cam = np.zeros((B, 3, 4), np.float32)
    cam[:, 0, 0] = cam[:, 1, 1] = 80.0
    cam[:, 0, 2] = cam[:, 1, 2] = 32.0
    cam[:, 2, 2] = 1.0
    root = np.tile(np.asarray([0.02, -0.01, 0.55], np.float32), (B, 1, 1))
    labels = rng.randint(-1, NUM_CLASS, B * N)
    return fmap, emb, xyz, cam, root, labels


def _pixel_decoder(model_type, dtype="bfloat16"):
    """(JAX params, port decoder, JAX specs, port specs): JAX's seeded init,
    the classifier head scaled x20 so that the logits' gradient (dx_last)
    matters."""
    jspecs, pspecs = _pixel_specs(model_type, dtype)
    jdec = jax_make_decoder(model_type, C, PFS, "both", jspecs.network_specs, True)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(0), jnp.zeros((8, C + PFS)))["params"])
    for trunk in params.values():
        if "classifier_head" in trunk:
            trunk["classifier_head"]["kernel"] = trunk["classifier_head"]["kernel"] * 20
    pdec = make_decoder(model_type, C, PFS, "both", pspecs.network_specs, use_classifier=True)
    pdec.load_state_dict(decoder_from_jax(params))
    return params, pdec, jspecs, pspecs


def _pixel_operands(pdec, pspecs, data):
    """K4's operands as the plan hands them: ((table, mean, xp, yp, mask,
    emb), trunks, statics)."""
    fmap, emb, xyz, cam, root, _ = data
    with torch.no_grad():
        inputs = (*pixel_train_inputs(torch.from_numpy(fmap).permute(0, 3, 1, 2),
                                      torch.from_numpy(xyz), torch.from_numpy(cam),
                                      torch.from_numpy(root), pspecs), torch.from_numpy(emb))
        trunks = pixel_trunks(pdec, pspecs, C)
    st = make_pixel_train_decoder(pspecs).statics._replace(feat_hw=(HF, WF))
    return inputs, trunks, st


def _jax_pixel_vjp(inputs, trunks, st, seed, dy, dxl, combined):
    """JAX's bf16 fused_pixel_decoder on K4's operands in JAX's layout
    (widths padded to 128, C to 128, the embedding to 16): y (rows, M),
    x_last (M, h) and the VJP of (dy, dxl) as K4's gradients in
    ``flatten_pixel_params``' order after (table, mean, xp, yp, emb)."""
    table, mean, xp, yp, mask, emb = (t.numpy() for t in inputs)
    m = emb.shape[0]
    c_pad = _r128(C)

    def jtrunk(ws, lats, xs, bs):
        pad = lambda t: None if t is None else jnp.asarray(  # noqa: E731
            _pad(t, _r128(t.shape[0]), _r128(t.shape[1])))
        return PixelTrunk(tuple(pad(w) for w in ws),
                          tuple(None if t is None else jnp.asarray(_pad(t, c_pad, _r128(t.shape[1])))
                                for t in lats),
                          tuple(None if t is None else jnp.asarray(_pad(t, 16, _r128(t.shape[1])))
                                for t in xs),
                          tuple(jnp.asarray(_pad(b[None], 1, _r128(b.shape[0]))) for b in bs))

    jt = [jtrunk(*_np_trunk(t)) for t in trunks]
    n_layers = len(st.has_w)
    static = PixelStatic(n_layers, tuple(st.has_x[l] and l > 0 for l in range(n_layers)),
                         tuple(st.dropout), st.keep, BLOCK, "bfloat16", st.train, True, True,
                         N // BLOCK, HF, WF, combined, not combined)
    fe = jnp.asarray(_pad(table.reshape(-1, C), B * HF * WF, c_pad))
    mean8 = jnp.asarray(np.repeat(_pad(mean, B, c_pad)[:, None, :], 8, axis=1))
    pix = np.zeros((8, m), np.float32)
    pix[0], pix[1], pix[2] = xp, yp, mask
    emb_j = jnp.asarray(_pad(emb, m, 16))
    rlo = jnp.zeros((m // BLOCK,), jnp.int32)

    def run(tr, f, mn, px, e):
        return fused_pixel_decoder(static, (tr[0], tr[1] if len(tr) > 1 else None), f, mn, px, e,
                                   rlo, jnp.asarray(False), jnp.int32(seed))

    (y8, xl), pull = jax.vjp(run, jt, fe, mean8, jnp.asarray(pix), emb_j)
    rows = dy.shape[0]
    dy8 = np.zeros((8, m), np.float32)
    dy8[:rows] = dy
    dxl_pad = np.zeros(xl.shape, np.float32)
    dxl_pad[:, :dxl.shape[1]] = dxl
    dtr, dfe, dmean8, dpix, demb = pull((jnp.asarray(dy8), jnp.asarray(dxl_pad)))
    grads = [np.asarray(dfe)[:, :C].reshape(B, HF * WF, C), np.asarray(dmean8)[:, 0, :C],
             np.asarray(dpix)[0], np.asarray(dpix)[1], np.asarray(demb)[:, :PFS]]
    for (ws, lats, xs, bs), d in zip(trunks, dtr):
        grads += [np.asarray(g)[:w.shape[0], :w.shape[1]]
                  for g, w in zip(d.wx, ws) if w is not None]
        grads += [np.asarray(g)[:t.shape[0], :t.shape[1]]
                  for g, t in zip(d.wlat, lats) if t is not None]
        grads += [np.asarray(g)[:t.shape[0], :t.shape[1]]
                  for g, t in zip(d.wemb, xs) if t is not None]
        grads += [np.asarray(g)[0, :b.shape[0]] for g, b in zip(d.biases, bs)]
    return np.asarray(y8)[:rows], np.asarray(xl)[:, :dxl.shape[1]], grads


def _np_trunk(trunk):
    return tuple(_np(group) for group in trunk)


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
@pytest.mark.parametrize("train", [False, True])
def test_plain_bf16_k4_matches_jax_kernel(model_type, train):
    """K4's plain bf16 version (the CPU route of a bf16 K4) against JAX's
    bf16 fused_pixel_decoder on the same operands, dropout on and off: y,
    x_last (bf16 values) and its flips, every gradient under dy and a
    random dx_last; both sides see points in and out of the image."""
    _, pdec, _, pspecs = _pixel_decoder(model_type)
    inputs, trunks, st = _pixel_operands(pdec, pspecs, _pixel_data())
    st = st._replace(train=train)
    assert st.dtype == BF16 and 0.0 < float(inputs[4].mean()) < 1.0
    leaves = [t.detach().clone().requires_grad_()
              for t in (*inputs[:4], inputs[5], *flatten_pixel_params(trunks))]
    before = pixel_train_decode.launches, pixel_train_decode.bf16_launches
    y, xl = pixel_train_decode(*leaves[:4], inputs[4], leaves[4],
                               unflatten_pixel_params(st, leaves[5:]), 9, st)
    assert (pixel_train_decode.launches, pixel_train_decode.bf16_launches) == before
    rng = np.random.RandomState(5)
    dy = rng.randn(*y.shape).astype(np.float32)
    dxl = rng.randn(*xl.shape).astype(np.float32)
    grads = torch.autograd.grad((y, xl), leaves, (torch.from_numpy(dy), torch.from_numpy(dxl)))
    jy, jxl, jgrads = _jax_pixel_vjp(inputs, trunks, st, 9, dy, dxl,
                                     model_type == "1encoder1decoder")
    _close_mostly(y.detach().numpy(), jy, "y")
    _close_mostly(xl.detach().numpy(), jxl, "x_last")
    assert xl.dtype == torch.float32 and torch.equal(xl, round_to(xl.detach(), BF16))
    assert _flips(xl.detach().numpy(), jxl) <= 0.001 * xl.numel()
    assert len(grads) == len(jgrads)
    names = ["table", "mean", "xp", "yp", "emb"]
    for i, (g, w) in enumerate(zip(grads, jgrads)):
        assert g.dtype == torch.float32
        _close_grad(g.numpy(), w, names[i] if i < len(names) else f"weights[{i - 5}]")
    assert float(np.abs(jgrads[1]).max()) > 0 and float(np.abs(jgrads[2]).max()) > 0


def _pixel_loss_jax(fused, labels, train):
    def loss(p, fm, e, r, xyz, cam):
        h, o, c = fused(p, fm, e, xyz, cam, r, jnp.int32(11), train=train)
        valid = labels >= 0
        lp = jax.nn.log_softmax(c, axis=-1)[jnp.arange(len(labels)), jnp.maximum(labels, 0)]
        ce = -jnp.sum(jnp.where(valid, lp, 0.0)) / jnp.sum(valid)
        return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + 5.0 * ce, (h, o, c)
    return loss


def _pixel_loss_port(h, o, c, labels):
    valid = labels >= 0
    lp = torch.log_softmax(c, dim=-1)[torch.arange(len(labels)), labels.clamp(min=0)]
    ce = -torch.sum(torch.where(valid, lp, torch.zeros_like(lp))) / valid.sum()
    return torch.sum(torch.sin(h)) + torch.sum(o ** 2) + 5.0 * ce


def _param_grads(pdec, gp, close):
    """Each weight_v, weight_g (or kernel) and bias of JAX's decoder
    gradients ``gp`` against the port's, through ``close``; returns the
    count of layers."""
    count = 0
    for trunk in gp.values():
        for name, g in trunk.items():
            layer = getattr(pdec, name)
            if "v" in g:
                close(layer.weight_v.grad.numpy().T, g["v"], name + ".v")
                close(layer.weight_g.grad.numpy().reshape(-1), g["g"], name + ".g")
            else:
                close(layer.weight.grad.numpy().T, g["kernel"], name + ".kernel")
            close(layer.bias.grad.numpy(), g["bias"], name + ".bias")
            count += 1
    return count


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
def test_bf16_pixel_train_decoder_matches_jax(model_type):
    """The decoder as a bf16 --pa_feat train step runs it (the table and
    its mean from a bf16 map, K4's plain bf16 version, the logits a float32
    product) against JAX's bf16 make_fused_train_decoder_pixel under an SDF
    + cross-entropy loss: the SDFs and logits, the gradients of every
    parameter, the embedding and the predicted root (float32, unrounded),
    and of the bf16 map: bf16 on both sides, the one cotangent rounded,
    within one bf16 step of JAX's."""
    params, pdec, jspecs, pspecs = _pixel_decoder(model_type)
    fmap, emb, xyz, cam, root, labels = _pixel_data()
    fused = make_fused_train_decoder_pixel(jspecs, interpret=True)
    assert fused is not None and fused.block == BLOCK
    fm16 = jnp.asarray(fmap).astype(jnp.bfloat16)
    (_, (jh, jo, jc)), (gp, gf, ge, gr) = jax.value_and_grad(
        _pixel_loss_jax(fused, jnp.asarray(labels), True), argnums=(0, 1, 2, 3), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), fm16, jnp.asarray(emb), jnp.asarray(root),
        jnp.asarray(xyz), jnp.asarray(cam))
    assert gf.dtype == jnp.bfloat16 and ge.dtype == jnp.float32

    decode = make_pixel_train_decoder(pspecs)
    fm_t = torch.from_numpy(np.asarray(fm16.astype(jnp.float32))).permute(0, 3, 1, 2)
    fm_t = fm_t.to(BF16).requires_grad_()
    emb_t, root_t = torch.from_numpy(emb).requires_grad_(), torch.from_numpy(root).requires_grad_()
    pdec.zero_grad()
    h, o, c = decode(pdec, fm_t, emb_t, torch.from_numpy(xyz), torch.from_numpy(cam), root_t,
                     11, True)
    _pixel_loss_port(h, o, c, torch.from_numpy(labels)).backward()
    _close_mostly(h.detach().numpy(), jh, "sdf_hand")
    _close_mostly(o.detach().numpy(), jo, "sdf_obj")
    assert c.dtype == torch.float32
    _close_grad(c.detach().numpy(), jc, "logits")
    assert fm_t.grad.dtype == BF16
    _close_bf16_grad(fm_t.grad.float().numpy(), np.asarray(gf.astype(jnp.float32))
                     .transpose(0, 3, 1, 2), "map")
    _close_grad(emb_t.grad.numpy(), ge, "emb")
    _close_grad(root_t.grad.numpy(), gr, "root")
    assert _param_grads(pdec, gp, _close_grad) == 4 * len(gp) + 1
    # the weights' cotangents leave float32 and unrounded, as JAX's
    v = pdec.linh1.weight_v.grad if hasattr(pdec, "linh1") else pdec.lin1.weight_v.grad
    assert v.dtype == torch.float32 and not torch.equal(v, round_to(v, BF16))


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

LS5, M5 = 32, 256


def _k5_specs(model_type, dtype="bfloat16"):
    ns = dict(dims=DIMS, dropout=(0, 1, 2), dropout_prob=0.2, norm_layers=(0, 1, 2),
              latent_in=(0, 2))
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=PFS, latent_size=LS5,
              classifier_branch=True, compute_dtype=dtype)
    return (JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw),
            Specs(network_specs=NetworkSpecs(**ns), **kw))


def _k5_decoder(model_type, dtype="bfloat16"):
    jspecs, pspecs = _k5_specs(model_type, dtype)
    jdec = jax_make_decoder(model_type, LS5, PFS, "both", jspecs.network_specs, True)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(1), jnp.zeros((8, LS5 + PFS)))["params"])
    for trunk in params.values():
        if "classifier_head" in trunk:
            trunk["classifier_head"]["kernel"] = trunk["classifier_head"]["kernel"] * 20
    pdec = make_decoder(model_type, LS5, PFS, "both", pspecs.network_specs, use_classifier=True)
    pdec.load_state_dict(decoder_from_jax(params))
    return params, pdec, jspecs, pspecs


def _k5_rows(seed=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(M5, LS5 + PFS) * 0.5).astype(np.float32)


def _k5_trunks(pdec, pspecs, rows):
    """[(x0, ws, xs, bs, n_out)] of the decoder's trunks on ``rows``."""
    first, second = trunk_prefixes(pdec)
    x = torch.from_numpy(rows)
    inputs = [x] if second is None else separate_decoder_inputs(LS5, "both", x)
    out = []
    with torch.no_grad():
        for prefix, width, x0 in zip((first, second), trunk_input_widths(pspecs), inputs):
            n_out = 2 if second is None else 1
            ws, xs, bs = generic_trunk_operands(pdec, prefix, width, pspecs, n_out)
            out.append((x0.contiguous(), ws, xs, bs, n_out))
    return out


def _jax_k5_vjp(x0, ws, xs, bs, st, seed, dy, dxl):
    """JAX's bf16 fused_branch on one trunk's operands in JAX's layout (widths
    and x0 padded to 128; layer 0's stacked pair split into its weight and
    its inject weight): y (n_out, M), x_last (M, h) and the VJP of (dy, dxl)
    as the port's gradients (x0, then ``flatten_params``' order)."""
    x0 = x0.detach().numpy()
    m, e = x0.shape
    n_layers = len(bs)
    e_pad = _r128(e)
    weights, injects = [], []
    for layer in range(n_layers):
        out_pad = _r128(bs[layer].shape[0])
        if layer == 0:
            parts = xs[0].detach().numpy().reshape(-1, e, bs[0].shape[0])
            weights.append(_pad(parts[0], e_pad, out_pad))
            injects.append(_pad(parts[1], e_pad, out_pad) if len(parts) > 1 else None)
        else:
            weights.append(_pad(ws[layer].detach().numpy(), _r128(ws[layer].shape[0]), out_pad))
            injects.append(None if xs[layer] is None else _pad(xs[layer].detach().numpy(), e_pad, out_pad))
    biases = [_pad(b.detach().numpy()[None], 1, _r128(b.shape[0])) for b in bs]
    inject = tuple(i is not None for i in injects)
    static = _plan_statics(n_layers, inject, tuple(st.dropout), st.keep, BLOCK, "bfloat16",
                           st.train, True, True)

    def run(w, i, b, x):
        return fused_branch(static, w, i, b, x, jnp.int32(seed))

    args = (tuple(jnp.asarray(w) for w in weights),
            tuple(None if i is None else jnp.asarray(i) for i in injects),
            tuple(jnp.asarray(b) for b in biases), jnp.asarray(_pad(x0, m, e_pad)))
    (y, xl), pull = jax.vjp(run, *args)
    n_out = bs[-1].shape[0]
    dy_pad = np.zeros(y.shape, np.float32)
    dy_pad[:, :n_out] = dy.T
    dxl_pad = np.zeros(xl.shape, np.float32)
    dxl_pad[:, :dxl.shape[1]] = dxl
    dw, di, db, dx = pull((jnp.asarray(dy_pad), jnp.asarray(dxl_pad)))
    grads = [np.asarray(dx)[:, :e]]
    grads += [np.asarray(dw[l])[:ws[l].shape[0], :ws[l].shape[1]]
              for l in range(n_layers) if ws[l] is not None]
    for layer in range(n_layers):
        if xs[layer] is not None:
            out = xs[layer].shape[1]
            parts = [np.asarray(dw[layer])[:e, :out]] if layer == 0 else []
            if injects[layer] is not None:
                parts.append(np.asarray(di[layer])[:e, :out])
            grads.append(np.concatenate(parts) if layer == 0 else parts[0])
    grads += [np.asarray(d)[0, :b.shape[0]] for d, b in zip(db, bs)]
    return np.asarray(y)[:, :n_out].T, np.asarray(xl)[:, :dxl.shape[1]], grads


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
@pytest.mark.parametrize("train", [False, True])
def test_plain_bf16_k5_matches_jax_kernel(model_type, train):
    """Each trunk of a latent_in (0, 2) decoder through K5's plain bf16
    version (the CPU route of a bf16 K5; layer 0's two weights stacked and
    rounded apart) against JAX's bf16 fused_branch on the same operands,
    with a random dx_last on the first trunk: y, x_last and its flips, the
    gradients of x0 and every weight and bias."""
    _, pdec, _, pspecs = _k5_decoder(model_type)
    st = make_generic_train_decoder(pspecs).statics._replace(train=train)
    assert st.dtype == BF16
    rng = np.random.RandomState(5)
    for t, (x0, ws, xs, bs, n_out) in enumerate(_k5_trunks(pdec, pspecs, _k5_rows())):
        assert xs[0].shape[0] == 2 * x0.shape[1]  # the stacked pair
        leaves = [v.detach().clone().requires_grad_() for v in [x0, *flatten_params(ws, xs, bs)]]
        before = k5.generic_train_decode.launches, k5.generic_train_decode.bf16_launches
        y, xl = k5.generic_train_decode(leaves[0], *unflatten_params(st, leaves[1:]), 11 + t, st)
        assert (k5.generic_train_decode.launches, k5.generic_train_decode.bf16_launches) == before
        dy = rng.randn(*y.shape).astype(np.float32)
        dxl = (rng.randn(*xl.shape) if t == 0 else np.zeros(xl.shape)).astype(np.float32)
        grads = torch.autograd.grad((y, xl), leaves, (torch.from_numpy(dy),
                                                       torch.from_numpy(dxl)))
        jy, jxl, jgrads = _jax_k5_vjp(x0, ws, xs, bs, st, 11 + t, dy, dxl)
        _close_mostly(y.detach().numpy(), jy, "y")
        _close_mostly(xl.detach().numpy(), jxl, "x_last")
        assert torch.equal(xl, round_to(xl.detach(), BF16))
        assert _flips(xl.detach().numpy(), jxl) <= 0.001 * xl.numel()
        assert len(grads) == len(jgrads)
        for j, (g, w) in enumerate(zip(grads, jgrads)):
            assert g.dtype == torch.float32
            _close_grad(g.numpy(), w, f"trunk {t} gradient {j}")


def test_summed_layer_0_weights_miss_jax_bf16():
    """Why a bf16 plan keeps layer 0's two weights apart: K5's plain bf16
    version on their float32 sum (one rounding, the float32 plan's
    operands) falls outside the bounds against JAX's bf16 kernel that the
    stacked pair meets (test_plain_bf16_k5_matches_jax_kernel)."""
    _, pdec, _, pspecs = _k5_decoder("1encoder2decoder")
    st = make_generic_train_decoder(pspecs).statics._replace(train=False)
    x0, ws, xs, bs, _ = _k5_trunks(pdec, pspecs, _k5_rows())[0]
    e = x0.shape[1]
    summed = [xs[0][:e] + xs[0][e:], *xs[1:]]
    with torch.no_grad():
        y_sum, _ = k5.generic_train_decode_reference(x0, ws, summed, bs, 11, st)
        y_two, _ = k5.generic_train_decode_reference(x0, ws, xs, bs, 11, st)
    dy = np.zeros((1, M5), np.float32)
    jy, _, _ = _jax_k5_vjp(x0, ws, xs, bs, st, 11, dy, np.zeros((M5, 64), np.float32))
    _close_mostly(y_two.numpy(), jy, "y (stacked)")
    err = np.abs(y_sum.numpy().astype(np.float64) - jy)
    assert float((err <= TIGHT).mean()) < SHARE, float((err <= TIGHT).mean())


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
def test_bf16_generic_train_decoder_matches_jax(model_type):
    """The decoder as a bf16 latent_in (0, 2) train step runs it (the rows
    [latent, embedding] from a bf16 latent, K5's plain bf16 version, the
    logits a float32 product) against JAX's bf16 make_fused_train_decoder:
    the SDFs and logits, every parameter's gradient (float32, unrounded),
    the embedding's, and the bf16 latent's: bf16 on both sides (rounded at
    the rows' concatenation), within one bf16 step of JAX's."""
    params, pdec, jspecs, pspecs = _k5_decoder(model_type)
    rows = _k5_rows()
    rng = np.random.RandomState(6)
    lat16 = jnp.asarray(rows[:, :LS5]).astype(jnp.bfloat16)
    emb = rows[:, LS5:]
    proj = rng.randn(M5, NUM_CLASS).astype(np.float32)
    fused = make_fused_train_decoder(jspecs, block=BLOCK, interpret=True)

    def loss(p, lat, e):
        h, o, c = fused(p, jnp.concatenate([lat, e], axis=1), jnp.int32(11), train=True)
        return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + jnp.sum(c * proj), (h, o, c)

    (_, (jh, jo, jc)), (gp, gl, ge) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), lat16, jnp.asarray(emb))
    assert gl.dtype == jnp.bfloat16
    decode = make_generic_train_decoder(pspecs)
    lat_t = torch.from_numpy(np.asarray(lat16.astype(jnp.float32))).to(BF16).requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    pdec.zero_grad()
    h, o, c = decode(pdec, torch.cat([lat_t, emb_t], dim=1), 11, True)
    (torch.sum(torch.sin(h)) + torch.sum(o ** 2) + torch.sum(c * torch.from_numpy(proj))).backward()
    _close_mostly(h.detach().numpy(), np.asarray(jh)[:, 0], "sdf_hand")
    _close_mostly(o.detach().numpy(), np.asarray(jo)[:, 0], "sdf_obj")
    _close_grad(c.detach().numpy(), jc, "logits")
    assert lat_t.grad.dtype == BF16
    _close_bf16_grad(lat_t.grad.float().numpy(), np.asarray(gl.astype(jnp.float32)), "latent")
    _close_grad(emb_t.grad.numpy(), ge, "emb")
    assert _param_grads(pdec, gp, _close_grad) == 4 * len(gp) + 1
    first = trunk_prefixes(pdec)[0]
    v = getattr(pdec, f"{first}0").weight_v.grad
    assert v.dtype == torch.float32 and not torch.equal(v, round_to(v, BF16))


# ---------------------------------------------------------------------------
# the bf16 packs
# ---------------------------------------------------------------------------

def _runs(stream, shapes):
    """Split a bf16 tile stream into its (k, n) runs, untiled."""
    out, at = [], 0
    for k, n in shapes:
        size = k * n // 2
        out.append(untile_weights(stream[at:at + size], k, n, BF16))
        at += size
    assert at == stream.numel()
    return out


@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
def test_bf16_k4_pack_holds_the_rounded_operands(model_type):
    """A bf16 K4 pack at the flagship widths' shape (C = 256, hidden 512 ->
    250 -> 512): the forward's runs untile to [W; Lat] rounded, layer by
    layer and trunk by trunk, the chain's to their transposes; the table,
    the mean, the embedding, X and the final weights rounded, the biases
    not; the table's and the embedding's bf16 copies equal to them."""
    jspecs, pspecs = _pixel_specs(model_type)
    ns = NetworkSpecs(dims=(512, 512, 512, 512), latent_in=(2,))
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=PFS,
                  latent_size=256, pixel_align=True, samples_per_scene=N, sdf_scale_factor=7.0,
                  image_size=(64, 64), network_specs=ns, compute_dtype="bfloat16")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        pdec = make_decoder(model_type, 256, PFS, "both", ns)
    rng = np.random.RandomState(3)
    m = B * N
    table = torch.from_numpy(rng.randn(B, HF * WF, 256).astype(np.float32))
    mean = table.mean(1)
    xp = torch.from_numpy((rng.rand(m) * WF).astype(np.float32))
    yp = torch.from_numpy((rng.rand(m) * HF).astype(np.float32))
    mask = torch.ones(m)
    emb = torch.from_numpy(rng.randn(m, PFS).astype(np.float32))
    with torch.no_grad():
        trunks = pixel_trunks(pdec, specs, 256)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=(HF, WF))
    p = pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st)
    assert p.dtype == BF16 and p.c_pad == 256
    assert torch.equal(p.table, round_to(table, BF16)) and torch.equal(p.table16.float(), p.table)
    assert torch.equal(p.mean, round_to(mean, BF16))
    assert torch.equal(p.emb_t, round_to(emb, BF16).T) and torch.equal(p.emb16.float(), p.emb_t)
    fwd_shapes, fwd_want, chain_shapes, chain_want = [], [], [], []
    for (ws, lats, xs, bs), t in zip(trunks, p.trunks):
        layers = []
        for layer in range(len(bs) - 1):
            mats = [x for x in (t.w[layer], t.lat[layer]) if x is not None]
            layers.append(torch.cat(mats))
            fwd_shapes.append((layers[-1].shape[0], t.out_pads[layer]))
        fwd_want += layers
        for s in reversed(layers):
            chain_shapes.append((s.shape[1], s.shape[0]))
            chain_want.append(s.T)
        for layer, (w, lat, x, b) in enumerate(zip(ws, lats, xs, bs)):
            if w is not None:
                assert torch.equal(t.w[layer][:w.shape[0], :w.shape[1]], round_to(w, BF16))
            if lat is not None:
                assert torch.equal(t.lat[layer][:lat.shape[0], :lat.shape[1]], round_to(lat, BF16))
                assert torch.equal(t.x[layer][:, :x.shape[1]], round_to(x, BF16))
            assert torch.equal(t.b[layer][:b.shape[0]], b)
        assert torch.equal(t.wt[-1], t.w[-1].T)
    assert fwd_shapes[:4] == [(256, 512), (512, 256), (512, 512), (512, 512)]
    for got, want in zip(_runs(p.fwd, fwd_shapes), fwd_want):
        assert torch.equal(got, want)
    for got, want in zip(_runs(p.chain, chain_shapes), chain_want):
        assert torch.equal(got, want)


@pytest.mark.parametrize("model_type,pfs", [("1encoder2decoder", 9), ("1encoder1decoder", 9),
                                            ("1encoder2decoder", 63)])
def test_bf16_k5_pack_keeps_layer_0_twice(model_type, pfs):
    """A bf16 K5 pack of the flagship with latent_in (0, 2) (rows of 256 +
    6, 9 or 63): the head stays the latent's 256 columns (twice at layer 0:
    512 rows, the buffer's), the forward's layer-0 run untiles to [W_0[:h];
    W_in[:h]] rounded apart, the latent_in layer's to [W; X[:h]], the chain's
    to their transposes; the tail takes the two rounded weights' sum; x0
    rounded, its bf16 copy equal.  A float32 pack of the same spec sums
    the pair and reads the head once."""
    ns = NetworkSpecs(latent_in=(0, 2))
    style = "both" if pfs == 9 else "nerf"
    specs = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                  latent_size=256, network_specs=ns, compute_dtype="bfloat16")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(15)
        pdec = make_decoder(model_type, 256, pfs, style, ns)
    rows = torch.randn(256, 256 + pfs, generator=torch.Generator().manual_seed(15))
    st = make_generic_train_decoder(specs).statics
    first, second = trunk_prefixes(pdec)
    inputs = [rows] if second is None else separate_decoder_inputs(256, style, rows)
    for prefix, width, x0 in zip((first, second), trunk_input_widths(specs), inputs):
        with torch.no_grad():
            ws, xs, bs = generic_trunk_operands(pdec, prefix, width, specs,
                                                2 if second is None else 1)
        e = x0.shape[1]
        assert xs[0].shape == (2 * e, bs[0].shape[0])
        p = k5.pack_generic_trunk(x0.contiguous(), ws, xs, bs, st)
        assert p.twice and p.head == p.head_pad == 256 and p.dtype == BF16
        assert torch.equal(p.x0_t, round_to(x0, BF16).T) and torch.equal(p.x016.float(), p.x0_t)
        h = p.head
        pad = lambda t, out: torch.nn.functional.pad(t, (0, out - t.shape[1]))  # noqa: E731
        layer0 = torch.cat([pad(round_to(xs[0][:h], BF16), p.out_pads[0]),
                            pad(round_to(xs[0][e:e + h], BF16), p.out_pads[0])])
        layer2 = torch.cat([p.w[2], pad(round_to(xs[2][:h], BF16), p.out_pads[2])])
        fwd = _runs(p.fwd, [(512, 512), (512, 256), (512, 512), (512, 512)])
        assert torch.equal(fwd[0], layer0) and torch.equal(fwd[2], layer2)
        assert torch.equal(fwd[1], p.w[1]) and torch.equal(fwd[3], p.w[3])
        chain = _runs(p.chain, [(512, 512), (512, 512), (256, 512), (512, 512)])
        assert torch.equal(chain[3], layer0.T) and torch.equal(chain[1], layer2.T)
        tail0 = round_to(xs[0][h:e], BF16) + round_to(xs[0][e + h:], BF16)
        assert torch.equal(p.tail[0][:, :xs[0].shape[1]], tail0)
        assert torch.equal(p.tail[2][:, :xs[2].shape[1]], round_to(xs[2][h:], BF16))
        f32 = k5.pack_generic_trunk(x0.contiguous(), ws, [xs[0][:e] + xs[0][e:], *xs[1:]], bs,
                                    st._replace(dtype=torch.float32))
        assert not f32.twice and f32.x016 is None and f32.head == 256


# ---------------------------------------------------------------------------
# one bf16 train step of the narrow --pa_feat spec
# ---------------------------------------------------------------------------

# ClampingDistance 1 and targets placed off the L1 loss's kink (_off_the_kink):
# at the seeded targets one object point's float32 prediction lies 6.5e-5
# from its target, below the bf16 noise there (3e-4), so the sign of its L1
# derivative is a coin flip between any two bf16 runs, and that one point
# moves the object trunk's final bias gradient by 2/256 (measured: 7.8e-3
# between the port's bf16 step and JAX's, against 7.1e-6 between JAX's
# bf16 and float32 steps, where the flip fell on a hand point), which swamps
# the comparison of the two frameworks' roundings that the test is for.
STEP_SPECS = dict(torch_parity.PIXEL_NARROW, ComputeDtype="bfloat16", ImageSize=[64, 64],
                  SamplesPerScene=128, ScenesPerBatch=2, ClampingDistance=1.0)
KINK_GAP = (0.02, 0.05)  # each target's distance from its float32 prediction
STEP_RATIO = 0.85  # the flagship step's bound (tests/test_torch_bf16_train.py)
LOSS_RTOL, LOSS_ATOL = 0.05, 1e-4  # bf16 losses against the float32 step (JAX's test_bf16.py)
GROUPS = ("encoder.", "mano_decoder.", "volume_layer.", "decoder.linh", "decoder.lino")


def _port_step(specs_dict, state_dict, batch, seed):
    """One port train step from ``state_dict`` (CPU, K4's plain version):
    (losses, the updated state dict)."""
    from alignsdf_torch.config import specs_from_dict
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.training.train_state import TrainState, make_optimizer
    from alignsdf_torch.training.train_step import batch_to_device, make_train_step

    specs = specs_from_dict(specs_dict)
    model = build_model(specs)
    model.load_state_dict(state_dict)
    state = TrainState(model, make_optimizer(specs, model.parameters()))
    step = make_train_step(specs)
    assert step.decode.pixel
    assert step.decode.statics.dtype == (BF16 if specs.compute_dtype == "bfloat16"
                                         else torch.float32)
    losses = step(state, batch_to_device(batch, "cpu"), seed)
    return {k: float(v) for k, v in losses.items()}, {k: v.detach().clone()
                                                      for k, v in model.state_dict().items()}


def _off_the_kink(specs_dict, state_dict, batch, seed):
    """The batch with its SDF targets each KINK_GAP from the float32 step's
    prediction, on a random side, so that no point's L1 derivative changes
    sign under bf16's noise."""
    from alignsdf_torch.config import specs_from_dict
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.training.train_step import COND_KEYS, batch_to_device, make_train_step

    specs = specs_from_dict(dict(specs_dict, ComputeDtype="float32"))
    model = build_model(specs)
    model.load_state_dict(state_dict)
    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        fmap, emb, mano, _ = model.decoder_inputs_pixel(b["image"], b["xyz"],
                                                        {k: b[k] for k in COND_KEYS}, train=True)
        h, o, _ = make_train_step(specs).decode(model.decoder, fmap, emb, b["xyz"],
                                                b["cam_intr"], mano["joints"][:, 0:1], seed, True)
    rng = np.random.RandomState(1)
    out = dict(batch)
    for key, pred in (("sdf_gt_hand", h), ("sdf_gt_obj", o)):
        gap = rng.choice([-1.0, 1.0], pred.shape[0]) * rng.uniform(*KINK_GAP, pred.shape[0])
        out[key] = (pred.numpy() + gap).astype(np.float32).reshape(batch[key].shape)
    return out


def test_bf16_pixel_train_step_matches_jax(tmp_path):
    """One bf16 train step of the narrow --pa_feat spec (the encoder's
    convolutions and the one-pass BatchNorm on bf16, the bf16 HeadNet map
    through K4's plain bf16 version, float32 losses and Adam) against JAX's
    bf16 step (its pixel train kernel in interpret mode) from the same
    weights, batch and dropout seed: each parameter group's update (the
    decoder's two trunks apart) at a mean distance from JAX's of at most
    STEP_RATIO times JAX's own bf16-to-float32 update distance, and the
    losses within LOSS_RTOL / LOSS_ATOL of the float32 step's.  The final
    biases are 0, so that the SDF losses carry gradient into the decoder;
    the targets sit off the L1 loss's kink (STEP_SPECS).  Measured: the
    encoder 0.674, the MANO branch 0.596, the volume layer 0.038, the hand
    trunk 0.725, the object trunk 0.687; a port stepping in float32 (the
    mutation): 1.00-1.03."""
    from alignsdf_torch.data.synthetic import synthetic_train_batch

    _, _, pmodel, _, pspecs = torch_parity.build_pair_from_port(STEP_SPECS)
    with torch.no_grad():
        for name in ("linh4", "lino4"):
            getattr(pmodel.decoder, name).bias.zero_()
    init = {k: v.detach().clone() for k, v in pmodel.state_dict().items()}
    seed = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, jnp.iinfo(jnp.int32).max))
    batch = _off_the_kink(STEP_SPECS, init, synthetic_train_batch(pspecs, batch_size=2, seed=0),
                          seed)
    jax_out = torch_parity.jax_train_step_rounded(STEP_SPECS, pmodel, batch, 0,
                                                  str(tmp_path / "step"))
    port_losses, port_sd = _port_step(STEP_SPECS, init, batch, seed)
    f32_losses, _ = _port_step(dict(STEP_SPECS, ComputeDtype="float32"), init, batch, seed)
    (jb_losses, jb_sd), (_, jf_sd) = jax_out["bfloat16"], jax_out["float32"]
    assert set(port_losses) == set(jb_losses)
    for k, v in port_losses.items():
        assert np.isfinite(v)
        assert abs(v - f32_losses[k]) <= LOSS_RTOL * abs(f32_losses[k]) + LOSS_ATOL, k
    ratios = {}
    for group in GROUPS:
        keys = [k for k, v in init.items() if k.startswith(group) and v.dtype == torch.float32
                and not k.endswith(("running_mean", "running_var"))]
        assert keys, group

        def update(sd):
            return np.concatenate([(np.asarray(sd[k], np.float64)
                                    - init[k].numpy().astype(np.float64)).ravel() for k in keys])

        port, jb, jf = update(port_sd), update(jb_sd), update(jf_sd)
        own = float(np.abs(jb - jf).mean())
        assert own > 0, group
        ratios[group] = float(np.abs(port - jb).mean()) / own
    assert all(r <= STEP_RATIO for r in ratios.values()), ratios
