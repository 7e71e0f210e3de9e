"""bf16 training: the port's K2 bf16 contract, its latent fold, the one-pass
bf16 BatchNorm, K7 on bf16 and one bf16 train step against the JAX
package's bf16 functions, on the CPU.

- K2's plain bf16 version (``TrainDecodeReference``: the plain forward and
  the plain backward on its residuals) against JAX's scene-factored kernel
  (``fused_branch_scene`` with cdtype bfloat16, interpret mode) on the same
  folded operands, twin, combined and classifier trunks: y and x_last (the
  last residual) within TIGHT at >= SHARE of the entries and LOOSE
  everywhere, x_last's flips at ReLU's edge counted (0 allowed beyond
  FLIP_MAX); every gradient within GRAD_TOL of its largest entry.  Both
  sides round at the same points and sum in float32 in other orders, so now
  and then a hidden unit rounds to the neighbouring bf16 value and the next
  layers carry the step (measured on these seeds: y within TIGHT at
  99.87-100% of the points, the largest 3.6e-5; x_last at 99.998%, the
  largest 9.8e-4, one bf16 step; no flip; gradients 2.8e-5 of their
  largest at most).  JAX's interpret-mode kernel keeps its bf16 roundings
  in this process (checked against a process with
  --xla_allow_excess_precision=false: equal bit for bit).
- The decoder as the train step runs it (``make_train_decoder`` on a bf16
  spec, the fold included) against ``make_fused_train_decoder_factored``:
  the SDF and the gradients of every parameter, the latent and the
  embedding within the same bounds; but the latent's gradient, bf16 on
  both sides, within one bf16 step of each entry (beyond GRAD_TOL), and
  weight_v of layers 0 and 2, whose latent rows take such a cotangent,
  within FOLD_TOL (measured: the SDF within TIGHT at 99.09% of the points,
  the largest 1.1e-4; gradients 1.9e-3 of their largest at most, those
  weight_v 2.3e-3: the fold's float32 sums in another order move the bias
  tables, which moves some hidden units' bf16 rounding).
- The fold alone: the latent's and W_lat's cotangents are rounded to bf16,
  as JAX's autodiff rounds them (bit for bit with JAX's).
- The one-pass BatchNorm in train mode on bf16 against JAX's
  ``TorchBatchNorm`` (outputs, running stats, the input's gradient).
- K7's plain version on bf16 against JAX's K7 in interpret mode: forward
  and backward bit for bit (dy1 and dx rounded to bf16).
- One bf16 train step of the narrow flagship against JAX's bf16 step run in
  a process whose XLA rounds where the code converts: each parameter
  group's update within STEP_RATIO of JAX's own bf16-to-float32 update
  distance (the port: 0.29-0.73; a port that trains in float32: 1.00-1.04);
  the losses within rel 0.05 / abs 1e-4 of the float32 step (JAX's
  tests/test_bf16.py).
- ``cli.train --bf16 --smoke --device cpu``; a bf16 pack's tiles hold the
  rounded weights.

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py's phase 20."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.models.resnet import TorchBatchNorm
from alignsdf_tpu.ops.decoder_train_kernel import (
    _plan_statics,
    _scene_statics,
    fused_branch_scene,
    make_fused_train_decoder_factored,
)
from alignsdf_tpu.ops.maxpool import maxpool_k3s2p1 as jax_k7
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import decoder_from_jax
from alignsdf_torch.kernels.grid_decoder import TC_GROUP, round_to, untile_weights
from alignsdf_torch.kernels.maxpool import maxpool_k3s2p1
from alignsdf_torch.kernels.train_decoder import (
    PAD,
    flatten_params,
    pack_trunk,
    train_decode,
    unflatten_params,
)
from alignsdf_torch.models.decoder import make_decoder, trunk_prefixes
from alignsdf_torch.models.resnet import BatchNorm2d
from alignsdf_torch.ops.grid_plan import branch_columns
from alignsdf_torch.ops.train_plan import fold_latent, make_train_decoder, trunk_operands

import torch_parity

BF16 = torch.bfloat16
TIGHT = 1e-5      # y and x_last, port against JAX, at >= SHARE of the entries
LOOSE = 2e-3      # ... and everywhere
SHARE = 0.99
GRAD_TOL = 2e-3   # every gradient, of its largest entry
FLIP_MAX = 2e-3   # a residual 0 on one side may be at most this on the other
FOLD_TOL = 2 ** -7  # weight_v of a layer that takes the latent: one bf16 step of the largest
B, N, LS, PFS = 3, 256, 64, 9
DIMS = (128, 128, 128, 128)
NUM_CLASS = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _specs(model_type, num_class=0):
    ns = dict(dims=DIMS, dropout=(0, 1, 2, 3), dropout_prob=0.2, norm_layers=(0, 1, 2, 3),
              latent_in=(2,), num_class=num_class or 6)
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=PFS, latent_size=LS,
              samples_per_scene=N, compute_dtype="bfloat16", classifier_branch=num_class > 0)
    return (JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw),
            Specs(network_specs=NetworkSpecs(**ns), **kw))


def _pair(kind):
    """(JAX params, JAX factored decoder, port decoder, port decode, latent,
    emb, port specs) of a twin, combined or twin-with-classifier decoder,
    the port's weights from JAX's seeded init."""
    model_type = "1encoder1decoder" if kind == "combined" else "1encoder2decoder"
    num_class = NUM_CLASS if kind == "classifier" else 0
    jspecs, pspecs = _specs(model_type, num_class)
    rng = np.random.RandomState(2)
    latent = (rng.randn(B, LS) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    jdec = jax_make_decoder(model_type, LS, PFS, "both", jspecs.network_specs, num_class > 0)
    x = np.concatenate([np.repeat(latent, N, axis=0), emb], axis=1)
    params = jax.tree_util.tree_map(np.asarray,
                                    jdec.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    if num_class:  # a head large enough that the logits' gradients matter
        for trunk in params.values():
            if "classifier_head" in trunk:
                trunk["classifier_head"]["kernel"] = trunk["classifier_head"]["kernel"] * 20
    fac = make_fused_train_decoder_factored(jspecs, interpret=True)
    pdec = make_decoder(model_type, LS, PFS, "both", pspecs.network_specs,
                        use_classifier=num_class > 0)
    pdec.load_state_dict(decoder_from_jax(params))
    decode = make_train_decoder(pspecs)
    assert fac is not None and decode is not None and decode.statics.dtype == BF16
    return params, fac, pdec, decode, latent, emb, pspecs


def _close_mostly(got, want, name):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    share = float((err <= TIGHT).mean())
    assert share >= SHARE, (name, share, float(err.max()))
    assert float(err.max()) <= LOOSE, (name, float(err.max()))


def _close_grad(port, ref, name, tol=GRAD_TOL):
    ref = np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max()) + 1e-12
    err = float(np.abs(np.asarray(port, np.float64) - ref).max()) / scale
    assert err <= tol, (name, err)


def _close_bf16_grad(port, ref, name):
    """A cotangent that both sides round to bf16 (the latent's): each entry
    within one bf16 step of JAX's (a sum in another order may round to the
    neighbouring value) beyond GRAD_TOL of the largest."""
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    slack = 2.0 ** -7 * np.maximum(np.abs(port), np.abs(ref))
    excess = float((np.abs(port - ref) - slack).max()) / (float(np.abs(ref).max()) + 1e-12)
    assert excess <= GRAD_TOL, (name, excess)


def _pad(a, rows, cols):
    return np.pad(a, ((0, rows - a.shape[0]), (0, cols - a.shape[1])))


def _jax_trunk_vjp(ws, xs, bs, emb, seed, st, dy, dxl, block=128):
    """JAX's bf16 scene kernel on one trunk's folded operands (ws, xs, bs as
    ``trunk_operands`` gives them, padded to JAX's layout: the embedding to
    16 columns, widths to 128, scene tables row-0-of-8): (y (n_out, M),
    x_last (M, h)) and the VJP of (dy, dxl) as (d emb, [dW | None], [dX |
    None], [db]) at the true shapes."""
    n_layers = len(bs)
    e = emb.shape[1]
    outs = [b.shape[-1] for b in bs]
    pads = [-(-o // 128) * 128 for o in outs]
    weights = [_pad(xs[0], 16, pads[0])] + [_pad(ws[l], pads[l - 1], pads[l])
                                            for l in range(1, n_layers)]
    inject = tuple(l > 0 and xs[l] is not None for l in range(n_layers))
    injects = [_pad(xs[l], 16, pads[l]) if inject[l] else None for l in range(n_layers)]

    def table(b, width):
        if b.ndim == 2:
            return np.pad(_pad(b, b.shape[0], width)[:, None, :],
                          ((0, 0), (0, 7), (0, 0))).reshape(-1, width)
        return _pad(b[None], 1, width)

    biases = [table(b, p) for b, p in zip(bs, pads)]
    static = _scene_statics(_plan_statics(n_layers, inject, tuple(st.dropout), st.keep, block,
                                          "bfloat16", st.train, True, True),
                            st.n_per_scene // block, tuple(st.scene_bias))
    args = (tuple(map(jnp.asarray, weights)),
            tuple(None if i is None else jnp.asarray(i) for i in injects),
            tuple(map(jnp.asarray, biases)), jnp.asarray(_pad(emb, emb.shape[0], 16)))
    (y8, xl), pull = jax.vjp(lambda w, i, b, em: fused_branch_scene(static, w, i, b, em,
                                                                    jnp.int32(seed)), *args)
    n_out = outs[-1]
    dy8 = np.zeros((8, emb.shape[0]), np.float32)
    dy8[:n_out] = dy
    dxl_pad = np.zeros(xl.shape, np.float32)
    dxl_pad[:, :dxl.shape[1]] = dxl
    dw, di, db, dem = pull((jnp.asarray(dy8), jnp.asarray(dxl_pad)))
    dws = [None] + [np.asarray(dw[l])[:ws[l].shape[0], :outs[l]] for l in range(1, n_layers)]
    dxs = [np.asarray(dw[0])[:e, :outs[0]]] + [
        np.asarray(di[l])[:e, :outs[l]] if inject[l] else None for l in range(1, n_layers)]
    dbs = [np.asarray(d).reshape(-1, 8, d.shape[-1])[:, 0, :outs[l]] if b.ndim == 2
           else np.asarray(d)[0, :outs[l]] for l, (d, b) in enumerate(zip(db, bs))]
    return (np.asarray(y8)[:n_out], np.asarray(xl)[:, :outs[-2]],
            (np.asarray(dem)[:, :e], dws, dxs, dbs))


@pytest.mark.parametrize("kind", ["twin", "combined", "classifier"])
def test_plain_bf16_k2_matches_jax_kernel(kind):
    """Each trunk of the decoder through K2's plain bf16 version (with
    dx_last on the hand trunk) against JAX's bf16 scene kernel on the same
    folded operands: y and x_last, the flips, every gradient."""
    _, _, pdec, decode, latent, emb, specs = _pair(kind)
    st = decode.statics
    first, second = trunk_prefixes(pdec)
    cols = branch_columns(specs)
    rng = np.random.RandomState(5)
    trunks = [(first, cols[0], 1 if second else 2)] + ([(second, cols[1], 1)] if second else [])
    flips = 0
    for i, (prefix, c, out_dim) in enumerate(trunks):
        with torch.no_grad():
            ws, xs, bs = trunk_operands(pdec, prefix, len(c), torch.from_numpy(latent), specs,
                                        out_dim)
        e = torch.from_numpy(emb[:, list(c)])
        leaves = [t.detach().clone().requires_grad_() for t in [e, *flatten_params(ws, xs, bs)]]
        y, xl = train_decode(leaves[0], *unflatten_params(st, leaves[1:]), 11 + i, st)
        dy = rng.randn(*y.shape).astype(np.float32)
        dxl = (rng.randn(*xl.shape).astype(np.float32) if i == 0
               else np.zeros(xl.shape, np.float32))
        grads = torch.autograd.grad((y, xl), leaves, (torch.from_numpy(dy), torch.from_numpy(dxl)))
        np_ = lambda ts: [None if t is None else t.detach().numpy() for t in ts]  # noqa: E731
        jy, jxl, jgrads = _jax_trunk_vjp(np_(ws), np_(xs), np_(bs), e.numpy(), 11 + i, st, dy, dxl)
        _close_mostly(y.detach().numpy(), jy, f"{prefix} y")
        _close_mostly(xl.detach().numpy(), jxl, f"{prefix} x_last")
        xl_np = xl.detach().numpy()
        flip = (xl_np > 0) != (jxl > 0)
        flips += int(flip.sum())
        assert float(np.abs(xl_np - jxl)[flip].max(initial=0.0)) <= FLIP_MAX
        assert np.array_equal(xl_np, round_to(xl.detach(), BF16).numpy())  # bf16 values
        want = [jgrads[0], *flatten_params(*jgrads[1:])]
        assert len(want) == len(grads)
        for j, (g, w) in enumerate(zip(grads, want)):
            _close_grad(g.numpy(), w, f"{prefix} gradient {j}")
    assert flips <= 0.001 * xl.numel() * len(trunks)


@pytest.mark.parametrize("kind", ["twin", "classifier"])
def test_bf16_train_decoder_matches_jax(kind):
    """The decoder as a bf16 train step runs it (the latent folded in bf16,
    K2 in bf16, the logits in float32) against JAX's bf16 factored decoder:
    the SDF (and logits), and the gradients of every parameter, the latent
    and the embedding."""
    params, fac, pdec, decode, latent, emb, _ = _pair(kind)

    def loss_jax(p, lat, e):
        h, o, logits = fac(p, lat, e, jnp.int32(11), train=True)
        total = jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2)
        return total + (0.0 if logits is None else jnp.sum(jnp.cos(logits))), (h, o, logits)

    (_, (jh, jo, jl)), (gp, gl, ge) = jax.value_and_grad(loss_jax, argnums=(0, 1, 2),
                                                         has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(latent), jnp.asarray(emb))
    lat_t = torch.from_numpy(latent).requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    pdec.zero_grad()
    h, o, logits = decode(pdec, lat_t, emb_t, 11, True)
    total = torch.sum(torch.sin(h)) + torch.sum(o ** 2)
    if logits is not None:
        total = total + torch.sum(torch.cos(logits))
    total.backward()
    _close_mostly(h.detach().numpy(), jh, "sdf_hand")
    _close_mostly(o.detach().numpy(), jo, "sdf_obj")
    assert (logits is None) == (jl is None)
    if logits is not None:
        assert logits.dtype == torch.float32
        _close_grad(logits.detach().numpy(), jl, "logits")
    _close_bf16_grad(lat_t.grad.numpy(), gl, "latent")
    _close_grad(emb_t.grad.numpy(), ge, "emb")
    count = 0
    for trunk in gp.values():
        for name, g in trunk.items():
            layer = getattr(pdec, name)
            if "v" in g:
                # layers 0 and 2 take the latent: W's latent rows' cotangent
                # is rounded to bf16 on both sides (the fold), one step apart
                # at most
                _close_grad(layer.weight_v.grad.numpy().T, g["v"], name,
                            FOLD_TOL if name[-1] in "02" else GRAD_TOL)
                _close_grad(layer.weight_g.grad.numpy().reshape(-1), g["g"], name)
            else:
                _close_grad(layer.weight.grad.numpy().T, g["kernel"], name)
            _close_grad(layer.bias.grad.numpy(), g["bias"], name)
            count += 1
    assert count == 5 * len(gp) + (1 if kind == "classifier" else 0)


def test_bf16_fold_rounds_the_cotangents_as_jax():
    """beff = lat_bf16 @ W_bf16 summed in float32, unrounded; the latent's
    and W's cotangents rounded to bf16, as JAX's autodiff of
    jnp.dot(lat.astype(bf16), W.astype(bf16), preferred_element_type=f32)
    rounds them: equal bit for bit (two terms of four products each
    reassociate nowhere: K = 4)."""
    rng = np.random.RandomState(0)
    lat = (rng.randn(3, 4) * 0.7).astype(np.float32)
    w = (rng.randn(4, 40) * 0.3).astype(np.float32)
    g = (rng.randn(3, 40) * 1e-2).astype(np.float32)

    def f(l, ww):
        return jnp.sum(g * jnp.dot(l.astype(jnp.bfloat16), ww.astype(jnp.bfloat16),
                                   preferred_element_type=jnp.float32))

    val = jnp.dot(jnp.asarray(lat).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
                  preferred_element_type=jnp.float32)
    jl, jw = jax.grad(f, argnums=(0, 1))(jnp.asarray(lat), jnp.asarray(w))
    lt, wt = torch.from_numpy(lat).requires_grad_(), torch.from_numpy(w).requires_grad_()
    out = fold_latent(lt, wt, BF16)
    (out * torch.from_numpy(g)).sum().backward()
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(val), rtol=1e-6, atol=0)
    assert not np.array_equal(out.detach().numpy(), round_to(out.detach(), BF16).numpy())
    for port, ref in ((lt.grad, jl), (wt.grad, jw)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref, np.float32))
        assert np.array_equal(port.numpy(), round_to(port, BF16).numpy())  # bf16 values


def _bn_input(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 1.7 + 0.4).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_one_pass_batchnorm_matches_jax():
    """Train-mode BatchNorm on a bf16 input against JAX's TorchBatchNorm
    (train=True, bf16): the bf16 output equal to JAX's at >= 99% of the
    entries and within one bf16 step of it everywhere, the running mean and
    var within 1e-6 (relative), the input's gradient within 1e-2 of its
    largest.  The scale's and bias's gradients, sums over the batch of bf16
    products, are held to their float64 values (1e-2 of the largest): XLA
    on the CPU accumulates a bf16 reduction in bf16 (JAX's here 4.5% off
    the float64 sums, the port's 0.5%).  Eval mode still normalizes in
    float32 and returns bf16."""
    shape = (4, 6, 10, 12)  # NCHW
    x = _bn_input(shape, 0)
    dy = _bn_input(shape, 1)
    rng = np.random.RandomState(3)
    scale = (1 + 0.3 * rng.randn(6)).astype(np.float32)
    bias = (0.2 * rng.randn(6)).astype(np.float32)
    rm, rv = (0.1 * rng.randn(6)).astype(np.float32), (rng.rand(6) + 0.5).astype(np.float32)
    bn = TorchBatchNorm()
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}}
    xj = jnp.asarray(x.transpose(0, 2, 3, 1)).astype(jnp.bfloat16)

    def run(params, xx):
        out, upd = bn.apply({**variables, "params": params}, xx, train=True,
                            mutable=["batch_stats"])
        return out, upd

    jy, jupd = run(variables["params"], xj)
    _, vjp = jax.vjp(lambda p, xx: run(p, xx)[0], variables["params"], xj)
    jdp, jdx = vjp(jnp.asarray(dy.transpose(0, 2, 3, 1)).astype(jnp.bfloat16))

    pbn = BatchNorm2d(6, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        pbn.weight.copy_(torch.from_numpy(scale))
        pbn.bias.copy_(torch.from_numpy(bias))
        pbn.running_mean.copy_(torch.from_numpy(rm))
        pbn.running_var.copy_(torch.from_numpy(rv))
    xt = torch.from_numpy(x).to(BF16).requires_grad_()
    out = pbn(xt)
    out.backward(torch.from_numpy(dy).to(BF16))
    assert out.dtype == BF16 and xt.grad.dtype == BF16
    got = out.detach().float().numpy().transpose(0, 2, 3, 1)
    want = np.asarray(jy.astype(jnp.float32))
    assert float((got == want).mean()) >= 0.99
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)
    np.testing.assert_allclose(pbn.running_mean.numpy(), np.asarray(jupd["batch_stats"]["mean"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pbn.running_var.numpy(), np.asarray(jupd["batch_stats"]["var"]),
                               rtol=1e-6, atol=1e-7)
    assert int(pbn.num_batches_tracked) == 1
    jdx = np.asarray(jdx.astype(jnp.float32))
    gdx = xt.grad.float().numpy().transpose(0, 2, 3, 1)
    assert float(np.abs(gdx - jdx).max()) <= 1e-2 * float(np.abs(jdx).max())
    x64, dy64 = x.astype(np.float64), dy.astype(np.float64)
    n = x.size // x.shape[1]
    mean = x64.sum((0, 2, 3)) / n
    inv = 1 / np.sqrt((x64 ** 2).sum((0, 2, 3)) / n - mean ** 2 + 1e-5)
    d_a, d_b = (dy64 * x64).sum((0, 2, 3)), dy64.sum((0, 2, 3))
    for port, ref in ((pbn.weight.grad, d_a * inv - d_b * mean * inv), (pbn.bias.grad, d_b)):
        assert float(np.abs(port.numpy() - ref).max()) <= 1e-2 * float(np.abs(ref).max())
    # eval: the float32 statistics normalize in float32, the result bf16
    ev = pbn.eval()(torch.from_numpy(x).to(BF16))
    assert ev.dtype == BF16


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (5, 12, 20, 4), (1, 20, 18, 65)])
def test_plain_k7_bf16_matches_jax_k7(shape):
    """K7's plain version on bf16 against JAX's K7 on bf16 in interpret
    mode: the forward and the gradient (both passes' results rounded to
    bf16) equal bit for bit, on inputs with ties; the tie routing is the
    float32 K7's (tests/test_torch_maxpool.py)."""
    rng = np.random.default_rng(sum(shape))
    x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)
    n, h, w, _ = shape
    x[:, h // 8:h // 2, w // 4:3 * w // 4, :] = 0.7
    dy = rng.normal(size=(n, h // 2, w // 2, shape[3])).astype(np.float32)
    xj, dyj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dy).astype(jnp.bfloat16)
    jy, pull = jax.vjp(lambda a: jax_k7(a, True), xj)
    (jdx,) = pull(dyj)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32)).transpose(0, 3, 1, 2)).to(BF16)
    xt = xt.contiguous().requires_grad_()
    y = maxpool_k3s2p1(xt)
    y.backward(torch.from_numpy(np.asarray(dyj.astype(jnp.float32)).transpose(0, 3, 1, 2)).to(BF16))
    assert y.dtype == xt.grad.dtype == BF16
    np.testing.assert_array_equal(y.detach().float().numpy().transpose(0, 2, 3, 1),
                                  np.asarray(jy.astype(jnp.float32)))
    got = xt.grad.float().numpy().transpose(0, 2, 3, 1)
    want = np.asarray(jdx.astype(jnp.float32))
    np.testing.assert_array_equal(got, want)
    # dy1 rounded before its second pass: a float32 gradient, rounded once at
    # the end, differs somewhere on these ties
    x32 = xt.detach().float().requires_grad_()
    maxpool_k3s2p1(x32).backward(torch.from_numpy(
        np.asarray(dyj.astype(jnp.float32)).transpose(0, 3, 1, 2)))
    once = x32.grad.to(BF16).float().numpy().transpose(0, 2, 3, 1)
    assert not np.array_equal(once, want)


def test_k7_refuses_float16_without_casting():
    x = torch.rand(1, 2, 9, 9).to(torch.float16)
    with pytest.raises(NotImplementedError, match="K7 on torch.float16"):
        maxpool_k3s2p1(x)


@pytest.mark.parametrize("kind", ["twin", "combined"])
def test_bf16_pack_holds_the_rounded_weights(kind):
    """A bf16 K2 pack: the forward's tiles untile to bf16(W) of every hidden
    layer but the first, the chain's to bf16(W)^T (last layer first), X,
    the final weights and the embedding rounded, the biases not; the
    embedding's bf16 copy for the reduction equal to the rounded one."""
    _, _, pdec, decode, latent, emb, specs = _pair(kind)
    st = decode.statics
    prefix = trunk_prefixes(pdec)[0]
    c = branch_columns(specs)[0]
    with torch.no_grad():
        ws, xs, bs = trunk_operands(pdec, prefix, len(c), torch.from_numpy(latent), specs,
                                    2 if kind == "combined" else 1)
    e = torch.from_numpy(emb[:, list(c)])
    p = pack_trunk(e, ws, xs, bs, st)
    f32 = pack_trunk(e, ws, xs, bs, st._replace(dtype=torch.float32))
    assert p.dtype == BF16 and p.fwd.dtype == torch.float32 and p.fwd.numel() * 2 == \
        f32.fwd.numel() // 2
    hidden = range(1, len(bs) - 1)
    pads = p.out_pads
    at = 0
    for layer in hidden:
        k, n = pads[layer - 1], pads[layer]
        size = k * n // 2
        got = untile_weights(p.fwd[at:at + size], k, n, BF16)
        want = round_to(ws[layer], BF16)
        assert torch.equal(got[:want.shape[0], :want.shape[1]], want)
        assert float(got[want.shape[0]:].abs().sum() + got[:, want.shape[1]:].abs().sum()) == 0
        at += size
    assert at == p.fwd.numel()
    at = 0
    for layer in reversed(hidden):
        k, n = pads[layer], pads[layer - 1]
        size = k * n // 2
        got = untile_weights(p.chain[at:at + size], k, n, BF16)
        want = round_to(ws[layer], BF16).T
        assert torch.equal(got[:want.shape[0], :want.shape[1]], want)
        at += size
    for layer, x in enumerate(xs):
        if x is not None:
            assert torch.equal(p.x[layer][:, :x.shape[1]], round_to(x, BF16))
    assert torch.equal(p.w[-1][:ws[-1].shape[0]], round_to(ws[-1], BF16))
    assert torch.equal(p.wt[-1], p.w[-1].T)
    for b_pack, b in zip(p.b, bs):
        assert torch.equal(b_pack[..., :b.shape[-1]], b)
    assert torch.equal(p.emb_t, round_to(e, BF16).T)
    assert p.emb16.dtype == BF16 and torch.equal(p.emb16.float(), p.emb_t)
    assert f32.emb16 is None and torch.equal(f32.emb_t, e.T)
    assert all(o % PAD == 0 and o % TC_GROUP == 0 for o in pads[:-1])


# the narrow flagship in bf16 at 64x64 images, 2 scenes x 128 points
STEP_SPECS = dict(torch_parity.FLAGSHIP_NARROW, ComputeDtype="bfloat16", ImageSize=[64, 64],
                  SamplesPerScene=128, ScenesPerBatch=2)
# a group's update distance from JAX's bf16 step, of JAX's own bf16-to-float32
# one.  Measured: 0.29 (volume_layer) to 0.73 (mano_decoder), a float32 port
# 1.00-1.04.  Not 0.5: with XLA's rounding on, JAX's CPU step accumulates
# its bf16 reductions in bf16 (its BatchNorm affine gradients 4.5% off their
# float64 sums, the port's 0.5%, test_one_pass_batchnorm_matches_jax), a
# noisier bf16 step than the port's float32 accumulation or a TPU's.
STEP_RATIO = 0.85
LOSS_RTOL, LOSS_ATOL = 0.05, 1e-4  # bf16 losses against the float32 step (JAX's test_bf16.py)
GROUPS = ("encoder.", "mano_decoder.", "volume_layer.", "decoder.")


def _port_step(specs_dict, state_dict, batch, seed):
    """One port train step from ``state_dict`` (CPU, K2's plain version):
    (losses, the updated state dict)."""
    from alignsdf_torch.config import specs_from_dict
    from alignsdf_torch.models.alignsdf import build_model
    from alignsdf_torch.training.train_state import TrainState, make_optimizer
    from alignsdf_torch.training.train_step import batch_to_device, make_train_step

    specs = specs_from_dict(specs_dict)
    model = build_model(specs)
    model.load_state_dict(state_dict)
    state = TrainState(model, make_optimizer(specs, model.parameters()))
    losses = make_train_step(specs)(state, batch_to_device(batch, "cpu"), seed)
    return {k: float(v) for k, v in losses.items()}, {k: v.detach().clone()
                                                      for k, v in model.state_dict().items()}


def test_bf16_train_step_matches_jax(tmp_path):
    """One bf16 train step of the narrow flagship (the encoder's convolutions
    and the one-pass BatchNorm on bf16, K2's plain bf16 version, float32
    losses and Adam) against JAX's bf16 step from the same weights, batch
    and dropout seed: each parameter group's update at a mean distance from
    JAX's of at most STEP_RATIO times JAX's own bf16-to-float32 update
    distance, and the losses within LOSS_RTOL / LOSS_ATOL of the float32
    step's.  A port that trains in float32 sits at about 1 times that
    distance (the mutation check in CHANGES.md).  The final biases are 0, so
    that the SDF losses carry gradient into the decoder."""
    from alignsdf_torch.data.synthetic import synthetic_train_batch

    _, _, pmodel, _, pspecs = torch_parity.build_pair_from_port(STEP_SPECS)
    with torch.no_grad():
        for name in ("linh4", "lino4"):
            getattr(pmodel.decoder, name).bias.zero_()
    init = {k: v.detach().clone() for k, v in pmodel.state_dict().items()}
    batch = synthetic_train_batch(pspecs, batch_size=2, seed=0)
    seed = int(jax.random.randint(jax.random.PRNGKey(0), (), 0, jnp.iinfo(jnp.int32).max))
    jax_out = torch_parity.jax_train_step_rounded(STEP_SPECS, pmodel, batch, 0,
                                                  str(tmp_path / "step"))
    port_losses, port_sd = _port_step(STEP_SPECS, init, batch, seed)
    f32_losses, _ = _port_step(dict(STEP_SPECS, ComputeDtype="float32"), init, batch, seed)
    (jb_losses, jb_sd), (_, jf_sd) = jax_out["bfloat16"], jax_out["float32"]
    assert set(port_losses) == set(jb_losses)
    for k, v in port_losses.items():
        assert np.isfinite(v)
        assert abs(v - f32_losses[k]) <= LOSS_RTOL * abs(f32_losses[k]) + LOSS_ATOL, k
    for group in GROUPS:
        keys = [k for k, v in init.items() if k.startswith(group) and v.dtype == torch.float32
                and not k.endswith(("running_mean", "running_var"))]
        assert keys, group

        def update(sd):
            return np.concatenate([(np.asarray(sd[k], np.float64)
                                    - init[k].numpy().astype(np.float64)).ravel() for k in keys])

        port, jb, jf = update(port_sd), update(jb_sd), update(jf_sd)
        own = float(np.abs(jb - jf).mean())
        dist = float(np.abs(port - jb).mean())
        assert own > 0, group
        assert dist <= STEP_RATIO * own, (group, dist / own)


def test_cli_train_bf16_smoke(tmp_path, capfd):
    """cli.train --bf16 --smoke on the narrow flagship on the CPU: it trains
    (K2's plain bf16 version), and the log names the compute dtype on its
    own line."""
    from alignsdf_torch.cli.train import main as train_main

    path = tmp_path / "spec.json"
    path.write_text(json.dumps(dict(torch_parity.FLAGSHIP_NARROW, ImageSize=[64, 64],
                                    SamplesPerScene=128)))
    train_main(["-e", str(path), "--smoke", "--device", "cpu", "--bf16",
                "--output_root", str(tmp_path)])
    text = capfd.readouterr().err
    assert "compute dtype: bfloat16" in text and "scene-factored (K2)" in text
    assert "smoke OK" in text
