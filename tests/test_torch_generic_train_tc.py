"""Kernel K5 on the tensor cores (csrc/generic_train_decoder.cu, on
csrc/train_fwd_tc.cuh and csrc/chain_tc.cuh) on the CPU: the pack's head
and tail split of x0 and its forward and chain tile streams at full width,
and a split-TF32 emulation of the whole forward and backward chain against
the plain versions and against the JAX package's ``fused_branch`` and its
custom VJP in interpret mode.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
TF32 is emulated as in tests/test_torch_train_fwd_tc.py: round to nearest,
ties away, on the float32 bits; a TF32 x TF32 product is exact in float64
and each layer's sum is rounded once to float32.  The emulation walks the
points in the kernels' 64-point tiles, rows past M included (zero rows of
x0, zero dy), and keeps the first M; its backward stands in for the
kernels' wrappers under K5's autograd Function, whose padding and gradient
order it so exercises.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity
from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.torch_import import convert_combined_decoder, convert_separate_decoder
from alignsdf_tpu.ops.decoder_train_kernel import make_fused_train_decoder
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.kernels import generic_train_decoder as k5
from alignsdf_torch.kernels.train_decoder import flatten_params
from alignsdf_torch.models.decoder import make_decoder, separate_decoder_inputs, trunk_prefixes
from alignsdf_torch.ops.decoder_plan import trunk_input_widths
from alignsdf_torch.ops.generic_train_plan import generic_trunk_operands, make_generic_train_decoder
from test_torch_generic_train import _relu_margin
from test_torch_split_tf32 import _chain_runs
from test_torch_train_fwd_tc import _Stream, _layer, _product, _runs_view_back, _tiled

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


# ---------------------------------------------------------------------------
# the pack at full width: the head, the tail, the tile streams
# ---------------------------------------------------------------------------

# (model type, encode style, point_feat_size): x0 rows of 262 (latent + 6)
# per trunk, 265 on the combined trunk, 319 at --point_size 63's NeRF PE
FULL = [("1encoder2decoder", "both", 9), ("1encoder1decoder", "both", 9),
        ("1encoder2decoder", "nerf", 63)]


def _full_packs(model_type, style, pfs):
    """K5's packs of the trunks of a full-width decoder with latent_in
    (0, 2) on 256 random rows."""
    ns = NetworkSpecs(latent_in=(0, 2))
    specs = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                  latent_size=256, network_specs=ns)
    with torch.random.fork_rng():
        torch.manual_seed(15)
        decoder = make_decoder(model_type, 256, pfs, style, ns)
    gen = torch.Generator().manual_seed(15)
    rows = torch.randn(256, 256 + pfs, generator=gen)
    st = make_generic_train_decoder(specs).statics
    first, second = trunk_prefixes(decoder)
    inputs = [rows] if second is None else separate_decoder_inputs(256, style, rows)
    out = []
    with torch.no_grad():
        for prefix, width, x0 in zip((first, second), trunk_input_widths(specs), inputs):
            ws, xs, bs = generic_trunk_operands(decoder, prefix, width, specs,
                                                2 if second is None else 1)
            out.append((xs, k5.pack_generic_trunk(x0.contiguous(), ws, xs, bs, st)))
    return out


def _head_and_tail(xs, p):
    """The head is the latent's 256 columns, padded to a tensor-core group,
    and the tail, X's other rows, float32 as they are, on the layers with X
    (0 and 2) alone."""
    e = p.x0_t.shape[0]
    assert p.head == p.head_pad == 256 and e - p.head in (6, 9, 63)
    assert p.out_pads[:-1] == [512, 256, 512, 512] and p.has_x == [x is not None for x in xs]
    assert [i for i, has in enumerate(p.has_x) if has] == [0, 2]
    for x, t, out_pad in zip(xs, p.tail, p.out_pads):
        if x is None:
            assert t is None
        else:
            assert t.shape == (e - 256, out_pad)
            assert torch.equal(t[:, :x.shape[1]], x[256:]) and bool((t[:, x.shape[1]:] == 0).all())


@pytest.mark.parametrize("model_type,style,pfs", FULL)
def test_k5_forward_tiles_view_back_the_weights(model_type, style, pfs):
    """The forward's tile stream, run by run in layer order, holds [W;
    X[:h]]'s TF32 halves: layer 0's head rows alone (depth 256), the
    latent_in layer's W over the head (256 + 256), the others W; the tail
    stays float32 beside it."""
    for xs, p in _full_packs(model_type, style, pfs):
        _head_and_tail(xs, p)
        heads = [None if x is None else torch.nn.functional.pad(x[:256], (0, out_pad - x.shape[1]))
                 for x, out_pad in zip(xs, p.out_pads)]
        layers = [(p.out_pads[layer], [p.w[layer], heads[layer]])
                  for layer in range(len(p.b) - 1)]
        assert [sum(t.shape[0] for t in mats if t is not None) for _, mats in layers] == \
            [256, 512, 512, 512]
        _runs_view_back(p.fwd, layers)


@pytest.mark.parametrize("model_type,style,pfs", FULL)
def test_k5_chain_tiles_view_back_the_transposed_weights(model_type, style, pfs):
    """The backward chain's tile stream, run by run from the last hidden
    layer down, untiles to [W^T | X[:h]^T]: the latent_in layer's dx and
    d(head) outputs side by side, 256 + 256 of depth 512, and layer 0's
    d(head) alone; only the final layer keeps a plain transpose."""
    for xs, p in _full_packs(model_type, style, pfs):
        _head_and_tail(xs, p)
        n = len(p.b)
        runs = [(p.out_pads[layer], [p.w[layer], None if xs[layer] is None else xs[layer][:256]])
                for layer in range(n - 2, -1, -1)]
        assert [len([t for t in mats if t is not None]) for _, mats in runs] == [1, 2, 1, 1]
        _chain_runs(p.chain, runs)
        assert all(t is None for t in p.wt[:-1]) and torch.equal(p.wt[-1], p.w[-1].T)


def test_head_width_fits_the_buffer():
    """The head takes all of x0 where it fits beside the widest activation a
    latent_in layer reads, else the buffer's rows left beside it."""
    assert k5.head_width(262, [256]) == 256
    assert k5.head_width(319, [256]) == 256
    assert k5.head_width(38, [256]) == 38
    assert k5.head_width(262, []) == 262
    assert k5.head_width(600, []) == 512
    assert k5.head_width(38, [512]) == 0


# ---------------------------------------------------------------------------
# the emulated kernels
# ---------------------------------------------------------------------------

def _rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """t (M, c) with zero rows up to n."""
    out = t.new_zeros(n, t.shape[1])
    out[:t.shape[0]] = t
    return out


def k5_split_forward(p, seed, st):
    """generic_train_fwd_tc_kernel on a pack: (y (n_out, M), the residuals,
    each (out_pad, M)).  A layer with X runs one product over [activation |
    head] against its [W; X[:h]] tiles (layer 0 over the head alone), the
    tail's columns enter in the epilogue."""
    e, m = p.x0_t.shape
    rows = torch.arange(_tiled(m))
    x0 = _rows(p.x0_t.T, len(rows))
    head = torch.zeros(len(rows), p.head_pad)
    head[:, :p.head] = x0[:, :p.head]
    tail = x0[:, p.head:]
    stream, a, acts = _Stream(p.fwd), None, []
    for layer in range(len(p.b) - 1):
        parts = (([a] if p.w[layer] is not None else [])
                 + ([head] if p.has_x[layer] and p.head_pad else []))
        out_pad = p.out_pads[layer]
        acc = torch.zeros(len(rows), out_pad)
        if parts:
            inp = torch.cat(parts, dim=1)
            acc = _product(inp, stream.take(inp.shape[1], out_pad))
        a = _layer(acc, tail, p.tail[layer], p.b[layer], seed, layer, layer, rows, st)
        acts.append(a[:m].T.contiguous())
    assert stream.pos == p.fwd.numel()
    return torch.tanh(a @ p.wt[-1].T + p.b[-1])[:m].T.contiguous(), acts


def k5_split_backward(p, st, y, acts, dy, dx_last=None):
    """generic_train_bwd_chain_tc_kernel, then the reductions, on a pack:
    K5's backward wrapper's (dx0 (M, e), [(dW, dX, db)] padded).  A layer's
    product of dpre with [W^T | X[:h]^T] gives [dx | d(head)]; the tail's
    d(x0) columns come from dpre X[h:]^T.  The reductions (split TF32 on the
    card, float32's accuracy: tests/test_torch_split_tf32.py) are float64
    rounded to float32 here."""
    e, m = p.x0_t.shape
    n, h = len(p.b), p.head
    n_rows = _tiled(m)
    scale = [np.float32(1.0 / st.keep) if st.train and st.dropout[layer] else np.float32(1.0)
             for layer in range(n - 1)]
    res = [_rows(a.T, n_rows) for a in acts]  # (rows, out_pad)
    yv, dyv = _rows(y.T, n_rows), _rows(dy.T, n_rows)
    dpre = [None] * n
    dpre[-1] = dyv * (1.0 - yv * yv)
    dx = dpre[-1] @ p.w[-1].T
    if dx_last is not None:
        dx[:m, :dx_last.shape[1]] += dx_last
    cur = torch.where(res[-1] > 0, dx * scale[-1], 0.0)
    dpre[-2] = cur
    dhead, dtail = torch.zeros(n_rows, h), torch.zeros(n_rows, e - h)
    stream = _Stream(p.chain)
    for layer in range(n - 2, -1, -1):
        dx_rows = p.w[layer].shape[0] if layer > 0 else 0
        cols = dx_rows + (p.head_pad if p.has_x[layer] else 0)
        out = _product(cur, stream.take(p.out_pads[layer], cols)) if cols else None
        if p.tail[layer] is not None:
            dtail = dtail + cur @ p.tail[layer].T
        if p.has_x[layer] and h:
            dhead = dhead + out[:, dx_rows:dx_rows + h]
        if layer > 0:
            cur = torch.where(res[layer - 1] > 0, out[:, :dx_rows] * scale[layer - 1], 0.0)
            dpre[layer - 1] = cur
    assert stream.pos == p.chain.numel()
    x0 = _rows(p.x0_t.T, n_rows).double()

    def reduce(a, d):
        return (a.double().T @ d.double()).float()

    grads = [(None if p.w[layer] is None else reduce(res[layer - 1], dpre[layer]),
              reduce(x0, dpre[layer]) if p.has_x[layer] else None,
              dpre[layer].double().sum(0).float()) for layer in range(n)]
    return torch.cat([dhead, dtail], dim=1)[:m], grads


def _emulated(monkeypatch):
    """K5's autograd Function with the emulated kernels in the wrappers'
    place: the decode kernel for make_generic_train_decoder."""
    monkeypatch.setattr(k5, "generic_train_decode_forward", k5_split_forward)
    monkeypatch.setattr(k5, "generic_train_decode_backward", k5_split_backward)

    def kernel(x0, ws, xs, bs, seed, st):
        return k5.GenericTrainDecodeFunction.apply(st, seed, x0, *flatten_params(ws, xs, bs))

    return kernel


# (latent size, hidden widths; layer 1 emits its width less x0's): x0 all
# head (38 or 41 columns); the head the 256 latent columns and a tail of 6
# (9 combined), as at the flagship; no head (layer 1's 262 outputs pad to
# 512, which leaves the latent_in layer's buffer no rows), x0 all tail
CASES = {"all head": (32, (64, 64, 64, 64)), "head and tail": (256, (64, 300, 64, 64)),
         "all tail": (32, (64, 300, 64, 64))}
PFS, M = 9, 200  # 200 points: the last 64-point tile has rows past M


@pytest.fixture(scope="module", params=[(t, c) for t in ("1encoder2decoder", "1encoder1decoder")
                                        for c in CASES], ids=lambda v: f"{v[0]}-{v[1]}")
def k5_pair(request):
    """A narrow decoder with latent_in (0, 2) and a classifier in JAX and in
    the port (the same weights), JAX's fused_branch in interpret mode, and
    seeded rows whose hidden units all keep a margin from ReLU's edge."""
    model_type, case = request.param
    ls, dims = CASES[case]
    kw = dict(model_type=model_type, encode_style="both", point_feat_size=PFS, latent_size=ls,
              classifier_branch=True)
    ns = dict(dims=dims, dropout=(0, 1, 2, 3), dropout_prob=0.2, norm_layers=(0, 1, 2, 3),
              latent_in=(0, 2))
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw)
    pspecs = Specs(network_specs=NetworkSpecs(**ns), **kw)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        pdec = make_decoder(model_type, ls, PFS, "both", pspecs.network_specs, use_classifier=True)
    rng = np.random.RandomState(8)
    rows = (rng.randn(M, ls + PFS) * 0.5).astype(np.float32)
    assert _relu_margin(pdec, pspecs, rows, 11) > 2e-7
    convert = (convert_combined_decoder if model_type == "1encoder1decoder"
               else convert_separate_decoder)
    params = jax.tree_util.tree_map(jnp.asarray, convert(pdec.state_dict(), jspecs.network_specs,
                                                         True))
    fused = make_fused_train_decoder(jspecs, block=40, interpret=True)
    return case, fused, params, pdec, pspecs, rows, rng.randn(M, 6).astype(np.float32)


@pytest.mark.parametrize("train", [False, True])
def test_k5_split_kernels_match_plain_and_jax(k5_pair, train, monkeypatch):
    """The emulated forward and chain in 64-point tiles, rows past M
    included: per trunk, y and the residuals against the plain forward and
    every gradient against the plain backward fed the emulation's residuals
    (with a random dx_last on the first trunk); then the whole decoder under
    sum(sin(h)) + sum(o^2) + <logits, R> through K5's autograd Function
    against JAX's fused_branch and its VJP: the outputs, the rows' gradient
    and every parameter's, each to TOL (gradients of their largest entry)."""
    case, fused, params, pdec, specs, rows, proj = k5_pair
    seed = 11
    decode = make_generic_train_decoder(specs)
    st = decode.statics._replace(train=train)
    first, second = trunk_prefixes(pdec)
    x = torch.from_numpy(rows)
    inputs = [x] if second is None else separate_decoder_inputs(specs.latent_size, "both", x)
    gen = torch.Generator().manual_seed(4)
    heads = []
    with torch.no_grad():
        for t, (prefix, width, x0) in enumerate(zip((first, second), trunk_input_widths(specs),
                                                     inputs)):
            ws, xs, bs = generic_trunk_operands(pdec, prefix, width, specs,
                                                2 if second is None else 1)
            p = k5.pack_generic_trunk(x0.contiguous(), ws, xs, bs, st)
            heads.append((p.head, x0.shape[1]))
            y, acts = k5_split_forward(p, seed + t, st)
            refs = []
            y_ref, _ = k5.generic_train_decode_reference(x0, ws, xs, bs, seed + t, st, acts=refs)
            assert float((y - y_ref).abs().max()) <= TOL
            for a, r in zip(acts, refs):
                assert float((a[:r.shape[1]].T - r).abs().max()) <= TOL
                assert bool((a[r.shape[1]:] == 0).all())
            dy = torch.randn(y.shape, generator=gen)
            dxl = torch.randn(M, bs[-2].shape[-1], generator=gen) if t == 0 else None
            dx0, grads = k5_split_backward(p, st, y, acts, dy, dxl)
            plain = k5.generic_train_decode_backward_reference(
                x0, ws, xs, bs, st, y, [a[:b.shape[-1]].T for a, b in zip(acts, bs)], dy, dxl)
            got = [dx0, *flatten_params(
                [None if w is None else g[0][:w.shape[0], :w.shape[1]] for w, g in zip(ws, grads)],
                [None if xx is None else g[1][:, :xx.shape[1]] for xx, g in zip(xs, grads)],
                [g[2][:b.shape[-1]] for b, g in zip(bs, grads)])]
            for g, r in zip(got, [plain[0], *flatten_params(*plain[1:])]):
                assert g.shape == r.shape
                assert float((g - r).abs().max()) <= TOL * (float(r.abs().max()) + 1e-12)
    expect = {"all head": lambda e: e, "head and tail": lambda e: 256, "all tail": lambda e: 0}
    assert all(h == expect[case](e) for h, e in heads), heads

    def jax_loss(p, xj):
        h, o, c = fused(p, xj, jnp.int32(seed), train=train)
        return jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + jnp.sum(c * proj), (h, o, c)

    (_, (j_h, j_o, j_c)), (gp, gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(rows))
    pdec.zero_grad()
    xg = torch.from_numpy(rows).requires_grad_()
    h, o, c = make_generic_train_decoder(specs, kernel=_emulated(monkeypatch))(pdec, xg, seed,
                                                                             train=train)
    (torch.sum(torch.sin(h)) + torch.sum(o ** 2) + torch.sum(c * torch.from_numpy(proj))).backward()
    for port, ref in ((h, np.asarray(j_h)[:, 0]), (o, np.asarray(j_o)[:, 0]), (c, j_c)):
        np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=TOL, rtol=0)

    def close(port, ref, name):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max()) + 1e-12
        np.testing.assert_allclose(port / scale, ref / scale, atol=TOL, rtol=0, err_msg=name)

    close(xg.grad.numpy(), gx, "rows")
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
