"""The tensor-core trunk of kernels K1, K3 and K6 (csrc/grid_trunk_tc.cuh),
the train backwards' reverse chain of K2 and K4 (csrc/chain_tc.cuh) and
their weight-gradient reduction (csrc/wgrad_tc.cuh) on the CPU: why their
split-TF32 products meet the kernels' float32 contract, and the plans' and
packs' tiled, split weight layout.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
Here TF32 is emulated with bit arithmetic on float32 (round to nearest,
ties away from zero, as cvt.rna.tf32.f32 does; an emulation of the test's
own, not the package's ``tf32_round``, which it checks): a TF32 x TF32
product is exact in float64, and each layer's sum is rounded once to
float32, as the tensor cores' float32 accumulators hold it.
"""

import numpy as np
import pytest
import torch

import torch_parity
from alignsdf_torch.kernels.generic_decoder import pack_generic_plan
from alignsdf_torch.kernels.grid_decoder import (
    FoldedTrunk,
    HiddenLayer,
    TC_GROUP,
    TC_K,
    TC_MAX_OUT,
    TC_MAX_ROWS,
    pack_grid_plan,
    tc_smem_bytes,
    tf32_round,
    tf32_split,
    tile_weights,
    untile_weights,
)
from alignsdf_torch.kernels.pixel_grid_decoder import (
    PixelHiddenLayer,
    PixelTrunk,
    make_feature_table,
    pack_pixel_grid_plan,
)

# the flagship trunk at its true widths: xyz folded into layer 0, then
# 512 -> 250 -> 512 -> 512 -> 1
FLAGSHIP = (3, 512, 250, 512, 512, 1)
POINTS = 1024


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunk(seed: int):
    """He-scaled random layers (w (in, out), b) of the flagship trunk and
    POINTS random inputs in [-1, 1]^3."""
    rng = np.random.RandomState(seed)
    layers = []
    for fan_in, fan_out in zip(FLAGSHIP[:-1], FLAGSHIP[1:]):
        w = rng.randn(fan_in, fan_out) * np.sqrt(2.0 / fan_in)
        b = rng.randn(fan_out) * 0.05
        layers.append((torch.tensor(w, dtype=torch.float32), torch.tensor(b, dtype=torch.float32)))
    x = torch.tensor(rng.uniform(-1, 1, (POINTS, 3)), dtype=torch.float32)
    return layers, x


def _forward(layers, x, product, dtype=torch.float32):
    """tanh(trunk(x)) with ``product(a, w)`` (float64 out) for every layer's
    matrix product; each layer's sum rounds once to ``dtype``."""
    a = x
    for i, (w, b) in enumerate(layers):
        h = (product(a, w) + b.double()).to(dtype)
        a = torch.relu(h) if i < len(layers) - 1 else h
    return torch.tanh(a.double())


def _split(a, w):
    """big_a big_w + small_a big_w + big_a small_w, as the kernels run it."""
    ab, wb = tf32(a), tf32(w)
    asm, wsm = tf32(a - ab), tf32(w - wb)
    return ab.double() @ wb.double() + asm.double() @ wb.double() + ab.double() @ wsm.double()


def _one_pass(a, w):
    return tf32(a).double() @ tf32(w).double()


def _float32(a, w):
    return (a @ w).double()


def test_tf32_emulation_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 value after 1
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -12, 3.0], dtype=torch.float32)
    assert tf32(x).tolist() == [one, -one, 1.0, one, 3.0]
    # the split's halves rebuild a float32 value to 2^-22 of itself, and
    # the package's split (the plans' weights) is the same bits
    v = torch.randn(10000, generator=torch.Generator().manual_seed(0)) * 100
    big = tf32(v)
    small = tf32(v - big)
    assert bool(((big + small - v).abs() <= v.abs() * 2.0 ** -22).all())
    assert torch.equal(tf32_round(v), big)
    assert all(torch.equal(a, b) for a, b in zip(tf32_split(v), (big, small)))


def test_split_tf32_meets_float32_accuracy_one_pass_does_not():
    """The reason K1 and K3 run three TF32 products a multiply-add: at the
    flagship trunk's widths the split product is within 1e-6 of float64
    after tanh and no worse than twice float32's own error (5e-7 against
    1e-6 here), while one TF32 pass errs by more than 1e-5 (1.3e-3 here,
    over the kernels' whole 1e-4 tolerance)."""
    layers, x = _trunk(0)
    exact = _forward([(w.double(), b) for w, b in layers], x.double(),
                     lambda a, w: a.double() @ w, torch.float64)
    err = {name: float((_forward(layers, x, fn) - exact).abs().max())
           for name, fn in (("float32", _float32), ("split", _split), ("one_pass", _one_pass))}
    assert err["split"] <= 1e-6, err
    assert err["split"] <= 2 * err["float32"], err
    assert err["one_pass"] > 1e-5, err


def _folded(rng, widths, rows, fin_x=True):
    """A FoldedTrunk with random weights: layer 0 folded (x, b only), then
    (in, out) weights between ``widths``; final rows ``rows``."""
    hidden = [HiddenLayer(None, torch.tensor(rng.randn(3, widths[0]), dtype=torch.float32),
                          torch.tensor(rng.randn(widths[0]), dtype=torch.float32))]
    for w_in, w_out in zip(widths[:-1], widths[1:]):
        hidden.append(HiddenLayer(torch.tensor(rng.randn(w_in, w_out), dtype=torch.float32),
                                  None, torch.tensor(rng.randn(w_out), dtype=torch.float32)))
    k = len(rows)
    return FoldedTrunk(hidden, torch.tensor(rng.randn(widths[-1], k), dtype=torch.float32),
                       torch.tensor(rng.randn(3, k), dtype=torch.float32) if fin_x else None,
                       torch.tensor(rng.randn(k), dtype=torch.float32), rows)


def _padded_equal(view, ref, split=False):
    """The plan's (padded) view holds ``ref`` in its top-left, zeros
    elsewhere; with ``split``, ref's TF32 halves summed, which is ref to
    2^-22 of each entry."""
    assert view.shape[0] >= ref.shape[0] and view.shape[1] >= ref.shape[1]
    full = torch.zeros_like(view)
    if split:
        big, small = tf32_split(ref)
        assert bool(((big + small - ref).abs() <= ref.abs() * 2.0 ** -22).all())
        ref = big + small
    full[:ref.shape[0], :ref.shape[1]] = ref
    return torch.equal(view, full)


def test_tile_weights_round_trip_and_layout():
    """A tile is two wgmma B operands, big then small: element (k, o) of a
    (16, 256) matrix sits in tile (k // 8, o // 128), at [o % 128 // 8]
    [k % 8 // 4][o % 8][k % 4] of each half."""
    rng = np.random.RandomState(1)
    w = torch.tensor(rng.randn(13, 250), dtype=torch.float32)
    flat = tile_weights(w, 16, 256)
    assert flat.shape == (2 * 16 * 256,)
    assert _padded_equal(untile_weights(flat, 16, 256), w, split=True)
    tile = 2 * TC_GROUP * TC_K
    for k, o in ((0, 0), (5, 3), (9, 130), (12, 249)):
        pos = ((k // TC_K) * 2 + o // TC_GROUP) * tile + \
            (o % TC_GROUP // 8) * 64 + (k % 8 // 4) * 32 + (o % 8) * 4 + k % 4
        big, small = tf32(w[k, o][None]), tf32(w[k, o][None] - tf32(w[k, o][None]))
        assert float(flat[pos]) == float(big) and float(flat[pos + tile // 2]) == float(small)
    with pytest.raises(ValueError):
        tile_weights(w, 12, 256)


@pytest.mark.parametrize("classes,two_trunks", [(0, True), (6, True), (126, True), (0, False),
                                                (6, False)])
def test_grid_plan_views_give_back_the_folded_weights(classes, two_trunks):
    """K1's pack round trip: the plan's views give back every folded array,
    padded to the kernel's widths (hidden weights untiled, their TF32
    halves summed; bias and xyz weights from each layer's epilogue tile)."""
    rng = np.random.RandomState(2 + classes)
    widths = (40, 250, 130)
    if two_trunks:
        trunks = [_folded(rng, widths, [0, *range(2, 2 + classes)]), _folded(rng, widths, [1])]
    else:
        trunks = [_folded(rng, widths, [0, 1, *range(2, 2 + classes)], fin_x=False)]
    plan = pack_grid_plan(trunks, 16)
    assert plan.n_rows == 2 + classes
    assert int(plan.desc[2]) == 256  # rows: the widest layer, 250 -> 256
    assert plan.out_pads() == [128, 256, 256] * len(trunks)
    # each layer's bias and xyz weights are one ring tile: x = b + TC_MAX_OUT
    d, pos = plan.desc.tolist(), 4
    for trunk in trunks:
        pos += 4
        for h in trunk.hidden:
            _, x_off, b_off, _, _ = d[pos:pos + 5]
            pos += 5
            assert b_off % 4 == 0 and x_off == (b_off + TC_MAX_OUT if h.x is not None else -1)
    fin_b = torch.zeros(plan.n_rows)
    for trunk, (hidden, fin, fin_xyz) in zip(trunks, plan.trunks()):
        for h, (w, x, b) in zip(trunk.hidden, hidden):
            assert (w is None) == (h.w is None)
            if w is not None:
                assert w.shape[1] % TC_GROUP == 0
                assert _padded_equal(w, h.w, split=True)
            assert _padded_equal(x, h.x) if h.x is not None else x is None
            assert _padded_equal(b[None], h.b[None])
        assert torch.equal(fin[list(trunk.rows)][:, :trunk.fin.shape[0]], trunk.fin.T)
        if trunk.fin_x is None:
            assert fin_xyz is None
        else:
            assert torch.equal(fin_xyz[list(trunk.rows)], trunk.fin_x.T)
        fin_b[list(trunk.rows)] += trunk.fin_b
    assert torch.equal(plan.fin_b, fin_b)


def _pixel_trunk(rng, c, widths, latent_in, rows):
    """A PixelTrunk: layer 0 reads the latent (and xyz), layer ``latent_in``
    the previous activation and the latent."""
    def t(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    hidden = [PixelHiddenLayer(None, t(c, widths[0]), t(3, widths[0]), t(widths[0]))]
    for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:]), start=1):
        lat = t(c, w_out) if i == latent_in else None
        x = t(3, w_out) if i == latent_in else None
        hidden.append(PixelHiddenLayer(t(w_in, w_out), lat, x, t(w_out)))
    return PixelTrunk(hidden, t(widths[-1], len(rows)), t(3, len(rows)), t(len(rows)), rows)


@pytest.mark.parametrize("classes,two_trunks,c", [(0, True, 256), (6, True, 256),
                                                  (126, True, 20), (6, False, 36)])
def test_pixel_grid_plan_views_give_back_the_folded_weights(classes, two_trunks, c):
    """K3's pack round trip, with a latent_in layer: a layer's activation and
    latent weights are one run of tiles, the latent's right after; the views
    give both back (their TF32 halves summed), and the activation buffer
    holds the latent layer's [activation; latent] rows."""
    rng = np.random.RandomState(3 + classes)
    widths = (512, 250, 512, 512)
    if two_trunks:
        trunks = [_pixel_trunk(rng, c, widths, 2, [0, *range(2, 2 + classes)]),
                  _pixel_trunk(rng, c, widths, 2, [1])]
    else:
        trunks = [_pixel_trunk(rng, c, widths, 2, [0, 1, *range(2, 2 + classes)])]
    fmap = torch.tensor(rng.randn(1, c, 4, 5), dtype=torch.float32)
    plan = pack_pixel_grid_plan(trunks, make_feature_table(fmap), torch.zeros(28), (4, 5), 16)
    lat_pad = int(plan.desc[4])
    assert lat_pad == -(-c // 8) * 8 and plan.n_rows == 2 + classes
    assert int(plan.desc[2]) == max(512, 256 + lat_pad)
    d = plan.desc.tolist()
    pos = plan._HEAD  # the head: 8 entries, then the final latent's 2 offsets
    for trunk, (hidden, fin, fin_xyz) in zip(trunks, plan.trunks()):
        pos += 4
        for h, (w, lat, x, b) in zip(trunk.hidden, hidden):
            w_off, _, lat_off, _, in_pad, out_pad = d[pos:pos + 6]
            pos += 6
            if w_off >= 0 and lat_off >= 0:
                assert lat_off == w_off + 2 * in_pad * out_pad
            assert (w is None) == (h.w is None) and (lat is None) == (h.lat is None)
            if w is not None:
                assert _padded_equal(w, h.w, split=True)
            if lat is not None:
                assert lat.shape[0] == lat_pad and _padded_equal(lat, h.lat, split=True)
            assert _padded_equal(x, h.x) if h.x is not None else x is None
            assert _padded_equal(b[None], h.b[None])
        assert torch.equal(fin[list(trunk.rows)][:, :trunk.fin.shape[0]], trunk.fin.T)
        assert torch.equal(fin_xyz[list(trunk.rows)], trunk.fin_x.T)


def _reduce(a, b, product):
    """sum over points of a[:, p] b[:, p]^T (a (K, m), b (N, m)), 8 points
    (one wgmma k step) a product in float64, each added into a float32
    accumulator, as the weight-gradient reduction runs it."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for p in range(0, a.shape[1], TC_K):
        acc = (acc.double() + product(a[:, p:p + TC_K], b[:, p:p + TC_K])).float()
    return acc


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """float32 -> TF32 by dropping the 13 low mantissa bits, as wgmma reads a
    float32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def test_split_tf32_reduction_meets_float32_accuracy_one_pass_does_not():
    """Why the train backwards' weight-gradient reduction (csrc/wgrad_tc.cuh)
    splits both run-time operands, as it does: A rounded into big and small
    halves, B's raw tile read as its big half (truncated) beside the small
    half B - trunc(B) (truncated too).  At a backward's widths (K = N = 512,
    m = 4096 points, A a ReLU activation, B a pre-activation gradient) that
    errs by no more than twice float32's own sum (6.8e-8 against 5.9e-8 of
    |A_k| |B_n| here), within 1e-6, while one TF32 pass errs by more than
    1e-5 (2.2e-5 here): over the card's test bound, and at the gradients'
    1e-4-of-the-largest tolerance a miss of up to a fifth of it."""
    rng = np.random.RandomState(4)
    a = torch.relu(torch.tensor(rng.randn(512, 4096), dtype=torch.float32))
    b = torch.tensor(rng.randn(512, 4096) * 1e-3, dtype=torch.float32)
    exact = a.double() @ b.double().T
    scale = a.double().norm(dim=1)[:, None] * b.double().norm(dim=1)[None, :]

    def split(x, y):
        xb, yb = tf32(x), _trunc(y)
        xs, ys = tf32(x - xb), _trunc(y - yb)
        return (xb.double() @ yb.double().T + xs.double() @ yb.double().T
                + xb.double() @ ys.double().T)

    err = {name: float(((_reduce(a, b, fn).double() - exact).abs() / scale).max())
           for name, fn in (("float32", lambda x, y: (x @ y.T).double()), ("split", split),
                            ("one_pass", lambda x, y: _one_pass(x, y.T)))}
    assert err["split"] <= 1e-6, err
    assert err["split"] <= 2 * err["float32"], err
    assert err["one_pass"] > 1e-5, err


def _generic_trunk(rng, in_width, widths, latent_in, rows, fin_x=False):
    """A K6 FoldedTrunk: layer 0 on the input row (x only), a latent_in
    layer on the previous activation and the input row, final rows
    ``rows`` (with the input row's fin_x where ``fin_x``, zero in the class
    rows, as with_classifier leaves them)."""
    def t(*shape):
        return torch.tensor(rng.randn(*shape), dtype=torch.float32)

    hidden = [HiddenLayer(None, t(in_width, widths[0]), t(widths[0]))]
    for i, (w_in, w_out) in enumerate(zip(widths[:-1], widths[1:]), start=1):
        hidden.append(HiddenLayer(t(w_in, w_out), t(in_width, w_out) if i == latent_in else None,
                                  t(w_out)))
    fx = None
    if fin_x:
        fx = t(in_width, len(rows))
        fx[:, [i for i, r in enumerate(rows) if r >= 2]] = 0
    return FoldedTrunk(hidden, t(widths[-1], len(rows)), fx, t(len(rows)), rows)


@pytest.mark.parametrize("in_widths,widths,latent_in,classes,fin_x,rows", [
    ((319, 319), (512, 193, 512, 512), 2, 0, False, 544),   # NeRF PE, --point_size 63
    ((319, 319), (512, 193, 512, 512), 2, 6, False, 544),   # with C = 6
    ((319,), (512, 193, 512, 512), 2, 6, False, 544),       # a combined trunk
    ((41, 50), (128, 128, 128, 128), 0, 0, True, 128),      # latent_in (0, 4): fin_x
    ((575, 575), (512, 512, 512, 512), 0, 0, True, 544),    # a row wider than the buffer
])
def test_generic_plan_views_give_back_the_folded_weights(in_widths, widths, latent_in, classes,
                                                         fin_x, rows):
    """K6's pack round trip on the tensor-core trunk: each layer's W_x and
    W_in are one run of tiles, W_in's (padded to lat_pad rows) right after;
    the views give both back (their TF32 halves summed), with the bias,
    final rows and fin_x; the activation buffer holds a latent_in layer's
    [activation; input] rows up to TC_MAX_ROWS (the kernel stages the rest
    in chunks)."""
    rng = np.random.RandomState(sum(in_widths) + classes)
    if len(in_widths) == 2:
        trunks = [_generic_trunk(rng, in_widths[0], widths, latent_in,
                                 [0, *range(2, 2 + classes)], fin_x),
                  _generic_trunk(rng, in_widths[1], widths, latent_in, [1], fin_x)]
    else:
        trunks = [_generic_trunk(rng, in_widths[0], widths, latent_in,
                                 [0, 1, *range(2, 2 + classes)], fin_x)]
    plan = pack_generic_plan(trunks, in_widths)
    lat_pad = -(-max(in_widths) // TC_K) * TC_K
    assert TC_MAX_ROWS == 544 and tc_smem_bytes(TC_MAX_ROWS) <= 232448
    assert plan.lat_pad == lat_pad and plan.n_rows == 2 + classes
    assert int(plan.desc[2]) == rows
    d = plan.desc.tolist()
    pos = 5
    for trunk, (hidden, fin, fx) in zip(trunks, plan.trunks()):
        pos += 4
        for h, (w, x, b) in zip(trunk.hidden, hidden):
            w_off, x_slot, lat_off, _, in_pad, out_pad = d[pos:pos + 6]
            pos += 6
            assert x_slot == -1 and out_pad % TC_GROUP == 0
            if w_off >= 0 and lat_off >= 0:
                assert lat_off == w_off + 2 * in_pad * out_pad
            assert (w is None) == (h.w is None) and (x is None) == (h.x is None)
            if w is not None:
                assert _padded_equal(w, h.w, split=True)
            if x is not None:
                assert x.shape[0] == lat_pad and _padded_equal(x, h.x, split=True)
            assert _padded_equal(b[None], h.b[None])
        assert torch.equal(fin[list(trunk.rows)][:, :trunk.fin.shape[0]], trunk.fin.T)
        if trunk.fin_x is None:
            assert fx is None
        else:
            assert fx.shape == (plan.n_rows, lat_pad)
            assert torch.equal(fx[list(trunk.rows)][:, :trunk.fin_x.shape[0]], trunk.fin_x.T)


def test_generic_plan_refuses_input_terms_on_class_rows():
    """K6 reads fin_x on the SDF rows only: a plan whose class rows read the
    input row is refused at packing."""
    rng = np.random.RandomState(7)
    trunk = _generic_trunk(rng, 20, (128, 128), 1, [0, 1, 2, 3], fin_x=True)
    bad = trunk._replace(fin_x=torch.ones_like(trunk.fin_x))
    with pytest.raises(ValueError, match="class rows"):
        pack_generic_plan([bad], (20,))


def _chain(layers, gates, dpre, product, dtype=torch.float32):
    """The train backwards' reverse chain (csrc/chain_tc.cuh) from the final
    layer's pre-activation gradient ``dpre`` (P, n_out) down to layer 0's:
    dx = product(dpre, W^T) (float64 out), rounded once to ``dtype`` as
    the tensor cores' float32 accumulators hold it, then gated by the
    recovered gate of the layer's input."""
    for (w, _), gate in zip(layers[:0:-1], gates[::-1]):
        dpre = product(dpre, w.T).to(dtype) * gate.to(dtype)
    return dpre.double()


def test_split_tf32_chain_meets_float32_accuracy_one_pass_does_not():
    """Why the backward chains of K2 and K4 run three TF32 products a
    multiply-add, as the forward trunk does: at the flagship trunk's widths
    (dx = dpre W^T through 512 -> 512 -> 250 -> 512, each gated by its
    input's ReLU) the split chain's layer-0 gradient is within 1e-6 of the
    largest entry of the float64 chain's and no worse than twice float32's
    own error (1.7e-7 against 4.7e-7 here), while one TF32 pass errs by more
    than 1e-5 of it (5.0e-4 here, over the gradients' 1e-4 tolerance)."""
    layers, x = _trunk(5)
    gates, a = [], x.double()
    for w, b in layers[:-1]:
        a = torch.relu(a @ w.double() + b.double())
        gates.append((a > 0).double())
    y = torch.tanh(a @ layers[-1][0].double() + layers[-1][1].double())
    dy = torch.tensor(np.random.RandomState(6).randn(POINTS, 1))
    dpre = (dy * (1 - y * y)).float()
    exact = _chain([(w.double(), b) for w, b in layers], gates, dpre.double(),
                   lambda d, w: d.double() @ w, torch.float64)
    scale = float(exact.abs().max())
    err = {name: float((_chain(layers, gates, dpre, fn) - exact).abs().max()) / scale
           for name, fn in (("float32", _float32), ("split", _split), ("one_pass", _one_pass))}
    assert err["split"] <= 1e-6, err
    assert err["split"] <= 2 * err["float32"], err
    assert err["one_pass"] > 1e-5, err


CHAIN_SCENES, CHAIN_POINTS = 2, 512  # 1,024 points


def _chain_specs(model_type, classes, pixel):
    from alignsdf_torch.config import NetworkSpecs, Specs

    c = 256
    return Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=c,
                 pixel_align=pixel, samples_per_scene=CHAIN_POINTS, sdf_scale_factor=7.0,
                 image_size=(256, 256), classifier_branch=classes > 0,
                 network_specs=NetworkSpecs(num_class=max(classes, 6)))


def _chain_runs(stream, layers):
    """Slice the chain's stream into its runs, one per (out_pad, [W (in_pad,
    out_pad) | None, Lat (c_pad, out_pad) | None]) of ``layers`` in order,
    and check that each run untiles to [W^T | Lat^T], their TF32 halves
    summed; the stream holds nothing else."""
    pos = 0
    for out_pad, mats in layers:
        mats = [t for t in mats if t is not None]
        cols = sum(t.shape[0] for t in mats)
        assert cols % TC_GROUP == 0 and out_pad % TC_K == 0
        # the kernel's count of this layer's tiles, two halves of TC_TILE floats each
        size = out_pad // TC_K * (cols // TC_GROUP) * 2 * TC_GROUP * TC_K
        run = untile_weights(stream[pos:pos + size], out_pad, cols)
        col = 0
        for t in mats:
            assert _padded_equal(run[:, col:col + t.shape[0]], t.T, split=True)
            col += t.shape[0]
        pos += size
    assert pos == stream.numel()


@pytest.mark.parametrize("model_type,classes", [("1encoder2decoder", 0),
                                                ("1encoder1decoder", 0),
                                                ("1encoder2decoder", 6)])
def test_k2_chain_tiles_view_back_the_transposed_weights(model_type, classes):
    """K2's pack at the flagship widths (the twin trunks, a combined trunk,
    the classifier's trunk): the backward chain's tile stream, run by run
    from the last hidden layer down, untiles to each layer's W^T (in_pad
    outputs of depth out_pad); layer 0 reads no activation and has none.
    Only the final layer keeps a plain transpose (the forward's)."""
    from alignsdf_torch.kernels.train_decoder import pack_trunk
    from alignsdf_torch.models.decoder import make_decoder, trunk_prefixes
    from alignsdf_torch.ops.grid_plan import branch_columns
    from alignsdf_torch.ops.train_plan import make_train_decoder, trunk_operands

    specs = _chain_specs(model_type, classes, False)
    gen = torch.Generator().manual_seed(11)
    with torch.random.fork_rng():
        torch.manual_seed(11)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=classes > 0)
    latent = torch.randn(CHAIN_SCENES, 256, generator=gen)
    emb = torch.randn(CHAIN_SCENES * CHAIN_POINTS, 9, generator=gen)
    st = make_train_decoder(specs).statics
    first, second = trunk_prefixes(decoder)
    cols = branch_columns(specs)
    trunks = [(first, cols[0], 1), (second, cols[1], 1)] if second else [(first, cols[0], 2)]
    for prefix, c, out_dim in trunks:
        with torch.no_grad():
            ws, xs, bs = trunk_operands(decoder, prefix, len(c), latent, specs, out_dim)
            pack = pack_trunk(emb[:, list(c)].contiguous(), ws, xs, bs, st)
        n = len(pack.b)
        assert pack.out_pads[:-1] == [512, 256, 512, 512]
        _chain_runs(pack.chain, [(pack.out_pads[layer], [pack.w[layer], None])
                                 for layer in range(n - 2, 0, -1)])
        assert all(t is None for t in pack.wt[:-1])
        assert torch.equal(pack.wt[-1], pack.w[-1].T)


@pytest.mark.parametrize("model_type,classes", [("1encoder2decoder", 0),
                                                ("1encoder1decoder", 0),
                                                ("1encoder2decoder", 6)])
def test_k4_chain_tiles_view_back_the_transposed_weights(model_type, classes):
    """K4's pack at the flagship --pa_feat widths (C = 256): each trunk's
    runs, from the last hidden layer down, untile to [W^T | Lat^T] -- the
    latent_in layer's dx and dlat outputs side by side, 256 + 256 of depth
    512 -- and layer 0's to Lat^T alone, trunk after trunk."""
    from alignsdf_torch.kernels.pixel_train_decoder import pack_pixel_trunks
    from alignsdf_torch.models.decoder import make_decoder
    from alignsdf_torch.ops.pixel_train_plan import (
        make_pixel_train_decoder, pixel_train_inputs, pixel_trunks)

    specs = _chain_specs(model_type, classes, True)
    gen = torch.Generator().manual_seed(12)
    with torch.random.fork_rng():
        torch.manual_seed(12)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=classes > 0)
    m = CHAIN_SCENES * CHAIN_POINTS
    fmap = torch.randn(CHAIN_SCENES, 256, 8, 8, generator=gen)
    xyz = torch.randn(m, 3, generator=gen) * 0.5
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]])
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(CHAIN_SCENES, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=(8, 8))
    with torch.no_grad():
        inputs = pixel_train_inputs(fmap, xyz, cam.repeat(CHAIN_SCENES, 1, 1), root, specs)
        pack = pack_pixel_trunks(*inputs, torch.randn(m, 9, generator=gen),
                                 pixel_trunks(decoder, specs, 256), st)
    assert pack.c_pad == 256 and len(pack.trunks) == (2 if model_type == "1encoder2decoder" else 1)
    runs = []
    for t in pack.trunks:
        n = len(t.b)
        assert t.out_pads[:-1] == [512, 256, 512, 512]
        runs += [(t.out_pads[layer], [t.w[layer], t.lat[layer]]) for layer in range(n - 2, -1, -1)]
        assert all(w is None for w in t.wt[:-1]) and torch.equal(t.wt[-1], t.w[-1].T)
    assert [len([m for m in mats if m is not None]) for _, mats in runs[:4]] == [1, 2, 1, 1]
    _chain_runs(pack.chain, runs)
