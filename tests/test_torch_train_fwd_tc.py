"""The train forwards of kernels K2 and K4 on the tensor cores
(csrc/train_fwd_tc.cuh) on the CPU: the packs' forward tile streams, and a
split-TF32 emulation of the whole forward -- products against the stream's
own big and small halves, the embedding and each point's scene bias in the
epilogue, ReLU, the hash gate, the residuals -- against the plain versions
and against the JAX package's kernels in interpret mode.

The kernels themselves run only on the card (tests/test_torch_cuda.py).
TF32 is emulated as in tests/test_torch_split_tf32.py: round to nearest,
ties away from zero, on the float32 bits; a TF32 x TF32 product is exact in
float64 and each layer's sum is rounded once to float32, as the tensor
cores' float32 accumulators hold it.  The emulation walks the points in the
kernel's 64-point tiles, rows past M included (zero embedding, the last
scene's bias), and keeps the first M.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_parity
from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.ops.decoder_train_kernel import make_fused_train_decoder_factored
from alignsdf_tpu.ops.decoder_train_pixel import make_fused_train_decoder_pixel
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import decoder_from_jax
from alignsdf_torch.kernels.grid_decoder import TC_GROUP, TC_K, tf32_split
from alignsdf_torch.kernels.pixel_train_decoder import (
    pack_pixel_trunks,
    pixel_train_decode_reference,
    sample_latent,
)
from alignsdf_torch.kernels.train_decoder import (
    dropout_gate,
    pack_trunk,
    train_decode_reference,
)
from alignsdf_torch.models.decoder import make_decoder, trunk_prefixes
from alignsdf_torch.ops.grid_plan import branch_columns
from alignsdf_torch.ops.pixel_train_plan import (
    make_pixel_train_decoder,
    pixel_train_inputs,
    pixel_trunks,
)
from alignsdf_torch.ops.train_plan import make_train_decoder, trunk_operands

TILE = 64  # the kernels' points a block
# 2 scenes x 144 points: 288 is no multiple of the 64-point tile, so a tile
# straddles the scenes, and 144 is a block the JAX kernels take
B, N, PFS = 2, 144, 9
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _halves(flat: torch.Tensor, k: int, out_pad: int):
    """The (k, out_pad) big and small halves of a run of tile_weights tiles,
    each as the kernel reads it (one wgmma B operand a tile half)."""
    tiles = flat.view(k // TC_K, out_pad // TC_GROUP, 2, TC_GROUP // 8, 2, 8, 4)
    return [tiles[:, :, h].permute(0, 3, 5, 1, 2, 4).reshape(k, out_pad) for h in (0, 1)]


class _Stream:
    """The forward's tile stream, read run by run in the kernel's order."""

    def __init__(self, flat: torch.Tensor):
        self.flat, self.pos = flat, 0

    def take(self, depth: int, out_pad: int):
        size = 2 * depth * out_pad
        run = self.flat[self.pos:self.pos + size]
        self.pos += size
        return _halves(run, depth, out_pad)


def _product(a: torch.Tensor, halves) -> torch.Tensor:
    """big_a big_w + small_a big_w + big_a small_w in float64, rounded once
    to float32: a layer's split-TF32 product on the tensor cores."""
    big, small = (h.double() for h in halves)
    ab = tf32(a)
    asm = tf32(a - ab)
    return (ab.double() @ big + asm.double() @ big + ab.double() @ small).float()


def _layer(acc, emb, x, bias, seed, layer, hashed, rows, st):
    """The epilogue of hidden layer ``layer``: + emb @ X, + the bias, ReLU,
    the gate hashing layer ``hashed``."""
    if x is not None:
        acc = acc + emb @ x
    a = torch.relu(acc + bias)
    if st.train and st.dropout[layer]:
        a = a * dropout_gate(seed, hashed, rows, a.shape[1], st.keep)
    return a


def _tiled(m: int) -> int:
    return -(-m // TILE) * TILE


def k2_split_forward(p, st, seed):
    """train_fwd_tc_kernel on a pack_trunk pack: (y (n_out, M), the
    residuals, each (out_pad, M))."""
    e, m = p.emb_t.shape
    rows = torch.arange(_tiled(m))
    emb = torch.zeros(len(rows), e)
    emb[:m] = p.emb_t.T
    scene = rows.clamp(max=m - 1) // st.n_per_scene
    stream, a, acts = _Stream(p.fwd), None, []
    for layer in range(len(p.b) - 1):
        out_pad = p.out_pads[layer]
        acc = torch.zeros(len(rows), out_pad)
        if p.w[layer] is not None:
            acc = _product(a, stream.take(p.w[layer].shape[0], out_pad))
        bias = p.b[layer][scene] if st.scene_bias[layer] else p.b[layer]
        a = _layer(acc, emb, p.x[layer], bias, seed, layer, layer, rows, st)
        acts.append(a[:m].T)
    assert stream.pos == p.fwd.numel()
    return torch.tanh(a @ p.wt[-1].T + p.b[-1])[:m].T, acts


def k4_split_forward(p, st, seed):
    """pixel_train_fwd_tc_kernel on a pack_pixel_trunks pack: (y (rows, M),
    per trunk the residuals, each (out_pad, M), the latent (c_pad, M)); a
    latent layer's product runs over [activation | latent] against its
    [W; Lat] tiles."""
    e, m = p.emb_t.shape
    c = p.table.shape[2]
    rows = torch.arange(_tiled(m))
    emb = torch.zeros(len(rows), e)
    emb[:m] = p.emb_t.T
    lat = torch.zeros(len(rows), p.c_pad)
    lat[:m, :c] = sample_latent(p.table, p.mean, p.xp, p.yp, p.mask, st)
    stream, ys, acts = _Stream(p.fwd), [], []
    for tr in p.trunks:
        a, trunk_acts = None, []
        for layer in range(len(tr.b) - 1):
            parts = ([a] if tr.w[layer] is not None else []) + ([lat] if tr.lat[layer] is not None
                                                                else [])
            inp = torch.cat(parts, dim=1)
            acc = _product(inp, stream.take(inp.shape[1], tr.out_pads[layer]))
            a = _layer(acc, emb, tr.x[layer], tr.b[layer], seed, layer, layer + tr.layer_off,
                       rows, st)
            trunk_acts.append(a[:m].T)
        ys.append(torch.tanh(a @ tr.wt[-1].T + tr.b[-1])[:m].T)
        acts.append(trunk_acts)
    assert stream.pos == p.fwd.numel()
    return torch.cat(ys), acts, lat[:m].T


def _k2_kernel(emb, ws, xs, bs, seed, st):
    """K2's signature (train_decode) on the emulation, for the decoders."""
    p = pack_trunk(emb, ws, xs, bs, st)
    y, acts = k2_split_forward(p, st, seed)
    return y, acts[-1][:bs[-2].shape[-1]].T


def _k4_kernel(table, mean, xp, yp, mask, emb, trunks, seed, st):
    p = pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st)
    y, acts, _ = k4_split_forward(p, st, seed)
    return y, acts[0][-1][:trunks[0][3][-2].shape[-1]].T


def _residuals_match(acts, refs):
    """The kernel's residuals (out_pad, M) hold the plain version's gated
    activations (M, out) to TOL, and zeros in their padding rows."""
    for a, r in zip(acts, refs):
        assert float((a[:r.shape[1]].T - r).abs().max()) <= TOL
        assert bool((a[r.shape[1]:] == 0).all())


# ---------------------------------------------------------------------------
# the packs' forward tile streams at the flagship widths
# ---------------------------------------------------------------------------

def _flagship_specs(model_type, classes, pixel):
    return Specs(model_type=model_type, encode_style="both", point_feat_size=PFS,
                 latent_size=256, pixel_align=pixel, samples_per_scene=512,
                 sdf_scale_factor=7.0, image_size=(256, 256), classifier_branch=classes > 0,
                 network_specs=NetworkSpecs(num_class=max(classes, 6)))


def _runs_view_back(stream, layers):
    """Each run of the stream, in ``layers`` order ((out_pad, [W (in_pad,
    out_pad) | None, Lat (c_pad, out_pad) | None])), holds [W; Lat]'s TF32
    halves; the stream holds nothing else."""
    s = _Stream(stream)
    for out_pad, mats in layers:
        mats = [t for t in mats if t is not None]
        depth = sum(t.shape[0] for t in mats)
        assert depth % TC_K == 0 and out_pad % TC_GROUP == 0
        big, small = s.take(depth, out_pad)
        ref = torch.cat(mats)
        ref_big, ref_small = tf32_split(ref)
        assert torch.equal(big, ref_big) and torch.equal(small, ref_small)
    assert s.pos == stream.numel()


@pytest.mark.parametrize("model_type,classes", [("1encoder2decoder", 0),
                                                ("1encoder1decoder", 0),
                                                ("1encoder2decoder", 6)])
def test_k2_forward_tiles_view_back_the_weights(model_type, classes):
    """K2's pack (the twin trunks, a combined trunk, the classifier's
    trunk): the forward's tile stream, run by run in layer order, holds each
    hidden layer l > 0's padded W (in_pad, out_pad) split into TF32 halves;
    layer 0 reads the embedding alone and has no run."""
    specs = _flagship_specs(model_type, classes, False)
    with torch.random.fork_rng():
        torch.manual_seed(13)
        decoder = make_decoder(model_type, 256, PFS, "both", specs.network_specs,
                               use_classifier=classes > 0)
    gen = torch.Generator().manual_seed(13)
    latent = torch.randn(2, 256, generator=gen)
    emb = torch.randn(1024, PFS, generator=gen)
    st = make_train_decoder(specs).statics
    first, second = trunk_prefixes(decoder)
    cols = branch_columns(specs)
    trunks = [(first, cols[0], 1), (second, cols[1], 1)] if second else [(first, cols[0], 2)]
    for prefix, c, out_dim in trunks:
        with torch.no_grad():
            ws, xs, bs = trunk_operands(decoder, prefix, len(c), latent, specs, out_dim)
            p = pack_trunk(emb[:, list(c)].contiguous(), ws, xs, bs, st)
        assert p.out_pads[:-1] == [512, 256, 512, 512]
        _runs_view_back(p.fwd, [(p.out_pads[layer], [p.w[layer]])
                                for layer in range(1, len(p.b) - 1)])


@pytest.mark.parametrize("model_type,classes", [("1encoder2decoder", 0),
                                                ("1encoder1decoder", 0),
                                                ("1encoder2decoder", 6)])
def test_k4_forward_tiles_view_back_the_weights(model_type, classes):
    """K4's pack at the --pa_feat widths (C = 256): each trunk's runs, in
    layer order, hold [W; Lat] split into TF32 halves -- layer 0's Lat
    alone (depth 256), the latent_in layer's W over Lat (256 + 256), the
    others W -- trunk after trunk."""
    specs = _flagship_specs(model_type, classes, True)
    with torch.random.fork_rng():
        torch.manual_seed(14)
        decoder = make_decoder(model_type, 256, PFS, "both", specs.network_specs,
                               use_classifier=classes > 0)
    gen = torch.Generator().manual_seed(14)
    m = 1024
    fmap = torch.randn(2, 256, 8, 8, generator=gen)
    xyz = torch.randn(m, 3, generator=gen) * 0.5
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]).repeat(2, 1, 1)
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(2, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=(8, 8))
    with torch.no_grad():
        inputs = pixel_train_inputs(fmap, xyz, cam, root, specs)
        p = pack_pixel_trunks(*inputs, torch.randn(m, PFS, generator=gen),
                              pixel_trunks(decoder, specs, 256), st)
    layers = []
    for t in p.trunks:
        assert t.out_pads[:-1] == [512, 256, 512, 512]
        layers += [(t.out_pads[layer], [t.w[layer], t.lat[layer]])
                   for layer in range(len(t.b) - 1)]
    assert [sum(t.shape[0] for t in mats if t is not None) for _, mats in layers[:4]] == \
        [256, 512, 512, 512]
    _runs_view_back(p.fwd, layers)


# ---------------------------------------------------------------------------
# the emulated forward against the plain versions and the JAX kernels
# ---------------------------------------------------------------------------

K2_NS = dict(dims=(128, 128, 128, 128), dropout=(0, 1, 2, 3), dropout_prob=0.2,
             norm_layers=(0, 1, 2, 3), latent_in=(2,))
K4_NS = dict(K2_NS, dims=(96, 96, 96, 96))
K4_SPEC = dict(encode_style="both", point_feat_size=PFS, latent_size=32, pixel_align=True,
               samples_per_scene=N, sdf_scale_factor=7.0186, image_size=(64, 64))


@pytest.fixture(scope="module", params=["1encoder2decoder", "1encoder1decoder"])
def k2_pair(request):
    """A narrow K2 decoder in JAX and in the port (the same parameters), its
    factored Pallas train decoder in interpret mode, and seeded inputs."""
    model_type, ls = request.param, 64
    jspecs = JaxSpecs(model_type=model_type, encode_style="both", point_feat_size=PFS,
                      latent_size=ls, samples_per_scene=N,
                      network_specs=JaxNetworkSpecs(**K2_NS))
    pspecs = Specs(model_type=model_type, encode_style="both", point_feat_size=PFS,
                   latent_size=ls, samples_per_scene=N, network_specs=NetworkSpecs(**K2_NS))
    rng = np.random.RandomState(3)
    latent = (rng.randn(B, ls) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    jdec = jax_make_decoder(model_type, ls, PFS, "both", jspecs.network_specs, False)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(1), jnp.zeros((8, ls + PFS)))["params"])
    fac = make_fused_train_decoder_factored(jspecs, interpret=True)
    assert fac is not None
    pdec = make_decoder(model_type, ls, PFS, "both", pspecs.network_specs)
    pdec.load_state_dict(decoder_from_jax(params))
    return params, fac, pdec, pspecs, latent, emb


@pytest.mark.parametrize("train", [False, True])
def test_k2_split_forward_matches_plain_and_jax(k2_pair, train):
    """K2's tensor-core forward, emulated, at a narrow width on 2 scenes x
    144 points (a 64-point tile straddles the scenes): each trunk's y and
    residuals to TOL against the plain forward, and the decoder's SDFs to
    TOL against JAX's _fused_scene_fwd in interpret mode, with the same
    hash gates."""
    params, fac, pdec, specs, latent, emb = k2_pair
    st = make_train_decoder(specs).statics._replace(train=train)
    first, second = trunk_prefixes(pdec)
    cols_h, cols_o = branch_columns(specs)
    trunks = ([(first, cols_h, 7, 1), (second, cols_o, 8, 1)] if second
              else [(first, cols_h, 7, 2)])
    lat_t, emb_t = torch.from_numpy(latent), torch.from_numpy(emb)
    with torch.no_grad():
        for prefix, cols, seed, out_dim in trunks:
            ws, xs, bs = trunk_operands(pdec, prefix, len(cols), lat_t, specs, out_dim)
            e = emb_t[:, list(cols)].contiguous()
            y, acts = k2_split_forward(pack_trunk(e, ws, xs, bs, st), st, seed)
            refs = []
            y_ref, _ = train_decode_reference(e, ws, xs, bs, seed, st, acts=refs)
            assert float((y - y_ref).abs().max()) <= TOL
            _residuals_match(acts, refs)
        h, o, _ = make_train_decoder(specs, kernel=_k2_kernel)(pdec, lat_t, emb_t, 7, train)
    h1, o1, _ = fac(params, jnp.asarray(latent), jnp.asarray(emb), jnp.int32(7), train=train)
    np.testing.assert_allclose(h.numpy(), np.asarray(h1), atol=TOL, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o1), atol=TOL, rtol=0)


def _k4_data():
    """An 8 x 8 map of 32 channels (NHWC), the embedding, points of which
    part project out of the image, the camera and the predicted root."""
    rng = np.random.RandomState(4)
    fmap = (rng.randn(B, 8, 8, 32) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    xyz = (rng.randn(B * N, 3) * 1.5).astype(np.float32)
    cam = np.zeros((B, 3, 4), np.float32)
    cam[:, 0, 0] = cam[:, 1, 1] = 80.0
    cam[:, 0, 2] = cam[:, 1, 2] = 32.0
    cam[:, 2, 2] = 1.0
    root = np.tile(np.asarray([0.02, -0.01, 0.55], np.float32), (B, 1, 1))
    return fmap, emb, xyz, cam, root


@pytest.fixture(scope="module", params=["1encoder2decoder", "1encoder1decoder"])
def k4_pair(request):
    """A narrow --pa_feat decoder in JAX and in the port, JAX's pixel train
    decoder in interpret mode (block 48), and seeded inputs."""
    model_type = request.param
    jspecs = JaxSpecs(model_type=model_type, network_specs=JaxNetworkSpecs(**K4_NS), **K4_SPEC)
    pspecs = Specs(model_type=model_type, network_specs=NetworkSpecs(**K4_NS), **K4_SPEC)
    jdec = jax_make_decoder(model_type, 32, PFS, "both", jspecs.network_specs, False)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(2), jnp.zeros((8, 32 + PFS)))["params"])
    fused = make_fused_train_decoder_pixel(jspecs, interpret=True, block_cap=48)
    assert fused is not None and fused.pixel
    pdec = make_decoder(model_type, 32, PFS, "both", pspecs.network_specs)
    pdec.load_state_dict(decoder_from_jax(params))
    return params, fused, pdec, pspecs, _k4_data()


@pytest.mark.parametrize("train", [False, True])
def test_k4_split_forward_matches_plain_and_jax(k4_pair, train):
    """K4's tensor-core forward, emulated, at a narrow width on 2 scenes x
    144 points, part of them outside the image: y, every residual and the
    latent to TOL against the plain forward, and the decoder's SDFs to TOL
    against JAX's _fused_pixel_fwd in interpret mode."""
    params, fused, pdec, specs, (fmap, emb, xyz, cam, root) = k4_pair
    fmap_t = torch.from_numpy(fmap).permute(0, 3, 1, 2).contiguous()
    port = (fmap_t, torch.from_numpy(emb), torch.from_numpy(xyz), torch.from_numpy(cam),
            torch.from_numpy(root))
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=(8, 8), train=train)
    with torch.no_grad():
        table, mean, xp, yp, mask = pixel_train_inputs(port[0], port[2], port[3], port[4], specs)
        assert 0.0 < float(mask.mean()) < 1.0
        trunks = pixel_trunks(pdec, specs, 32)
        inputs = (table, mean, xp, yp, mask, port[1])
        y, acts, lat = k4_split_forward(pack_pixel_trunks(*inputs, trunks, st), st, 9)
        refs, lat_ref = [], []
        y_ref, _ = pixel_train_decode_reference(*inputs, trunks, 9, st, acts=refs,
                                                latent=lat_ref)
        assert float((y - y_ref).abs().max()) <= TOL
        assert float((lat[:32].T - lat_ref[0]).abs().max()) <= TOL
        assert bool((lat[32:] == 0).all())
        for trunk_acts, trunk_refs in zip(acts, refs):
            _residuals_match(trunk_acts, trunk_refs)
        h, o, _ = make_pixel_train_decoder(specs, kernel=_k4_kernel)(pdec, *port, 9, train)
    h1, o1, _ = fused(params, jnp.asarray(fmap), jnp.asarray(emb), jnp.asarray(xyz),
                      jnp.asarray(cam), jnp.asarray(root), jnp.int32(9), train=train)
    np.testing.assert_allclose(h.numpy(), np.asarray(h1), atol=TOL, rtol=0)
    np.testing.assert_allclose(o.numpy(), np.asarray(o1), atol=TOL, rtol=0)
