"""K6's bf16 kernel (``generic_bf16_kernel`` on ``csrc/grid_trunk_bf16_tc.cuh``)
and its plan (``kernels/generic_decoder.py:pack_generic_plan_bf16``), on the
CPU.

- The plan round-trips: ``GenericPlan.trunks()`` reads back each weight as
  the grid trunk's TcBf16 layout held it, bf16(W) (the float32 plan's
  weights rounded), hidden widths now padded to 16 instead of 128, biases
  float32, the class rows' input-row weights zero; for twin, combined and
  classifier trunks (C = 6 and 126), latent_in (0, 2) and a latent input at
  the final layer (fin_x).
- The plan's streams are the kernel's walk: a Python copy of
  ``gb_take_plan`` (with input rows) and of the producer's items lands every
  offset of the descriptor and ends each stream at its final tiles (then
  fin_x's); ``generic_bf16_stream_bytes`` is the items' bytes; at the
  --point_size 63 flagship a tile's streams are 3.24 MB, read once for a
  cluster's 256 points (26.6 GB a 128^3 pass, modelled).
- The plain bf16 K6 on the new layout against JAX's bf16 generic kernel
  (``make_pallas_decode_fn(..., dtype=bfloat16)``, interpret mode) on 300
  seeded rows at small widths and 1-2 hidden layers, a 575-wide row (wider
  than the kernel's 512-row buffer) and a latent input at the final layer
  among them: within tests/test_torch_bf16.py's bounds (TIGHT at >= 99% of
  the entries, LOOSE everywhere).
- The kernel's schedule emulated (tests/test_torch_grid_bf16.py's
  simulator with input rows): at --point_size 63 layer 2 reads 208 + 320 =
  528 rows, 16 more than the buffer holds, and both halves of its outputs
  read every k step; its last x0 step reads registers in each half, so no
  step reads a row after it is overwritten, in either half, under many
  interleavings; likewise a row wider than the buffer and a final layer on
  the input rows above a 512-row activation (every fin_x step from
  registers).

The kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from alignsdf_tpu.ops.decoder_kernel import make_pallas_decode_fn
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.kernels.generic_decoder import (
    generic_bf16_plan,
    generic_bf16_stream_bytes,
    generic_decode,
)
from alignsdf_torch.kernels.grid_decoder import GB_HALF, GB_SLOT, fin_width, half_widths, round_to
from alignsdf_torch.models.decoder import make_decoder
from alignsdf_torch.ops.decoder_plan import make_generic_decode_fn, make_generic_plan

import torch_parity
from test_torch_bf16 import _close_mostly
from test_torch_generic_decoder import LATENT, _jax_params, _pair
from test_torch_grid_bf16 import CLUSTER, consumer_ops, simulate

BF16 = torch.bfloat16
BUFFER_ROWS = 512  # a warpgroup's activation rows (GB_MAX_OUT)

# (model_type, style, point_size, latent_in, classes, dims, latent)
PLANS = {
    "twin": ("1encoder2decoder", "nerf", 63, (2,), 0, (128,) * 4, LATENT),
    "combined": ("1encoder1decoder", "nerf", 9, (2,), 0, (64,) * 4, LATENT),
    "C6": ("1encoder2decoder", "both", 9, (2,), 6, (64,) * 4, LATENT),
    "C126": ("1encoder1decoder", "nerf", 9, (2,), 126, (64,) * 4, LATENT),
    "latent_in_0_2": ("1encoder2decoder", "both", 9, (0, 2), 6, (64,) * 4, LATENT),
    "fin_lat": ("1encoder2decoder", "nerf", 9, (0, 4), 0, (128,) * 4, LATENT),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _plans(name):
    _, pspecs, pdec, _ = _pair(*PLANS[name][:5], dims=PLANS[name][5], latent=PLANS[name][6])
    return (make_generic_plan(pdec, pspecs, BF16), make_generic_plan(pdec, pspecs),
            PLANS[name][4])


# ---- the plan -------------------------------------------------------------

def _same_rounded(got, f32):
    """got (a bf16 plan's, padded to 16) holds bf16(f32) (the float32 plan's,
    padded to 128 or 8) where both have entries, zeros past f32's."""
    k, n = min(got.shape[0], f32.shape[0]), min(got.shape[1], f32.shape[1])
    assert torch.equal(got[:k, :n], round_to(f32[:k, :n], BF16))
    assert not got[k:].any() and not got[:, n:].any() and not f32[k:, :n].any()


@pytest.mark.parametrize("name", PLANS)
def test_plan_round_trips(name):
    """trunks() of the bf16 plan against the float32 plan's rounded to bf16
    (the TcBf16 layout's values): hidden and input-row weights, biases
    unrounded, final rows and fin_x; widths padded to 16, lat_pad to 16."""
    plan, plan32, classes = _plans(name)
    assert plan.dtype == BF16 and plan.lat_pad % 16 == 0 and plan.n_rows == 2 + classes
    assert plan.lat_pad == -(-max(plan.in_widths) // 16) * 16
    for (hb, fin_b, fx_b), (hf, fin_f, fx_f) in zip(plan.trunks(), plan32.trunks()):
        assert len(hb) == len(hf)
        for (wb, xb, bb), (wf, xf, bf) in zip(hb, hf):
            assert bb.shape[0] % 16 == 0 and bb.shape[0] - 16 < bf.shape[0]
            assert torch.equal(bb, bf[:bb.shape[0]]) and not bf[bb.shape[0]:].any()
            for got, f32 in ((wb, wf), (xb, xf)):
                assert (got is None) == (f32 is None)
                if got is not None:
                    assert got.shape[1] == bb.shape[0]
                    _same_rounded(got, f32)
        _same_rounded(fin_b, fin_f)
        assert (fx_b is None) == (fx_f is None) == (name != "fin_lat")
        if fx_b is not None:
            _same_rounded(fx_b, fx_f)
            assert not fx_b[2:].any()  # the class rows read no input row
    assert torch.equal(plan.fin_b, plan32.fin_b)


def kernel_walk(plan):
    """A Python copy of gb_take_plan (rows true) and the producer's items:
    per trunk its items [(offset in floats, bytes)] in the kernel's order, or
    an AssertionError where the kernel would refuse the descriptor."""
    d = plan.desc.tolist()
    n_trunks, n_rows, lat_pad, pos = d[0], d[3], d[4], 5
    assert 1 <= n_trunks <= 2 and 2 <= n_rows <= 128 and d[1] >= 0
    assert lat_pad >= 16 and lat_pad % 16 == 0
    walks = []
    for t in range(n_trunks):
        n_hidden, fin, fin_lat, last_pad = d[pos:pos + 4]
        pos += 4
        nf = fin_width(n_rows if t == 0 else 2)
        items, cursor, prev = [], None, 0
        for l in range(n_hidden):
            w, x, lat, b, in_pad, out_pad = d[pos:pos + 6]
            pos += 6
            assert out_pad % 16 == 0 and 16 <= out_pad <= 512 and x < 0
            assert (w < 0 and in_pad == 0 and lat >= 0) if l == 0 else (w >= 0 and in_pad == prev)
            start = w if w >= 0 else lat
            if l == 0:
                cursor = start
            assert start == cursor and cursor % 4 == 0
            steps = in_pad // 16 + (lat_pad // 16 if lat >= 0 else 0)
            for k, width in enumerate(half_widths(out_pad)[::-1]):
                for st in range(steps):
                    if k == 0 and st == in_pad // 16:
                        assert lat == cursor
                    items.append((cursor, width * 32))
                    cursor += width * 8
                if k == 0:
                    assert b == cursor
                items.append((cursor, 4 * width))
                cursor += width
            prev = out_pad
        assert last_pad == prev and fin == cursor
        assert fin_lat < 0 or fin_lat == fin + last_pad // 16 * nf * 8
        steps, fk = last_pad // 16 + (lat_pad // 16 if fin_lat >= 0 else 0), GB_SLOT // (nf * 32)
        for st in range(0, steps, fk):
            items.append((cursor, min(fk, steps - st) * nf * 32))
            cursor += min(fk, steps - st) * nf * 8
        walks.append(items)
    assert pos == len(d)
    return walks


@pytest.mark.parametrize("name", PLANS)
def test_plan_streams_are_the_kernel_walk(name):
    """Every descriptor offset lands where the kernel's walk puts it, each
    item fits a slot in pieces of 16 bytes a block of a cluster (of 2, and of
    4 as the timing tool's copy), the streams' bytes are
    generic_bf16_stream_bytes, and the launch model reads each stream once a
    cluster's 256 points."""
    plan, _, _ = _plans(name)
    walks = kernel_walk(plan)
    for items in walks:
        assert all(0 < size <= GB_SLOT and size % (16 * 4) == 0 for _, size in items)
        assert all(off + size // 4 <= plan.flat.numel() for off, size in items)
    assert generic_bf16_stream_bytes(plan) == sum(size for items in walks for _, size in items)
    launch = generic_bf16_plan(plan, 4101)
    assert launch["cluster_tiles"] == -(-4101 // (CLUSTER * 128))
    assert launch["l2_tile_bytes"] == generic_bf16_stream_bytes(plan) * launch["cluster_tiles"]


def _flagship_plan():
    specs = Specs(encode_style="nerf", point_feat_size=63, latent_size=256, mano_branch=True,
                  object_pose_branch=True, sdf_scale_factor=7.0, network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        dec = make_decoder("1encoder2decoder", 256, 63, "nerf", specs.network_specs)
    return make_generic_plan(dec, specs, BF16)


def test_flagship_stream_bytes():
    """At --point_size 63 (x0 319 wide, padded to 320; 512 -> 193 -> [193 +
    319] -> 512 -> 512 -> 1) layer 1's 193 outputs pad to 208, a trunk's
    stream is 1.62 MB, and a 128^3 pass in the generic evaluator's runs of
    2^18 reads 26.6 GB of tiles from L2 (one read a cluster's 256 points;
    modelled)."""
    plan = _flagship_plan()
    assert plan.lat_pad == 320 and plan.in_widths == (319, 319)
    pads = [plan.desc[5 + 4 + 6 * l + 5] for l in range(4)]
    assert pads == [512, 208, 512, 512]
    per_trunk = (2 * (20 * 256 * 32 + 256 * 4)          # layer 0: x0's 20 k steps
                 + 32 * 208 * 32 + 208 * 4               # 512 -> 208
                 + 2 * ((13 + 20) * 256 * 32 + 256 * 4)  # [208 + 320] -> 512
                 + 2 * (32 * 256 * 32 + 256 * 4)         # 512 -> 512
                 + 32 * 8 * 32)                          # the final rows, 8 wide
    assert generic_bf16_stream_bytes(plan) == 2 * per_trunk == 3_241_600
    total = sum(generic_bf16_plan(plan, min(1 << 18, 128 ** 3 - s))["l2_tile_bytes"]
                for s in range(0, 128 ** 3, 1 << 18))
    assert total == 8192 * 3_241_600


# ---- the plain version against JAX --------------------------------------------

@pytest.mark.parametrize("model_type,style,pfs,latent_in,classes,dims,latent", [
    ("1encoder2decoder", "nerf", 9, (), 0, (48,), LATENT),
    ("1encoder2decoder", "nerf", 9, (1,), 0, (64, 64), LATENT),
    ("1encoder1decoder", "nerf", 9, (1,), 6, (64, 64), LATENT),
    ("1encoder2decoder", "nerf", 9, (2,), 0, (48, 48), LATENT),
    ("1encoder2decoder", "nerf", 63, (), 0, (32,), 512),
], ids=["one_layer", "two_layers", "combined_C6", "fin_lat", "wider_than_the_buffer"])
def test_plain_bf16_k6_matches_jax(model_type, style, pfs, latent_in, classes, dims, latent):
    """300 seeded rows through the bf16 plan's plain version against JAX's
    bf16 generic kernel in interpret mode (block 128): both SDFs and the
    logits within TIGHT at >= 99% of the entries and LOOSE everywhere; a CPU
    tensor takes the plain version (no launch counted)."""
    jspecs, pspecs, pdec, _ = _pair(model_type, style, pfs, latent_in, classes, dims=dims,
                                    latent=latent)
    rows = (np.random.RandomState(3).randn(300, latent + pfs) * 0.5).astype(np.float32)
    want = make_pallas_decode_fn(jspecs, block=128, interpret=True, dtype=jnp.bfloat16)(
        {"decoder_params": _jax_params(pdec, jspecs)}, jnp.asarray(rows))
    before = generic_decode.bf16_launches, generic_decode.launches
    with torch.no_grad():
        got = make_generic_decode_fn(pspecs, dtype=BF16)({"decoder": pdec},
                                                         torch.from_numpy(rows))
    assert (generic_decode.bf16_launches, generic_decode.launches) == before
    plan = make_generic_plan(pdec, pspecs, BF16)
    assert (plan.lat_pad > BUFFER_ROWS) == (latent == 512)
    assert any(fx is not None for *_, fx in plan.trunks()) == (latent_in == (2,))
    for name, g, w in zip(("sdf_hand", "sdf_obj", "logits"), got, want):
        assert (g is None) == (w is None) == (name == "logits" and not classes)
        if g is not None:
            assert g.dtype == torch.float32 and g.shape == w.shape
            _close_mostly(g.numpy(), np.asarray(w), name)


# ---- the schedule ------------------------------------------------------------

# (out_pads, nf, trunks, the layers on the input rows, lat_pad, fin_lat)
SCHEDULES = {
    "point_size_63": ([512, 208, 512, 512], 8, 2, (0, 2), 320, False),
    "combined_C126": ([512, 208, 512, 512], 128, 1, (0, 2), 320, False),
    "wider_than_the_buffer": ([512, 512, 512, 512], 8, 2, (0,), 576, False),
    "fin_lat": ([512, 208, 512, 512], 8, 2, (0, 2), 320, True),
    "narrow_fin_lat": ([128, 96, 128, 48], 8, 2, (0, 2), 48, True),
}


def test_the_528_rows_read_registers():
    """At --point_size 63 layer 2's input is 208 + 320 rows: the buffer
    stages 304 of x0's columns above a_1 and the last k step of each half
    reads registers (2 a trunk, 4 a tile of twin trunks); layer 0's 320 rows
    fit; a 512-row last activation leaves fin_lat none (20 a trunk)."""
    assert 208 + 320 == BUFFER_ROWS + 16
    for name, regs in (("point_size_63", 4), ("fin_lat", 4 + 2 * 20),
                       ("wider_than_the_buffer", 2 * 2 * 4), ("narrow_fin_lat", 0)):
        out_pads, nf, trunks, lats, lat_pad, fin_lat = SCHEDULES[name]
        _, _, got = consumer_ops(out_pads, out_pads[-1] // 16, nf, trunks, 1, lats=lats,
                                 lat_pad=lat_pad, fin_lat=fin_lat)
        assert got == regs, (name, got)


@pytest.mark.parametrize("name", SCHEDULES)
def test_order_of_work_is_safe(name):
    """Every interleaving tried completes, refills no slot before every
    warpgroup of the cluster released it and reads only rows that hold what
    the step wants (the layer before's outputs, then x0's columns in order),
    two tiles a block, in clusters of 2 (and of 4 at --point_size 63)."""
    out_pads, nf, trunks, lats, lat_pad, fin_lat = SCHEDULES[name]
    assert max(out_pads) <= 2 * GB_HALF
    for cluster in (CLUSTER, 4) if name == "point_size_63" else (CLUSTER,):
        for seed in range(3):
            simulate(out_pads, nf, trunks, 2, seed, cluster, lats=lats, lat_pad=lat_pad,
                     fin_lat=fin_lat)
