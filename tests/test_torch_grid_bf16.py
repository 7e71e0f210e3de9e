"""K1's bf16 kernel (``csrc/grid_trunk_bf16_tc.cuh``, ``grid_bf16_kernel``)
and its plan (``kernels/grid_decoder.py:pack_grid_plan_bf16``), on the CPU.

- The bf16 tiles (``tile_bf16``: a k step's B operand of any width) round
  trip through ``untile_bf16``, and at widths of 128 x G they are
  ``tile_weights``' bf16 layout.
- The plan's streams are the kernel's walk: a Python copy of its
  ``gb_take_plan`` and of its producer's items (per layer the halves of up
  to 256 outputs, the last first: their k-step tiles, then their epilogue
  blocks; then the final rows' tiles) lands every offset of the descriptor
  and ends each stream at its final tiles; ``bf16_stream_bytes`` is the
  items' bytes; the plan's weights untile to the fold's, rounded to bf16.
- The new plan's plain version against JAX's bf16 K1 in interpret mode
  (block 128) over a 16^3 grid, on a run from a nonzero base: at 2 rows, at
  2 + 6, on a combined trunk, with a final-layer latent (fin_xyz), and at a
  width of two halves (320, padded to 384): within TIGHT at >= 99% of the
  points (97% at 320 wide, SHARES) and LOOSE everywhere
  (tests/test_torch_bf16.py's bounds).
- The kernel's schedule emulated: per block of a cluster of 2 (the
  package's build) or 4 (the timing tool's GB_CLUSTER copy), the producer's
  items and both consumer warpgroups' products, epilogues, scratch stores
  and reloads, with the ring's full and empty mbarriers, under many
  interleavings: no deadlock; no ring slot refilled before every warpgroup
  of the cluster released it; every product reads rows that hold the layer
  before's outputs (no epilogue wrote them before the warpgroup's last
  read).

The kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import math
import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from alignsdf_tpu.ops.decoder_kernel import make_fused_grid_decode_fn
from alignsdf_torch.kernels.grid_decoder import (
    GB_HALF,
    GB_SLOT,
    GridPlan,
    bf16_stream_bytes,
    fin_width,
    grid_bf16_plan,
    half_widths,
    round_to,
    tile_bf16,
    tile_weights,
    untile_bf16,
)
from alignsdf_torch.ops.grid_plan import make_grid_decode_fn

import torch_parity
from test_torch_generic_decoder import LATENT, _jax_params, _kinematic_ctx, _pair

BF16 = torch.bfloat16
TIGHT, LOOSE, SHARE = 1e-5, 2e-3, 0.99
N, BASE, CUT = 16, 37, 300
SLOTS, CLUSTER = 12, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


@pytest.mark.parametrize("k,width", [(16, 8), (32, 16), (512, 8), (64, 128), (256, 256),
                                     (512, 384)])
def test_tiles_round_trip(k, width):
    """tile_bf16 -> untile_bf16 gives bf16(W), zero-padded; each entry (kk,
    n) sits where the kernel's B descriptor reads it (k step kk // 16's
    tile, core matrix of outputs n // 8 and k half (kk % 16) // 8, row n %
    8, column kk % 8); at widths of 128 x G they are the bf16 layout that
    K3 and K6 read (tile_weights), written out here as its own permutation."""
    g = torch.Generator().manual_seed(k + width)
    w = torch.randn(k - 3, width - 1, generator=g)
    tiles = tile_bf16(w, k, width)
    assert tiles.numel() == k * width // 2
    want = torch.zeros(k, width)
    want[:k - 3, :width - 1] = round_to(w, BF16)
    assert torch.equal(untile_bf16(tiles, k, width), want)
    raw = tiles.view(BF16).view(k // 16, width // 8, 2, 8, 8).to(torch.float32)
    for kk, n in zip(torch.randint(0, k - 3, (64,), generator=g).tolist(),
                     torch.randint(0, width - 1, (64,), generator=g).tolist()):
        assert raw[kk // 16, n // 8, (kk % 16) // 8, n % 8, kk % 8] == want[kk, n]
    if width % 128 == 0:
        # (step, k half, k, group of 128, output group of 8, output) -> (step,
        # group, output group of 8, k half, output, k)
        full = torch.zeros(k, width)
        full[:k - 3, :width - 1] = w
        old = (full.unflatten(1, (width // 128, 16, 8)).unflatten(0, (k // 16, 2, 8))
               .permute(0, 3, 4, 1, 5, 2).to(BF16).reshape(-1).view(torch.float32))
        assert torch.equal(tiles, old)
        assert torch.equal(tile_weights(w, k, width, BF16), old)


# ---- the plan -------------------------------------------------------------

def _scene(model_type="1encoder2decoder", num_class=0, latent_in=(2,), dims=(64,) * 4,
           style="both", pfs=9):
    jspecs, pspecs, pdec, _ = _pair(model_type, style, pfs, latent_in, num_class, dims=dims)
    rng = np.random.RandomState(26)
    ctx = _kinematic_ctx(rng)
    ctx["latent"] = (rng.randn(1, LATENT) * 0.5).astype(np.float32)
    pctx = {"decoder": pdec, **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    params = _jax_params(pdec, jspecs)
    jctx = {"decoder_params": params, "params": params,
            **{k: jnp.asarray(v) for k, v in ctx.items()}}
    return jspecs, pspecs, pctx, jctx


SCENES = {
    "twin": {},
    "C6": {"num_class": 6},
    "combined": {"model_type": "1encoder1decoder", "style": "nerf", "pfs": 3, "num_class": 6},
    "fin_xyz": {"latent_in": (2, 4)},
    "two_halves": {"dims": (320,) * 4, "num_class": 6},
}
# within TIGHT, of the points: at 64 wide tests/test_torch_bf16.py's 99%; at
# 320 wide (hidden 282 -> 384, two halves) the longer float32 sums flip more
# bf16 roundings (measured: the SDF rows 98.1% within 1e-5, 1.3e-4 at most)
SHARES = {"two_halves": 0.97}


def kernel_walk(plan: GridPlan):
    """A Python copy of gb_take_plan and the producer's items: per trunk
    its items [(offset in floats, bytes)] in the kernel's order, or an
    AssertionError where the kernel would refuse the descriptor."""
    d = plan.desc.tolist()
    n_trunks, n_rows, pos = d[0], d[3], 4
    assert 1 <= n_trunks <= 2 and 2 <= n_rows <= 128 and d[1] >= 0
    walks = []
    for t in range(n_trunks):
        n_hidden, fin, fin_xyz, last_pad = d[pos:pos + 4]
        pos += 4
        nf = fin_width(n_rows if t == 0 else 2)
        items, cursor, prev = [], None, 0
        for l in range(n_hidden):
            w, x, b, in_pad, out_pad = d[pos:pos + 5]
            pos += 5
            assert out_pad % 128 == 0 and 128 <= out_pad <= 512
            assert (w < 0 and in_pad == 0) if l == 0 else (w >= 0 and in_pad == prev)
            if l == 0:
                cursor = b
            assert (b if l == 0 else w) == cursor and cursor % 4 == 0
            widths = half_widths(out_pad)[::-1]
            for k, width in enumerate(widths):
                for _ in range(in_pad // 16):
                    items.append((cursor, width * 32))
                    cursor += width * 8
                if k == 0:
                    assert b == cursor and (x < 0 or x == b + width)
                size = width * (4 if x >= 0 else 1)
                items.append((cursor, 4 * size))
                cursor += size
            prev = out_pad
        assert last_pad == prev and fin == cursor
        steps, fk = last_pad // 16, GB_SLOT // (nf * 32)
        for st in range(0, steps, fk):
            items.append((cursor, min(fk, steps - st) * nf * 32))
            cursor += min(fk, steps - st) * nf * 8
        walks.append(items)
    assert pos == len(d)
    return walks


@pytest.mark.parametrize("name", SCENES)
def test_plan_streams_are_the_kernel_walk(name):
    """Every descriptor offset lands where the kernel's walk puts it, each
    item fits a slot in pieces of 16 bytes a block of a cluster, the streams'
    bytes are bf16_stream_bytes, the plan's weights untile to the fold's
    rounded to bf16 (as the float32 plan holds them unrounded), and the
    launch model reads each stream once a cluster's 256 points."""
    _, pspecs, pctx, _ = _scene(**SCENES[name])
    plan = make_grid_decode_fn(pspecs, N, BF16)(pctx).plan
    plan32 = make_grid_decode_fn(pspecs, N)(pctx).plan
    walks = kernel_walk(plan)
    for items in walks:
        assert all(0 < size <= GB_SLOT and size % (16 * CLUSTER) == 0 for _, size in items)
        assert all(off + size // 4 <= plan.flat.numel() for off, size in items)
    assert bf16_stream_bytes(plan) == sum(size for items in walks for _, size in items)
    for (hb, fin_b, fx_b), (hf, fin_f, fx_f) in zip(plan.trunks(), plan32.trunks()):
        for (wb, xb, bb), (wf, xf, bf) in zip(hb, hf):
            assert (wb is None) == (wf is None) and (xb is None) == (xf is None)
            assert torch.equal(bb, bf)
            if wb is not None:
                assert torch.equal(wb[:, :wf.shape[1]], round_to(wf[:wb.shape[0]], BF16))
            if xb is not None:
                assert torch.equal(xb, round_to(xf, BF16))
        assert torch.equal(fin_b, round_to(fin_f, BF16))
        assert (fx_b is None) == (fx_f is None) and (fx_b is None or torch.equal(
            fx_b, round_to(fx_f, BF16)))
    assert (any(fx is not None for _, _, fx in plan.trunks())) == (name == "fin_xyz")
    m = N ** 3
    launch = grid_bf16_plan(plan, m)
    assert launch["cluster_tiles"] == math.ceil(m / 256)
    assert launch["l2_tile_bytes"] == bf16_stream_bytes(plan) * launch["cluster_tiles"]


def test_flagship_stream_bytes():
    """At the flagship's widths (latent 256, 5 x 512 trunks, latent_in (2,))
    a tile's streams are ~2.15 MB (twin trunks of 512 -> 256 -> 512 -> 512
    -> 1), so a 128^3 pass reads ~17.6 GB from L2 at 256 points a read (the
    figure ISSUE 26's arithmetic starts from)."""
    from alignsdf_torch.config import NetworkSpecs, Specs
    from alignsdf_torch.models.decoder import make_decoder

    specs = Specs(encode_style="both", point_feat_size=9, latent_size=256, mano_branch=True,
                  object_pose_branch=True, sdf_scale_factor=7.0, network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        dec = make_decoder("1encoder2decoder", 256, 9, "both", specs.network_specs)
    rng = np.random.RandomState(0)
    ctx = {"decoder": dec, "latent": torch.randn(1, 256),
           **{k: torch.from_numpy(v) for k, v in _kinematic_ctx(rng).items()}}
    plan = make_grid_decode_fn(specs, 128, BF16)(ctx).plan
    assert plan.out_pads() == [512, 256, 512, 512] * 2
    per_trunk = (2 * 4 * 256 * 4                    # layer 0: two epilogue blocks with xyz
                 + 32 * 256 * 32 + 256 * 4          # 512 -> 256
                 + 2 * (16 * 256 * 32 + 256 * 16)   # 256 -> 512, xyz
                 + 2 * (32 * 256 * 32 + 256 * 4)    # 512 -> 512
                 + 32 * 8 * 32)                     # the final rows, 8 wide
    assert bf16_stream_bytes(plan) == 2 * per_trunk
    total = sum(grid_bf16_plan(plan, min(1 << 20, 128 ** 3 - s))["l2_tile_bytes"]
                for s in range(0, 128 ** 3, 1 << 20))
    assert 17.5e9 < total < 17.7e9, total


# ---- the plain version against JAX --------------------------------------------

@pytest.mark.parametrize("name", SCENES)
def test_plain_bf16_k1_matches_jax(name):
    """The bf16 plan's plain version against JAX's bf16 K1 (interpret mode,
    block 128) on the run [BASE, N^3 - CUT) of a 16^3 grid."""
    jspecs, pspecs, pctx, jctx = _scene(**SCENES[name])
    origin, voxel = np.full(3, -1.0, np.float32), np.float32(2.0 / (N - 1))
    m = N ** 3 - BASE - CUT
    decode = make_grid_decode_fn(pspecs, N, BF16)(pctx)
    got = decode(BASE, m, torch.from_numpy(origin), torch.tensor(voxel)).numpy()
    gd = make_fused_grid_decode_fn(jspecs, N, block=128, interpret=True, dtype=jnp.bfloat16,
                                   layout="lanes")
    h, o, logits = gd(jctx, jnp.arange(BASE, BASE + m, dtype=jnp.int32), jnp.asarray(origin),
                      jnp.asarray(voxel))
    want = [np.asarray(h)[:, 0], np.asarray(o)[:, 0]]
    if logits is not None:
        want += list(np.asarray(logits).T)
    want = np.stack(want)
    assert got.shape == want.shape == (decode.plan.n_rows, m)
    err = np.abs(got.astype(np.float64) - want)
    err[2:] /= max(1.0, float(np.abs(want[2:]).max(initial=0.0)))
    share = SHARES.get(name, SHARE)
    assert float((err <= TIGHT).mean()) >= share, (name, float((err <= TIGHT).mean()))
    assert float(err.max()) <= LOOSE, (name, float(err.max()))


# ---- the schedule ------------------------------------------------------------

def x0_rows(t, count):
    """The labels of trunk t's input-row columns 0 .. count - 1 staged in rows."""
    return tuple(("x0", t, c) for c in range(count))


def product_ops(ops, s, steps, sm, rows, fk=1):
    """A product's operations in the kernel's order from item s on: ``steps``
    k steps, fk an item; the first ``sm`` read their 16 rows (``rows``: the
    labels those rows must hold), the rest (K6's register steps) device
    memory and wait for their product at once.  Each item waits for its
    slot; an item is released once the item after it is issued
    (wgmma.wait_group 1), or at once after a register step.  Returns the next
    item."""
    held = False
    st = 0
    while st < steps:
        ops.append(("wait_full", s))
        reg = False
        for _ in range(min(fk, steps - st)):
            if st < sm:
                ops.append(("read", 16 * st, rows[16 * st:16 * st + 16]))
            else:
                reg = True
            st += 1
        if reg:
            if held:
                ops.append(("release", s - 1))
            ops.append(("release", s))
            held = False
        else:
            if held:
                ops.append(("release", s - 1))
            held = True
        s += 1
    if held:
        ops.append(("release", s - 1))
    return s


def consumer_ops(out_pads, last_steps, nf, trunks, tiles, lats=(), lat_pad=0, fin_lat=False):
    """A consumer warpgroup's operations in gb_body's order, over ``tiles``
    tiles: per layer and half (the last first) a product over the input
    rows, then its epilogue (wait for the half's epilogue item; the first
    half's rows to scratch where the rows the layer reads reach past 256, or
    into the buffer; the last half reloads the scratch after its products),
    then the final rows' product and epilogue.  K6 (``lats``: the layers that
    read the input rows, ``lat_pad`` their width, ``fin_lat``: the final rows
    too): the columns that fit the 512-row buffer are filled above the
    activation, before layer 0 and after the last epilogue of the layer
    before a reader; the k steps past them read registers.  Returns (the
    operations, items, register steps a tile)."""
    ops, s, regs = [], 0, 0
    fk = GB_SLOT // (nf * 32)

    def staged(reads, in_pad):
        return min(lat_pad, 512 - in_pad) if reads else 0

    for _ in range(tiles):
        regs = 0
        for t in range(trunks):
            in_pad = 0
            for l, out in enumerate(out_pads):
                x_rows = staged(l in lats, in_pad)
                if lats and l == 0:
                    ops.append(("stage", 0, x0_rows(t, x_rows)))
                steps = in_pad // 16 + (lat_pad // 16 if l in lats else 0)
                sm = (in_pad + x_rows) // 16
                regs += (steps - sm) * len(half_widths(out))
                rows = ((t, l - 1),) * in_pad + x0_rows(t, x_rows)
                halves = list(enumerate(half_widths(out)))[::-1]
                spill = len(halves) > 1 and in_pad + x_rows > GB_HALF
                for h, width in halves:
                    s = product_ops(ops, s, steps, sm, rows)
                    ops.append(("wait_full", s))
                    lo = GB_HALF * h
                    if spill and h:
                        ops.append(("scratch", (t, l), lo, lo + width))
                    else:
                        ops.append(("write", (t, l), lo, lo + width))
                    if spill and not h:
                        ops.append(("reload", (t, l), GB_HALF, out))
                    if not h and (l + 1 in lats if l + 1 < len(out_pads) else fin_lat):
                        ops.append(("stage", out, x0_rows(t, staged(True, out))))
                    ops.append(("release", s))
                    s += 1
                in_pad = out
            x_rows = staged(fin_lat, in_pad)
            steps = last_steps + (lat_pad // 16 if fin_lat else 0)
            sm = (in_pad + x_rows) // 16
            regs += steps - sm
            rows = ((t, len(out_pads) - 1),) * in_pad + x0_rows(t, x_rows)
            s = product_ops(ops, s, steps, sm, rows, fk)
    return ops, s, regs


def simulate(out_pads, nf, trunks, tiles, seed, cluster, **k6):
    """Every block of a cluster of ``cluster`` (a producer and two consumer
    warpgroups each) in a random interleaving, one actor slow by the seed,
    with mbarrier semantics; ``k6``: consumer_ops' K6 arguments.  Returns
    nothing, asserts the schedule's safety."""
    rng = random.Random(seed)
    ops, items, _ = consumer_ops(out_pads, out_pads[-1] // 16, nf, trunks, tiles, **k6)
    producer = [op for s in range(items) for op in
                ([("wait_empty", s)] if s >= SLOTS else []) + [("fill", s)]]
    actors = [(b, w) for b in range(cluster) for w in ("p", 0, 1)]
    seqs = {a: (producer if a[1] == "p" else ops) for a in actors}
    pos = {a: 0 for a in actors}
    weights = {a: 1.0 for a in actors}
    weights[actors[seed % len(actors)]] = 0.03
    pieces = {}                                # (block, item) -> producers' pieces landed
    released = {}                              # item -> consumer warpgroups that released it
    slot_item = {}                             # (block, slot) -> the item it holds
    rows = {(b, w): [None] * 512 for b in range(cluster) for w in (0, 1)}  # a warpgroup's
    scratch = {}

    def can_run(a):
        op = seqs[a][pos[a]]
        kind = op[0]
        if kind == "wait_empty":
            return len(released.get(op[1] - SLOTS, ())) == 2 * cluster
        if kind == "wait_full":
            return len(pieces.get((a[0], op[1]), ())) == cluster
        return True

    while any(pos[a] < len(seqs[a]) for a in actors):
        live = [a for a in actors if pos[a] < len(seqs[a]) and can_run(a)]
        waiting = [(a, seqs[a][pos[a]]) for a in actors if pos[a] < len(seqs[a])]
        assert live, f"deadlock at {waiting}"
        a = rng.choices(live, [weights[x] for x in live])[0]
        op = seqs[a][pos[a]]
        pos[a] += 1
        b, w = a
        kind = op[0]
        if kind == "fill":  # this block's piece into the slot of every block
            s = op[1]
            for bb in range(cluster):
                old = slot_item.get((bb, s % SLOTS))
                assert old in (None, s) or len(released.get(old, ())) == 2 * cluster, (op, old)
                slot_item[(bb, s % SLOTS)] = s
                pieces.setdefault((bb, s), set()).add(b)
        elif kind == "release":
            s = op[1]
            assert slot_item[(b, s % SLOTS)] == s
            released.setdefault(s, set()).add((b, w))
        elif kind == "read":  # a product step over 16 of the warpgroup's input rows
            want = list(op[2])
            got = rows[a][op[1]:op[1] + len(want)]
            assert got == want, (a, op[1], want[:1], got[:1])
        elif kind == "stage":  # K6's input rows into the warpgroup's rows
            rows[a][op[1]:op[1] + len(op[2])] = list(op[2])
        elif kind == "write":
            rows[a][op[2]:op[3]] = [op[1]] * (op[3] - op[2])
        elif kind == "scratch":
            scratch[a] = (op[1], op[2], op[3])
        elif kind == "reload":
            assert scratch.pop(a) == (op[1], op[2], op[3])
            rows[a][op[2]:op[3]] = [op[1]] * (op[3] - op[2])
    assert not scratch


@pytest.mark.parametrize("cluster", [CLUSTER, 4], ids=["cluster2", "cluster4"])
@pytest.mark.parametrize("out_pads,nf,trunks", [
    ([512, 256, 512, 512], 8, 2),      # the flagship's twin trunks
    ([512, 256, 512, 512], 128, 1),    # a combined trunk at 2 + 126 rows
    ([512, 256, 512, 256], 8, 2),      # latent_in (2, 4): layer 3 at 250
    ([384, 384, 128, 512, 384], 16, 2),
    ([128, 128, 128, 128], 8, 1),
    ([512] * 8, 8, 2),
])
def test_order_of_work_is_safe(out_pads, nf, trunks, cluster):
    """Every interleaving tried completes, refills no slot before every
    warpgroup of the cluster released it and reads whole input rows only
    (two tiles a block), in clusters of 2 as the package builds the kernel
    and of 4 as the timing tool's probe copy does."""
    for seed in range(8):
        simulate(out_pads, nf, trunks, 2, seed, cluster)
