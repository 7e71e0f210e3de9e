"""K2's bf16 train forward (``csrc/train_fwd_bf16_tc.cuh``), on the CPU.

- Its launch plan (``train_fwd_bf16_plan``, the launcher's checks and
  counts in Python) at the widths of the specs the port trains in bf16: the
  flagship, BASELINE.json's configs 1 and 2, ``--cls``, the combined trunk
  and ``latent_in (2, 4)``: shared memory within the card's 232,448 bytes,
  64 points a block, clusters of 2 (each tile read from L2 once per 128
  points), the tile bytes from L2 and the device bytes of the bound; and the
  widths it refuses.
- The bytes behind the restated bound at the flagship's 64 x 2000 points,
  and the pack's second tile stream (``fwd_x``: X as bf16 tiles, the
  embedding's k steps).
- The kernel's order of work simulated: each consumer warpgroup's items
  (layer, group w, w + 2, ...), the rule that runs a group's epilogue under
  the next product or on its own, the per-(buffer, group) ready and drained
  mbarriers with the launcher's phase bits, and the store thread, under
  many interleavings: no deadlock, every product k step reads a group's
  rows only once they are whole, no epilogue overwrites rows that a
  product or a store still has to read.
- The kernel's arithmetic emulated in plain torch: each group's product (W's
  k steps, then X's over the embedding) into one float32 sum, its epilogue
  into the layer's buffer, and the final rows summed as the kernel sums
  them (each thread's 32 units in order, the quad's four sums in pairs, the
  groups in order, then the final layer's embedding terms).  In float64 it
  gives the plain bf16 forward's residuals bit for bit (no sum order can
  move a rounding there) and y within 1e-12; in float32 it holds to JAX's
  bf16 scene kernel (``_fused_scene_fwd`` in interpret mode) and to the
  plain version in float32 at the card's bounds: residuals equal at >=
  99.9% of the entries and elsewhere within one bf16 step, y within 1e-5
  at >= 99% of the points and 2e-3 everywhere.  Scenes of 40 and 200
  points, so that blocks of 64 straddle them.

The kernel itself is held to the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from alignsdf_tpu.ops.decoder_train_kernel import _fused_scene_fwd, _plan_statics, _scene_statics
from alignsdf_torch.kernels.grid_decoder import round_to, untile_weights
from alignsdf_torch.kernels.train_decoder import (
    FB_SMEM,
    MAX_SMEM,
    PAD,
    dropout_gate,
    pack_trunk,
    train_decode_reference,
    train_fwd_bf16_plan,
)

import torch_parity
from test_torch_chain_bf16 import SPECS, _spec, _trunk, _trunk_inputs

BF16 = torch.bfloat16
P, CLUSTER, GROUP = 64, 2, 128
TIGHT, SHARE, LOOSE = 1e-5, 0.99, 2e-3
RESID_SHARE = 0.999


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


@pytest.mark.parametrize("name", SPECS)
def test_fwd_bf16_plan_at_the_specs_widths(name):
    """The plan at each trained spec's widths over 64 scenes: the kernel
    takes them in one 224,704-byte block of 64 points, clusters of 2 over
    ceil(M / 64) blocks, each tile read once a cluster; the residuals, 2
    bytes each, are most of the bytes."""
    specs = _spec(name)
    m = 64 * specs.samples_per_scene
    for out_pads, e, st, has_x in _trunk_inputs(specs):
        plan = train_fwd_bf16_plan(out_pads, e, m, st.n_per_scene, st.scene_bias, has_x)
        assert plan["smem_bytes"] == FB_SMEM <= MAX_SMEM
        assert (plan["points_per_block"], plan["cluster"], plan["ring_stages"]) == (P, CLUSTER, 10)
        assert plan["blocks"] == -(-m // P) and plan["grid"] % CLUSTER == 0
        assert plan["grid"] - plan["blocks"] < CLUSTER and plan["bulk"] == 1
        hidden = out_pads[:-1]
        xs = sum(w for w, x in zip(hidden, has_x) if x)
        assert plan["tile_bytes"] == 2 * (sum(a * b for a, b in zip(hidden, hidden[1:]))
                                          + -(-e // 16) * 16 * xs)
        assert plan["l2_tile_bytes"] == plan["tile_bytes"] * plan["grid"] // CLUSTER
        floor = 2 * m * sum(hidden)
        assert floor < plan["device_bytes"] < 1.1 * floor


def test_fwd_bf16_plan_bytes_at_the_flagship():
    """The restated bound at the flagship's 64 x 2000 points, both trunks:
    ~0.93 GB (the residuals 0.92 of it), 0.28 ms at 3.35 TB/s; the tiles
    from L2 ~2.16 GB, each tile read for 128 points, half of one block's
    reads."""
    specs = _spec("flagship")
    m = 64 * specs.samples_per_scene
    plans = [train_fwd_bf16_plan(o, e, m, st.n_per_scene, st.scene_bias, x)
             for o, e, st, x in _trunk_inputs(specs)]
    total = sum(p["device_bytes"] for p in plans)
    assert 0.92e9 < total < 0.94e9, total
    assert 0.27 < total / 3.35e12 * 1e3 < 0.285
    l2 = sum(p["l2_tile_bytes"] for p in plans)
    assert l2 * CLUSTER == sum(p["tile_bytes"] * p["blocks"] for p in plans)
    assert 2.15e9 < l2 < 2.17e9, l2


@pytest.mark.parametrize("change,match", [
    (dict(out_pads=[512, 640, 1]), "hidden widths"),
    (dict(out_pads=[512, 200, 1]), "hidden widths"),
    (dict(out_pads=[512, 256, 3]), "outputs"),
    (dict(out_pads=[512] * 10 + [1]), "layers"),
    (dict(e=65), "embedding columns"),
    (dict(e=0), "embedding columns"),
    (dict(m=4002), "multiple of 4"),
    (dict(m=4000, n_per_scene=3000), "multiple of 4 and of n_per_scene"),
    (dict(first_x=False), "layer 0 reads the embedding"),
])
def test_fwd_bf16_plan_refuses(change, match):
    """Widths and shapes the kernel cannot take raise; it never falls back."""
    args = dict(out_pads=[512, 256, 1], e=6, m=4000, n_per_scene=2000, first_x=True)
    args.update(change)
    n = len(args["out_pads"])
    with pytest.raises(ValueError, match=match):
        train_fwd_bf16_plan(args["out_pads"], args["e"], args["m"], args["n_per_scene"],
                            [False] * n, [args["first_x"]] + [False] * (n - 1))


def test_pack_holds_x_as_bf16_tiles():
    """A bf16 pack's fwd_x untiles to bf16(X) of each hidden layer with X,
    e rounded up to 16 rows (zeros below), in layer order; a float32 pack
    has none."""
    _, st, e, ws, xs, bs, *_ = _trunk(40, 3)
    p = pack_trunk(e, ws, xs, bs, st)
    f32 = pack_trunk(e, ws, xs, bs, st._replace(dtype=torch.float32))
    assert f32.fwd_x is None and p.fwd_x is not None
    e16 = -(-e.shape[1] // 16) * 16
    at = 0
    for layer in range(len(bs) - 1):
        if xs[layer] is None:
            continue
        n = p.out_pads[layer]
        got = untile_weights(p.fwd_x[at:at + e16 * n // 2], e16, n, BF16)
        want = round_to(xs[layer], BF16)
        assert torch.equal(got[:want.shape[0], :want.shape[1]], want)
        assert float(got[want.shape[0]:].abs().sum() + got[:, want.shape[1]:].abs().sum()) == 0
        at += e16 * n // 2
    assert at == p.fwd_x.numel()


# ---- the order of work ------------------------------------------------------

def phase_bits(out_pads):
    """Per hidden layer the launcher's phase word: bit g the parity of
    (buffer l % 2, group g)'s phase for this layer, bit 4 + g whether an
    earlier layer of that buffer had group g (launch_fwd_bf16)."""
    bits = []
    for l, w in enumerate(out_pads):
        word = 0
        for g in range(w // GROUP):
            k = sum(out_pads[j] // GROUP > g for j in range(l % 2, l, 2))
            word |= (k & 1) << g | (k > 0) << (4 + g)
        bits.append(word)
    return bits


def consumer_ops(wg, out_pads, e):
    """Warpgroup wg's operations in the kernel's order (the consumer loop
    of train_fwd_bf16_kernel): its items (layer l, group wg, wg + 2, ...),
    each a product of W's k steps over layer l - 1's rows and X's over the
    embedding (layer 0: X's alone), the pending group's epilogue as 4
    slices under the product where the rule allows, else on its own."""
    bits = phase_bits(out_pads)
    x_steps = -(-e // 16)
    ops, pl, pg = [], -1, 0

    def epilogue_start(l, g):
        if (bits[l] >> (4 + g)) & 1:
            ops.append(("wait_drained", l, g, ((bits[l] >> g) & 1) ^ 1))

    def finish(l, g):
        ops.append(("ready", l, g))

    hidden = len(out_pads)
    for l in range(hidden + 1):
        groups = out_pads[l] // GROUP if l < hidden else wg + 1
        for g in range(wg, groups, 2):
            w_steps = out_pads[l - 1] // 16 if 0 < l < hidden else 0
            steps = w_steps + (x_steps if l < hidden else 0)
            under = pl >= 0 and steps >= 16 and (pl == l or (pl == l - 1 and pg >= 2))
            if pl >= 0 and not under:
                epilogue_start(pl, pg)
                ops += [("write", pl, pg)] * 4
                finish(pl, pg)
                pl = -1
            if l == hidden:
                break
            if under:
                epilogue_start(pl, pg)
            for st in range(steps):
                if st < w_steps and st % 8 == 0:
                    kg = st // 8
                    ops.append(("wait_ready", l - 1, kg, (bits[l - 1] >> kg) & 1))
                if st < w_steps:
                    ops.append(("read", l - 1, st // 8))
                if under and st % 4 == 3 and st < 16:
                    ops.append(("write", pl, pg))
                    if st == 15:
                        finish(pl, pg)
            pl, pg = l, g
    return ops


def store_ops(out_pads):
    """The store thread's operations (fb_store): each (layer, group), once
    ready, stored (its rows read), then its drained barrier."""
    bits = phase_bits(out_pads)
    ops = []
    for l, w in enumerate(out_pads):
        for g in range(w // GROUP):
            ops += [("wait_ready", l, g, (bits[l] >> g) & 1), ("store", l, g), ("drained", l, g)]
    return ops


def simulate(out_pads, e, seed):
    """Runs both warpgroups and the store thread in a random interleaving
    (one of them slow, by the seed) with mbarrier semantics (a wait on parity P passes once the barrier's
    completed phases have the other parity, never two phases ahead),
    checking every read and write against the buffers' contents."""
    rng = random.Random(seed)
    actors = [consumer_ops(0, out_pads, e), consumer_ops(1, out_pads, e), store_ops(out_pads)]
    weights = [1.0, 1.0, 1.0]
    weights[seed % 3] = 0.02
    pos = [0, 0, 0]
    phases = {}       # ("ready" | "drained", buffer, group) -> the layers of its completed phases
    arrivals = {}     # ready's arrivals in its current phase (4 slices + finish: one)
    content = {}      # (buffer, group) -> (layer, whole)
    reads_left = {}   # (layer, group) -> reads its rows still owe to products and the store
    hidden = len(out_pads)

    def can_run(op):
        kind = op[0]
        if kind in ("wait_ready", "wait_drained"):
            name = "ready" if kind == "wait_ready" else "drained"
            return len(phases.get((name, op[1] % 2, op[2]), [])) % 2 != op[3]
        return True

    def earlier(l, g):  # the layers before l that wrote buffer l % 2's group g
        return [j for j in range(l % 2, l, 2) if out_pads[j] // GROUP > g]

    while any(pos[i] < len(actors[i]) for i in range(3)):
        live = [i for i in range(3) if pos[i] < len(actors[i]) and can_run(actors[i][pos[i]])]
        assert live, f"deadlock at {[actors[i][pos[i]] if pos[i] < len(actors[i]) else None for i in range(3)]}"
        # a slow actor now and then (the store thread, or one warpgroup),
        # so that the others run as far ahead as their waits allow
        i = rng.choices(live, [weights[j] for j in live])[0]
        op = actors[i][pos[i]]
        pos[i] += 1
        kind, l, g = op[:3]
        key = (l % 2, g)
        if kind == "wait_ready":  # layer l's rows: its phase is the latest completed
            assert phases[("ready",) + key] == earlier(l, g) + [l], op
        elif kind == "wait_drained":  # the rows' last store before layer l's epilogue
            assert phases[("drained",) + key] == earlier(l, g), op
        elif kind == "write":
            layer, _ = content.get(key, (None, True))
            if layer != l:  # the first slice: the rows' old layer must be fully read
                assert layer is None or reads_left[(layer, g)] == 0, (op, layer)
                content[key] = (l, False)
                arrivals[key] = 0
            arrivals[key] += 1
        elif kind == "ready":
            assert content[key] == (l, False) and arrivals[key] == 4
            content[key] = (l, True)
            # the next layer's products (one a group) and the store
            reads_left[(l, g)] = (out_pads[l + 1] // GROUP if l + 1 < hidden else 0) + 1
            phases.setdefault(("ready",) + key, []).append(l)
        elif kind == "read":
            assert content[key] == (l, True), (op, content.get(key))
            # a product reads a group over 8 k steps: count the group once
            if actors[i][pos[i] - 2][0] == "wait_ready":
                reads_left[(l, g)] -= 1
        elif kind == "store":
            assert content[key] == (l, True)
            reads_left[(l, g)] -= 1
        elif kind == "drained":
            phases.setdefault(("drained",) + key, []).append(l)
    for (l, g), left in reads_left.items():
        assert left == 0, (l, g, left)


@pytest.mark.parametrize("out_pads", [
    [512, 256, 512, 512],        # the flagship's trunks (latent_in (2,))
    [512, 256, 512, 256],        # latent_in (2, 4): layer 3 narrowed to 250
    [256, 256, 256, 256],
    [512, 512, 512, 512, 512, 512, 512, 512, 512],
    [128, 384, 128, 512, 256],
])
def test_order_of_work_is_safe(out_pads):
    """Every interleaving tried completes, reads whole rows only and
    overwrites no row before its products and its store have read it."""
    for seed in range(40):
        simulate(out_pads, 6, seed)


def test_flagship_epilogues_run_under_products():
    """At the flagship's widths 4 of each warpgroup's 7 epilogues run under
    a product: all but its first group of layer 0, its group of the
    256-wide layer 1 and its last group."""
    for wg in (0, 1):
        ops = consumer_ops(wg, [512, 256, 512, 512], 6)
        under = own = 0
        for i, op in enumerate(ops):
            if op[0] == "ready":
                own += ops[i - 1][0] == "write" and ops[i - 2][0] == "write"
                under += not (ops[i - 1][0] == "write" and ops[i - 2][0] == "write")
        assert (own, under) == (3, 4), (wg, own, under)


# ---- the arithmetic ---------------------------------------------------------

def emulate(e, ws, xs, bs, seed, st):
    """The kernel's arithmetic in the inputs' dtype (float32, or float64):
    (y (n_out, M), the residuals [(M, width)])."""
    dt = e.dtype
    m, ecols = e.shape
    n_layers = len(bs)
    rows = torch.arange(m)
    scene = rows // st.n_per_scene
    emb = round_to(e, BF16)
    pads = [-(-b.shape[-1] // PAD) * PAD for b in bs[:-1]]

    def pad(t, r, c):
        out = torch.zeros(r, c, dtype=dt)
        out[:t.shape[0], :t.shape[1]] = t
        return out

    a_prev, acts = None, []
    for layer in range(n_layers - 1):
        w = pads[layer]
        wp = None if ws[layer] is None else pad(round_to(ws[layer], BF16), a_prev.shape[1], w)
        xp = None if xs[layer] is None else pad(round_to(xs[layer], BF16), ecols, w)
        b = bs[layer]
        bp = pad(b, b.shape[0], w) if b.dim() == 2 else pad(b[None], 1, w)[0]
        buf = torch.zeros(m, w, dtype=dt)
        for g in range(w // GROUP):  # one group at a time, into the layer's buffer
            cols = slice(GROUP * g, GROUP * g + GROUP)
            acc = torch.zeros(m, GROUP, dtype=dt)
            if wp is not None:
                acc = a_prev @ wp[:, cols]          # W's k steps
            if xp is not None:
                acc = acc + emb @ xp[:, cols]       # then X's, in the same sum
            v = torch.relu(acc + (bp[scene][:, cols] if st.scene_bias[layer] else bp[cols]))
            if st.train and st.dropout[layer]:
                gate = dropout_gate(seed, layer, rows, w, st.keep)[:, cols]
                v = v * gate.to(dt)
            buf[:, cols] = round_to(v, BF16)
        acts.append(buf[:, :bs[layer].shape[-1]])
        a_prev = buf
    # the final rows: a thread's 32 units of a group in order, the quad's
    # four sums in pairs, the groups in order, then X's terms, the bias
    wf = pad(round_to(ws[-1], BF16), a_prev.shape[1], bs[-1].shape[-1])
    n_out = wf.shape[1]
    y = []
    for r in range(n_out):
        total = torch.zeros(m, dtype=dt)
        for g in range(a_prev.shape[1] // GROUP):
            quad = []
            for t4 in range(4):
                f = torch.zeros(m, dtype=dt)
                for i in range(16):
                    o = GROUP * g + 8 * i + 2 * t4
                    f = f + wf[o, r] * a_prev[:, o]
                    f = f + wf[o + 1, r] * a_prev[:, o + 1]
                quad.append(f)
            total = total + ((quad[0] + quad[1]) + (quad[2] + quad[3]))
        if xs[-1] is not None:
            xf = round_to(xs[-1], BF16)
            for c in range(ecols):
                total = total + xf[c, r] * emb[:, c]
        b = bs[-1][scene, r] if st.scene_bias[-1] else bs[-1][r]
        y.append(torch.tanh(total + b))
    return torch.stack(y), acts


def _jax_fwd(ws, xs, bs, e, seed, st, block):
    """JAX's bf16 scene kernel in interpret mode on one trunk's operands,
    padded to its layout: (y (n_out, M), the residuals [(M, width)])."""
    n_layers = len(bs)
    outs = [b.shape[-1] for b in bs]
    pads = [-(-o // 128) * 128 for o in outs]
    npad = lambda a, r, c: np.pad(a, ((0, r - a.shape[0]), (0, c - a.shape[1])))  # noqa: E731
    weights = [npad(xs[0], 16, pads[0])] + [npad(ws[l], pads[l - 1], pads[l])
                                            for l in range(1, n_layers)]
    inject = tuple(l > 0 and xs[l] is not None for l in range(n_layers))
    injects = [npad(xs[l], 16, pads[l]) if inject[l] else None for l in range(n_layers)]

    def table(b, width):
        if b.ndim == 2:
            return np.pad(npad(b, b.shape[0], width)[:, None, :],
                          ((0, 0), (0, 7), (0, 0))).reshape(-1, width)
        return npad(b[None], 1, width)

    static = _scene_statics(_plan_statics(n_layers, inject, tuple(st.dropout), st.keep, block,
                                          "bfloat16", st.train, True, True),
                            st.n_per_scene // block, tuple(st.scene_bias))
    (y8, _), res = _fused_scene_fwd(
        static, tuple(map(jnp.asarray, weights)),
        tuple(None if i is None else jnp.asarray(i) for i in injects),
        tuple(jnp.asarray(table(b, p)) for b, p in zip(bs, pads)),
        jnp.asarray(npad(e, e.shape[0], 16)), jnp.int32(seed))
    acts = [np.asarray(a.astype(jnp.float32))[:, :outs[l]] for l, a in enumerate(res[3])]
    return np.asarray(y8)[:outs[-1]], acts


def _residuals_close(acts, refs):
    for a, r in zip(acts, refs):
        a, r = torch.tensor(np.asarray(a, np.float32)), torch.tensor(np.asarray(r, np.float32))
        assert float((a == r).float().mean()) >= RESID_SHARE
        step = 2.0 ** -7 * torch.maximum(a.abs(), r.abs())
        assert bool(((a - r).abs() <= torch.clamp(step, min=LOOSE)).all())


def _y_close(y, ref):
    err = np.abs(np.asarray(y, np.float64) - np.asarray(ref, np.float64))
    assert float((err <= TIGHT).mean()) >= SHARE, float((err <= TIGHT).mean())
    assert float(err.max()) <= LOOSE


@pytest.mark.parametrize("nps,scenes", [(40, 3), (200, 2)])
def test_emulation_matches_the_plain_version_in_float64(nps, scenes):
    """In float64 the kernel's order of work gives the plain bf16 forward's
    residuals bit for bit and y within 1e-12."""
    _, st, e, ws, xs, bs, *_ = _trunk(nps, scenes, torch.float64)
    with torch.no_grad():
        refs = []
        y_ref, _ = train_decode_reference(e, ws, xs, bs, 7, st, acts=refs)
        y, acts = emulate(e, ws, xs, bs, 7, st)
    for a, r in zip(acts, refs):
        assert torch.equal(a, r)
    assert float((y - y_ref).abs().max()) <= 1e-12


@pytest.mark.parametrize("nps,scenes,block", [(40, 3, 8), (200, 2, 40)])
def test_emulation_matches_jax_and_the_plain_version(nps, scenes, block):
    """In float32 the kernel's order of work against JAX's bf16 scene kernel
    (interpret mode, JAX blocks of ``block`` points inside each scene) and
    the plain bf16 forward: the residuals equal at >= 99.9% of the entries
    and elsewhere within one bf16 step; y within 1e-5 at >= 99% of the
    points and 2e-3 everywhere."""
    _, st, e, ws, xs, bs, *_ = _trunk(nps, scenes)
    with torch.no_grad():
        y, acts = emulate(e, ws, xs, bs, 7, st)
        refs = []
        y_ref, _ = train_decode_reference(e, ws, xs, bs, 7, st, acts=refs)
    np_ = lambda ts: [None if t is None else t.detach().numpy() for t in ts]  # noqa: E731
    jy, jacts = _jax_fwd(np_(ws), np_(xs), np_(bs), e.numpy(), 7, st, block)
    _residuals_close(acts, jacts)
    _residuals_close(acts, refs)
    _y_close(y, jy)
    _y_close(y, y_ref)
