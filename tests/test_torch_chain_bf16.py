"""K2's bf16 backward chain (``csrc/chain_bf16_tc.cuh``), on the CPU.

- Its launch plan (``chain_bf16_plan``, the launcher's own checks and
  counts in Python) at the widths of the specs the port trains in bf16: the
  flagship, BASELINE.json's configs 1 and 2, ``--cls`` (the labelled
  DexYCB full model), the combined trunk and ``latent_in (2, 4)``: shared
  memory within the card's 232,448 bytes, 64 points a block, clusters of 2,
  the tile bytes read from L2 and the device bytes a call; and the widths it
  refuses.
- The bytes behind the chain's bound at the flagship's 64 x 2000 points:
  ~1.85 GB a step of two trunks (the residuals read and dpre16 written, 2
  bytes each, most of it), and the tile reads from L2 halved by the
  clusters.
- The kernel's db path emulated in plain torch: per block of 64 points,
  each warp's 16 points summed per scene segment, the segments joined by
  the walk into db (a scene inside the block) or the block's two partial
  slots, then the fixed-order sum of the slots; every db entry written
  exactly once.  Fed the plain bf16 backward's own unrounded dpre (both in
  float64), it gives that backward's db within 1e-6 of the largest entry
  (the same values summed in another order); in float32, JAX's
  ``fused_branch_scene`` with cdtype bfloat16 in interpret mode within
  GRAD_TOL, the port's bf16 bound against JAX
  (tests/test_torch_bf16_train.py; measured ~1e-7).  The scenes are short
  (4 to 200 points, and 2000), so that blocks straddle scene boundaries and
  warps' 16 points too, and M is not a multiple of 64.

The kernel itself is held to the plain backward on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from alignsdf_torch.config import apply_overrides, load_specs
from alignsdf_torch.kernels.train_decoder import (
    CB_SMEM,
    MAX_SMEM,
    PAD,
    chain_bf16_plan,
    pack_trunk,
    train_decode_backward_reference,
    train_decode_reference,
)
from alignsdf_torch.models.decoder import make_decoder, trunk_prefixes
from alignsdf_torch.ops.grid_plan import branch_columns
from alignsdf_torch.ops.train_plan import make_train_decoder, trunk_operands

import torch_parity
from test_torch_bf16_train import GRAD_TOL, _jax_trunk_vjp, _specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = 64        # points a block
QUARTER = 16  # a warp's points
SLOT_WARPS = 32  # the db kernel's warps


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


class _Flags:
    mano = obj_pose = True
    encode, point_size = "both", 9
    pa_feat = cls = False


def _bf16(specs, **network):
    ns = dataclasses.replace(specs.network_specs, **network) if network else specs.network_specs
    return dataclasses.replace(specs, compute_dtype="bfloat16", network_specs=ns)


def _spec(name):
    """The bf16 specs of one of the port's trained configurations."""
    base = load_specs(os.path.join(REPO, "experiments", "obman_30k.json"))
    flagship = apply_overrides(base, _Flags())
    if name == "flagship":
        return _bf16(flagship)
    if name == "config 1":
        return _bf16(base)
    if name == "config 2":
        flags = type("Mano", (), {"mano": True})
        return _bf16(apply_overrides(base, flags()))
    if name == "--cls":
        flags = type("Cls", (_Flags,), {"cls": True})
        dexycb = load_specs(os.path.join(REPO, "experiments", "dexycb_140k.json"))
        return _bf16(apply_overrides(dexycb, flags()))
    if name == "combined":
        return _bf16(dataclasses.replace(flagship, model_type="1encoder1decoder"))
    if name == "latent_in (2, 4)":
        return _bf16(flagship, latent_in=(2, 4))
    raise ValueError(name)


def _trunk_inputs(specs, scenes: int = 2):
    """Per trunk: (out_pads as pack_trunk pads them, e, statics, which
    layers read X) of a seeded decoder of ``specs`` at its widths."""
    torch.manual_seed(0)
    ns = specs.network_specs
    dec = make_decoder(specs.model_type, specs.latent_size, specs.point_feat_size,
                       specs.encode_style, ns, use_classifier=specs.classifier_branch)
    st = make_train_decoder(specs).statics
    latent = torch.zeros(scenes, specs.latent_size)
    out = []
    first, second = trunk_prefixes(dec)
    for prefix, cols in zip([first] + ([second] if second else []), branch_columns(specs)):
        with torch.no_grad():
            ws, xs, bs = trunk_operands(dec, prefix, len(cols), latent, specs, 1 if second else 2)
        out_pads = [-(-b.shape[-1] // PAD) * PAD for b in bs[:-1]] + [bs[-1].shape[-1]]
        out.append((out_pads, len(cols), st, [x is not None for x in xs]))
    return out


SPECS = ["flagship", "config 1", "config 2", "--cls", "combined", "latent_in (2, 4)"]


@pytest.mark.parametrize("name", SPECS)
def test_chain_bf16_plan_at_the_specs_widths(name):
    """The plan at each trained spec's widths over 64 scenes: the kernel
    takes them, in one 226,976-byte block of 64 points, clusters of 2 over
    ceil(M / 64) blocks, the tiles read once a cluster; the pack agrees on
    the widths."""
    specs = _spec(name)
    m = 64 * specs.samples_per_scene
    for out_pads, e, st, has_x in _trunk_inputs(specs):
        xl_w = out_pads[-2] if name == "--cls" else 0
        plan = chain_bf16_plan(out_pads, e, m, st.n_per_scene, st.scene_bias, has_x, xl_w)
        assert plan["smem_bytes"] == CB_SMEM <= MAX_SMEM
        assert (plan["points_per_block"], plan["cluster"], plan["ring_stages"]) == (P, 2, 4)
        assert plan["blocks"] == -(-m // P) and plan["grid"] % 2 == 0
        assert plan["grid"] - plan["blocks"] < 2 and plan["bulk"] == 1
        hidden = out_pads[:-1]
        assert plan["tile_bytes"] == 2 * sum(a * b for a, b in zip(hidden, hidden[1:]))
        assert plan["l2_tile_bytes"] == plan["tile_bytes"] * plan["grid"] // 2
        assert plan["db_partial_floats"] == plan["blocks"] * 2 * sum(out_pads)
        # the residuals read, dpre16 written and dx_last read are most of what
        # the call moves
        floor = 2 * m * (sum(hidden) + sum(out_pads)) + 4 * m * xl_w
        assert floor < plan["device_bytes"] < 1.05 * floor
    # the pack pads the hidden widths as the plan was given them
    e_in = torch.zeros(2 * specs.samples_per_scene, _trunk_inputs(specs)[0][1])
    torch.manual_seed(0)
    dec = make_decoder(specs.model_type, specs.latent_size, specs.point_feat_size,
                       specs.encode_style, specs.network_specs,
                       use_classifier=specs.classifier_branch)
    first, second = trunk_prefixes(dec)
    with torch.no_grad():
        ws, xs, bs = trunk_operands(dec, first, e_in.shape[1], torch.zeros(2, specs.latent_size),
                                    specs, 1 if second else 2)
    assert pack_trunk(e_in, ws, xs, bs, st).out_pads == _trunk_inputs(specs)[0][0]


def test_chain_bf16_plan_bytes_at_the_flagship():
    """The bound's bytes at the flagship's 64 x 2000 points, both trunks:
    ~1.85 GB (against ~3.68 GB of the float32-and-bf16 dpre design), 0.55
    ms at 3.35 TB/s; the tiles from L2 2.1 GB, half of one block's reads."""
    specs = _spec("flagship")
    m = 64 * specs.samples_per_scene
    plans = [chain_bf16_plan(o, e, m, st.n_per_scene, st.scene_bias, x)
             for o, e, st, x in _trunk_inputs(specs)]
    total = sum(p["device_bytes"] for p in plans)
    assert 1.84e9 < total < 1.86e9, total
    assert 0.54 < total / 3.35e12 * 1e3 < 0.56
    l2 = sum(p["l2_tile_bytes"] for p in plans)
    assert l2 == sum(p["tile_bytes"] * p["blocks"] for p in plans) // 2
    assert 2.09e9 < l2 < 2.11e9, l2


@pytest.mark.parametrize("change,match", [
    (dict(out_pads=[512, 640, 1]), "hidden widths"),
    (dict(out_pads=[512, 200, 1]), "hidden widths"),
    (dict(out_pads=[512, 256, 3]), "outputs"),
    (dict(out_pads=[512] * 10 + [1]), "layers"),
    (dict(e=65), "embedding columns"),
    (dict(e=0), "embedding columns"),
    (dict(m=4002), "multiple of 4"),
    (dict(m=4000, n_per_scene=3000), "multiple of 4 and of n_per_scene"),
    (dict(xl_w=300), "dx_last"),
])
def test_chain_bf16_plan_refuses(change, match):
    """Widths and shapes the kernel cannot take raise; it never falls back."""
    args = dict(out_pads=[512, 256, 1], e=6, m=4000, n_per_scene=2000, xl_w=0)
    args.update(change)
    n = len(args["out_pads"])
    with pytest.raises(ValueError, match=match):
        chain_bf16_plan(args["out_pads"], args["e"], args["m"], args["n_per_scene"],
                        [False] * n, [True] + [False] * (n - 1), args["xl_w"])


def chain_db(dpre: torch.Tensor, seg: int):
    """The kernel's db path over dpre (M, out), unrounded, for segments of
    ``seg`` points (n_per_scene, or M for a global bias): (db (M / seg,
    out), how many times each entry was written).  Per block of 64 points
    (``cb_db_group``): each quarter of 16 points sums each scene segment it
    holds, its first into qh, its last into qt, a scene wholly inside it
    straight into db; the walk (``cb_db_walk``) joins the quarters'
    segments, storing a scene wholly inside the block into db and the
    block's first segment into partial slot 0, its last (where another)
    into slot 1; then ``train_bwd_chain_bf16_db_kernel``: for each scene
    over more than one block, warp w sums the slots of blocks w, w + 32, ...
    in order, then the warps' sums in warp order."""
    m, out = dpre.shape
    zeros = lambda *shape: torch.zeros(*shape, dtype=dpre.dtype)  # noqa: E731
    db = zeros(m // seg, out)
    writes = torch.zeros(m // seg, dtype=torch.int64)
    blocks = -(-m // P)
    part = torch.full((blocks, 2, out), float("nan"), dtype=dpre.dtype)

    def store(sc, v):
        db[sc] = v
        writes[sc] += 1

    for b in range(blocks):
        first, last = b * P, min(b * P + P - 1, m - 1)
        qh, qt = {}, {}
        for qd in range(P // QUARTER):
            qs = first + QUARTER * qd
            if qs >= m:
                break
            pts = torch.arange(qs, qs + QUARTER)
            scene = pts.clamp(max=m - 1) // seg
            vals = zeros(QUARTER, out)
            vals[pts < m] = dpre[pts[pts < m]]
            s_lo, s_hi = qs // seg, min(qs + QUARTER - 1, m - 1) // seg
            for sc in range(s_lo, s_hi + 1):
                v = vals[scene == sc].sum(0)
                if sc == s_lo:
                    qh[qd] = v
                elif sc == s_hi:
                    qt[qd] = v
                else:
                    store(sc, v)

        def emit(sc, v):
            start, end = sc * seg, min(sc * seg + seg, m) - 1
            if start >= first and end <= last:
                store(sc, v)
            else:
                part[b, 0 if sc == first // seg else 1] = v

        cs, cur = first // seg, zeros(out)
        for qd in range(P // QUARTER):
            qs = first + QUARTER * qd
            if qs > last:
                break
            s0, s1 = qs // seg, min(qs + QUARTER - 1, last) // seg
            if s0 != cs:
                emit(cs, cur)
                cur, cs = zeros(out), s0
            cur = cur + qh[qd]
            if s1 != s0:
                emit(cs, cur)
                cur, cs = qt[qd], s1
        emit(cs, cur)
    for sc in range(m // seg):
        start, end = sc * seg, min(sc * seg + seg, m) - 1
        b0, b1 = start // P, end // P
        if b0 == b1:
            continue
        warps = []
        for w in range(SLOT_WARPS):
            acc = zeros(out)
            for b in range(b0 + w, b1 + 1, SLOT_WARPS):
                acc = acc + part[b, 0 if sc == b * P // seg else 1]
            warps.append(acc)
        total = zeros(out)
        for acc in warps:
            total = total + acc
        store(sc, total)
    return db, writes


def _trunk(nps: int, scenes: int, dtype=torch.float32):
    """A narrow bf16 trunk's operands (JAX's bf16 test's specs) on scenes x
    nps points in ``dtype`` (the arithmetic of the plain versions; bf16
    roundings either way), its plain forward's residuals and seeded dy:
    (specs, statics, e, ws, xs, bs, y, acts, dy)."""
    _, specs = _specs("1encoder2decoder")
    specs = dataclasses.replace(specs, samples_per_scene=nps)
    torch.manual_seed(0)
    dec = make_decoder(specs.model_type, specs.latent_size, 9, "both", specs.network_specs)
    st = make_train_decoder(specs).statics
    rng = np.random.RandomState(3)
    latent = torch.from_numpy((rng.randn(scenes, specs.latent_size) * 0.5).astype(np.float32))
    emb = torch.from_numpy((rng.randn(scenes * nps, 9) * 0.5).astype(np.float32))
    first, second = trunk_prefixes(dec)
    cols = branch_columns(specs)[0]
    with torch.no_grad():
        ws, xs, bs = trunk_operands(dec, first, len(cols), latent, specs, 1 if second else 2)
        ws, xs, bs = ([None if t is None else t.to(dtype) for t in ts] for ts in (ws, xs, bs))
        e = emb[:, list(cols)].contiguous().to(dtype)
        acts = []
        y, _ = train_decode_reference(e, ws, xs, bs, 7, st, acts=acts)
    dy = torch.from_numpy(rng.randn(*y.shape)).to(dtype)
    return specs, st, e, ws, xs, bs, y, acts, dy


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max()) / (float(np.abs(want).max())
                                                                     + 1e-30)
    assert err <= tol, err
    return err


# (points a scene, scenes): whole blocks, blocks across scene boundaries,
# scenes shorter than a block and than a warp's 16 points, M % 64 != 0
DB_CASES = [(2000, 2), (36, 5), (20, 7), (100, 3), (8, 9), (4, 7), (200, 2)]


@pytest.mark.parametrize("nps,scenes", DB_CASES)
def test_chain_db_emulation_matches_the_plain_backward(nps, scenes):
    """The kernel's db path, fed the plain bf16 backward's own dpre, gives
    its db within 1e-6 of the largest entry, each entry written once, on
    every layer (scene-bias and global).  Both in float64: the path is
    checked, not float32's rounding, which over a global bias's thousands
    of cancelling terms errs by a few 1e-6 of the sum in either order."""
    _, st, e, ws, xs, bs, y, acts, dy = _trunk(nps, scenes, torch.float64)
    dpres = []
    with torch.no_grad():
        _, _, _, dbs = train_decode_backward_reference(e, ws, xs, bs, st, y, acts, dy,
                                                       dpres=dpres)
    m = e.shape[0]
    for layer, dpre in zip(range(len(bs) - 1, -1, -1), dpres):
        seg = nps if st.scene_bias[layer] else m
        db, writes = chain_db(dpre, seg)
        assert bool((writes == 1).all()), (layer, writes)
        want = dbs[layer] if st.scene_bias[layer] else dbs[layer][None]
        _close(db, want, 1e-6)


@pytest.mark.parametrize("nps,scenes,block", [(40, 3, 8), (200, 2, 40)])
def test_chain_db_emulation_matches_jax(nps, scenes, block):
    """The same db path against JAX's bf16 scene kernel (``fused_branch_scene``
    in interpret mode, JAX blocks of ``block`` points inside each scene),
    on scenes of 40 and 200 points: within GRAD_TOL of the largest entry
    (measured ~1e-7), every layer."""
    _, st, e, ws, xs, bs, y, acts, dy = _trunk(nps, scenes)
    dpres = []
    with torch.no_grad():
        train_decode_backward_reference(e, ws, xs, bs, st, y, acts, dy, dpres=dpres)
    np_ = lambda ts: [None if t is None else t.detach().numpy() for t in ts]  # noqa: E731
    _, xl, (_, _, _, jdbs) = _jax_trunk_vjp(np_(ws), np_(xs), np_(bs), e.numpy(), 7, st,
                                            dy.numpy(), np.zeros((e.shape[0], 1), np.float32),
                                            block=block)
    m = e.shape[0]
    for layer, dpre in zip(range(len(bs) - 1, -1, -1), dpres):
        db, _ = chain_db(dpre, nps if st.scene_bias[layer] else m)
        _close(db if st.scene_bias[layer] else db[0], jdbs[layer], GRAD_TOL)
