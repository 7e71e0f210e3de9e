"""K4's band and ``cli.train --pixel_band`` in the port against the JAX
package, on the CPU: the host row sort (``data/pixel_sort.py``) bit for bit
against JAX's; the port's banded decode, presorted and sorting on the
device, with dropout on, against JAX's banded pixel train kernel in
interpret mode, forward and gradients; the plain version of the banded tap
stage's bounds (``tile_band_bounds``) against a numpy recomputation, and
the band's refusals; a 3-step ``--pixel_band`` trajectory against JAX's
step with ``band`` / ``presorted=True`` on the sorted batch across the
AdditionalLossStart gate (``point_is_hand`` masks); and the CLI's wiring:
``--pixel_band --smoke``, and a pack whose native batches come out of the
loader sorted, in thread and in forked workers (the repair of the JAX
loader, whose native pack path skips the sort).

Geometry of JAX's ``tests/test_decoder_train_pixel.py:221-446``: 2 scenes x
96 points, a 16 x 16 map (64-pixel images), JAX's block cap 48 (two blocks a
scene), bands of 8 and 12, a tight cluster with a few far points and a wide
spread.
"""

import copy
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.data.pixel_sort import pixel_row_order as jax_row_order
from alignsdf_tpu.data.pixel_sort import pixel_row_sort_batch as jax_sort_batch
from alignsdf_tpu.models.decoder import make_decoder as jax_make_decoder
from alignsdf_tpu.ops.decoder_train_pixel import make_fused_train_decoder_pixel
from alignsdf_tpu.training import train_state as jax_train_state
from alignsdf_tpu.training import train_step as jax_train_step
from alignsdf_torch.cli import train as train_cli
from alignsdf_torch.config import NetworkSpecs, Specs, load_specs
from alignsdf_torch.convert import decoder_from_jax, from_jax
from alignsdf_torch.data.pixel_sort import pixel_row_order, pixel_row_sort_batch
from alignsdf_torch.data.synthetic import synthetic_train_batch, write_synthetic_dataset
from alignsdf_torch.kernels.pixel_train_decoder import (
    band_rows_max,
    check_band,
    pixel_train_decode_backward,
    sample_latent,
    tile_band_bounds,
)
from alignsdf_torch.kernels.train_decoder import dropout_gate
from alignsdf_torch.models.decoder import make_decoder
from alignsdf_torch.ops.geometry import pixel_coords
from alignsdf_torch.ops.pixel_train_plan import (
    default_band,
    make_pixel_train_decoder,
    pixel_train_inputs,
    pixel_trunks,
    sort_by_row,
)
from alignsdf_torch.training.train_state import TrainState, make_optimizer
from alignsdf_torch.training.train_step import batch_to_device, make_train_step

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import pack_dataset_torch  # noqa: E402

B, N, HF, WF, LS, PFS = 2, 96, 16, 16, 32, 9
IMAGE = 64.0
NS = dict(dims=(96, 96, 96, 96), dropout=(0, 1, 2, 3), dropout_prob=0.2,
          norm_layers=(0, 1, 2, 3), latent_in=(2,))
SPEC = dict(model_type="1encoder2decoder", encode_style="both", point_feat_size=PFS,
            latent_size=LS, pixel_align=True, samples_per_scene=N, sdf_scale_factor=7.0186,
            image_size=(64, 64), classifier_branch=True)
ROOT = np.asarray([0.02, -0.01, 0.55], np.float32)
BLOCK_CAP = 48  # JAX's blocks of 48: two a scene, so its banded decode sorts
SEED = 11       # the dropout seed of the decode tests (train=True)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _cam():
    cam = np.zeros((B, 3, 4), np.float32)
    cam[:, 0, 0] = cam[:, 1, 1] = 80.0
    cam[:, 0, 2] = cam[:, 1, 2] = 32.0
    cam[:, 2, 2] = 1.0
    return cam


def _xyz(rng, geometry: str) -> np.ndarray:
    """A tight cluster with every 17th point thrown far out (the mean
    fallback runs in the banded path), or a wide spread (blocks overflow
    the band)."""
    if geometry == "tight":
        xyz = rng.randn(B * N, 3).astype(np.float32) * 0.1
        xyz[::17] *= 40.0
        return xyz
    return rng.randn(B * N, 3).astype(np.float32) * 1.5


def _loader_batch(xyz, seed=0):
    """A train batch's per-point and per-scene columns around ``xyz``: the
    SDF targets and labels are distinct so that each follows its point."""
    rng = np.random.RandomState(seed)
    root = np.tile(ROOT, (B, 1)) + rng.randn(B, 3).astype(np.float32) * 0.01
    return {"xyz": xyz, "sdf_gt_hand": rng.randn(B * N, 1).astype(np.float32),
            "sdf_gt_obj": rng.randn(B * N, 1).astype(np.float32),
            "labels": np.arange(B * N, dtype=np.int32), "cam_intr": _cam(),
            "mano_root": root.astype(np.float32),
            "image": np.zeros((B, 8, 8, 3), np.uint8)}


# ---------------------------------------------------------------------------
# the host sort
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", ["tight", "wide"])
def test_row_sort_matches_jax_bit_for_bit(geometry):
    """pixel_row_order and pixel_row_sort_batch equal JAX's on every column
    and on point_is_hand, at the 16-row map and at the flagship's 64 rows;
    points within the 4-pixel margin sort by their clamped row."""
    rng = np.random.RandomState(3)
    xyz = _xyz(rng, geometry)
    batch = _loader_batch(xyz)
    cam, root = batch["cam_intr"], batch["mano_root"]
    for rows in (HF, 64):
        for s in range(B):
            pts = xyz[s * N:(s + 1) * N]
            port = pixel_row_order(pts, cam[s], root[s], IMAGE, SPEC["sdf_scale_factor"], rows)
            ref = jax_row_order(pts, cam[s], root[s], IMAGE, SPEC["sdf_scale_factor"], rows)
            assert port.dtype == ref.dtype and np.array_equal(port, ref)
        port = pixel_row_sort_batch(batch, IMAGE, SPEC["sdf_scale_factor"], rows)
        ref = jax_sort_batch(batch, IMAGE, SPEC["sdf_scale_factor"], rows)
        assert set(port) == set(ref) == set(batch) | {"point_is_hand"}
        for k in ref:
            assert port[k].dtype == ref[k].dtype and np.array_equal(port[k], ref[k]), k
        assert not np.array_equal(port["labels"], batch["labels"])  # the sort moved points
        # each point's columns travel with it; a scene's points stay in it
        lab = port["labels"]
        assert np.array_equal(port["xyz"], xyz[lab])
        assert np.array_equal(port["sdf_gt_obj"], batch["sdf_gt_obj"][lab])
        assert np.array_equal(port["point_is_hand"], (lab % N < N // 2).astype(np.float32))
        assert all(set(lab[s * N:(s + 1) * N]) == set(range(s * N, (s + 1) * N))
                   for s in range(B))


def test_margin_points_sort_by_clamped_row():
    """A point just outside the image (within 4 pixels) sorts at the clamped
    first or last row, one past the margin goes to the end."""
    cam = _cam()[0]
    # image coordinates (x, y) at depth 0.6, back to decoder-frame points
    xy = np.asarray([[30.0, -3.0], [30.0, 20.0], [30.0, -5.0], [30.0, 66.0], [30.0, 40.0]])
    z = 0.6
    cam_pts = np.stack([(xy[:, 0] - 32.0) * z / 80.0, (xy[:, 1] - 32.0) * z / 80.0,
                        np.full(len(xy), z)], axis=1)
    xyz = ((cam_pts - ROOT) * SPEC["sdf_scale_factor"] / 2.0).astype(np.float32)
    order = pixel_row_order(xyz, cam, ROOT, IMAGE, SPEC["sdf_scale_factor"], HF)
    assert list(order) == [0, 1, 4, 3, 2]
    assert np.array_equal(order, jax_row_order(xyz, cam, ROOT, IMAGE,
                                               SPEC["sdf_scale_factor"], HF))


# ---------------------------------------------------------------------------
# the banded decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**NS), **SPEC)
    pspecs = Specs(network_specs=NetworkSpecs(**NS), **SPEC)
    jdec = jax_make_decoder(SPEC["model_type"], LS, PFS, "both", jspecs.network_specs, True)
    params = jax.tree_util.tree_map(
        np.asarray, jdec.init(jax.random.PRNGKey(0), jnp.zeros((8, LS + PFS)))["params"])
    pdec = make_decoder(SPEC["model_type"], LS, PFS, "both", pspecs.network_specs,
                        use_classifier=True)
    pdec.load_state_dict(decoder_from_jax(params))
    return params, pdec, jspecs, pspecs


def _decode_data(geometry: str, presorted: bool):
    """(fmap NHWC, emb, xyz, cam, root (B, 1, 3), labels); the presorted
    case's points in the host's row order."""
    rng = np.random.RandomState(1)
    fmap = (rng.randn(B, HF, WF, LS) * 0.5).astype(np.float32)
    emb = (rng.randn(B * N, PFS) * 0.5).astype(np.float32)
    xyz = _xyz(rng, geometry)
    labels = rng.randint(-1, 6, B * N)
    root = np.tile(ROOT, (B, 1, 1))
    if presorted:
        batch = {"xyz": xyz, "cam_intr": _cam(), "mano_root": root[:, 0]}
        xyz = pixel_row_sort_batch(batch, IMAGE, SPEC["sdf_scale_factor"], HF)["xyz"]
    return fmap, emb, xyz, _cam(), root, labels


def _relu_margin(pdec, specs, data, decode) -> float:
    """The smallest |pre-activation| of any hidden unit of either trunk in
    float64, on the order and gates K4 sees.  Where one lies within float32
    rounding of zero, JAX's kernel and the port may put it on either side
    of ReLU and that row's gradients differ by up to ~1e-3 of the largest."""
    fmap, emb, xyz, cam, root, _ = (torch.from_numpy(np.asarray(a)) for a in data)
    table, mean, xp, yp, mask = (t.double() for t in pixel_train_inputs(
        fmap.permute(0, 3, 1, 2), xyz, cam, root, specs))
    emb = emb.double()
    if decode.sorts:
        perm, _ = sort_by_row(yp, mask, B)
        xp, yp, mask, emb = xp[perm], yp[perm], mask[perm], emb[perm]
    st = decode.statics._replace(feat_hw=(HF, WF))
    lat = sample_latent(table, mean, xp, yp, mask, st)
    rows = torch.arange(B * N)
    margin = float("inf")
    with torch.no_grad():
        trunks = pixel_trunks(copy.deepcopy(pdec).double(), specs, LS)
        for (ws, lats, xs, bs), off in zip(trunks, st.layer_offsets):
            x = None
            for layer in range(len(bs) - 1):
                acc = bs[layer]
                if ws[layer] is not None:
                    acc = acc + x @ ws[layer]
                if lats[layer] is not None:
                    acc = acc + lat @ lats[layer] + emb @ xs[layer]
                margin = min(margin, float(acc.abs().min()))
                x = torch.relu(acc) * dropout_gate(SEED, layer + off, rows, acc.shape[1],
                                                   st.keep).double()
    return margin


def _ce_jax(logits, labels):
    valid = labels >= 0
    lp = jax.nn.log_softmax(logits, axis=-1)[jnp.arange(len(labels)), jnp.maximum(labels, 0)]
    return -jnp.sum(jnp.where(valid, lp, 0.0)) / jnp.sum(valid)


def _ce_port(logits, labels):
    valid = labels >= 0
    lp = torch.log_softmax(logits, dim=-1)[torch.arange(len(labels)), labels.clamp(min=0)]
    return -torch.sum(torch.where(valid, lp, torch.zeros_like(lp))) / valid.sum()


@functools.lru_cache(maxsize=None)
def _jax_loss_and_grads(band: int, presorted: bool):
    """JAX's banded decode under the tests' loss, jitted once a band and
    mode: (loss, (h, o, logits)) and the gradients of the parameters, the
    map, the embedding and the root."""
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**NS), **SPEC)
    fused = make_fused_train_decoder_pixel(jspecs, interpret=True, block_cap=BLOCK_CAP,
                                           band=band, presorted=presorted)
    assert fused.block == BLOCK_CAP

    def loss(p, fm, e, r, xyz, cam, labels):
        h, o, c = fused(p, fm, e, xyz, cam, r, jnp.int32(SEED), train=True)
        return (jnp.sum(jnp.sin(h)) + jnp.sum(o ** 2) + 50.0 * _ce_jax(c, labels), (h, o, c))

    return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))


@pytest.mark.parametrize("presorted,geometry,band", [(False, "tight", 8), (False, "wide", 8),
                                                     (True, "tight", 12)])
def test_banded_decode_matches_jax(pair, presorted, geometry, band):
    """The port's decode with a band, presorted or sorting each scene on the
    device (the dropout gate then falls on the sorted positions, and y and
    x_last go back to the batch's order), against JAX's banded decode in
    interpret mode with dropout on: y and the logits to 2e-6 abs, every
    weight-norm parameter's and bias's gradient, the classifier head's, the
    map's, the embedding's and the predicted root's to 2e-5 of the largest
    entry of each, under an SDF + cross-entropy loss (dx_last live)."""
    params, pdec, jspecs, pspecs = pair
    data = _decode_data(geometry, presorted)
    decode = make_pixel_train_decoder(pspecs, band=band, presorted=presorted,
                                      block_cap=BLOCK_CAP)
    assert decode.band == band and decode.sorts == (not presorted)
    assert _relu_margin(pdec, pspecs, data, decode) > 2e-7
    fmap, emb, xyz, cam, root, labels = data
    (_, (h1, o1, c1)), (gp, gf, ge, gr) = _jax_loss_and_grads(band, presorted)(
        jax.tree_util.tree_map(jnp.asarray, params), *map(jnp.asarray, (fmap, emb, root, xyz,
                                                                        cam, labels)))

    fmap_t = torch.from_numpy(fmap).permute(0, 3, 1, 2).contiguous().requires_grad_()
    emb_t = torch.from_numpy(emb).requires_grad_()
    root_t = torch.from_numpy(root).requires_grad_()
    pdec.zero_grad()
    h, o, c = decode(pdec, fmap_t, emb_t, torch.from_numpy(xyz), torch.from_numpy(cam), root_t,
                     SEED, True)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h1), atol=2e-6, rtol=0)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o1), atol=2e-6, rtol=0)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(c1), atol=2e-6, rtol=0)
    (torch.sum(torch.sin(h)) + torch.sum(o ** 2)
     + 50.0 * _ce_port(c, torch.from_numpy(labels))).backward()

    def close(port, ref):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max()) + 1e-8
        np.testing.assert_allclose(port / scale, ref / scale, atol=2e-5, rtol=0)

    close(fmap_t.grad.numpy(), np.asarray(gf).transpose(0, 3, 1, 2))
    close(emb_t.grad.numpy(), ge)
    close(root_t.grad.numpy(), gr)
    assert float(np.abs(np.asarray(gr)).max()) > 1e-6
    count = 0
    for trunk in gp.values():
        for name, g in trunk.items():
            layer = getattr(pdec, name)
            if "v" in g:
                close(layer.weight_v.grad.numpy().T, g["v"])
                close(layer.weight_g.grad.numpy().reshape(-1), g["g"])
            else:
                close(layer.weight.grad.numpy().T, g["kernel"])
            close(layer.bias.grad.numpy(), g["bias"])
            count += 1
    assert count == 5 * len(gp) + 1


def test_device_sort_moves_the_gate(pair):
    """Sorting on the device is what JAX's does, not a no-op: the same
    points decoded unbanded (batch order) and banded (sorted positions)
    draw different dropout gates, so their y differ, as JAX's do."""
    params, pdec, jspecs, pspecs = pair
    fmap, emb, xyz, cam, root, _ = _decode_data("tight", False)
    args = [torch.from_numpy(a) for a in (fmap, emb, xyz, cam, root)]
    args[0] = args[0].permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        banded = make_pixel_train_decoder(pspecs, band=8, block_cap=BLOCK_CAP)(
            pdec, *args, SEED, True)[0]
        plain = make_pixel_train_decoder(pspecs)(pdec, *args, SEED, True)[0]
        # without dropout the sort changes nothing
        still = make_pixel_train_decoder(pspecs, band=8, block_cap=BLOCK_CAP)(
            pdec, *args, SEED, False)[0]
        still_ref = make_pixel_train_decoder(pspecs)(pdec, *args, SEED, False)[0]
    assert float((banded - plain).abs().max()) > 1e-3
    np.testing.assert_allclose(still.numpy(), still_ref.numpy(), atol=1e-6, rtol=0)


def test_sort_only_where_jax_sorts():
    """The block rule (JAX's _scene_block, cap 400 under a band): at 2000
    points a scene the decode sorts; at 96 with the default cap (one block
    of 96) it does not and K4 runs unbanded; presorted never sorts and
    keeps the band; band is an explicit int."""
    flag = Specs(network_specs=NetworkSpecs(), **dict(SPEC, samples_per_scene=2000))
    assert make_pixel_train_decoder(flag, band=32).sorts
    assert make_pixel_train_decoder(flag, band=32).band == 32
    small = Specs(network_specs=NetworkSpecs(**NS), **SPEC)
    d = make_pixel_train_decoder(small, band=8)
    assert not d.sorts and d.band is None
    d = make_pixel_train_decoder(small, band=8, presorted=True)
    assert not d.sorts and d.band == 8 and d.presorted
    assert make_pixel_train_decoder(small).band is None
    for bad in ("auto", 0, 8.0, True):
        with pytest.raises(ValueError):
            make_pixel_train_decoder(small, band=bad)


# ---------------------------------------------------------------------------
# the tap stage's bounds and refusals
# ---------------------------------------------------------------------------

def _bounds_numpy(yp, mask, nps, hf, band):
    """[(tile, scene, r0, fits, live)] per scene segment of each 64-point
    tile, recomputed point by point."""
    out = []
    m = len(yp)
    for first in range(0, m, 64):
        rows = np.arange(first, min(first + 64, m))
        for scene in np.unique(rows // nps):
            seg = rows[rows // nps == scene]
            ys = [int(np.floor(yp[r])) for r in seg if mask[r] > 0]
            if not ys:
                out.append((first // 64, scene, 0, False, False))
                continue
            r0 = min(max(min(ys) - 1, 0), hf - band)
            out.append((first // 64, scene, r0, min(max(ys) + 2, hf - 1) < r0 + band, True))
    return out


@pytest.mark.parametrize("geometry", ["tight", "wide"])
def test_tile_band_bounds_match_numpy(geometry):
    """tile_band_bounds on the sorted projection against a numpy
    recomputation, scene segments of the 64-point tiles that straddle the
    96-point scenes included: every live segment of the tight cluster's
    sorted tiles fits, none of the wide spread's."""
    rng = np.random.RandomState(1)
    xyz = torch.from_numpy(_xyz(rng, geometry))
    _, yp, mask = pixel_coords(xyz, torch.from_numpy(_cam()),
                               torch.from_numpy(np.tile(ROOT, (B, 1, 1))), 64,
                               SPEC["sdf_scale_factor"], HF, WF)
    perm, _ = sort_by_row(yp.reshape(-1), mask.reshape(-1), B)
    yp, mask = yp.reshape(-1)[perm], mask.reshape(-1)[perm]
    band = 8
    got = list(zip(*(t.tolist() for t in tile_band_bounds(yp, mask, N, HF, band))))
    ref = _bounds_numpy(yp.numpy(), mask.numpy(), N, HF, band)
    assert got == [tuple(int(v) if not isinstance(v, (bool, np.bool_)) else bool(v)
                         for v in r) for r in ref]
    assert len(got) == 4  # tile 1 holds both scenes
    live = [r for r in got if r[4]]
    share = sum(r[3] for r in live) / len(live)
    assert share == (1.0 if geometry == "tight" else 0.0), share


def test_band_refusals():
    """A band the tap stage's window cannot hold raises with the largest it
    can (32 rows of the flagship's 64 x 64 map at 256 channels); so does a
    band beyond the map's rows; both on the CPU too, and no launch."""
    flag = Specs(network_specs=NetworkSpecs(), **dict(SPEC, latent_size=256,
                                                      image_size=(256, 256)))
    assert band_rows_max(64, 256) == 32 == default_band(flag)
    st = make_pixel_train_decoder(flag).statics._replace(feat_hw=(64, 64))
    check_band(st._replace(band=32), 256)
    with pytest.raises(ValueError, match="at most 32 rows"):
        check_band(st._replace(band=33), 256)
    with pytest.raises(ValueError, match="1 to the map's 16 rows"):
        check_band(st._replace(feat_hw=(16, 16), band=17), 32)
    assert default_band(Specs(network_specs=NetworkSpecs(**NS), **SPEC)) == HF // 2
    assert pixel_train_decode_backward.band_launches == 0


# ---------------------------------------------------------------------------
# the --pixel_band train step
# ---------------------------------------------------------------------------

# the pixel flagship at 64x64 images (a 16 x 16 map), 2 scenes x 128 points;
# LR interval 2 and AdditionalLossStart 3 so epochs 1, 2, 3 cross both
TRAJ_SPECS = dict(torch_parity.PIXEL_NARROW, ImageSize=[64, 64], SamplesPerScene=128,
                  ScenesPerBatch=2, AdditionalLossStart=3, PenetrationLoss=True,
                  ContactLoss=True, HandSdfWeight=0.5, ObjSdfWeight=0.5, JointWeight=0.5,
                  LearningRateSchedule=[{"Type": "Step", "Initial": 1e-4, "Interval": 2,
                                         "Factor": 0.5}])


def _traj_batch(specs, seed):
    """A synthetic batch, its camera scaled to the 64-pixel image, sorted as
    --pixel_band's loader sorts it (the CLI's row_sorter)."""
    batch = synthetic_train_batch(specs, batch_size=2, seed=seed)
    batch["cam_intr"][:, :2, :] *= specs.image_size[0] / 256.0
    return train_cli.row_sorter(specs)(batch)


@pytest.fixture(scope="module")
def trajectories():
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair(TRAJ_SPECS)
    for trunk, name in (("hand", "linh4"), ("obj", "lino4")):
        bias = variables["params"]["decoder"][trunk][name]["bias"]
        variables["params"]["decoder"][trunk][name]["bias"] = np.zeros_like(bias)
        getattr(pmodel.decoder, name).bias.data.zero_()
    band = default_band(pspecs)
    # JAX's CLI gives band "auto" = 8 here, but at 128 points its cap of 400
    # leaves one block a scene, which turns the band off; blocks of 64 keep it
    override = make_fused_train_decoder_pixel(jspecs, interpret=True, band=band,
                                              presorted=True, block_cap=64)
    jstep = jax.jit(jax_train_step.make_train_step(
        jmodel, jspecs, jax_train_state.make_optimizer(jspecs), override))
    jstate = jax_train_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        consts=variables.get("consts", {}),
        opt_state=jax_train_state.make_optimizer(jspecs).init(variables["params"]),
        epoch=jnp.asarray(1, jnp.int32))
    decode = make_pixel_train_decoder(pspecs, band=band, presorted=True)
    pstate = TrainState(pmodel, make_optimizer(pspecs, pmodel.parameters()))
    pstep = make_train_step(pspecs, decode)
    init = from_jax(variables["params"], variables["batch_stats"], pspecs)
    j_losses, p_losses, batches = [], [], []
    for i in range(3):
        batch = _traj_batch(pspecs, i)
        batches.append(batch)
        key = jax.random.PRNGKey(i)
        seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
        jstate = jstate.replace(epoch=jnp.asarray(i + 1, jnp.int32))
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        pstate.epoch = i + 1
        pl = pstep(pstate, batch_to_device(batch, "cpu"), seed)
        j_losses.append({k: float(v) for k, v in jl.items()})
        p_losses.append({k: float(v) for k, v in pl.items()})
    ref = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats), pspecs)
    return j_losses, p_losses, ref, pmodel, init, batches, band, pstep


def test_pixel_band_trajectory_matches_jax(trajectories):
    """Three --pixel_band steps (K4 with the default band of 8 on host-sorted
    points; the masks from point_is_hand) against JAX's step with band 8 and
    presorted on the same sorted batches: each loss term to 1e-4 relative
    or 1e-6 absolute, the gate opening at epoch 3; parameters to 1e-3 and
    running statistics to 1e-4, each tensor's update within 10% of JAX's in
    norm (as tests/test_torch_pixel_train.py holds the unbanded step)."""
    j_losses, p_losses, ref, pmodel, init, batches, band, pstep = trajectories
    assert band == 8 and pstep.decode.band == 8 and pstep.decode.presorted
    positional = np.tile(np.repeat([1.0, 0.0], 64), 2)
    assert all(not np.array_equal(b["point_is_hand"], positional) for b in batches)
    for jl, pl in zip(j_losses, p_losses):
        assert set(jl) == set(pl)
        for k in jl:
            np.testing.assert_allclose(pl[k], jl[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert p_losses[1]["contact"] == 0 and p_losses[2]["contact"] > 0
    state = pmodel.state_dict()
    for k, v in ref.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=k)
            continue
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), atol=1e-3, rtol=0, err_msg=k)
        d_jax, d_port = v - init[k], state[k] - init[k]
        assert float((d_port - d_jax).norm()) <= 0.1 * float(d_jax.norm()), k


# ---------------------------------------------------------------------------
# the CLI and the loader
# ---------------------------------------------------------------------------

PACK_HW = 96
PACK_KEYS = [f"{i:08d}" for i in range(6)]
PACK_SPEC = dict(torch_parity.PIXEL_NARROW, ImageSize=[PACK_HW, PACK_HW], SamplesPerScene=128,
                 ScenesPerBatch=3, DataLoaderThreads=2, TrainSplit="", LogFrequency=1,
                 LogFrequencyStep=1, NumEpochs=1, Dataset="obman", LMDB=False,
                 NetworkSpecs=dict(torch_parity.PIXEL_NARROW["NetworkSpecs"],
                                   dims=[288, 288], dropout=[0, 1], norm_layers=[0, 1],
                                   latent_in=[1]))


def test_cli_pixel_band_smoke(tmp_path, capsys, monkeypatch):
    """--pa_feat --pixel_band --smoke: K4 with the default band on presorted
    points, the smoke batch sorted by the host sort; --pixel_band on a spec
    that is not pixel-aligned is logged and ignored."""
    sorted_batches = []
    real = train_cli.pixel_row_sort_batch
    monkeypatch.setattr(train_cli, "pixel_row_sort_batch",
                        lambda *a, **k: sorted_batches.append(1) or real(*a, **k))
    spec = dict(PACK_SPEC, ImageSize=[64, 64], ScenesPerBatch=2)
    path = str(tmp_path / "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    train_cli.main(["-e", path, "--pixel_band", "--smoke", "--device", "cpu"])
    text = capsys.readouterr().err  # the CLI's log (logging.basicConfig on stderr)
    assert "pixel-aligned (K4) with a band of 8 rows on host-sorted points" in text
    assert "smoke OK" in text and sorted_batches == [1]
    flat = dict(spec, PixelAlign=False, LatentSize=16,
                NetworkSpecs=dict(spec["NetworkSpecs"], dims=[32, 32]))
    with open(path, "w") as f:
        json.dump(flat, f)
    train_cli.main(["-e", path, "--pixel_band", "--smoke", "--device", "cpu"])
    text = capsys.readouterr().err
    assert "not pixel-aligned (no --pa_feat); ignored" in text
    assert "scene-factored (K2)" in text and sorted_batches == [1]


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    root = tmp_path_factory.mktemp("band_pack")
    base = write_synthetic_dataset(str(root), PACK_KEYS, n_points=800, image_hw=PACK_HW)
    path = str(root / "scenes.pack")
    pack_dataset_torch.pack(base, path, PACK_KEYS, "obman")
    spec = str(root / "spec.json")
    with open(spec, "w") as f:
        json.dump(PACK_SPEC, f)
    return path, spec


def test_pack_native_batches_come_out_sorted(pack):
    """The repair of JAX's loader: with --pixel_band a pack's native batches
    (the loader's default path for a pack) are sorted in the workers, equal
    to the host sort of the unsorted native batch on every column, with
    point_is_hand."""
    path, spec = pack
    specs = load_specs(spec)
    plain = train_cli.make_loader(specs, None, path)
    banded = train_cli.make_loader(specs, None, path, pixel_band=True)
    assert banded.native_batches
    assert banded.dataset.build_batch([0, 1, 2], [1, 2, 3]) is not None  # the native path
    sort = train_cli.row_sorter(specs)
    count = 0
    for loader in (plain, banded):
        loader.set_epoch(1)
    for raw, got in zip(plain, banded):
        assert "point_is_hand" not in raw
        want = sort(raw)
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), k
        count += 1
    assert count == len(PACK_KEYS) // 3


def test_pack_forked_workers_sort_too(pack, tmp_path):
    """Forked loader workers sort the native batches as threads do (run in
    a fresh interpreter without JAX, whose threads a fork may deadlock)."""
    path, spec = pack
    script = tmp_path / "forked.py"
    script.write_text(
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import numpy as np\n"
        "from alignsdf_torch.cli import train as train_cli\n"
        "from alignsdf_torch.config import load_specs\n"
        f"specs = load_specs({spec!r})\n"
        "out = []\n"
        "for mode in ('thread', 'process'):\n"
        f"    loader = train_cli.make_loader(specs, None, {path!r}, mode, pixel_band=True)\n"
        "    loader.set_epoch(2)\n"
        "    out.append(list(loader))\n"
        "assert len(out[0]) == len(out[1]) == 2\n"
        "for a, b in zip(*out):\n"
        "    assert 'point_is_hand' in b and set(a) == set(b)\n"
        "    assert all(np.array_equal(a[k], b[k]) for k in a)\n"
        "print('forked OK')\n")
    run = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert run.returncode == 0 and "forked OK" in run.stdout, run.stderr[-3000:]


def test_cli_packed_pixel_band_two_steps(pack, tmp_path, capsys):
    """cli.train --packed --pa_feat --pixel_band on the CPU: one epoch of the
    pack's 6 scenes, 3 a batch, 2 steps on sorted native batches through K4
    with the default band (12 rows of the 24-row map), finite losses."""
    path, spec = pack
    out = str(tmp_path / "out")
    train_cli.main(["-e", spec, "--packed", path, "--pixel_band", "--device", "cpu",
                    "--output_root", out, "--no_init_guard", "--skip_test"])
    assert ("pixel-aligned (K4) with a band of 12 rows on host-sorted points"
            in capsys.readouterr().err)
    exp = os.path.join(out, load_specs(spec).experiment_name())
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        steps = [ln for ln in map(json.loads, f) if "step" in ln]
    assert [(s["epoch"], s["step"]) for s in steps] == [(1, 1), (1, 2)]
    assert all(np.isfinite(v) for s in steps for v in s.values())
