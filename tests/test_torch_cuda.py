"""Kernels K1, K2, K3, K4, K5, K6 and K7 on the card against their plain
versions, in float32 and bf16 (K1, K3 and K6 with the classifier's rows,
K2, K4 and K5 with x_last / dx_last, K7 forward and backward on tied
inputs), and against
float64 the train backwards' weight-gradient reduction, K2's, K4's and
K5's whole backwards (their chains on the tensor cores) and their forwards
(on the tensor cores too: y, and the residuals against the plain ones);
K4's banded tap stage against the plain backward and the unbanded kernel.
Needs a CUDA GPU and skips without one; it imports no JAX, so it runs on a
machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses

import pytest
import torch

from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.kernels.generic_decoder import generic_decode, generic_decode_reference
from alignsdf_torch.kernels.generic_train_decoder import (
    generic_train_decode,
    generic_train_decode_backward,
    generic_train_decode_backward_reference,
    generic_train_decode_forward,
    generic_train_decode_reference,
    pack_generic_trunk,
)
from alignsdf_torch.kernels.grid_decoder import grid_decode, grid_decode_reference
from alignsdf_torch.kernels.maxpool import (
    maxpool_backward,
    maxpool_backward_reference,
    maxpool_forward,
    maxpool_k3s2p1,
    maxpool_reference,
)
from alignsdf_torch.kernels.pixel_grid_decoder import (
    pixel_grid_decode,
    pixel_grid_decode_reference,
    pixel_projection,
)
from alignsdf_torch.kernels.pixel_train_decoder import (
    band_rows_max,
    flatten_pixel_params,
    pack_pixel_trunks,
    pixel_train_decode,
    pixel_train_decode_backward,
    pixel_train_decode_backward_reference,
    pixel_train_decode_forward,
    pixel_train_decode_reference,
    tile_band_bounds,
    unflatten_pixel_params,
)
from alignsdf_torch.kernels.weight_grad import weight_grad, weight_grad_reference, weight_grads
from alignsdf_torch.kernels.train_decoder import (
    flatten_params,
    pack_trunk,
    train_decode,
    train_decode_backward,
    train_decode_backward_reference,
    train_decode_forward,
    train_decode_reference,
    unflatten_params,
)
from alignsdf_torch.models.decoder import (
    SeparateDecoder,
    make_decoder,
    separate_decoder_inputs,
    trunk_prefixes,
)
from alignsdf_torch.ops.decoder_plan import make_generic_plan, trunk_input_widths
from alignsdf_torch.ops.generic_train_plan import generic_trunk_operands, make_generic_train_decoder
from alignsdf_torch.ops.grid_plan import branch_columns, make_grid_decode_fn
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn
from alignsdf_torch.ops.pixel_train_plan import (
    make_pixel_train_decoder,
    pixel_train_inputs,
    pixel_trunks,
    sort_by_row,
)
from alignsdf_torch.ops.train_plan import make_train_decoder, trunk_operands


def _rigid(gen, count):
    tf = torch.eye(4).repeat(1, count, 1, 1)
    q, _ = torch.linalg.qr(torch.randn(1, count, 3, 3, generator=gen))
    tf[..., :3, :3] = q * torch.linalg.det(q)[..., None, None]
    tf[..., :3, 3] = torch.randn(1, count, 3, generator=gen) * 0.05
    return tf


@pytest.mark.cuda
@pytest.mark.parametrize("dims,n,base,cut", [((64,) * 4, 20, 5, 9), ((512,) * 4, 24, 0, 0)])
def test_cuda_kernel_matches_plain(dims, n, base, cut):
    """Narrow and flagship widths, a ragged run and a whole grid.  Both
    sides run the same folded plan in float32 (TF32 off): 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    latent = 256 if dims[0] == 512 else 32
    specs = Specs(encode_style="both", point_feat_size=9, latent_size=latent,
                  mano_branch=True, object_pose_branch=True, sdf_scale_factor=7.0,
                  network_specs=NetworkSpecs(dims=dims))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        decoder = SeparateDecoder(latent, 9, "both", specs.network_specs).cuda()
    ctx = {"decoder": decoder, "latent": torch.randn(1, latent, generator=gen).cuda(),
           "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
           "global_trans": _rigid(gen, 16).cuda(), "obj_trans": _rigid(gen, 1)[:, 0].cuda()}
    plan = make_grid_decode_fn(specs, n)(ctx).plan
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    m = n ** 3 - base - cut
    before = grid_decode.launches
    out = grid_decode(plan, base, m, origin, voxel)
    torch.cuda.synchronize()
    assert grid_decode.launches == before + 1
    ref = grid_decode_reference(plan, base, m, origin, voxel)
    assert out.shape == (2, m)
    assert float((out - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("num_class,model_type", [(6, "1encoder2decoder"), (8, "1encoder2decoder"),
                                                  (126, "1encoder2decoder"),
                                                  (6, "1encoder1decoder")])
def test_cuda_kernel_class_rows_match_plain(num_class, model_type):
    """K1 with 2 + C rows at the flagship width on a 24^3 grid: the SDF rows
    to 1e-5 and the logits (no tanh, so larger) to 1e-4 against the plain
    version, and the same argmax wherever the top two logits differ by more
    than 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(4)
    n = 24
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=256,
                  mano_branch=True, object_pose_branch=True, sdf_scale_factor=6.2,
                  classifier_branch=True, network_specs=NetworkSpecs(num_class=num_class))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(4)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=True).cuda()
    ctx = {"decoder": decoder, "latent": torch.randn(1, 256, generator=gen).cuda(),
           "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
           "global_trans": _rigid(gen, 16).cuda(), "obj_trans": _rigid(gen, 1)[:, 0].cuda()}
    plan = make_grid_decode_fn(specs, n)(ctx).plan
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    before = grid_decode.launches
    out = grid_decode(plan, 3, n ** 3 - 5, origin, voxel)
    torch.cuda.synchronize()
    assert grid_decode.launches == before + 1
    ref = grid_decode_reference(plan, 3, n ** 3 - 5, origin, voxel)
    assert out.shape == ref.shape == (2 + num_class, n ** 3 - 5)
    assert float((out[:2] - ref[:2]).abs().max()) <= 1e-5
    assert float((out[2:] - ref[2:]).abs().max()) <= 1e-4
    top2 = ref[2:].topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > 1e-5
    assert bool((out[2:].argmax(0) == ref[2:].argmax(0))[clear].all())


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
def test_cuda_train_kernel_x_last_matches_plain(model_type):
    """K2 with x_last out and dx_last in, at the flagship width on 4 x 2000
    points: y and x_last to 1e-5 abs against the plain forward, every
    gradient (nonzero random dy and dx_last) to 1e-4 of its largest entry
    against the plain backward fed the kernel's own residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    scenes, n = 4, 2000
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=256,
                  samples_per_scene=n, classifier_branch=True, network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(5)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=True).cuda()
    latent = torch.randn(scenes, 256, generator=gen).cuda()
    emb = (torch.randn(scenes * n, 9, generator=gen) * 0.5).cuda()
    st = make_train_decoder(specs).statics
    first, second = trunk_prefixes(decoder)
    cols = branch_columns(specs)[0]
    with torch.no_grad():
        ws, xs, bs = trunk_operands(decoder, first, len(cols), latent, specs, 1 if second else 2)
    e = emb[:, list(cols)].contiguous()
    leaves = [t.detach().clone().requires_grad_() for t in [e, *flatten_params(ws, xs, bs)]]
    fwd, bwd = train_decode.launches, train_decode_backward.launches
    y, x_last = train_decode(leaves[0], *unflatten_params(st, leaves[1:]), 5, st)
    dy = torch.randn(y.shape, generator=gen).cuda()
    dx_last = torch.randn(x_last.shape, generator=gen).cuda()
    grads = torch.autograd.grad((y, x_last), leaves, (dy, dx_last))
    torch.cuda.synchronize()
    assert (train_decode.launches, train_decode_backward.launches) == (fwd + 1, bwd + 1)
    with torch.no_grad():
        y_ref, x_ref = train_decode_reference(e, ws, xs, bs, 5, st)
        assert x_last.shape == x_ref.shape == (scenes * n, 512)
        assert float((y - y_ref).abs().max()) <= 1e-5
        assert float((x_last - x_ref).abs().max()) <= 1e-5
        y_k, acts = train_decode_forward(pack_trunk(e, ws, xs, bs, st), 5, st)
        acts = [a[:b.shape[-1]].T for a, b in zip(acts, bs)]
        demb, dws, dxs, dbs = train_decode_backward_reference(e, ws, xs, bs, st, y_k, acts, dy,
                                                              dx_last)
    for g, r in zip(grads, [demb, *flatten_params(dws, dxs, dbs)]):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * (float(r.abs().max()) + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,scenes,n,train,model_type",
                         [((64,) * 4, 3, 128, True, "1encoder2decoder"),
                          ((512,) * 4, 4, 2000, True, "1encoder2decoder"),
                          ((512,) * 4, 2, 2000, False, "1encoder2decoder"),
                          ((512,) * 4, 2, 2000, True, "1encoder1decoder")])
def test_cuda_train_kernel_matches_plain(dims, scenes, n, train, model_type):
    """K2 forward and backward on each trunk (the twin trunks, or the one
    combined trunk with two outputs), through the autograd Function, against
    the plain versions on the same card, TF32 off: y to 1e-5 abs against the
    plain forward, every gradient to 1e-4 of its largest entry against the
    plain backward fed the kernel's own residuals (autograd through the plain
    forward would differ wherever rounding flips a unit at ReLU's edge; sums
    run in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(1)
    latent_size = 256 if dims[0] == 512 else 32
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9,
                  latent_size=latent_size, samples_per_scene=n,
                  network_specs=NetworkSpecs(dims=dims))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        decoder = make_decoder(model_type, latent_size, 9, "both", specs.network_specs).cuda()
    latent = torch.randn(scenes, latent_size, generator=gen).cuda()
    emb = (torch.randn(scenes * n, 9, generator=gen) * 0.5).cuda()
    st = make_train_decoder(specs).statics._replace(train=train)
    first, second = trunk_prefixes(decoder)
    cols_h, cols_o = branch_columns(specs)
    trunks = ([(first, cols_h, 5, 1), (second, cols_o, 6, 1)] if second
              else [(first, cols_h, 5, 2)])
    for prefix, cols, seed, out_dim in trunks:
        with torch.no_grad():
            ws, xs, bs = trunk_operands(decoder, prefix, len(cols), latent, specs, out_dim)
        e = emb[:, list(cols)].contiguous()
        leaves = [t.detach().clone().requires_grad_() for t in [e, *flatten_params(ws, xs, bs)]]
        fwd, bwd = train_decode.launches, train_decode_backward.launches
        y, _ = train_decode(leaves[0], *unflatten_params(st, leaves[1:]), seed, st)
        dy = torch.randn(y.shape, generator=gen).cuda()
        grads = torch.autograd.grad(y, leaves, dy)
        torch.cuda.synchronize()
        assert (train_decode.launches, train_decode_backward.launches) == (fwd + 1, bwd + 1)
        with torch.no_grad():
            y_ref, _ = train_decode_reference(e, ws, xs, bs, seed, st)
            assert y.shape == y_ref.shape == (out_dim, scenes * n)
            assert float((y - y_ref).abs().max()) <= 1e-5
            y_k, acts = train_decode_forward(pack_trunk(e, ws, xs, bs, st), seed, st)
            acts = [a[:b.shape[-1]].T for a, b in zip(acts, bs)]
            demb, dws, dxs, dbs = train_decode_backward_reference(e, ws, xs, bs, st, y_k, acts, dy)
        for g, r in zip(grads, [demb, *flatten_params(dws, dxs, dbs)]):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= 1e-4 * (float(r.abs().max()) + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,c,hw,n,base,cut,ref", [((64,) * 4, 32, (8, 8), 20, 5, 9, False),
                                                     ((512,) * 4, 256, (64, 64), 24, 0, 0, True),
                                                     ((512,) * 4, 256, (64, 64), 32, 0, 0, False)])
def test_cuda_pixel_kernel_matches_plain(dims, c, hw, n, base, cut, ref):
    """K3 at a narrow width on a small map with a ragged run, and at the
    flagship width on the 256 x 64 x 64 HeadNet map, in both projection
    modes, with part of the grid outside the image.  Both sides run the same
    plan in float32 (TF32 off) and agree on which points are in the image:
    1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    specs = Specs(encode_style="both", point_feat_size=9, latent_size=c, mano_branch=True,
                  object_pose_branch=True, sdf_scale_factor=7.0, pixel_align=True,
                  network_specs=NetworkSpecs(dims=dims))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        decoder = SeparateDecoder(c, 9, "both", specs.network_specs).cuda()
    ctx = {"decoder": decoder, "latent": torch.randn(1, c, *hw, generator=gen).cuda(),
           "cam_intr": torch.tensor([[[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]]).cuda(),
           "pred_root": torch.tensor([[[0.01, -0.02, 0.6]]]).cuda(),
           "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
           "global_trans": _rigid(gen, 16).cuda(), "obj_trans": _rigid(gen, 1)[:, 0].cuda()}
    plan = make_pixel_grid_decode_fn(specs, n, ref)(ctx).plan
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    m = n ** 3 - base - cut
    before = pixel_grid_decode.launches
    out = pixel_grid_decode(plan, base, m, origin, voxel)
    torch.cuda.synchronize()
    assert pixel_grid_decode.launches == before + 1
    ref_out = pixel_grid_decode_reference(plan, base, m, origin, voxel)
    share = float(pixel_projection(plan, base, m, origin, voxel)[3].float().mean())
    assert 0.0 < share < 1.0
    assert out.shape == (2, m)
    assert float((out - ref_out).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dims,c,hw,scenes,n,train,model_type",
                         [((64,) * 4, 32, (8, 8), 3, 128, True, "1encoder2decoder"),
                          ((512,) * 4, 256, (64, 64), 4, 2000, True, "1encoder2decoder"),
                          ((512,) * 4, 256, (64, 64), 2, 2000, False, "1encoder1decoder")])
def test_cuda_pixel_train_kernel_matches_plain(dims, c, hw, scenes, n, train, model_type):
    """K4 forward and backward through the autograd Function against the
    plain versions on the same card, TF32 off, with part of the points
    outside the image: y to 1e-5 abs against the plain forward, every
    gradient (weights, d(table), d(mean), d(xp), d(yp), d(emb)) to 1e-4 of
    its largest entry against the plain backward fed the kernel's own
    residuals; d(table) and the reductions add with atomics, in another
    order each run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=c,
                  pixel_align=True, samples_per_scene=n, sdf_scale_factor=7.0,
                  image_size=(256, 256), network_specs=NetworkSpecs(dims=dims))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        decoder = make_decoder(model_type, c, 9, "both", specs.network_specs).cuda()
    m = scenes * n
    fmap = (torch.randn(scenes, c, *hw, generator=gen) * 0.5).cuda()
    emb = (torch.randn(m, 9, generator=gen) * 0.5).cuda()
    xyz = (torch.randn(m, 3, generator=gen) * 0.5).cuda()
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]).repeat(scenes, 1, 1)
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(scenes, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=hw, train=train)
    with torch.no_grad():
        table, mean, xp, yp, mask = pixel_train_inputs(fmap, xyz, cam.cuda(), root.cuda(), specs)
        trunks = pixel_trunks(decoder, specs, c)
    share = float(mask.mean())
    assert 0.0 < share < 1.0
    leaves = [t.detach().clone().requires_grad_()
              for t in (table, mean, xp, yp, emb, *flatten_pixel_params(trunks))]
    fwd, bwd = pixel_train_decode.launches, pixel_train_decode_backward.launches
    y, _ = pixel_train_decode(*leaves[:4], mask, leaves[4],
                              unflatten_pixel_params(st, leaves[5:]), 9, st)
    dy = torch.randn(y.shape, generator=gen).cuda()
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (pixel_train_decode.launches, pixel_train_decode_backward.launches) == (fwd + 1, bwd + 1)
    with torch.no_grad():
        y_ref, _ = pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks, 9, st)
        assert y.shape == y_ref.shape == (2, m)
        assert float((y - y_ref).abs().max()) <= 1e-5
        y_k, acts, lat = pixel_train_decode_forward(
            pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st), 9, st)
        acts = [[a[:b.shape[-1]].T for a, b in zip(at, tr[3])] for at, tr in zip(acts, trunks)]
        dtable, dmean, dxp, dyp, demb, g_ref = pixel_train_decode_backward_reference(
            table, mean, xp, yp, mask, emb, trunks, st, y_k, acts, lat[:c].T, dy)
    ref = [dtable, dmean, dxp, dyp, demb, *flatten_pixel_params(g_ref)]
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * (float(r.abs().max()) + 1e-12)


def _pixel_scene(model_type, num_class, c, hw, gen, seed):
    """A seeded full-width pixel-aligned decoder with a classifier of
    num_class (head scaled x40 so labels vary), its specs and a grid
    context on the card."""
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=c,
                  mano_branch=True, object_pose_branch=True, sdf_scale_factor=7.0,
                  pixel_align=True, classifier_branch=True,
                  network_specs=NetworkSpecs(num_class=num_class))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = make_decoder(model_type, c, 9, "both", specs.network_specs,
                               use_classifier=True).cuda()
    with torch.no_grad():
        decoder.classifier_head.weight *= 40
    ctx = {"decoder": decoder, "latent": torch.randn(1, c, *hw, generator=gen).cuda(),
           "cam_intr": torch.tensor([[[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]]).cuda(),
           "pred_root": torch.tensor([[[0.01, -0.02, 0.6]]]).cuda(),
           "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
           "global_trans": _rigid(gen, 16).cuda(), "obj_trans": _rigid(gen, 1)[:, 0].cuda()}
    return specs, ctx


@pytest.mark.cuda
@pytest.mark.parametrize("pixel", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("num_class,model_type", [(0, "1encoder2decoder"),
                                                  (126, "1encoder2decoder"),
                                                  (6, "1encoder1decoder")])
def test_cuda_tc_trunk_matches_plain(pixel, num_class, model_type):
    """K1 and K3 on the tensor-core trunk (csrc/grid_trunk_tc.cuh) at the
    flagship width (the 250-wide layer pads to 256), with no classifier,
    with C = 126 and on a combined trunk: a run of 30^3 - 20 points from
    base 7, so neither end falls on the 64-point tile, against the plain
    version in float32 (TF32 off) at 1e-4 on every row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    n, base = 30, 7
    m = n ** 3 - base - 13
    assert m % 64 and base % 64
    if pixel:
        specs, ctx = _pixel_scene(model_type, max(num_class, 6), 256, (64, 64), gen, 9)
    else:
        specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9,
                      latent_size=256, mano_branch=True, object_pose_branch=True,
                      sdf_scale_factor=7.0, classifier_branch=True,
                      network_specs=NetworkSpecs(num_class=max(num_class, 6)))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(9)
            decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                                   use_classifier=True).cuda()
        ctx = {"decoder": decoder, "latent": torch.randn(1, 256, generator=gen).cuda(),
               "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
               "global_trans": _rigid(gen, 16).cuda(), "obj_trans": _rigid(gen, 1)[:, 0].cuda()}
    if num_class == 0:
        ctx["decoder"].classifier_head = None
    make, kernel, plain = ((make_pixel_grid_decode_fn, pixel_grid_decode,
                            pixel_grid_decode_reference) if pixel else
                           (make_grid_decode_fn, grid_decode, grid_decode_reference))
    plan = make(specs, n)(ctx).plan
    assert plan.n_rows == 2 + num_class
    assert 256 in plan.out_pads() and max(plan.out_pads()) == 512
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    before = kernel.launches
    out = kernel(plan, base, m, origin, voxel)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(plan, base, m, origin, voxel)
    assert out.shape == ref.shape == (2 + num_class, m)
    assert bool(torch.isfinite(out).all())
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("num_class,model_type", [(6, "1encoder2decoder"), (126, "1encoder2decoder"),
                                                  (6, "1encoder1decoder")])
def test_cuda_pixel_kernel_class_rows_match_plain(num_class, model_type):
    """K3 with 2 + C rows (8 and 128) at the flagship width on the 256 x 64 x
    64 map, a ragged run of a 24^3 grid partly outside the image: the SDF
    rows to 1e-5 and the logits (no tanh, so larger) to 1e-4 against the
    plain version, and the same argmax wherever the top two logits differ by
    more than 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(6)
    n = 24
    specs, ctx = _pixel_scene(model_type, num_class, 256, (64, 64), gen, 6)
    plan = make_pixel_grid_decode_fn(specs, n)(ctx).plan
    assert plan.n_rows == 2 + num_class
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    m = n ** 3 - 5
    before = pixel_grid_decode.launches
    out = pixel_grid_decode(plan, 3, m, origin, voxel)
    torch.cuda.synchronize()
    assert pixel_grid_decode.launches == before + 1
    ref = pixel_grid_decode_reference(plan, 3, m, origin, voxel)
    share = float(pixel_projection(plan, 3, m, origin, voxel)[3].float().mean())
    assert 0.0 < share < 1.0
    assert out.shape == ref.shape == (2 + num_class, m)
    assert float((out[:2] - ref[:2]).abs().max()) <= 1e-5
    assert float((out[2:] - ref[2:]).abs().max()) <= 1e-4
    top2 = ref[2:].topk(2, dim=0).values
    clear = (top2[0] - top2[1]) > 1e-5
    assert bool((out[2:].argmax(0) == ref[2:].argmax(0))[clear].all())


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", ["1encoder2decoder", "1encoder1decoder"])
def test_cuda_pixel_train_kernel_x_last_matches_plain(model_type):
    """K4 with x_last out and dx_last in, at the flagship width on 4 x 2000
    points and the 256 x 64 x 64 map: y and x_last to 1e-5 abs against the
    plain forward, every gradient (nonzero random dy and dx_last) to 1e-4 of
    its largest entry against the plain backward fed the kernel's own
    residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    scenes, n, c, hw = 4, 2000, 256, (64, 64)
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=c,
                  pixel_align=True, samples_per_scene=n, sdf_scale_factor=7.0,
                  image_size=(256, 256), classifier_branch=True, network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        decoder = make_decoder(model_type, c, 9, "both", specs.network_specs,
                               use_classifier=True).cuda()
    m = scenes * n
    fmap = (torch.randn(scenes, c, *hw, generator=gen) * 0.5).cuda()
    emb = (torch.randn(m, 9, generator=gen) * 0.5).cuda()
    xyz = (torch.randn(m, 3, generator=gen) * 0.5).cuda()
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]).repeat(scenes, 1, 1)
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(scenes, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=hw)
    with torch.no_grad():
        table, mean, xp, yp, mask = pixel_train_inputs(fmap, xyz, cam.cuda(), root.cuda(), specs)
        trunks = pixel_trunks(decoder, specs, c)
    leaves = [t.detach().clone().requires_grad_()
              for t in (table, mean, xp, yp, emb, *flatten_pixel_params(trunks))]
    fwd, bwd = pixel_train_decode.launches, pixel_train_decode_backward.launches
    y, x_last = pixel_train_decode(*leaves[:4], mask, leaves[4],
                                   unflatten_pixel_params(st, leaves[5:]), 9, st)
    dy = torch.randn(y.shape, generator=gen).cuda()
    dx_last = torch.randn(x_last.shape, generator=gen).cuda()
    grads = torch.autograd.grad((y, x_last), leaves, (dy, dx_last))
    torch.cuda.synchronize()
    assert (pixel_train_decode.launches, pixel_train_decode_backward.launches) == (fwd + 1, bwd + 1)
    with torch.no_grad():
        y_ref, x_ref = pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks, 9, st)
        assert x_last.shape == x_ref.shape == (m, 512)
        assert float((y - y_ref).abs().max()) <= 1e-5
        assert float((x_last - x_ref).abs().max()) <= 1e-5
        y_k, acts, lat = pixel_train_decode_forward(
            pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st), 9, st)
        acts = [[a[:b.shape[-1]].T for a, b in zip(at, tr[3])] for at, tr in zip(acts, trunks)]
        dtable, dmean, dxp, dyp, demb, g_ref = pixel_train_decode_backward_reference(
            table, mean, xp, yp, mask, emb, trunks, st, y_k, acts, lat[:c].T, dy, dx_last)
    ref = [dtable, dmean, dxp, dyp, demb, *flatten_pixel_params(g_ref)]
    assert len(ref) == len(grads)
    for g, r in zip(grads, ref):
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * (float(r.abs().max()) + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,style,pfs,latent_in,num_class,dims,latent,m", [
    ("1encoder2decoder", "nerf", 63, (2,), 0, (512,) * 4, 256, 4101),
    ("1encoder1decoder", "nerf", 9, (2,), 6, (512,) * 4, 256, 3000),
    ("1encoder2decoder", "both", 9, (0, 2), 6, (512,) * 4, 256, 1000),
    ("1encoder2decoder", "hand", 51, (0, 4), 0, (128,) * 4, 32, 777),
    ("1encoder2decoder", "nerf", 63, (0,), 0, (512,) * 4, 512, 2050)])
def test_cuda_generic_kernel_matches_plain(model_type, style, pfs, latent_in, num_class, dims,
                                           latent, m):
    """K6 on materialized rows: NeRF PE at point_size 63 (the --pallas
    config at full width, whose latent_in layer stages x0 in two chunks),
    the combined trunk with a classifier, twin trunks at C = 6 with
    latent_in (0, 2), a narrow trunk with a latent input at the final layer
    whose object rows are a strided view, and rows of 512 + 63 with 0 in
    latent_in (wider than the trunk's 544-row buffer: layer 0 stages x0 in
    chunks); ragged row counts.
    The SDFs to 1e-5 and the logits (no tanh) to 1e-4 against the plain
    version on the same plan, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    specs = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                  latent_size=latent, classifier_branch=bool(num_class),
                  network_specs=NetworkSpecs(dims=dims, latent_in=latent_in,
                                             num_class=num_class or 6))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        decoder = make_decoder(model_type, latent, pfs, style, specs.network_specs,
                               use_classifier=bool(num_class)).cuda()
    rows = (torch.randn(m, latent + pfs, generator=gen) * 0.5).cuda()
    plan = make_generic_plan(decoder, specs)
    inputs = ((rows,) if model_type == "1encoder1decoder"
              else separate_decoder_inputs(latent, style, rows))
    before = generic_decode.launches
    out = generic_decode(plan, *inputs)
    torch.cuda.synchronize()
    assert generic_decode.launches == before + 1
    ref = generic_decode_reference(plan, *inputs)
    with torch.no_grad():
        direct = decoder(rows)
    for k, r, d, tol in zip(out, ref, direct, (1e-5, 1e-5, 1e-4)):
        assert (k is None) == (r is None) == (d is None) == (tol == 1e-4 and not num_class)
        if k is not None:
            assert k.shape == r.shape == d.shape
            assert float((k - r).abs().max()) <= tol
            assert float((k - d).abs().max()) <= tol


def _f64(ts):
    return [None if t is None else t.double() for t in ts]


def _within(grads, refs, bound):
    """Each gradient within ``bound`` of its float64 reference's largest
    entry; returns the worst share."""
    worst = 0.0
    for g, r in zip(grads, refs):
        assert g.shape == r.shape
        worst = max(worst, float((g.double() - r).abs().max()) / (float(r.abs().max()) + 1e-30))
    assert worst <= bound, worst
    return worst


# The train backwards against float64 at a step's 64 x 2000 points: the
# kernels' contract, 1e-4 of each gradient's largest entry.  The chain and
# the reductions run split TF32 (float32's accuracy); the tensor cores'
# float32 accumulation over the reductions' 2,048-point chunks errs by
# ~2e-5 of the largest entry at this size, the plain float32 backward by
# ~1e-6, and a chain in one TF32 pass by ~5e-4 (tests/test_torch_split_tf32.py).
CHAIN_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,classifier", [("1encoder2decoder", False),
                                                   ("1encoder2decoder", True),
                                                   ("1encoder1decoder", False)],
                         ids=["flagship", "dx_last", "combined"])
def test_cuda_train_chain_matches_float64(model_type, classifier):
    """K2's backward (the reverse chain on the tensor cores, then the
    reductions) at the flagship width on 64 x 2000 points, each trunk
    against the plain backward in float64 fed the kernel's own residuals
    (with a random dx_last on the classifier's trunk): every gradient within
    CHAIN_TOL of its largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(21)
    scenes, n = 64, 2000
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=256,
                  samples_per_scene=n, classifier_branch=classifier,
                  network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(21)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=classifier).cuda()
    latent = torch.randn(scenes, 256, generator=gen).cuda()
    emb = (torch.randn(scenes * n, 9, generator=gen) * 0.5).cuda()
    st = make_train_decoder(specs).statics
    first, second = trunk_prefixes(decoder)
    cols_h, cols_o = branch_columns(specs)
    trunks = ([(first, cols_h, 5, 1), (second, cols_o, 6, 1)] if second
              else [(first, cols_h, 5, 2)])
    for i, (prefix, cols, seed, out_dim) in enumerate(trunks):
        with torch.no_grad():
            ws, xs, bs = trunk_operands(decoder, prefix, len(cols), latent, specs, out_dim)
            e = emb[:, list(cols)].contiguous()
            pack = pack_trunk(e, ws, xs, bs, st)
            y, acts = train_decode_forward(pack, seed, st)
            dy = torch.randn(y.shape, generator=gen).cuda()
            dxl = (torch.randn(e.shape[0], bs[-2].shape[-1], generator=gen).cuda()
                   if classifier and i == 0 else None)
            before = train_decode_backward.launches
            demb, grads = train_decode_backward(pack, st, y, acts, dy, dxl)
            torch.cuda.synchronize()
            assert train_decode_backward.launches == before + 1
            acts = [a[:b.shape[-1]].T for a, b in zip(acts, bs)]
            got = [demb, *flatten_params(
                [None if w is None else g[0][:w.shape[0], :w.shape[1]] for w, g in zip(ws, grads)],
                [None if x is None else g[1][:, :x.shape[1]] for x, g in zip(xs, grads)],
                [g[2][..., :b.shape[-1]] for b, g in zip(bs, grads)])]
            exact = train_decode_backward_reference(
                e.double(), _f64(ws), _f64(xs), _f64(bs), st, y.double(), _f64(acts),
                dy.double(), None if dxl is None else dxl.double())
            ref = [exact[0], *flatten_params(*exact[1:])]
            _within(got, ref, CHAIN_TOL)
            plain = train_decode_backward_reference(e, ws, xs, bs, st, y, acts, dy, dxl)
            _within([plain[0], *flatten_params(*plain[1:])], ref, CHAIN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,classifier", [("1encoder2decoder", False),
                                                   ("1encoder2decoder", True),
                                                   ("1encoder1decoder", False)],
                         ids=["pa_feat", "dx_last", "combined"])
def test_cuda_pixel_train_chain_matches_float64(model_type, classifier):
    """K4's backward (the reverse chain with the latent's gradient on the
    tensor cores, the tap stage, the reductions) at the flagship --pa_feat
    width (C = 256, a 64 x 64 map) on 64 x 2000 points, part of them outside
    the image, against the plain backward in float64 fed the kernel's own
    residuals (with a random dx_last on the classifier's trunk): every
    gradient, d(table), d(mean), d(xp), d(yp) and d(emb) within CHAIN_TOL of
    its largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(22)
    scenes, n, c, hw = 64, 2000, 256, (64, 64)
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=c,
                  pixel_align=True, samples_per_scene=n, sdf_scale_factor=7.0,
                  image_size=(256, 256), classifier_branch=classifier,
                  network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(22)
        decoder = make_decoder(model_type, c, 9, "both", specs.network_specs,
                               use_classifier=classifier).cuda()
    m = scenes * n
    fmap = (torch.randn(scenes, c, *hw, generator=gen) * 0.5).cuda()
    emb = (torch.randn(m, 9, generator=gen) * 0.5).cuda()
    xyz = (torch.randn(m, 3, generator=gen) * 0.5).cuda()
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]).repeat(scenes, 1, 1)
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(scenes, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=hw)
    with torch.no_grad():
        table, mean, xp, yp, mask = pixel_train_inputs(fmap, xyz, cam.cuda(), root.cuda(), specs)
        trunks = pixel_trunks(decoder, specs, c)
        assert 0.0 < float(mask.mean()) < 1.0
        pack = pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st)
        y, acts, lat = pixel_train_decode_forward(pack, 9, st)
        dy = torch.randn(y.shape, generator=gen).cuda()
        dxl = (torch.randn(m, trunks[0][3][-2].shape[-1], generator=gen).cuda() if classifier
               else None)
        before = pixel_train_decode_backward.launches
        dtable, dmean, dxp, dyp, demb, grads = pixel_train_decode_backward(
            pack, st, y, acts, lat, dy, dxl)
        torch.cuda.synchronize()
        assert pixel_train_decode_backward.launches == before + 1
        got = [dtable, dmean, dxp, dyp, demb]
        for (ws, lats, xs, bs), g in zip(trunks, grads):
            got += [dw[:w.shape[0], :w.shape[1]] for w, (dw, _, _, _) in zip(ws, g) if w is not None]
            got += [dl[:c, :t.shape[1]] for t, (_, dl, _, _) in zip(lats, g) if t is not None]
            got += [dx[:, :t.shape[1]] for t, (_, _, dx, _) in zip(xs, g) if t is not None]
            got += [db[:b.shape[-1]] for b, (_, _, _, db) in zip(bs, g)]
        acts = [[a[:b.shape[-1]].T for a, b in zip(at, tr[3])] for at, tr in zip(acts, trunks)]
        exact = pixel_train_decode_backward_reference(
            table.double(), mean.double(), xp.double(), yp.double(), mask, emb.double(),
            [tuple(_f64(group) for group in tr) for tr in trunks], st, y.double(),
            [_f64(at) for at in acts], lat[:c].T.double(), dy.double(),
            None if dxl is None else dxl.double())
        ref = [*exact[:5], *flatten_pixel_params(exact[5])]
        _within(got, ref, CHAIN_TOL)
        plain = pixel_train_decode_backward_reference(table, mean, xp, yp, mask, emb, trunks, st,
                                                      y, acts, lat[:c].T, dy, dxl)
        _within([*plain[:5], *flatten_pixel_params(plain[5])], ref, CHAIN_TOL)


def _k5_trunks(model_type, style, pfs, m, classifier, seed):
    """The trunks of a full-width decoder with latent_in (0, 2) on m random
    materialized rows, as K5 takes them: (statics, [(x0, ws, xs, bs, dropout
    seed, outputs)])."""
    gen = torch.Generator().manual_seed(seed)
    specs = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                  latent_size=256, classifier_branch=classifier,
                  network_specs=NetworkSpecs(latent_in=(0, 2)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = make_decoder(model_type, 256, pfs, style, specs.network_specs,
                               use_classifier=classifier).cuda()
    rows = (torch.randn(m, 256 + pfs, generator=gen) * 0.5).cuda()
    first, second = trunk_prefixes(decoder)
    inputs = [rows] if second is None else separate_decoder_inputs(256, style, rows)
    trunks = []
    with torch.no_grad():
        for prefix, width, x0, dseed in zip((first, second), trunk_input_widths(specs), inputs,
                                            (5, 6)):
            out_dim = 2 if second is None else 1
            ws, xs, bs = generic_trunk_operands(decoder, prefix, width, specs, out_dim)
            trunks.append((x0.contiguous(), ws, xs, bs, dseed, out_dim))
    return make_generic_train_decoder(specs).statics, trunks


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,style,pfs,classifier", [
    ("1encoder2decoder", "both", 9, False), ("1encoder2decoder", "both", 9, True),
    ("1encoder1decoder", "both", 9, False), ("1encoder2decoder", "nerf", 63, False)],
    ids=["latent_in_0_2", "dx_last", "combined", "nerf63"])
def test_cuda_generic_train_chain_matches_float64(model_type, style, pfs, classifier):
    """K5's backward (the reverse chain on the tensor cores with d(x0)'s head
    from the same products and its tail on the CUDA cores, then the
    reductions) at the flagship width with latent_in (0, 2) on 64 x 2000
    rows of 262 (265 combined, 319 at --point_size 63), each trunk against
    the plain backward in float64 fed the kernel's own residuals (with a
    random dx_last on the classifier's trunk): every gradient, d(x0)
    included, within CHAIN_TOL of its largest entry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    st, trunks = _k5_trunks(model_type, style, pfs, 128000, classifier, 23)
    gen = torch.Generator().manual_seed(24)
    for i, (x0, ws, xs, bs, seed, _) in enumerate(trunks):
        with torch.no_grad():
            pack = pack_generic_trunk(x0, ws, xs, bs, st)
            y, acts = generic_train_decode_forward(pack, seed, st)
            dy = torch.randn(y.shape, generator=gen).cuda()
            dxl = (torch.randn(x0.shape[0], bs[-2].shape[-1], generator=gen).cuda()
                   if classifier and i == 0 else None)
            before = generic_train_decode_backward.launches
            dx0, grads = generic_train_decode_backward(pack, st, y, acts, dy, dxl)
            torch.cuda.synchronize()
            assert generic_train_decode_backward.launches == before + 1
            acts = [a[:b.shape[-1]].T for a, b in zip(acts, bs)]
            got = [dx0, *flatten_params(
                [None if w is None else g[0][:w.shape[0], :w.shape[1]] for w, g in zip(ws, grads)],
                [None if x is None else g[1][:, :x.shape[1]] for x, g in zip(xs, grads)],
                [g[2][:b.shape[-1]] for b, g in zip(bs, grads)])]
            exact = generic_train_decode_backward_reference(
                x0.double(), _f64(ws), _f64(xs), _f64(bs), st, y.double(), _f64(acts),
                dy.double(), None if dxl is None else dxl.double())
            ref = [exact[0], *flatten_params(*exact[1:])]
            _within(got, ref, CHAIN_TOL)
            plain = generic_train_decode_backward_reference(x0, ws, xs, bs, st, y, acts, dy, dxl)
            _within([plain[0], *flatten_params(*plain[1:])], ref, CHAIN_TOL)


# The train forwards on the tensor cores (csrc/train_fwd_tc.cuh) against the
# plain forward: split TF32 and the plain float32 product round differently,
# so a hidden unit whose pre-activation lies within rounding of 0 may be 0 on
# one side and a tiny positive value on the other.  Such a flip is allowed
# where that value is at most FLIP_TOL, a few float32 roundings of the
# unit's sum; everywhere else the residuals agree to FWD_TOL.
FWD_TOL, FLIP_TOL = 1e-4, 1e-5


def _residuals_within(acts_k, acts_ref):
    """The kernel's residuals (out_pad, M) against the plain gated
    activations (M, out): FWD_TOL where both are positive, flips only at
    values within FLIP_TOL of 0, zeros in the padding rows; returns the
    flip count."""
    flips = 0
    for a, r in zip(acts_k, acts_ref):
        assert bool((a[r.shape[1]:] == 0).all())
        a = a[:r.shape[1]].T
        both, flip = (a > 0) & (r > 0), (a > 0) != (r > 0)
        assert float((a - r)[both].abs().max()) <= FWD_TOL
        if bool(flip.any()):
            assert float((a - r)[flip].abs().max()) <= FLIP_TOL
        flips += int(flip.sum())
    return flips


@pytest.mark.cuda
@pytest.mark.parametrize("x_last", [False, True], ids=["flagship", "x_last"])
@pytest.mark.parametrize("scenes", [4, 64])
@pytest.mark.parametrize("kernel", ["K2", "K4", "K5"])
def test_cuda_train_fwd_matches_plain_and_float64(kernel, scenes, x_last):
    """K2's, K4's and K5's forwards (split TF32 on the tensor cores) at the
    flagship width on scenes x 2000 points (K4 on a 256 x 64 x 64 map, part
    of the points outside the image; K5 on materialized rows with latent_in
    (0, 2); with x_last, the classifier's trunks): y within FWD_TOL of the
    plain forward and of the float64 forward, x_last within FWD_TOL of the
    plain one, the residuals as _residuals_within holds them (the flip
    count is printed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(31)
    n, c, m = 2000, 256, scenes * 2000
    if kernel == "K5":
        st, trunks = _k5_trunks("1encoder2decoder", "both", 9, m, x_last, 31)
        flips = 0
        with torch.no_grad():
            for i, (x0, ws, xs, bs, seed, _) in enumerate(trunks):
                y, xl = generic_train_decode(x0, ws, xs, bs, seed, st)
                refs = []
                y_ref, xl_ref = generic_train_decode_reference(x0, ws, xs, bs, seed, st,
                                                               acts=refs)
                y64, _ = generic_train_decode_reference(x0.double(), _f64(ws), _f64(xs),
                                                        _f64(bs), seed, st)
                assert float((y - y_ref).abs().max()) <= FWD_TOL
                assert float((y.double() - y64).abs().max()) <= FWD_TOL
                if x_last and i == 0:
                    assert float((xl - xl_ref).abs().max()) <= FWD_TOL
                _, acts = generic_train_decode_forward(pack_generic_trunk(x0, ws, xs, bs, st),
                                                       seed, st)
                flips += _residuals_within(acts, refs)
        print(f"K5 forward at {scenes} x {n}{' with x_last' if x_last else ''}: "
              f"{flips} flips at ReLU's edge")
        return
    specs = Specs(model_type="1encoder2decoder", encode_style="both", point_feat_size=9,
                  latent_size=c, pixel_align=kernel == "K4", samples_per_scene=n,
                  sdf_scale_factor=7.0, image_size=(256, 256), classifier_branch=x_last,
                  network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(31)
        decoder = make_decoder("1encoder2decoder", c, 9, "both", specs.network_specs,
                               use_classifier=x_last).cuda()
    emb = (torch.randn(m, 9, generator=gen) * 0.5).cuda()
    flips = 0
    with torch.no_grad():
        if kernel == "K2":
            latent = (torch.randn(scenes, c, generator=gen) * 0.5).cuda()
            st = make_train_decoder(specs).statics
            first, second = trunk_prefixes(decoder)
            for i, (prefix, cols, seed) in enumerate(zip((first, second), branch_columns(specs),
                                                          (5, 6))):
                ws, xs, bs = trunk_operands(decoder, prefix, len(cols), latent, specs, 1)
                e = emb[:, list(cols)].contiguous()
                y, xl = train_decode(e, ws, xs, bs, seed, st)
                refs = []
                y_ref, xl_ref = train_decode_reference(e, ws, xs, bs, seed, st, acts=refs)
                y64, _ = train_decode_reference(e.double(), _f64(ws), _f64(xs), _f64(bs), seed, st)
                assert float((y - y_ref).abs().max()) <= FWD_TOL
                assert float((y.double() - y64).abs().max()) <= FWD_TOL
                if x_last and i == 0:
                    assert float((xl - xl_ref).abs().max()) <= FWD_TOL
                _, acts = train_decode_forward(pack_trunk(e, ws, xs, bs, st), seed, st)
                flips += _residuals_within(acts, refs)
        else:
            fmap = (torch.randn(scenes, c, 64, 64, generator=gen) * 0.5).cuda()
            xyz = (torch.randn(m, 3, generator=gen) * 0.5).cuda()
            cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]])
            root = torch.tensor([[[0.01, -0.02, 0.6]]])
            st = make_pixel_train_decoder(specs).statics._replace(feat_hw=(64, 64))
            inputs = (*pixel_train_inputs(fmap, xyz, cam.repeat(scenes, 1, 1).cuda(),
                                          root.repeat(scenes, 1, 1).cuda(), specs), emb)
            assert 0.0 < float(inputs[4].mean()) < 1.0
            trunks = pixel_trunks(decoder, specs, c)
            y, xl = pixel_train_decode(*inputs, trunks, 9, st)
            refs, lat_ref = [], []
            y_ref, xl_ref = pixel_train_decode_reference(*inputs, trunks, 9, st, acts=refs,
                                                         latent=lat_ref)
            table, mean, xp, yp, mask, _ = inputs
            y64, _ = pixel_train_decode_reference(
                *(t.double() for t in (table, mean, xp, yp)), mask, emb.double(),
                [tuple(_f64(group) for group in tr) for tr in trunks], 9, st)
            assert float((y - y_ref).abs().max()) <= FWD_TOL
            assert float((y.double() - y64).abs().max()) <= FWD_TOL
            if x_last:
                assert float((xl - xl_ref).abs().max()) <= FWD_TOL
            _, acts, lat = pixel_train_decode_forward(
                pack_pixel_trunks(*inputs, trunks, st), 9, st)
            assert float((lat[:c].T - lat_ref[0]).abs().max()) <= FWD_TOL
            for at, ar in zip(acts, refs):
                flips += _residuals_within(at, ar)
    print(f"{kernel} forward at {scenes} x {n}{' with x_last' if x_last else ''}: "
          f"{flips} flips at ReLU's edge")


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m,scale", [(9, 1, 777, 1.0), (9, 8, 777, 1.0), (6, 512, 4000, 1.0),
                                         (512, 1, 777, 1.0), (130, 300, 1001, 1e3),
                                         (512, 512, 12800, 1.0), (256, 262, 4096, 1e-3),
                                         (512, 512, 128000, 1.0)])
def test_cuda_weight_grad_matches_float64(k, n, m, scale):
    """The train backwards' weight-gradient reduction (split TF32 on the
    tensor cores) against float64 A @ B.T: narrow and odd shapes (K 9 or 6,
    N 1 or 8, m 777 and 1001, which are not multiples of 4, so the rows are
    unaligned), the padding's column and row halves, a backward's widths,
    scaled inputs, and a train step's 128,000 points (chunks cut to the
    kernel's longest).  Every entry within 1e-5 of |A_k| |B_n| (float32's own
    error over m terms is ~1e-7 of it; one TF32 pass errs by ~3e-4 / sqrt(m)
    of it), and the plain float32 product within the same bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(k * n + m)
    a = (torch.randn(k, m, generator=gen) * scale).cuda()
    b = torch.randn(n, m, generator=gen).cuda()
    before = weight_grad.launches
    c = weight_grad(a, b)
    torch.cuda.synchronize()
    assert weight_grad.launches == before + 1
    exact = a.double() @ b.double().T
    scale_kn = a.double().norm(dim=1)[:, None] * b.double().norm(dim=1)[None, :]
    err = (c.double() - exact).abs()
    assert c.shape == (k, n)
    assert bool((err <= 1e-5 * scale_kn).all()), float((err / scale_kn).max())
    plain = (weight_grad_reference(a, b).double() - exact).abs()
    assert bool((plain <= 1e-5 * scale_kn).all())


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,style,pfs,latent_in,dims,latent,m,x_last", [
    ("1encoder2decoder", "both", 9, (0, 2), (512,) * 4, 256, 8000, True),
    ("1encoder1decoder", "both", 9, (0, 2), (512,) * 4, 256, 4000, True),
    ("1encoder2decoder", "nerf", 63, (0, 2), (512,) * 4, 256, 4000, True),
    ("1encoder2decoder", "both", 9, (0, 2), (64,) * 4, 32, 388, True),
    ("1encoder2decoder", "both", 9, (2,), (64,) * 4, 32, 388, False)])
def test_cuda_generic_train_kernel_matches_plain(model_type, style, pfs, latent_in, dims, latent,
                                                 m, x_last):
    """K5 forward and backward on each trunk through the autograd Function,
    on materialized rows (the flagship with latent_in (0, 2) at full width,
    twin and combined (2 outputs), --point_size 63's NeRF rows of 319
    columns (a tail of 63 beside the 256-column head), and narrow
    flagships, x0 all head), TF32 off: y and x_last to 1e-5 abs against the
    plain forward, every gradient, d(x0) included (nonzero random dy and,
    with the classifier, dx_last on the first trunk), to 1e-4 of its largest
    entry against the plain backward fed the kernel's own residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    specs = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                  latent_size=latent, classifier_branch=x_last,
                  network_specs=NetworkSpecs(dims=dims, latent_in=latent_in))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        decoder = make_decoder(model_type, latent, pfs, style, specs.network_specs,
                               use_classifier=x_last).cuda()
    rows = (torch.randn(m, latent + pfs, generator=gen) * 0.5).cuda()
    st = make_generic_train_decoder(specs).statics
    first, second = trunk_prefixes(decoder)
    widths = trunk_input_widths(specs)
    if second is None:
        trunks = [(first, widths[0], rows, 5, 2)]
    else:
        xh, xo = separate_decoder_inputs(latent, style, rows)
        trunks = [(first, widths[0], xh, 5, 1), (second, widths[1], xo, 6, 1)]
    for t, (prefix, width, x0, seed, out_dim) in enumerate(trunks):
        with torch.no_grad():
            ws, xs, bs = generic_trunk_operands(decoder, prefix, width, specs, out_dim)
        x0 = x0.contiguous()
        leaves = [t_.detach().clone().requires_grad_() for t_ in [x0, *flatten_params(ws, xs, bs)]]
        fwd, bwd = generic_train_decode.launches, generic_train_decode_backward.launches
        y, xl = generic_train_decode(leaves[0], *unflatten_params(st, leaves[1:]), seed, st)
        dy = torch.randn(y.shape, generator=gen).cuda()
        dxl = torch.randn(xl.shape, generator=gen).cuda() if x_last and t == 0 else None
        grads = (torch.autograd.grad(y, leaves, dy) if dxl is None
                 else torch.autograd.grad((y, xl), leaves, (dy, dxl)))
        torch.cuda.synchronize()
        assert (generic_train_decode.launches,
                generic_train_decode_backward.launches) == (fwd + 1, bwd + 1)
        with torch.no_grad():
            y_ref, xl_ref = generic_train_decode_reference(x0, ws, xs, bs, seed, st)
            assert y.shape == y_ref.shape == (out_dim, m)
            assert float((y - y_ref).abs().max()) <= 1e-5
            assert float((xl - xl_ref).abs().max()) <= 1e-5
            y_k, acts = generic_train_decode_forward(pack_generic_trunk(x0, ws, xs, bs, st),
                                                     seed, st)
            acts = [a[:b.shape[-1]].T for a, b in zip(acts, bs)]
            dx0, dws, dxs, dbs = generic_train_decode_backward_reference(x0, ws, xs, bs, st, y_k,
                                                                         acts, dy, dxl)
        ref = [dx0, *flatten_params(dws, dxs, dbs)]
        assert len(ref) == len(grads)
        for g, r in zip(grads, ref):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= 1e-4 * (float(r.abs().max()) + 1e-12)


def _k7_tied(shape, gen):
    """Post-ReLU data with a flat block and a zero row: ties."""
    x = torch.relu(torch.randn(shape, generator=gen) - 0.3)
    x[:, :, 2:9, 1:7] = 0.5
    x[:, :, 0] = 0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (3, 64, 128, 128), (1, 5, 13, 10),
                                   (2, 5, 33, 31), (1, 3, 1, 7), (2, 4, 9, 1), (2, 65, 20, 18),
                                   (3, 5, 37, 29), (64, 64, 128, 128)])
def test_cuda_maxpool_matches_plain(shape, channels_last):
    """K7 on post-ReLU data with flat blocks and zero rows, NCHW or channels
    last, odd sizes, sizes of 1 and C % 4 != 0 (channels last's one-channel
    columns) included, and the train shape, where the backward's bands are
    13 output rows in channels last (they do not divide the 64) and 32 in
    NCHW: the forward bit for bit (also against F.max_pool2d),
    in x's layout, the gradient of the autograd path and of the backward
    kernel bit for bit equal to the plain backward (each sum has at most two
    nonzero terms, associated as the plain version does), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(7)
    x = _k7_tied(shape, gen)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = x.cuda().contiguous(memory_format=fmt).requires_grad_()
    fwd, bwd = maxpool_forward.launches, maxpool_backward.launches
    y = maxpool_k3s2p1(x)
    dy = torch.randn(y.shape, generator=gen).cuda()
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert (maxpool_forward.launches, maxpool_backward.launches) == (fwd + 1, bwd + 1)
    assert y.is_contiguous(memory_format=fmt) and dx.is_contiguous(memory_format=fmt)
    with torch.no_grad():
        y_ref = maxpool_reference(x)
        assert torch.equal(y, y_ref)
        assert torch.equal(y, torch.nn.functional.max_pool2d(x, 3, 2, 1))
        dx_ref = maxpool_backward_reference(x, y_ref, dy)
        assert torch.equal(dx, dx_ref)
        dx_k = maxpool_backward(x.detach(), y, dy.contiguous(memory_format=fmt))
        assert torch.equal(dx_k, dx_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["nchw", "channels_last", "channels_last_unaligned"])
def test_cuda_maxpool_backward_layouts_match_plain(layout):
    """K7's backward at (3, 64, 128, 128) and (2, 8, 63, 17), bit for bit
    equal to the plain backward, NCHW, channels last, and channels last from
    an address 4 bytes past a 16-byte boundary, which takes the one-channel
    columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(3)
    for shape in ((3, 64, 128, 128), (2, 8, 63, 17)):
        n, c, h, w = shape
        x = _k7_tied(shape, gen).cuda()
        if layout == "nchw":
            x = x.contiguous()
        else:
            flat = torch.empty(n * h * w * c + 1, device="cuda")
            base = flat[1:] if layout == "channels_last_unaligned" else flat[:-1]
            x = base.view(n, h, w, c).copy_(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
            assert x.is_contiguous(memory_format=torch.channels_last)
            assert (x.data_ptr() % 16 != 0) == (layout == "channels_last_unaligned")
        y = maxpool_reference(x)
        dy = torch.randn(y.shape, generator=gen).cuda().contiguous(
            memory_format=torch.contiguous_format if layout == "nchw" else torch.channels_last)
        dx = maxpool_backward(x, y, dy)
        torch.cuda.synchronize()
        assert torch.equal(dx, maxpool_backward_reference(x, y, dy))


def _bf16_close(out: torch.Tensor, ref: torch.Tensor, tight: float = 1e-5, loose: float = 2e-3,
                share: float = 0.9) -> None:
    """A bf16 kernel against its plain version: both round the same values
    to bf16, but their float32 sums run in other orders, so now and then a
    hidden unit rounds to the neighbouring bf16 value and the layers after it
    carry the step.  Within ``tight`` at ``share`` of the entries and within
    ``loose`` everywhere, both scaled by the reference's largest magnitude
    where it exceeds 1 (the logits).  Measured on an H100 (NVIDIA H100 80GB
    HBM3, 700 W): 96.2-98.8% within 1e-5, the SDFs' largest 4.9e-4, the
    x40 logits' 1.9e-3 of their largest."""
    scale = max(1.0, float(ref.abs().max()))
    err = (out - ref).abs() / scale
    print(f"bf16 kernel vs plain: {float((err <= tight).float().mean()):.5f} within {tight:g}, "
          f"max {float(err.max()):.3e}")
    assert float((err <= tight).float().mean()) >= share, float((err <= tight).float().mean())
    assert float(err.max()) <= loose, float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("pixel", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("num_class,model_type", [(0, "1encoder2decoder"),
                                                  (6, "1encoder2decoder"),
                                                  (6, "1encoder1decoder")])
def test_cuda_bf16_grid_kernels_match_plain(pixel, num_class, model_type):
    """K1 and K3 on bf16 plans (bf16 wgmma, csrc/wgmma_bf16.cuh) at the
    flagship width, with and without C = 6 and on a combined trunk: a run of
    30^3 - 20 points from base 7 against the plain bf16 version
    (``_bf16_close``), and within 5e-3 of the float32 kernel's SDF rows
    (JAX's own bf16 bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(10)
    n, base = 30, 7
    m = n ** 3 - base - 13
    if pixel:
        specs, ctx = _pixel_scene(model_type, max(num_class, 6), 256, (64, 64), gen, 10)
    else:
        specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9,
                      latent_size=256, mano_branch=True, object_pose_branch=True,
                      sdf_scale_factor=7.0, classifier_branch=True,
                      network_specs=NetworkSpecs(num_class=max(num_class, 6)))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(10)
            decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                                   use_classifier=True).cuda()
        ctx = {"decoder": decoder, "latent": torch.randn(1, 256, generator=gen).cuda(),
               "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
               "global_trans": _rigid(gen, 16).cuda(), "obj_trans": _rigid(gen, 1)[:, 0].cuda()}
    if num_class == 0:
        ctx["decoder"].classifier_head = None
    make, kernel, plain = ((make_pixel_grid_decode_fn, pixel_grid_decode,
                            pixel_grid_decode_reference) if pixel else
                           (make_grid_decode_fn, grid_decode, grid_decode_reference))
    args = (specs, n, False) if pixel else (specs, n)
    plan = make(*args, dtype=torch.bfloat16)(ctx).plan
    plan32 = make(*args)(ctx).plan
    assert plan.dtype == torch.bfloat16 and plan.n_rows == 2 + num_class
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    before, before32 = kernel.bf16_launches, kernel.launches
    out = kernel(plan, base, m, origin, voxel)
    torch.cuda.synchronize()
    assert kernel.bf16_launches == before + 1 and kernel.launches == before32
    ref = plain(plan, base, m, origin, voxel)
    assert out.shape == ref.shape == (2 + num_class, m) and bool(torch.isfinite(out).all())
    _bf16_close(out[:2], ref[:2])
    if num_class:  # the x40 head carries a flip 40 times over
        _bf16_close(out[2:], ref[2:], loose=5e-3)
    f32 = kernel(plan32, base, m, origin, voxel)
    assert 0 < float((out[:2] - f32[:2]).abs().max()) <= 5e-3


def _bf16_k1_plan(model_type, num_class, latent_in, n, seed):
    """A bf16 K1 plan at the flagship width (latent 256, 5 x 512 trunks with
    the latent re-entering at ``latent_in``) from seeded weights, with
    num_class class rows (head x40) or none, on the card."""
    gen = torch.Generator().manual_seed(seed)
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9,
                  latent_size=256, mano_branch=True, object_pose_branch=True,
                  sdf_scale_factor=7.0, classifier_branch=num_class > 0,
                  network_specs=NetworkSpecs(num_class=max(num_class, 1), latent_in=latent_in))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=num_class > 0).cuda()
    if num_class:
        with torch.no_grad():
            decoder.classifier_head.weight *= 40
    ctx = {"decoder": decoder, "latent": torch.randn(1, 256, generator=gen).cuda(),
           "rot_center": (torch.randn(1, 1, 3, generator=gen) * 0.05).cuda(),
           "global_trans": _rigid(gen, 16).cuda(), "obj_trans": _rigid(gen, 1)[:, 0].cuda()}
    return make_grid_decode_fn(specs, n, torch.bfloat16)(ctx).plan


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,num_class,latent_in", [
    ("1encoder2decoder", 0, (2,)), ("1encoder2decoder", 6, (2,)),
    ("1encoder2decoder", 126, (2,)), ("1encoder1decoder", 6, (2,)),
    ("1encoder2decoder", 0, (2, 4))], ids=["twin", "C6", "C126", "combined", "fin_xyz"])
def test_cuda_bf16_k1_kernel_matches_plain(model_type, num_class, latent_in):
    """K1's bf16 kernel (grid_bf16_kernel, csrc/grid_trunk_bf16_tc.cuh) at
    the flagship width on a run whose length is no multiple of 128 (nor of a
    cluster's 256 points) from a nonzero base: at 2 rows, at 2 + 6 and 2 +
    126, on a combined trunk and with a final-layer latent (fin_xyz), against
    the plain bf16 version (``_bf16_close``; logits 5e-3 of their largest);
    one bf16 launch and no float32 one; the launcher's plan is
    ``grid_bf16_plan``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alignsdf_torch.kernels.grid_decoder import (GB_CLUSTER, GB_P, grid_bf16_card_plan,
                                                     grid_bf16_plan)

    torch.backends.cuda.matmul.allow_tf32 = False
    n, base = 40, 123
    m = n ** 3 - base - 77
    assert m % GB_P and m % (GB_CLUSTER * GB_P)
    plan = _bf16_k1_plan(model_type, num_class, latent_in, n, 31)
    assert plan.n_rows == 2 + num_class
    assert any(f is not None for _, _, f in plan.trunks()) == (latent_in == (2, 4))
    card = grid_bf16_card_plan(plan, base, m)
    model = grid_bf16_plan(plan, m)
    assert (card["points_a_block"], card["cluster"], card["stream_bytes"]) == (
        model["points_a_block"], model["cluster"], model["stream_bytes"]), (card, model)
    assert card["grid_blocks"] <= model["cluster_tiles"] * GB_CLUSTER
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / (n - 1), device="cuda")
    before = grid_decode.bf16_launches, grid_decode.launches
    out = grid_decode(plan, base, m, origin, voxel)
    torch.cuda.synchronize()
    assert (grid_decode.bf16_launches, grid_decode.launches) == (before[0] + 1, before[1])
    ref = grid_decode_reference(plan, base, m, origin, voxel)
    assert out.shape == ref.shape == (2 + num_class, m) and bool(torch.isfinite(out).all())
    _bf16_close(out[:2], ref[:2])
    if num_class:
        _bf16_close(out[2:], ref[2:], loose=5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["offset", "width", "rows"])
def test_cuda_bf16_k1_refuses_a_plan(change):
    """A bf16 K1 plan the kernel does not take raises on the card (the
    launcher returns -1): a layer's tiles moved off the stream, a width past
    512, more than 128 rows; no launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    plan = _bf16_k1_plan("1encoder2decoder", 0, (2,), 16, 32)
    desc = plan.desc.copy()
    layer1 = 4 + 4 + 5  # trunk 0's layer 1: w, x, b, in_pad, out_pad
    if change == "offset":
        desc[layer1] += 4
    elif change == "width":
        desc[layer1 + 4] = 640
    else:
        desc[3] = 129
    bad = dataclasses.replace(plan, desc=desc)
    origin = torch.full((3,), -1.0, device="cuda")
    voxel = torch.tensor(2.0 / 15, device="cuda")
    before = grid_decode.bf16_launches, grid_decode.launches
    with pytest.raises(RuntimeError, match="plan rejected"):
        grid_decode(bad, 0, 1000, origin, voxel)
    assert (grid_decode.bf16_launches, grid_decode.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,style,pfs,latent_in,num_class,latent,m", [
    ("1encoder2decoder", "nerf", 63, (2,), 0, 256, 4101),
    ("1encoder1decoder", "nerf", 9, (2,), 6, 256, 3000),
    ("1encoder2decoder", "both", 9, (0, 2), 6, 256, 1000),
    ("1encoder2decoder", "nerf", 63, (0,), 0, 512, 2050),
    ("1encoder2decoder", "both", 9, (2,), 126, 256, 5000),
    ("1encoder2decoder", "nerf", 63, (2, 4), 0, 256, 3333)])
def test_cuda_bf16_generic_kernel_matches_plain(model_type, style, pfs, latent_in, num_class,
                                                latent, m):
    """K6's bf16 kernel (generic_bf16_kernel on csrc/grid_trunk_bf16_tc.cuh)
    with bf16 rows at full width, on runs whose length is no multiple of a
    cluster's 256 points: the --pallas config (layer 2's 528 rows, its last
    x0 step from registers), a combined trunk with a classifier, latent_in
    (0, 2) at C = 6, rows of 512 + 63 wider than the 512-row buffer, twin
    trunks at C = 126 and a latent input at the final layer (fin_lat, every
    x0 step of the final rows from registers); against the plain bf16
    version (``_bf16_close``) and within 5e-3 of the float32 kernel; one bf16
    launch and no float32 one; the launcher's plan is generic_bf16_plan's.
    Float32 rows on a bf16 plan are refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alignsdf_torch.kernels.generic_decoder import generic_bf16_card_plan, generic_bf16_plan

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(8)
    specs = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                  latent_size=latent, classifier_branch=bool(num_class),
                  network_specs=NetworkSpecs(latent_in=latent_in, num_class=num_class or 6))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(8)
        decoder = make_decoder(model_type, latent, pfs, style, specs.network_specs,
                               use_classifier=bool(num_class)).cuda()
    rows = (torch.randn(m, latent + pfs, generator=gen) * 0.5).cuda()
    plan = make_generic_plan(decoder, specs, torch.bfloat16)
    plan32 = make_generic_plan(decoder, specs)
    assert plan.lat_pad % 16 == 0 and m % 256
    assert any(f is not None for *_, f in plan.trunks()) == (latent_in == (2, 4))
    card, model = generic_bf16_card_plan(plan, m), generic_bf16_plan(plan, m)
    assert (card["points_a_block"], card["cluster"], card["stream_bytes"]) == (
        model["points_a_block"], model["cluster"], model["stream_bytes"]), (card, model)

    def split(r):
        return (r,) if model_type == "1encoder1decoder" else separate_decoder_inputs(latent,
                                                                                      style, r)
    with pytest.raises(ValueError):
        generic_decode(plan, *split(rows))
    before, before32 = generic_decode.bf16_launches, generic_decode.launches
    out = generic_decode(plan, *split(rows.to(torch.bfloat16)))
    torch.cuda.synchronize()
    assert generic_decode.bf16_launches == before + 1 and generic_decode.launches == before32
    ref = generic_decode_reference(plan, *split(rows.to(torch.bfloat16)))
    f32 = generic_decode(plan32, *split(rows))
    for i, (k, r, f) in enumerate(zip(out, ref, f32)):
        assert (k is None) == (r is None) == (f is None)
        if k is not None:
            assert k.dtype == torch.float32 and k.shape == r.shape
            _bf16_close(k, r)
            if i < 2:
                assert float((k - f).abs().max()) <= 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("change", ["offset", "width", "lat_pad"])
def test_cuda_bf16_generic_refuses_a_plan(change):
    """A bf16 K6 plan the kernel does not take raises on the card (the
    launcher returns -1): a layer's tiles moved off the stream, a width past
    512, an input-row width not a multiple of 16; no launch is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    specs = Specs(encode_style="nerf", point_feat_size=63, latent_size=256,
                  network_specs=NetworkSpecs())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        decoder = make_decoder("1encoder2decoder", 256, 63, "nerf", specs.network_specs).cuda()
    plan = make_generic_plan(decoder, specs, torch.bfloat16)
    desc = plan.desc.copy()
    layer1 = 5 + 4 + 6  # trunk 0's layer 1: w, x, lat, b, in_pad, out_pad
    if change == "offset":
        desc[layer1] += 4
    elif change == "width":
        desc[layer1 + 5] = 528
    else:
        desc[4] = 328
    bad = dataclasses.replace(plan, desc=desc)
    rows = torch.randn(1000, 319, device="cuda").to(torch.bfloat16)
    before = generic_decode.bf16_launches, generic_decode.launches
    with pytest.raises(RuntimeError, match="rejected"):
        generic_decode(bad, rows, rows)
    assert (generic_decode.bf16_launches, generic_decode.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,model_type,classifier", [(4, "1encoder2decoder", False),
                                                          (4, "1encoder2decoder", True),
                                                          (4, "1encoder1decoder", False),
                                                          (64, "1encoder2decoder", False)])
def test_cuda_bf16_train_kernel_matches_plain(scenes, model_type, classifier):
    """K2 in bf16 (bf16 wgmma forward, chain and reduction; bf16 residuals)
    at the flagship width on scenes x 2000 points, the twin, classifier
    (x_last / dx_last) and combined trunks, through the autograd Function:
    y against the plain bf16 forward (``_bf16_close``), x_last within 1e-5
    at >= 90% of the entries (and as a residual below), the
    residuals equal to the plain ones at >= 99.9% of the entries and within
    one bf16 step or 2e-3 elsewhere, every gradient within 2e-3 of its largest
    against the plain bf16 backward fed the kernel's residuals; the bf16
    launch counters move, the float32 ones do not; y within 5e-3 of the
    float32 kernel's (JAX's bf16 bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(12)
    n = 2000
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=256,
                  samples_per_scene=n, classifier_branch=classifier,
                  network_specs=NetworkSpecs(), compute_dtype="bfloat16")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(12)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=classifier).cuda()
    latent = (torch.randn(scenes, 256, generator=gen) * 0.5).cuda()
    emb = (torch.randn(scenes * n, 9, generator=gen) * 0.5).cuda()
    st = make_train_decoder(specs).statics
    assert st.dtype == torch.bfloat16
    first, second = trunk_prefixes(decoder)
    cols_h, cols_o = branch_columns(specs)
    trunks = ([(first, cols_h, 5, 1), (second, cols_o, 6, 1)] if second
              else [(first, cols_h, 5, 2)])
    for i, (prefix, cols, seed, out_dim) in enumerate(trunks):
        with torch.no_grad():
            ws, xs, bs = trunk_operands(decoder, prefix, len(cols), latent, specs, out_dim)
        e = emb[:, list(cols)].contiguous()
        leaves = [t.detach().clone().requires_grad_() for t in [e, *flatten_params(ws, xs, bs)]]
        counts = (train_decode.launches, train_decode_backward.launches,
                  train_decode.bf16_launches, train_decode_backward.bf16_launches)
        y, x_last = train_decode(leaves[0], *unflatten_params(st, leaves[1:]), seed, st)
        dy = torch.randn(y.shape, generator=gen).cuda()
        dxl = torch.randn(x_last.shape, generator=gen).cuda() if classifier and i == 0 else None
        grads = (torch.autograd.grad(y, leaves, dy) if dxl is None
                 else torch.autograd.grad((y, x_last), leaves, (dy, dxl)))
        torch.cuda.synchronize()
        assert (train_decode.launches, train_decode_backward.launches,
                train_decode.bf16_launches, train_decode_backward.bf16_launches) == (
                    counts[0], counts[1], counts[2] + 1, counts[3] + 1)
        assert y.dtype == x_last.dtype == torch.float32
        with torch.no_grad():
            acts_ref = []
            y_ref, x_ref = train_decode_reference(e, ws, xs, bs, seed, st, acts=acts_ref)
            _bf16_close(y, y_ref)
            assert float(((x_last - x_ref).abs() <= 1e-5).float().mean()) >= 0.9
            y_k, acts = train_decode_forward(pack_trunk(e, ws, xs, bs, st), seed, st)
            assert all(a.dtype == torch.bfloat16 for a in acts)
            acts = [a[:b.shape[-1]].T.float() for a, b in zip(acts, bs)]
            for a, r in zip(acts, acts_ref):
                assert float((a == r).float().mean()) >= 0.999
                assert bool(((a - r).abs() <= torch.clamp(
                    2.0 ** -7 * torch.maximum(a.abs(), r.abs()), min=2e-3)).all())
            demb, dws, dxs, dbs = train_decode_backward_reference(e, ws, xs, bs, st, y_k, acts, dy,
                                                                  dxl)
            y32, _ = train_decode(e, ws, xs, bs, seed, st._replace(dtype=torch.float32))
            assert 0 < float((y - y32).abs().max()) <= 5e-3
        for g, r in zip(grads, [demb, *flatten_params(dws, dxs, dbs)]):
            assert g.shape == r.shape and g.dtype == torch.float32
            assert float((g - r).abs().max()) <= 2e-3 * (float(r.abs().max()) + 1e-12)


def _bf16_trunks(model_type, classifier, scenes, n, seed):
    """The bf16 statics and [(emb columns, ws, xs, bs, seed)] of each trunk
    of a seeded decoder at the flagship width on scenes x n points."""
    gen = torch.Generator().manual_seed(seed)
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=256,
                  samples_per_scene=n, classifier_branch=classifier,
                  network_specs=NetworkSpecs(), compute_dtype="bfloat16")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        decoder = make_decoder(model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=classifier).cuda()
    latent = (torch.randn(scenes, 256, generator=gen) * 0.5).cuda()
    emb = (torch.randn(scenes * n, 9, generator=gen) * 0.5).cuda()
    first, second = trunk_prefixes(decoder)
    cols_h, cols_o = branch_columns(specs)
    out = []
    for prefix, cols, tseed, out_dim in ([(first, cols_h, 5, 1), (second, cols_o, 6, 1)] if second
                                         else [(first, cols_h, 5, 2)]):
        with torch.no_grad():
            ws, xs, bs = trunk_operands(decoder, prefix, len(cols), latent, specs, out_dim)
        out.append((emb[:, list(cols)].contiguous(), ws, xs, bs, tseed))
    return make_train_decoder(specs).statics, out, gen


# (scenes, points a scene): the step's shapes, and short scenes whose blocks
# of 64 points straddle scene boundaries (20, 36, 100: inside a warp's 16
# points too; 8: scenes inside one warp's points, M below a block), two of
# them with M % 8 == 4 (the io warps' 8-byte copies instead of bulk copies)
BF16_CHAIN_CASES = [(4, 2000, "1encoder2decoder", False), (4, 2000, "1encoder2decoder", True),
                    (4, 2000, "1encoder1decoder", False), (64, 2000, "1encoder2decoder", False),
                    (5, 36, "1encoder2decoder", True), (7, 20, "1encoder1decoder", False),
                    (6, 100, "1encoder2decoder", False), (3, 8, "1encoder2decoder", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,n,model_type,classifier", BF16_CHAIN_CASES)
def test_cuda_bf16_chain_matches_plain(scenes, n, model_type, classifier):
    """K2's bf16 backward (the chain of csrc/chain_bf16_tc.cuh with its db
    kernel, then the bf16 reductions) on the raw wrappers against the plain
    bf16 backward fed the kernel's residuals: every gradient, db and d(emb)
    included, within 2e-3 of its largest; the launcher's own plan equals
    ``chain_bf16_plan``'s; one bf16 backward launch a trunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alignsdf_torch.kernels.train_decoder import (CB_PLAN_KEYS, chain_bf16_card_plan,
                                                      chain_bf16_plan)

    torch.backends.cuda.matmul.allow_tf32 = False
    st, trunks, gen = _bf16_trunks(model_type, classifier, scenes, n, 24)
    for i, (e, ws, xs, bs, seed) in enumerate(trunks):
        p = pack_trunk(e, ws, xs, bs, st)
        y, acts = train_decode_forward(p, seed, st)
        dy = torch.randn(tuple(y.shape), generator=gen).cuda()
        dxl = (torch.randn((e.shape[0], bs[-2].shape[-1]), generator=gen).cuda()
               if classifier and i == 0 else None)
        plan = chain_bf16_plan(p.out_pads, e.shape[1], e.shape[0], n, st.scene_bias,
                               [x is not None for x in p.x],
                               0 if dxl is None else dxl.shape[1])
        card = chain_bf16_card_plan(p, st, y, acts, dy, dxl)
        assert card == {k: plan[k] for k in CB_PLAN_KEYS}, (card, plan)
        before = train_decode_backward.bf16_launches, train_decode_backward.launches
        demb, grads = train_decode_backward(p, st, y, acts, dy, dxl)
        torch.cuda.synchronize()
        assert (train_decode_backward.bf16_launches, train_decode_backward.launches) == (
            before[0] + 1, before[1])
        with torch.no_grad():
            res = [a[:b.shape[-1]].T.float() for a, b in zip(acts, bs)]
            d_ref, dws, dxs, dbs = train_decode_backward_reference(e, ws, xs, bs, st, y, res, dy,
                                                                   dxl)
        got = [demb, *[g[0][:w.shape[0], :w.shape[1]] for g, w in zip(grads, ws) if w is not None],
               *[g[1][:, :x.shape[1]] for g, x in zip(grads, xs) if x is not None],
               *[g[2][..., :b.shape[-1]] for g, b in zip(grads, bs)]]
        for g, r in zip(got, [d_ref, *[w for w in dws if w is not None],
                              *[x for x in dxs if x is not None], *dbs]):
            assert g.shape == r.shape
            assert float((g - r).abs().max()) <= 2e-3 * (float(r.abs().max()) + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,n", [(4, 2000), (5, 36)])
def test_cuda_bf16_chain_db_reproducible(scenes, n):
    """The bf16 chain's db and d(emb) take no atomics (csrc/chain_bf16_tc.cuh):
    two backwards on the same operands give them bit for bit, on whole
    scenes of 2000 points and on short scenes that straddle blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    st, trunks, gen = _bf16_trunks("1encoder2decoder", False, scenes, n, 25)
    e, ws, xs, bs, seed = trunks[0]
    p = pack_trunk(e, ws, xs, bs, st)
    y, acts = train_decode_forward(p, seed, st)
    dy = torch.randn(tuple(y.shape), generator=gen).cuda()
    runs = [train_decode_backward(p, st, y, acts, dy) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    for (_, _, db0), (_, _, db1) in zip(runs[0][1], runs[1][1]):
        assert torch.equal(db0, db1)



@pytest.mark.cuda
@pytest.mark.parametrize("scenes,n,model_type,classifier", BF16_CHAIN_CASES)
def test_cuda_bf16_fwd_matches_plain(scenes, n, model_type, classifier):
    """K2's bf16 forward (train_fwd_bf16_kernel, csrc/train_fwd_bf16_tc.cuh)
    on the raw wrapper against the plain bf16 forward, at the flagship
    width on the twin, classifier and combined trunks at 4 and 64 x 2000
    and on short scenes whose blocks straddle scenes (two with M % 8 == 4:
    the residuals copied by threads instead of TMA stores): y within 1e-5
    at >= 90% of the points and 2e-3 everywhere, the residuals (x_last the
    last) equal at >= 99.9% of the entries and elsewhere within one bf16
    step or 2e-3; the launcher's own plan equals ``train_fwd_bf16_plan``'s;
    one bf16 forward launch a trunk and none of the float32 kernel; y and
    the residuals bit for bit from run to run (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alignsdf_torch.kernels.train_decoder import (FB_PLAN_KEYS, fwd_bf16_card_plan,
                                                      train_fwd_bf16_plan)

    torch.backends.cuda.matmul.allow_tf32 = False
    st, trunks, _ = _bf16_trunks(model_type, classifier, scenes, n, 26)
    for e, ws, xs, bs, seed in trunks:
        p = pack_trunk(e, ws, xs, bs, st)
        plan = train_fwd_bf16_plan(p.out_pads, e.shape[1], e.shape[0], n, st.scene_bias,
                                   [x is not None for x in p.x])
        assert fwd_bf16_card_plan(p, st) == {k: plan[k] for k in FB_PLAN_KEYS}, plan
        assert plan["bulk"] == int(e.shape[0] % 8 == 0)
        before = train_decode.bf16_launches, train_decode.launches
        runs = [train_decode_forward(p, seed, st) for _ in range(2)]
        torch.cuda.synchronize()
        assert (train_decode.bf16_launches, train_decode.launches) == (before[0] + 2, before[1])
        (y, acts), (y2, acts2) = runs
        assert torch.equal(y, y2) and all(torch.equal(a, b) for a, b in zip(acts, acts2))
        assert all(a.dtype == torch.bfloat16 for a in acts)
        with torch.no_grad():
            acts_ref = []
            y_ref, _ = train_decode_reference(e, ws, xs, bs, seed, st, acts=acts_ref)
        _bf16_close(y, y_ref)
        _bf16_residuals_close([a[:b.shape[-1]].T.float() for a, b in zip(acts, bs)], acts_ref,
                              share=0.999)


def _bf16_residuals_close(acts, acts_ref, share: float = 0.995) -> None:
    """A bf16 kernel's residuals (bf16, unpadded, as float32) against the
    plain bf16 forward's: equal at >= ``share`` of the entries, elsewhere
    within one bf16 step of the larger value or 2e-3 (a unit that rounded
    to the neighbouring bf16 value, or flipped at ReLU's edge).  K4's and
    K5's first products are 256-512 deep on the tensor cores (K2's first
    layer sums 6 embedding columns on the CUDA cores), and their float32
    sums in another order than the plain version's round ~0.1-0.25% of the
    units to the neighbouring bf16 value."""
    shares = [float((a == r).float().mean()) for a, r in zip(acts, acts_ref)]
    print("bf16 residuals equal to the plain ones at " + ", ".join(f"{v:.5f}" for v in shares))
    for a, r, eq in zip(acts, acts_ref, shares):
        assert eq >= share, shares
        assert bool(((a - r).abs() <= torch.clamp(
            2.0 ** -7 * torch.maximum(a.abs(), r.abs()), min=2e-3)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scenes,model_type,classifier", [(4, "1encoder2decoder", False),
                                                          (4, "1encoder2decoder", True),
                                                          (2, "1encoder1decoder", True),
                                                          (64, "1encoder2decoder", False)])
def test_cuda_bf16_pixel_train_kernel_matches_plain(scenes, model_type, classifier):
    """K4 in bf16 (bf16 wgmma forward, chain and reduction; bf16 residuals,
    latent and table copy) at the --pa_feat flagship width (C = 256, a 64 x
    64 map, scenes x 2000 points, part of them outside the image) through
    the autograd Function, the twin, classifier (x_last / dx_last) and
    combined trunks: y against the plain bf16 forward (``_bf16_close``),
    x_last within 1e-5 at >= 90% of the entries, the latent and the
    residuals (``_bf16_residuals_close``), every gradient within 2e-3 of
    its largest against the plain bf16 backward fed the kernel's residuals
    (the sampling's, of the table, the mean, xp and yp, at >= 99.9% of the
    entries and within one bf16 step, 2^-7, of the largest elsewhere); the bf16
    launch counters move, the float32 ones do not (a bf16 statics on CUDA
    launches the bf16 kernels); y within 5e-3 of the float32 kernel's (JAX's
    bf16 bound)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(13)
    c, hw, n = 256, (64, 64), 2000
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9, latent_size=c,
                  pixel_align=True, samples_per_scene=n, sdf_scale_factor=7.0,
                  image_size=(256, 256), classifier_branch=classifier,
                  network_specs=NetworkSpecs(), compute_dtype="bfloat16")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(13)
        decoder = make_decoder(model_type, c, 9, "both", specs.network_specs,
                               use_classifier=classifier).cuda()
    m = scenes * n
    fmap = (torch.randn(scenes, c, *hw, generator=gen) * 0.5).cuda()
    emb = (torch.randn(m, 9, generator=gen) * 0.5).cuda()
    xyz = (torch.randn(m, 3, generator=gen) * 0.5).cuda()
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]).repeat(scenes, 1, 1)
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(scenes, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=hw)
    assert st.dtype == torch.bfloat16
    with torch.no_grad():
        table, mean, xp, yp, mask = pixel_train_inputs(fmap, xyz, cam.cuda(), root.cuda(), specs)
        trunks = pixel_trunks(decoder, specs, c)
    assert 0.0 < float(mask.mean()) < 1.0
    leaves = [t.detach().clone().requires_grad_()
              for t in (table, mean, xp, yp, emb, *flatten_pixel_params(trunks))]
    counts = (pixel_train_decode.launches, pixel_train_decode_backward.launches,
              pixel_train_decode.bf16_launches, pixel_train_decode_backward.bf16_launches)
    y, xl = pixel_train_decode(*leaves[:4], mask, leaves[4],
                               unflatten_pixel_params(st, leaves[5:]), 9, st)
    dy = torch.randn(y.shape, generator=gen).cuda()
    dxl = torch.randn(xl.shape, generator=gen).cuda() if classifier else None
    grads = (torch.autograd.grad(y, leaves, dy) if dxl is None
             else torch.autograd.grad((y, xl), leaves, (dy, dxl)))
    torch.cuda.synchronize()
    assert (pixel_train_decode.launches, pixel_train_decode_backward.launches,
            pixel_train_decode.bf16_launches, pixel_train_decode_backward.bf16_launches) == (
                counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert y.dtype == xl.dtype == torch.float32
    with torch.no_grad():
        acts_ref, lat_ref = [], []
        y_ref, xl_ref = pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks, 9,
                                                     st, acts=acts_ref, latent=lat_ref)
        _bf16_close(y, y_ref)
        assert float(((xl - xl_ref).abs() <= 1e-5).float().mean()) >= 0.9
        y_k, acts, lat = pixel_train_decode_forward(
            pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st), 9, st)
        assert lat.dtype == torch.bfloat16 and all(a.dtype == torch.bfloat16 for at in acts
                                                   for a in at)
        lat = lat[:c].T.float()
        acts = [[a[:b.shape[-1]].T.float() for a, b in zip(at, tr[3])]
                for at, tr in zip(acts, trunks)]
        _bf16_residuals_close([lat, *[a for at in acts for a in at]],
                              [lat_ref[0], *[r for ar in acts_ref for r in ar]])
        dtable, dmean, dxp, dyp, demb, g_ref = pixel_train_decode_backward_reference(
            table, mean, xp, yp, mask, emb, trunks, st, y_k, acts, lat, dy, dxl)
        y32, _ = pixel_train_decode(table, mean, xp, yp, mask, emb, trunks, 9,
                                    st._replace(dtype=torch.float32))
        assert 0 < float((y - y32).abs().max()) <= 5e-3
    ref = [dtable, dmean, dxp, dyp, demb, *flatten_pixel_params(g_ref)]
    assert len(ref) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert g.shape == r.shape and g.dtype == torch.float32
        err = (g - r).abs() / (float(r.abs().max()) + 1e-12)
        if i < 4:
            # the sampling's gradients read dlat rounded to bf16, which the
            # chain sums in another order than the plain backward: where one
            # point's dlat rounds to the neighbouring bf16 value, a table
            # entry it dominates moves by up to one bf16 step (measured on
            # an NVIDIA H100 80GB HBM3 at 700 W: d(table) 2.1e-3-2.8e-3 of
            # its largest)
            print(f"sampling gradient {i}: {float((err <= 2e-3).float().mean()):.6f} within "
                  f"2e-3 of the largest, max {float(err.max()):.3e}")
            assert float((err <= 2e-3).float().mean()) >= 0.999
            assert float(err.max()) <= 2.0 ** -7
        else:
            assert float(err.max()) <= 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,style,pfs,m,classifier", [
    ("1encoder2decoder", "both", 9, 8000, True),
    ("1encoder1decoder", "both", 9, 4000, True),
    ("1encoder2decoder", "nerf", 63, 4000, False),
    ("1encoder2decoder", "both", 9, 128000, False)])
def test_cuda_bf16_generic_train_kernel_matches_plain(model_type, style, pfs, m, classifier):
    """K5 in bf16 (bf16 wgmma forward, chain and reduction; bf16 residuals;
    layer 0's two weights rounded apart, the head read twice) on the
    flagship with latent_in (0, 2) at full width, twin (rows of 256 + 6),
    combined (265) and --point_size 63 (319: a tail of 63), through the
    autograd Function: y (``_bf16_close``), x_last, the residuals
    (``_bf16_residuals_close``) and every gradient, d(x0) included, within
    2e-3 of its largest against the plain bf16 backward fed the kernel's
    residuals; the bf16 counters move, the float32 ones do not; y within
    5e-3 of the float32 kernel on the float32 plan's operands."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(17)
    ns = NetworkSpecs(latent_in=(0, 2))
    specs = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                  latent_size=256, classifier_branch=classifier, network_specs=ns,
                  compute_dtype="bfloat16")
    specs32 = Specs(model_type=model_type, encode_style=style, point_feat_size=pfs,
                    latent_size=256, classifier_branch=classifier, network_specs=ns)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(17)
        decoder = make_decoder(model_type, 256, pfs, style, ns, use_classifier=classifier).cuda()
    rows = (torch.randn(m, 256 + pfs, generator=gen) * 0.5).cuda()
    st = make_generic_train_decoder(specs).statics
    st32 = make_generic_train_decoder(specs32).statics
    assert st.dtype == torch.bfloat16 and st32.dtype == torch.float32
    first, second = trunk_prefixes(decoder)
    widths = trunk_input_widths(specs)
    if second is None:
        trunks = [(first, widths[0], rows, 5, 2)]
    else:
        xh, xo = separate_decoder_inputs(256, style, rows)
        trunks = [(first, widths[0], xh, 5, 1), (second, widths[1], xo, 6, 1)]
    for t, (prefix, width, x0, seed, out_dim) in enumerate(trunks):
        with torch.no_grad():
            ws, xs, bs = generic_trunk_operands(decoder, prefix, width, specs, out_dim)
            ws32, xs32, bs32 = generic_trunk_operands(decoder, prefix, width, specs32, out_dim)
        assert xs[0].shape[0] == 2 * x0.shape[1]  # the pair, stacked
        x0 = x0.contiguous()
        leaves = [v.detach().clone().requires_grad_() for v in [x0, *flatten_params(ws, xs, bs)]]
        counts = (generic_train_decode.launches, generic_train_decode_backward.launches,
                  generic_train_decode.bf16_launches, generic_train_decode_backward.bf16_launches)
        y, xl = generic_train_decode(leaves[0], *unflatten_params(st, leaves[1:]), seed, st)
        dy = torch.randn(y.shape, generator=gen).cuda()
        dxl = torch.randn(xl.shape, generator=gen).cuda() if classifier and t == 0 else None
        grads = (torch.autograd.grad(y, leaves, dy) if dxl is None
                 else torch.autograd.grad((y, xl), leaves, (dy, dxl)))
        torch.cuda.synchronize()
        assert (generic_train_decode.launches, generic_train_decode_backward.launches,
                generic_train_decode.bf16_launches,
                generic_train_decode_backward.bf16_launches) == (counts[0], counts[1],
                                                                 counts[2] + 1, counts[3] + 1)
        with torch.no_grad():
            acts_ref = []
            y_ref, xl_ref = generic_train_decode_reference(x0, ws, xs, bs, seed, st,
                                                           acts=acts_ref)
            _bf16_close(y, y_ref)
            assert float(((xl - xl_ref).abs() <= 1e-5).float().mean()) >= 0.9
            pack = pack_generic_trunk(x0, ws, xs, bs, st)
            assert pack.twice
            y_k, acts = generic_train_decode_forward(pack, seed, st)
            assert all(a.dtype == torch.bfloat16 for a in acts)
            acts = [a[:b.shape[-1]].T.float() for a, b in zip(acts, bs)]
            _bf16_residuals_close(acts, acts_ref)
            dx0, dws, dxs, dbs = generic_train_decode_backward_reference(x0, ws, xs, bs, st, y_k,
                                                                         acts, dy, dxl)
            y32, _ = generic_train_decode(x0, ws32, xs32, bs32, seed, st32)
            assert 0 < float((y - y32).abs().max()) <= 5e-3
        ref = [dx0, *flatten_params(dws, dxs, dbs)]
        assert len(ref) == len(grads)
        for g, r in zip(grads, ref):
            assert g.shape == r.shape and g.dtype == torch.float32
            assert float((g - r).abs().max()) <= 2e-3 * (float(r.abs().max()) + 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (1, 5, 13, 10), (2, 65, 20, 18),
                                   (3, 5, 37, 29), (64, 64, 128, 128)])
def test_cuda_bf16_maxpool_matches_plain(shape, channels_last):
    """K7 on bf16: the forward and the backward (dy1 and dx rounded to bf16)
    bit for bit against the plain versions, in x's layout and dtype, the
    forward also against F.max_pool2d; the bf16 counters move, not the
    float32 ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(8)
    x = _k7_tied(shape, gen).to(torch.bfloat16)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = x.cuda().contiguous(memory_format=fmt).requires_grad_()
    counts = (maxpool_forward.launches, maxpool_backward.launches,
              maxpool_forward.bf16_launches, maxpool_backward.bf16_launches)
    y = maxpool_k3s2p1(x)
    dy = torch.randn(y.shape, generator=gen).to(torch.bfloat16).cuda()
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert (maxpool_forward.launches, maxpool_backward.launches, maxpool_forward.bf16_launches,
            maxpool_backward.bf16_launches) == (counts[0], counts[1], counts[2] + 1, counts[3] + 1)
    assert y.dtype == dx.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=fmt) and dx.is_contiguous(memory_format=fmt)
    with torch.no_grad():
        y_ref = maxpool_reference(x)
        assert torch.equal(y, y_ref)
        assert torch.equal(y, torch.nn.functional.max_pool2d(x, 3, 2, 1))
        assert torch.equal(dx, maxpool_backward_reference(x, y_ref, dy))


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m", [(9, 1, 8000), (6, 512, 4004), (512, 512, 20000),
                                   (256, 250, 4004)])
def test_cuda_bf16_weight_grad_matches_float64(k, n, m):
    """The reduction's bf16 route (K2's bf16 backward): bf16 operands, their
    exact products summed in float32, against float64, to 1e-5 of the
    largest entry; m % 8 == 4 takes the 8-byte copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(3)
    a = torch.randn(k, m, generator=gen).to(torch.bfloat16).cuda()
    b = torch.randn(n, m, generator=gen).to(torch.bfloat16).cuda()
    before = weight_grad.bf16_launches
    c = weight_grad(a, b)
    torch.cuda.synchronize()
    assert weight_grad.bf16_launches == before + 1
    ref = a.double() @ b.double().T
    assert float((c.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert torch.equal(weight_grad_reference(a.cpu(), b.cpu()), a.cpu().float() @ b.cpu().float().T)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,m,prior", [(512, 512, 128000, False), (9, 512, 128000, False),
                                         (512, 2, 128000, False), (512, 512, 128000, True),
                                         (256, 262, 4004, True), (6, 512, 20004, False)])
def test_cuda_bf16_weight_grad_step_shapes(k, n, m, prior):
    """The bf16 route at a train step's shapes (a hidden layer, the
    embedding's dX, the final layer; 64 x 2000 points, the kernel's longest
    chunks and its clusters) against float64, every entry within 1e-6 of
    |A_k| |B_n| (a tenth of test_cuda_weight_grad_matches_float64's bound
    at 128,000 points: C rounded to bf16 would miss it); with ``prior``,
    ``out`` already holds a sum; m % 8 == 4 rows, which TMA cannot
    describe, take the producer's own copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(k + n + m)
    a = torch.relu(torch.randn(k, m, generator=gen)).to(torch.bfloat16).cuda()
    b = torch.randn(n, m, generator=gen).to(torch.bfloat16).cuda()
    start = (torch.randn(k, n, generator=gen) * 10.0 if prior else torch.zeros(k, n)).cuda()
    out = start.clone()
    before = weight_grad.bf16_launches
    c = weight_grad(a, b, out=out)
    torch.cuda.synchronize()
    assert c is out and weight_grad.bf16_launches == before + 1
    exact = start.double() + a.double() @ b.double().T
    scale_kn = a.double().norm(dim=1)[:, None] * b.double().norm(dim=1)[None, :]
    err = (c.double() - exact).abs()
    assert bool((err <= 1e-6 * scale_kn + 1e-6 * start.double().abs()).all()), \
        float((err / scale_kn).max())


@pytest.mark.cuda
def test_cuda_bf16_weight_grads_run():
    """A run of a step's reductions launched as a backward launches them
    (weight_grads: each after the first overlaps the one before), over
    128,000 points, one into an ``out`` holding a sum: every entry within
    1e-6 of |A_k| |B_n| of float64, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = 128000
    gen = torch.Generator().manual_seed(23)
    shapes = [(512, 512), (512, 512), (9, 512), (512, 2), (262, 512), (512, 512)]
    pairs = [(torch.relu(torch.randn(k, m, generator=gen)).to(torch.bfloat16).cuda(),
              torch.randn(n, m, generator=gen).to(torch.bfloat16).cuda()) for k, n in shapes]
    prior = (torch.randn(9, 512, generator=gen) * 10.0).cuda()
    outs = [None, None, prior.clone(), None, None, None]
    before = weight_grad.bf16_launches
    cs = weight_grads(pairs, outs)
    torch.cuda.synchronize()
    assert weight_grad.bf16_launches == before + len(shapes) and cs[2] is outs[2]
    for i, ((a, b), c) in enumerate(zip(pairs, cs)):
        start = prior.double() if i == 2 else torch.zeros((), dtype=torch.float64, device="cuda")
        exact = start + a.double() @ b.double().T
        scale_kn = a.double().norm(dim=1)[:, None] * b.double().norm(dim=1)[None, :]
        err = (c.double() - exact).abs()
        assert bool((err <= 1e-6 * scale_kn + 1e-6 * start.abs()).all()), \
            (i, float((err / scale_kn).max()))


def _final_latent_grads_close(grads, ref, bf16: bool, sampling: int = 0) -> None:
    """Every gradient against the plain backward fed the kernel's residuals:
    float32 within 1e-4 of its largest entry, bf16 within 2e-3; a bf16
    K4's first ``sampling`` (of the table, the mean, xp and yp) within 2e-3
    at >= 99.9% of the entries and one bf16 step, 2^-7, of the largest
    everywhere (test_cuda_bf16_pixel_train_kernel_matches_plain's bounds)."""
    assert len(ref) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref)):
        assert g.shape == r.shape and g.dtype == torch.float32
        err = (g - r).abs() / (float(r.abs().max()) + 1e-12)
        if not bf16:
            assert float(err.max()) <= 1e-4, (i, float(err.max()))
        elif i < sampling:
            assert float((err <= 2e-3).float().mean()) >= 0.999
            assert float(err.max()) <= 2.0 ** -7
        else:
            assert float(err.max()) <= 2e-3, (i, float(err.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,latent_in", [("K2", (2, 4)), ("K5", (0, 2, 4))])
def test_cuda_final_latent_trunk_kernels_match_plain(kernel, latent_in, dtype):
    """K2 (latent_in (2, 4)) and K5 ((0, 2, 4)) with the final layer's
    re-injection, at the flagship width on 4 x 2000 points, through the
    autograd Function with a random dx_last on the hand trunk: y against
    the plain forward (float32 1e-5 abs; bf16 ``_bf16_close``), every
    gradient against the plain backward fed the kernel's residuals
    (``_final_latent_grads_close``), the final layer's inject weights and
    (K2) scene table among them; the dtype's launch counters move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(21)
    scenes, n = 4, 2000
    bf16 = dtype == "bfloat16"
    specs = Specs(encode_style="both", point_feat_size=9, latent_size=256, samples_per_scene=n,
                  classifier_branch=True, compute_dtype=dtype,
                  network_specs=NetworkSpecs(latent_in=latent_in))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(21)
        decoder = make_decoder(specs.model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=True).cuda()
    latent = (torch.randn(scenes, 256, generator=gen) * 0.5).cuda()
    emb = (torch.randn(scenes * n, 9, generator=gen) * 0.5).cuda()
    if kernel == "K2":
        st = make_train_decoder(specs).statics
        fwd_fn, bwd_fn, plain, plain_bwd, pack, forward = (
            train_decode, train_decode_backward, train_decode_reference,
            train_decode_backward_reference, pack_trunk, train_decode_forward)
        with torch.no_grad():
            trunks = [(e, *trunk_operands(decoder, prefix, len(cols), latent, specs, 1))
                      for prefix, cols, e in ((p, c, emb[:, list(c)].contiguous()) for p, c in
                                              zip(trunk_prefixes(decoder),
                                                  branch_columns(specs)))]
        assert st.scene_bias[-1] and st.has_x[-1]
    else:
        st = make_generic_train_decoder(specs).statics
        fwd_fn, bwd_fn, plain, plain_bwd, pack, forward = (
            generic_train_decode, generic_train_decode_backward, generic_train_decode_reference,
            generic_train_decode_backward_reference, pack_generic_trunk,
            generic_train_decode_forward)
        rows = torch.cat([latent.repeat_interleave(n, dim=0), emb], dim=1)
        with torch.no_grad():
            trunks = [(x0.contiguous(), *generic_trunk_operands(decoder, prefix, width, specs, 1))
                      for prefix, width, x0 in zip(trunk_prefixes(decoder),
                                                   trunk_input_widths(specs),
                                                   separate_decoder_inputs(256, "both", rows))]
        assert st.has_x[-1]
    attr = "bf16_launches" if bf16 else "launches"
    for i, (e, ws, xs, bs) in enumerate(trunks):
        assert xs[-1] is not None
        leaves = [t.detach().clone().requires_grad_() for t in [e, *flatten_params(ws, xs, bs)]]
        counts = getattr(fwd_fn, attr), getattr(bwd_fn, attr)
        y, xl = fwd_fn(leaves[0], *unflatten_params(st, leaves[1:]), 5 + i, st)
        dy = torch.randn(y.shape, generator=gen).cuda()
        dxl = torch.randn(xl.shape, generator=gen).cuda() if i == 0 else None
        grads = (torch.autograd.grad(y, leaves, dy) if dxl is None
                 else torch.autograd.grad((y, xl), leaves, (dy, dxl)))
        torch.cuda.synchronize()
        assert (getattr(fwd_fn, attr), getattr(bwd_fn, attr)) == (counts[0] + 1, counts[1] + 1)
        with torch.no_grad():
            y_ref, _ = plain(e, ws, xs, bs, 5 + i, st)
            if bf16:
                _bf16_close(y, y_ref)
            else:
                assert float((y - y_ref).abs().max()) <= 1e-5
            y_k, acts = forward(pack(e, ws, xs, bs, st), 5 + i, st)
            acts = [a[:b.shape[-1]].T.float() for a, b in zip(acts, bs)]
            d_in, dws, dxs, dbs = plain_bwd(e, ws, xs, bs, st, y_k, acts, dy, dxl)
        assert float(dxs[-1].abs().max()) > 0
        _final_latent_grads_close(grads, [d_in, *flatten_params(dws, dxs, dbs)], bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_final_latent_pixel_train_kernel_matches_plain(dtype):
    """K4 with latent_in (2, 4) at the --pa_feat flagship width (C = 256, a
    64 x 64 map, 4 x 2000 points, part of them outside the image) through
    the autograd Function with a random dx_last: y against the plain
    forward (float32 1e-5 abs; bf16 ``_bf16_close``), every gradient (the
    final layer's latent and embedding weights, d(table), d(mean), d(xp),
    d(yp) among them) against the plain backward fed the kernel's
    residuals; the dtype's launch counters move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(22)
    c, hw, scenes, n = 256, (64, 64), 4, 2000
    bf16 = dtype == "bfloat16"
    specs = Specs(encode_style="both", point_feat_size=9, latent_size=c, pixel_align=True,
                  samples_per_scene=n, sdf_scale_factor=7.0, image_size=(256, 256),
                  classifier_branch=True, compute_dtype=dtype,
                  network_specs=NetworkSpecs(latent_in=(2, 4)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(22)
        decoder = make_decoder(specs.model_type, c, 9, "both", specs.network_specs,
                               use_classifier=True).cuda()
    m = scenes * n
    fmap = (torch.randn(scenes, c, *hw, generator=gen) * 0.5).cuda()
    emb = (torch.randn(m, 9, generator=gen) * 0.5).cuda()
    xyz = (torch.randn(m, 3, generator=gen) * 0.5).cuda()
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]).repeat(scenes, 1, 1)
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(scenes, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=hw)
    assert st.has_x[-1]
    with torch.no_grad():
        table, mean, xp, yp, mask = pixel_train_inputs(fmap, xyz, cam.cuda(), root.cuda(), specs)
        trunks = pixel_trunks(decoder, specs, c)
    assert 0.0 < float(mask.mean()) < 1.0
    leaves = [t.detach().clone().requires_grad_()
              for t in (table, mean, xp, yp, emb, *flatten_pixel_params(trunks))]
    attr = "bf16_launches" if bf16 else "launches"
    counts = getattr(pixel_train_decode, attr), getattr(pixel_train_decode_backward, attr)
    y, xl = pixel_train_decode(*leaves[:4], mask, leaves[4],
                               unflatten_pixel_params(st, leaves[5:]), 9, st)
    dy = torch.randn(y.shape, generator=gen).cuda()
    dxl = torch.randn(xl.shape, generator=gen).cuda()
    grads = torch.autograd.grad((y, xl), leaves, (dy, dxl))
    torch.cuda.synchronize()
    assert (getattr(pixel_train_decode, attr),
            getattr(pixel_train_decode_backward, attr)) == (counts[0] + 1, counts[1] + 1)
    with torch.no_grad():
        y_ref, _ = pixel_train_decode_reference(table, mean, xp, yp, mask, emb, trunks, 9, st)
        if bf16:
            _bf16_close(y, y_ref)
        else:
            assert float((y - y_ref).abs().max()) <= 1e-5
        y_k, acts, lat = pixel_train_decode_forward(
            pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st), 9, st)
        acts = [[a[:b.shape[-1]].T.float() for a, b in zip(at, tr[3])]
                for at, tr in zip(acts, trunks)]
        dtable, dmean, dxp, dyp, demb, g_ref = pixel_train_decode_backward_reference(
            table, mean, xp, yp, mask, emb, trunks, st, y_k, acts, lat[:c].T.float(), dy, dxl)
    assert all(float(g[1][-1].abs().max()) > 0 for g in g_ref)  # dLat of the final layers
    _final_latent_grads_close(grads, [dtable, dmean, dxp, dyp, demb,
                                      *flatten_pixel_params(g_ref)], bf16, sampling=4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_final_latent_k3_matches_plain(dtype):
    """K3 on a --pa_feat plan with latent_in (2, 4), whose final rows read
    the latent (fin_lat), with a classifier at C = 6 (head x40), over a 64^3
    grid part of which projects outside the image: against its plain
    version (float32 1e-4 abs; bf16 ``_bf16_close``, the logits to 5e-3 of
    their largest); without the final latent term the field moves (the
    term is live)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(23)
    specs, ctx = _pixel_scene("1encoder2decoder", 6, 256, (64, 64), gen, 23)
    specs = dataclasses.replace(specs, network_specs=dataclasses.replace(
        specs.network_specs, latent_in=(2, 4)))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(23)
        decoder = make_decoder(specs.model_type, 256, 9, "both", specs.network_specs,
                               use_classifier=True).cuda()
    with torch.no_grad():
        decoder.classifier_head.weight *= 40
    ctx["decoder"] = decoder
    n = 64
    dtype_t = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    plan = make_pixel_grid_decode_fn(specs, n, False, dtype_t)(ctx).plan
    assert all(f is not None for f in plan.fin_lats())
    origin, voxel = torch.full((3,), -1.0).cuda(), torch.tensor(2.0 / (n - 1)).cuda()
    attr = "bf16_launches" if dtype == "bfloat16" else "launches"
    before = getattr(pixel_grid_decode, attr)
    out = pixel_grid_decode(plan, 0, n ** 3, origin, voxel)
    torch.cuda.synchronize()
    assert getattr(pixel_grid_decode, attr) == before + 1
    ref = pixel_grid_decode_reference(plan, 0, n ** 3, origin, voxel)
    share = float(pixel_projection(plan, 0, n ** 3, origin, voxel)[3].float().mean())
    assert 0.0 < share < 1.0
    if dtype == "bfloat16":  # test_cuda_bf16_grid_kernels_match_plain's bounds
        _bf16_close(out[:2], ref[:2])
        _bf16_close(out[2:], ref[2:], loose=5e-3)
    else:
        assert float((out - ref).abs().max()) <= 1e-4
    bare = dataclasses.replace(plan, flat=plan.flat.clone())
    for f in bare.fin_lats():
        f.zero_()
    assert float((pixel_grid_decode(bare, 0, n ** 3, origin, voxel)[:2] - out[:2]).abs().max()) \
        > 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dims,c,hw,scenes,n,spread,band,order", [
    ("float32", (64,) * 4, 32, (16, 16), 3, 96, 0.1, 12, "sorted"),
    ("float32", (512,) * 4, 256, (64, 64), 4, 2000, 0.5, 32, "sorted"),
    ("float32", (512,) * 4, 256, (64, 64), 4, 2000, 0.5, 32, "unsorted"),
    ("bfloat16", (512,) * 4, 256, (64, 64), 4, 2000, 0.5, 32, "sorted")])
def test_cuda_pixel_band_matches_plain(dtype, dims, c, hw, scenes, n, spread, band, order):
    """K4's banded backward (its tap stage's shared-memory window) on points
    sorted by the kernel's own yp, as the plan's device sort gives them (so
    that every scene segment of every 64-point tile fits: 96-point scenes
    put two in some tiles; ``spread`` scales the points about the hand
    root), and unsorted (the per-tap fallback): each
    tile's window count equal to tile_band_bounds'; every gradient against
    the plain backward fed the kernel's residuals (float32: 1e-4 of the
    largest; bf16 as test_cuda_bf16_pixel_train_kernel_matches_plain), and
    against the unbanded kernel on the same residuals within 1e-5 of the
    largest (the same terms, summed in another order); the banded counters
    move, the others do not; the window's limit agrees with the library's,
    and at the flagship's map a band one row over it raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alignsdf_torch.kernels.pixel_train_decoder import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(17)
    bf16 = dtype == "bfloat16"
    specs = Specs(model_type="1encoder2decoder", encode_style="both", point_feat_size=9,
                  latent_size=c, pixel_align=True, samples_per_scene=n, sdf_scale_factor=7.0,
                  image_size=(256, 256), network_specs=NetworkSpecs(dims=dims),
                  compute_dtype=dtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(17)
        decoder = make_decoder(specs.model_type, c, 9, "both", specs.network_specs).cuda()
    m = scenes * n
    fmap = (torch.randn(scenes, c, *hw, generator=gen) * 0.5).cuda()
    emb = (torch.randn(m, 9, generator=gen) * 0.5).cuda()
    xyz = (torch.randn(m, 3, generator=gen) * spread).cuda()
    cam = torch.tensor([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]).repeat(scenes, 1, 1)
    root = torch.tensor([[[0.01, -0.02, 0.6]]]).repeat(scenes, 1, 1)
    st = make_pixel_train_decoder(specs).statics._replace(feat_hw=hw)
    for wf, cc in ((hw[1], c), (16, 32), (64, 256), (24, 256)):
        assert _lib().pixel_train_band_rows_max(wf, _round_pad(cc), int(bf16)) == band_rows_max(
            wf, cc)
    with torch.no_grad():
        table, mean, xp, yp, mask = pixel_train_inputs(fmap, xyz, cam.cuda(), root.cuda(), specs)
        if order == "sorted":
            perm, _ = sort_by_row(yp, mask, scenes)
            xp, yp, mask, emb = xp[perm], yp[perm], mask[perm], emb[perm]
        trunks = pixel_trunks(decoder, specs, c)
        packed = pack_pixel_trunks(table, mean, xp, yp, mask, emb, trunks, st)
        y, acts, lat = pixel_train_decode_forward(packed, 9, st)
        dy = torch.randn(y.shape, generator=gen).cuda()
        counts = {k: getattr(pixel_train_decode_backward, k) for k in (
            "launches", "bf16_launches", "band_launches", "band_bf16_launches")}
        tiles = -(-m // 64)
        fit = torch.full((tiles,), -1, dtype=torch.int32, device="cuda")
        banded = pixel_train_decode_backward(packed, st._replace(band=band), y, acts, lat, dy,
                                             tile_fit=fit)
        unbanded = pixel_train_decode_backward(packed, st, y, acts, lat, dy)
        torch.cuda.synchronize()
        key = "bf16_launches" if bf16 else "launches"
        counts[key] += 1
        counts["band_" + key] += 1
        assert counts == {k: getattr(pixel_train_decode_backward, k) for k in counts}
        tile, _, _, fits, live = tile_band_bounds(yp, mask, n, hw[0], band)
        want = torch.zeros(tiles, dtype=torch.int32, device="cuda").index_add_(
            0, tile, fits.to(torch.int32))
        assert torch.equal(fit, want)
        taken, segments = int(fits.sum()), int(live.sum())
        print(f"{dtype} {order}: {taken} of {segments} live segments took the window")
        if order == "sorted":
            assert taken == segments > tiles // 2
        else:
            assert taken < segments
        acts_u = [[a[:b.shape[-1]].T.float() for a, b in zip(at, tr[3])]
                  for at, tr in zip(acts, trunks)]
        ref = pixel_train_decode_backward_reference(
            table, mean, xp, yp, mask, emb, trunks, st, y, acts_u, lat[:c].T.float(), dy)
        most = band_rows_max(hw[1], c)
        if most < hw[0]:  # the flagship's map: the window holds fewer than its rows
            with pytest.raises(ValueError, match=f"at most {most} rows"):
                pixel_train_decode_backward(packed, st._replace(band=most + 1), y, acts, lat, dy)
    # the kernel's gradients (padded, per layer) in flatten_pixel_params' order
    kernel = lambda g: [*g[:5], *[t for layers in g[5] for group in zip(*layers)  # noqa: E731
                                  for t in group if t is not None]]
    plain = [*ref[:5], *flatten_pixel_params(ref[5])]
    assert len(plain) == len(kernel(banded)) == len(kernel(unbanded))
    for i, (g, u, r) in enumerate(zip(kernel(banded), kernel(unbanded), plain)):
        g, u = (t[tuple(slice(0, k) for k in r.shape)] for t in (g, u))
        scale = float(r.abs().max()) + 1e-12
        assert float((g - u).abs().max()) <= 1e-5 * scale, i
        err = (g - r).abs() / scale
        if not bf16:
            assert float(err.max()) <= 1e-4, i
        elif i < 4:  # the sampling's gradients: see test_cuda_bf16_pixel_train_kernel_matches_plain
            assert float((err <= 2e-3).float().mean()) >= 0.999 and float(err.max()) <= 2.0 ** -7
        else:
            assert float(err.max()) <= 2e-3, i


def _round_pad(c: int) -> int:
    return -(-c // 256) * 256
