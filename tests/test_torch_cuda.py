"""Kernels K1, K2, K3, K4, K5, K6 and K7 on the card against their plain
versions (K1, K3 and K6 with the classifier's rows, K2, K4 and K5 with
x_last / dx_last, K7 forward and backward on tied inputs).  Needs a CUDA GPU and skips without one; it imports no
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

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
    flatten_pixel_params,
    pack_pixel_trunks,
    pixel_train_decode,
    pixel_train_decode_backward,
    pixel_train_decode_backward_reference,
    pixel_train_decode_forward,
    pixel_train_decode_reference,
    unflatten_pixel_params,
)
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
    ("1encoder2decoder", "hand", 51, (0, 4), 0, (128,) * 4, 32, 777)])
def test_cuda_generic_kernel_matches_plain(model_type, style, pfs, latent_in, num_class, dims,
                                           latent, m):
    """K6 on materialized rows: NeRF PE at point_size 63 (the --pallas
    config at full width), the combined trunk with a classifier, twin trunks
    at C = 6 with latent_in (0, 2), and a narrow trunk with a latent input at
    the final layer whose object rows are a strided view; ragged row counts.
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


@pytest.mark.cuda
@pytest.mark.parametrize("model_type,latent_in,dims,latent,m,x_last", [
    ("1encoder2decoder", (0, 2), (512,) * 4, 256, 8000, True),
    ("1encoder1decoder", (0, 2), (512,) * 4, 256, 4000, True),
    ("1encoder2decoder", (2,), (64,) * 4, 32, 388, False)])
def test_cuda_generic_train_kernel_matches_plain(model_type, latent_in, dims, latent, m, x_last):
    """K5 forward and backward on each trunk through the autograd Function,
    on materialized rows (the flagship with latent_in (0, 2) at full width,
    twin and combined, and a narrow flagship), TF32 off: y and x_last to
    1e-5 abs against the plain forward, every gradient, d(x0) included
    (nonzero random dy and, with the classifier, dx_last on the first
    trunk), to 1e-4 of its largest entry against the plain backward fed the
    kernel's own residuals."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    specs = Specs(model_type=model_type, encode_style="both", point_feat_size=9,
                  latent_size=latent, classifier_branch=x_last,
                  network_specs=NetworkSpecs(dims=dims, latent_in=latent_in))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(9)
        decoder = make_decoder(model_type, latent, 9, "both", specs.network_specs,
                               use_classifier=x_last).cuda()
    rows = (torch.randn(m, latent + 9, generator=gen) * 0.5).cuda()
    st = make_generic_train_decoder(specs).statics
    first, second = trunk_prefixes(decoder)
    widths = trunk_input_widths(specs)
    if second is None:
        trunks = [(first, widths[0], rows, 5, 2)]
    else:
        xh, xo = separate_decoder_inputs(latent, "both", rows)
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


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 16), (3, 64, 128, 128), (1, 5, 13, 10)])
def test_cuda_maxpool_matches_plain(shape, channels_last):
    """K7 on post-ReLU data with flat blocks and zero rows, NCHW or channels
    last: the forward bit for bit (also against F.max_pool2d), in x's
    layout, the gradient of the autograd path and of the backward kernel
    within 1e-6 of the plain backward (each sum has at most two nonzero
    terms: exact), one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator().manual_seed(7)
    x = torch.relu(torch.randn(shape, generator=gen) - 0.3)
    x[:, :, 2:9, 1:7] = 0.5
    x[:, :, 0] = 0.0
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
        assert float((dx - dx_ref).abs().max()) <= 1e-6
        dx_k = maxpool_backward(x.detach(), y, dy.contiguous(memory_format=fmt))
        assert float((dx_k - dx_ref).abs().max()) <= 1e-6
