"""Kernel K3's plain version on the port's plan against the JAX fused pixel
grid kernel (``make_fused_pixel_grid_kernel_t`` in interpret mode, block
128, ``band=None``) on the JAX plan, from the same converted weights.
Tolerance 5e-5 abs, the JAX package's own fused-vs-XLA tolerance for the
pixel grid (tests/test_grid.py): the latent's float32 products are summed
in another order than the dense sampling matmul's.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import NetworkSpecs as JaxNetworkSpecs
from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.inference.grid import make_grid_evaluator as jax_grid_evaluator
from alignsdf_tpu.models.decoder import CombinedDecoder as JaxCombined
from alignsdf_tpu.models.decoder import SeparateDecoder as JaxSeparate
from alignsdf_tpu.ops.decoder_kernel import make_fused_pixel_grid_decode_fn
from alignsdf_tpu.ops.rotations import batch_rodrigues
from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.convert import decoder_from_jax
from alignsdf_torch.inference.grid import make_grid_evaluator
from alignsdf_torch.kernels.pixel_grid_decoder import (
    pixel_grid_decode,
    pixel_grid_decode_reference,
    pixel_projection,
)
from alignsdf_torch.models.decoder import make_decoder
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

ATOL = 5e-5
C = 32        # feature channels = latent width
HW = (8, 6)   # feature map rows, columns
NS = dict(dims=(64, 64, 64, 64), dropout=(), latent_in=(2,))


def _transforms(rng, count):
    rot = np.asarray(batch_rodrigues(jnp.asarray(rng.randn(1, count, 3) * 0.8, jnp.float32)))
    tf = np.tile(np.eye(4, dtype=np.float32), (1, count, 1, 1))
    tf[..., :3, :3] = rot
    tf[..., :3, 3] = rng.randn(1, count, 3) * 0.05
    return tf


def _scene(style, pfs, model_type="1encoder2decoder", shift_n=None, ns=NS):
    """Seeded decoder params (NetworkSpecs ``ns``), feature map, camera and
    transforms.  The camera puts part of the grid outside the image.  With
    ``shift_n`` the final biases are shifted so a fifth of a first pass at
    that size is inside (the refinement is exercised)."""
    kw = dict(model_type=model_type, encode_style=style, point_feat_size=pfs,
              latent_size=C, mano_branch=True, object_pose_branch=True,
              sdf_scale_factor=7.018621123357809, pixel_align=True, image_size=(256, 256))
    jspecs = JaxSpecs(network_specs=JaxNetworkSpecs(**ns), **kw)
    pspecs = Specs(network_specs=NetworkSpecs(**ns), **kw)
    rng = np.random.RandomState(11)
    combined = model_type == "1encoder1decoder"
    jdec = (JaxCombined if combined else JaxSeparate)(C, pfs, style, jspecs.network_specs)
    params = jax.tree_util.tree_map(np.asarray, jdec.init(
        jax.random.PRNGKey(5), jnp.zeros((4, C + pfs)))["params"])
    ctx = {"latent": (rng.randn(1, C, *HW) * 0.5).astype(np.float32),
           "cam_intr": np.asarray([[[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]]],
                                  np.float32),
           "pred_root": np.asarray([[[0.01, -0.02, 0.6]]], np.float32),
           "rot_center": (rng.randn(1, 1, 3) * 0.05).astype(np.float32),
           "global_trans": _transforms(rng, 16),
           "obj_trans": _transforms(rng, 1)[:, 0]}

    def jctx():
        return {"decoder_params": params, "params": params,
                **{k: jnp.asarray(v) for k, v in ctx.items()}}

    def decode_fn(c, rows):
        return jdec.apply({"params": c["decoder_params"]}, rows)

    if shift_n is not None:
        first = jax_grid_evaluator(decode_fn, jspecs, shift_n, chunk=shift_n ** 3,
                                   two_pass=False)(jctx())
        for col, (branch, field) in enumerate((("hand", first.sdf_hand), ("obj", first.sdf_obj))):
            shift = np.arctanh(np.quantile(np.asarray(field), 0.2))
            if combined:
                bias = params["trunk"]["lin4"]["bias"].copy()
                bias[col] -= shift
                params["trunk"]["lin4"]["bias"] = bias
            else:
                last = params[branch][f"lin{branch[0]}4"]
                last["bias"] = last["bias"] - shift
    pdec = make_decoder(model_type, C, pfs, style, pspecs.network_specs)
    pdec.load_state_dict(decoder_from_jax(params))
    pctx = {"decoder": pdec, **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    return jspecs, pspecs, jctx(), decode_fn, pctx


def _jax_run(jspecs, n, jctx, ref, base, m, origin, voxel):
    gd = make_fused_pixel_grid_decode_fn(jspecs, n, block=128, interpret=True,
                                         ref_projection=ref, band=None)
    idx = jnp.arange(base, base + m, dtype=jnp.int32)
    h, o, _ = gd(jctx, idx, jnp.asarray(origin), jnp.asarray(voxel))
    return np.stack([np.asarray(h)[:, 0], np.asarray(o)[:, 0]])


@pytest.mark.parametrize("style,pfs,model_type,ref", [
    ("both", 9, "1encoder2decoder", False),
    ("both", 9, "1encoder2decoder", True),
    ("hand", 6, "1encoder2decoder", True),
    ("nerf", 3, "1encoder1decoder", False),
])
def test_plain_k3_matches_jax_kernel(style, pfs, model_type, ref):
    """The twin trunks and the combined trunk, both projection modes, over
    a whole 12^3 grid of which only part projects into the image."""
    n = 12
    jspecs, pspecs, jctx, _, pctx = _scene(style, pfs, model_type)
    origin, voxel = np.full(3, -1.0, np.float32), np.float32(2.0 / (n - 1))
    want = _jax_run(jspecs, n, jctx, ref, 0, n ** 3, origin, voxel)
    plan = make_pixel_grid_decode_fn(pspecs, n, ref)(pctx).plan
    got = pixel_grid_decode_reference(plan, 0, n ** 3, torch.from_numpy(origin),
                                      torch.tensor(voxel))
    share = float(pixel_projection(plan, 0, n ** 3, torch.from_numpy(origin),
                                   torch.tensor(voxel))[3].float().mean())
    assert 0.1 < share < 0.9, share
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [20, 24])
def test_plain_k3_runs_off_line_starts_match_jax_unbanded(n):
    """The TPU kernel's banded variant can miss a block's last z-line when a
    run starts off a line (base % n != 0) at a cube_dim that is not a power
    of two (_band_plan's window).  K3 does not band; at n = 20 and 24, runs
    that start mid-line give JAX's unbanded result."""
    jspecs, pspecs, jctx, _, pctx = _scene("both", 9)
    origin, voxel = np.full(3, -1.0, np.float32), np.float32(2.0 / (n - 1))
    plan = make_pixel_grid_decode_fn(pspecs, n)(pctx).plan
    for base, m in ((7, 300), (n * n * (n // 2) + 5, 257), (n ** 3 - 131, 131)):
        assert base % n != 0
        want = _jax_run(jspecs, n, jctx, False, base, m, origin, voxel)
        got = pixel_grid_decode_reference(plan, base, m, torch.from_numpy(origin),
                                          torch.tensor(voxel))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0,
                                   err_msg=f"run [{base}, {base + m})")


def test_plain_k3_two_pass_grid_matches_jax_kernel():
    """The port's two-pass evaluator on K3's plain version against the JAX
    evaluator on its K3 (interpret, band=None): fields, voxel and origin."""
    n = 12
    jspecs, pspecs, jctx, decode_fn, pctx = _scene("both", 9, shift_n=n)
    gd = make_fused_pixel_grid_decode_fn(jspecs, n, block=128, interpret=True, band=None)
    jres = jax_grid_evaluator(decode_fn, jspecs, n, chunk=n ** 3, two_pass=True,
                              grid_decode_fn=gd)(jctx)
    pres = make_grid_evaluator(None, pspecs, n,
                               grid_decode_fn=make_pixel_grid_decode_fn(pspecs, n))(pctx)
    assert 0.0 < float((np.asarray(jres.sdf_hand) < 0).mean()) < 1.0
    for name in ("sdf_hand", "sdf_obj", "voxel_size", "origin"):
        np.testing.assert_allclose(getattr(pres, name).numpy(), np.asarray(getattr(jres, name)),
                                   atol=ATOL, rtol=0, err_msg=name)


def test_plain_k3_ragged_run_matches_full_grid():
    """A run that starts mid-grid and ends off a 32-point tile gives the
    same values as the whole grid, through the wrapper on the CPU."""
    n = 12
    _, pspecs, _, _, pctx = _scene("both", 9)
    plan = make_pixel_grid_decode_fn(pspecs, n)(pctx).plan
    origin, voxel = torch.full((3,), -1.0), torch.tensor(2.0 / (n - 1))
    full = pixel_grid_decode(plan, 0, n ** 3, origin, voxel)
    part = pixel_grid_decode(plan, 37, 101, origin, voxel)
    np.testing.assert_allclose(part.numpy(), full[:, 37:138].numpy(), atol=1e-6, rtol=0)
