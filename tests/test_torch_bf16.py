"""bf16 serving: the port's ComputeDtype bfloat16 and its bf16 grid kernels
against the JAX package's bf16 functions, on the CPU.

- K1, K3 and K6's plain versions on bf16 plans against JAX's Pallas
  kernels in interpret mode with dtype=jnp.bfloat16 (block 128, twin 4 x 64
  trunks, a 16^3 grid; K1 and K3 at 2 and 2 + C rows; K6 on twin and
  combined trunks).  Both sides round at the same points, so only float32
  sums in another order differ, and now and then one of them rounds to the
  neighbouring bf16 value, which the next layers carry: SDF and logits
  within TIGHT at >= 99% of the points and LOOSE everywhere (measured on
  these seeds: 99.25-100% within TIGHT, the largest 3.2e-4, K3 at 2 + 6
  rows; the 32^3 reconstruction 99.56-99.84%, 1.7e-4).
- Each plain bf16 version within JAX's own bf16 bound (5e-3,
  tests/test_decoder_kernel.py) of its float32 version.
- The bf16 tile streams untile to bf16(W) exactly; the float32 plans keep
  their unrounded weights.
- encode_scene under ComputeDtype bfloat16 against JAX's bf16 (run where
  XLA keeps no excess precision): well inside JAX's own bf16-to-float32
  distance, float32 outputs.
- Reconstructor(grid_dtype=bfloat16) at 32^3 against JAX's bf16 K1 through
  JAX's grid evaluator, and cli.reconstruct --bf16 once.
- Training takes a bf16 spec whose train decoder is K4 or K5
  (make_train_step, make_trainer and cli.train --bf16 build and step it in
  bf16); K7 refuses float16 (bf16 training: tests/test_torch_bf16_train.py
  and tests/test_torch_bf16_pixel_train.py).

The CUDA kernels are held to these plain versions on the card by
tests/test_torch_cuda.py."""

import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.inference.grid import make_grid_evaluator as jax_grid_evaluator
from alignsdf_tpu.ops.decoder_kernel import (
    make_fused_grid_decode_fn,
    make_fused_pixel_grid_decode_fn,
    make_pallas_decode_fn,
)
from alignsdf_torch.cli.reconstruct import main as cli_main
from alignsdf_torch.config import specs_from_dict
from alignsdf_torch.inference.reconstruct import Reconstructor
from alignsdf_torch.kernels.generic_decoder import generic_decode_reference
from alignsdf_torch.kernels.grid_decoder import round_to
from alignsdf_torch.models.alignsdf import build_model
from alignsdf_torch.ops.decoder_plan import make_generic_decode_fn, make_generic_plan
from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn
from alignsdf_torch.training.train_step import make_train_step

import torch_parity
from test_torch_generic_decoder import CAM, LATENT, _jax_params, _kinematic_ctx, _pair
from test_torch_pixel_kernel import HW

BF16 = torch.bfloat16
TIGHT = 1e-5      # SDF and logits, port against JAX, at >= 99% of the points
LOOSE = 2e-3      # ... and everywhere
SHARE = 0.99
JAX_BF16_TOL = 5e-3  # bf16 against float32 (tests/test_decoder_kernel.py:167-183)
N = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _close_mostly(got, want, name=""):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    share = float((err <= TIGHT).mean())
    assert share >= SHARE, (name, share, float(err.max()))
    assert float(err.max()) <= LOOSE, (name, float(err.max()))


def _grid_scene(pixel, num_class=0, combined=False):
    """(JAX specs, port specs, port ctx, JAX ctx): twin 4 x 64 trunks with the
    flagship's kinematic "both" embedding (or one combined trunk on raw xyz),
    a seeded latent (or, pixel-aligned, an 8 x 6 map of LATENT channels and
    the camera), the decoder from the port's seeded init."""
    style, pfs = ("nerf", 3) if combined else ("both", 9)
    model_type = "1encoder1decoder" if combined else "1encoder2decoder"
    jspecs, pspecs, pdec, _ = _pair(model_type, style, pfs, (2,), num_class, dims=(64,) * 4,
                                    pixel=pixel)
    rng = np.random.RandomState(21)
    ctx = _kinematic_ctx(rng)
    if pixel:
        ctx.update(latent=(rng.randn(1, LATENT, *HW) * 0.5).astype(np.float32), cam_intr=CAM,
                   pred_root=np.asarray([[[0.01, -0.02, 0.6]]], np.float32))
    else:
        ctx["latent"] = (rng.randn(1, LATENT) * 0.5).astype(np.float32)
    pctx = {"decoder": pdec, **{k: torch.from_numpy(v) for k, v in ctx.items()}}
    params = _jax_params(pdec, jspecs)
    jctx = {"decoder_params": params, "params": params,
            **{k: jnp.asarray(v) for k, v in ctx.items()}}
    return jspecs, pspecs, pctx, jctx


def _origin_voxel():
    return np.full(3, -1.0, np.float32), np.float32(2.0 / (N - 1))


def _port_rows(pspecs, pctx, pixel, dtype):
    origin, voxel = _origin_voxel()
    make = make_pixel_grid_decode_fn if pixel else make_grid_decode_fn
    args = (pspecs, N, False, dtype) if pixel else (pspecs, N, dtype)
    decode = make(*args)(pctx)
    return decode(0, N ** 3, torch.from_numpy(origin), torch.tensor(voxel)).numpy(), decode.plan


def _jax_rows(jspecs, jctx, pixel):
    origin, voxel = _origin_voxel()
    if pixel:
        gd = make_fused_pixel_grid_decode_fn(jspecs, N, block=128, interpret=True,
                                             band=None, dtype=jnp.bfloat16)
    else:
        gd = make_fused_grid_decode_fn(jspecs, N, block=128, interpret=True,
                                       dtype=jnp.bfloat16, layout="lanes")
    h, o, logits = gd(jctx, jnp.arange(N ** 3, dtype=jnp.int32), jnp.asarray(origin),
                      jnp.asarray(voxel))
    rows = [np.asarray(h)[:, 0], np.asarray(o)[:, 0]]
    if logits is not None:
        rows += list(np.asarray(logits).T)
    return np.stack(rows)


@pytest.mark.parametrize("pixel", [False, True])
@pytest.mark.parametrize("num_class", [0, 6])
def test_plain_bf16_grid_kernels_match_jax(pixel, num_class):
    """K1 (pixel False) and K3 on bf16 plans over a 16^3 grid, at 2 and 2 + 6
    rows, against JAX's bf16 kernels in interpret mode; and each within
    JAX's bf16 bound of its float32 version."""
    jspecs, pspecs, pctx, jctx = _grid_scene(pixel, num_class)
    got, plan = _port_rows(pspecs, pctx, pixel, BF16)
    assert plan.dtype == BF16
    want = _jax_rows(jspecs, jctx, pixel)
    assert got.shape == want.shape == (2 + num_class, N ** 3)
    _close_mostly(got, want, "bf16 port vs JAX")
    f32, _ = _port_rows(pspecs, pctx, pixel, torch.float32)
    assert float(np.abs(got[:2] - f32[:2]).max()) <= JAX_BF16_TOL
    assert float(np.abs(got - f32).max()) > 0  # the plan did round


def test_plain_bf16_k1_combined_trunk_matches_jax():
    jspecs, pspecs, pctx, jctx = _grid_scene(False, combined=True)
    got, _ = _port_rows(pspecs, pctx, False, BF16)
    _close_mostly(got, _jax_rows(jspecs, jctx, False), "combined K1")


@pytest.mark.parametrize("model_type,style,pfs,num_class", [
    ("1encoder2decoder", "nerf", 63, 0),
    ("1encoder2decoder", "both", 9, 6),
    ("1encoder1decoder", "nerf", 9, 6),
])
def test_plain_bf16_k6_matches_jax(model_type, style, pfs, num_class):
    """K6's plain version on a bf16 plan (twin and combined trunks; the
    --point_size 63 rows pad to lat_pad 96, a multiple of 16) against JAX's
    bf16 generic kernel in interpret mode on 1200 seeded rows, and within
    JAX's bf16 bound of the float32 plan."""
    dims = (128 if pfs == 63 else 64,) * 4  # latent_in's width must exceed 32 + 63
    jspecs, pspecs, pdec, _ = _pair(model_type, style, pfs, (2,), num_class, dims=dims)
    rows = (np.random.RandomState(3).randn(1200, LATENT + pfs) * 0.5).astype(np.float32)
    want = make_pallas_decode_fn(jspecs, block=128, interpret=True, dtype=jnp.bfloat16)(
        {"decoder_params": _jax_params(pdec, jspecs)}, jnp.asarray(rows))
    with torch.no_grad():
        got = make_generic_decode_fn(pspecs, dtype=BF16)({"decoder": pdec},
                                                         torch.from_numpy(rows))
        f32 = make_generic_decode_fn(pspecs)({"decoder": pdec}, torch.from_numpy(rows))
    assert make_generic_plan(pdec, pspecs, BF16).lat_pad % 16 == 0
    for name, g, w, f in zip(("sdf_hand", "sdf_obj", "logits"), got, want, f32):
        assert (g is None) == (w is None) == (f is None)
        if g is not None:
            assert g.dtype == torch.float32
            _close_mostly(g.numpy(), np.asarray(w), name)
            if name != "logits":
                assert float((g - f).abs().max()) <= JAX_BF16_TOL


def test_k6_plain_version_rounds_float32_rows():
    """The plain version takes the rows in either dtype: float32 rows round
    to the bf16 rows' values."""
    _, pspecs, pdec, _ = _pair("1encoder2decoder", "both", 9, (2,), 0, dims=(64,) * 4)
    plan = make_generic_plan(pdec, pspecs, BF16)
    rows = torch.from_numpy((np.random.RandomState(4).randn(50, LATENT + 9)).astype(np.float32))
    xh, xo = rows[:, :-3], torch.cat([rows[:, :LATENT + 3], rows[:, -3:]], dim=1)
    a = generic_decode_reference(plan, xh, xo)
    b = generic_decode_reference(plan, xh.to(BF16), xo.to(BF16))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("kind", ["twin", "combined", "classifier", "pixel", "generic"])
def test_bf16_tile_streams_hold_the_rounded_weights(kind):
    """A bf16 plan's hidden weights untile to bf16(W) exactly, its latent,
    input-row and final weights are bf16(W), its xyz weights bf16(W) for K1
    and float32 for K3 (as JAX's), its biases unrounded.  Compared where
    both plans have entries: K6's bf16 plan pads its widths to 16, the
    float32 plan to 128, and the padding holds zeros."""
    pixel, combined = kind == "pixel", kind == "combined"
    jspecs, pspecs, pctx, _ = _grid_scene(pixel, 6 if kind == "classifier" else 0, combined)
    plans = {}
    for dtype in (torch.float32, BF16):
        if kind == "generic":
            plans[dtype] = make_generic_plan(pctx["decoder"], pspecs, dtype)
        else:
            plans[dtype] = _port_rows(pspecs, pctx, pixel, dtype)[1]
    for (hf, fin_f, fx_f), (hb, fin_b, fx_b) in zip(plans[torch.float32].trunks(),
                                                    plans[BF16].trunks()):
        for lf, lb in zip(hf, hb):
            for i, (wf, wb) in enumerate(zip(lf[:-1], lb[:-1])):
                assert (wf is None) == (wb is None)
                if wf is None:
                    continue
                k, n = min(wf.shape[0], wb.shape[0]), min(wf.shape[1], wb.shape[1])
                assert not wb[k:].any() and not wb[:, n:].any()
                if pixel and i == 2:  # K3's xyz weights stay float32
                    assert torch.equal(wb, wf)
                else:
                    assert torch.equal(wb[:k, :n], round_to(wf[:k, :n], BF16))
                    assert float((wb[:k, :n] - wf[:k, :n]).abs().max()) > 0
            n = min(lf[-1].shape[0], lb[-1].shape[0])  # biases
            assert torch.equal(lf[-1][:n], lb[-1][:n])
            assert not lf[-1][n:].any() and not lb[-1][n:].any()
        n = min(fin_f.shape[1], fin_b.shape[1])
        assert torch.equal(fin_b[:, :n], round_to(fin_f[:, :n], BF16))
        assert not fin_b[:, n:].any() and not fin_f[:, n:].any()
        assert (fx_f is None) == (fx_b is None)
        if fx_f is not None:
            k = min(fx_f.shape[1], fx_b.shape[1])
            want = fx_f[:, :k] if pixel else round_to(fx_f[:, :k], BF16)
            assert torch.equal(fx_b[:, :k], want)
    assert torch.equal(plans[torch.float32].fin_b, plans[BF16].fin_b)
    if pixel:
        assert torch.equal(plans[BF16].table, round_to(plans[torch.float32].table, BF16))


def test_float32_plans_hold_unrounded_weights():
    """The float32 K1 plan's epilogue and final weights are the fold's own
    float32 values, its hidden weights the TF32 split's (2^-22)."""
    from alignsdf_torch.ops.grid_plan import build_grid_branch_plan, embedding_affine
    from alignsdf_torch.models.layers import materialize_linear

    _, pspecs, pctx, _ = _grid_scene(False)
    plan = _port_rows(pspecs, pctx, False, torch.float32)[1]
    dec, lat = pctx["decoder"], pctx["latent"]
    a, b = embedding_affine(pspecs, pctx, lat.device)
    with torch.no_grad():
        layers = [materialize_linear(getattr(dec, f"linh{i}")) for i in range(5)]
        trunk = build_grid_branch_plan(layers, lat, a[:, :-3], b[:-3], pspecs.network_specs, 1,
                                       [0])
    hidden, fin, _ = next(plan.trunks())
    assert torch.equal(hidden[0][1][:, :64], trunk.hidden[0].x)
    assert torch.equal(fin[0, :64], trunk.fin[:, 0])
    w = trunk.hidden[1].w
    got = hidden[1][0][:w.shape[0], :w.shape[1]]
    assert float((got - w).abs().max()) <= 2 ** -21 * float(w.abs().max())


BF16_FLAGSHIP = {**torch_parity.FLAGSHIP_NARROW, "ComputeDtype": "bfloat16"}


# JAX's bf16 reference comes from a process whose XLA rounds where the code
# converts (torch_parity.jax_encode_scene_rounded); both sides then round
# at the same points and differ only by float32 sums taken in other orders,
# where now and then an activation rounds to the neighbouring bf16 value and
# the layers after it carry the flip.  So the port sits well inside JAX's
# own bf16-to-float32 distance, while an encoder that ignored ComputeDtype
# would sit at about 1 times it.  Measured on these two images, as mean
# distances: 0.18-0.33 of JAX's own (the latent 0.32), 66% of the latent's
# entries equal to JAX's; a float32 encoder: 0.995-1.0, none equal.
ENCODE_RATIO = 0.5
LATENT_EQUAL = 0.4
FLOAT32_NOISE = ("rot_center", "center3d")  # float32 MANO, 0 to 1e-7 apart
ENCODE_FLOOR = 1e-6


def test_encode_scene_bf16_matches_jax(tmp_path):
    """The narrow flagship under ComputeDtype bfloat16 on two images: the
    latent, MANO and object pose, each at a mean distance from JAX's bf16
    of at most ENCODE_RATIO times JAX's own bf16-to-float32 mean distance,
    the same weights; LATENT_EQUAL of the (bf16-valued) latent's entries
    equal to JAX's; every output float32."""
    _, _, pmodel, _, _ = torch_parity.build_pair_from_port(BF16_FLAGSHIP)
    jf32, vf32, _, _, _ = torch_parity.build_pair_from_port(torch_parity.FLAGSHIP_NARROW)
    samples = [torch_parity.make_sample(7 + i) for i in range(2)]
    args = [np.stack([s[k] for s in samples])
            for k in ("image", "cam_intr", "mano_root", "rest_obj_corners")]
    jb = torch_parity.jax_encode_scene_rounded(BF16_FLAGSHIP, pmodel, args, str(tmp_path))
    jf = torch_parity.jax_encode_scene(jf32, vf32, args)
    with torch.no_grad():
        out = pmodel.encode_scene(*map(torch.from_numpy, args))
    assert pmodel.encoder.conv1.compute_dtype == BF16
    assert all(v.dtype == torch.float32 for v in (out[0], *out[1].values(), *out[2].values()))
    port = torch_parity.encode_outputs(*out)
    for name in torch_parity.ENCODE_KEYS:
        dist = np.abs(port[name] - jb[name])
        own = np.abs(jb[name] - jf[name])
        if name in FLOAT32_NOISE:
            assert float(dist.max()) <= ENCODE_FLOOR, (name, float(dist.max()))
        else:
            assert float(dist.mean()) <= ENCODE_RATIO * float(own.mean()), (
                name, float(dist.mean()), float(own.mean()))
    assert float((port["latent"] == jb["latent"]).mean()) >= LATENT_EQUAL
    assert float(np.abs(jb["latent"] - jf["latent"]).max()) > 1e-4  # bf16 did round


def test_decoder_bf16_outputs_float32():
    _, _, pmodel, _, pspecs = torch_parity.build_pair_from_port(BF16_FLAGSHIP)
    rows = torch.from_numpy(np.random.RandomState(2).randn(40, 32 + 9).astype(np.float32))
    h, o, _ = pmodel.decode_points(rows)
    assert h.dtype == o.dtype == torch.float32
    ref = build_model(specs_from_dict(torch_parity.FLAGSHIP_NARROW))
    ref.load_state_dict(pmodel.state_dict())
    h32, _, _ = ref.decode_points(rows)
    assert 0 < float((h - h32).abs().max()) <= 3e-2


def test_reconstructor_bf16_grid_matches_jax_kernel():
    """The narrow flagship (float32 model) at 32^3 with grid_dtype bfloat16:
    the port's two-pass fields against JAX's bf16 K1 (interpret mode)
    driven through JAX's grid evaluator on JAX's own encoding."""
    n = 32
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair_from_port(
        torch_parity.FLAGSHIP_NARROW, seed=1)
    sample = torch_parity.make_sample(3)
    args = [np.asarray(sample[k])[None] for k in ("image", "cam_intr", "mano_root",
                                                  "rest_obj_corners")]
    enc = torch_parity.jax_encode_scene(jmodel, variables, args)
    params = variables["params"]["decoder"]
    jctx = {"decoder_params": params, "params": params,
            **{k: jnp.asarray(enc[k]) for k in ("latent", "rot_center", "global_trans",
                                                "obj_trans")}}
    gd = make_fused_grid_decode_fn(jspecs, n, block=2048, interpret=True, dtype=jnp.bfloat16)
    jres = jax_grid_evaluator(None, jspecs, n, chunk=n ** 3, grid_decode_fn=gd)(jctx)
    recon = Reconstructor(pmodel, pspecs, cube_dim=n, device="cpu", grid_dtype=BF16)
    assert recon.fused and recon.grid_dtype == BF16
    host = recon.submit(sample)["host"]
    for name in ("voxel", "origin"):
        jname = "voxel_size" if name == "voxel" else name
        np.testing.assert_allclose(host[name].numpy(), np.asarray(getattr(jres, jname)),
                                   atol=1e-5, rtol=0)
    for name in ("sdf_hand", "sdf_obj"):
        _close_mostly(host[name].numpy().reshape(-1), np.asarray(getattr(jres, name)).reshape(-1),
                      name)


def test_cli_reconstruct_bf16(tmp_path):
    """cli.reconstruct --bf16 on an experiment whose ComputeDtype is
    bfloat16: the fused K1 path in bf16 on the CPU, both exports."""
    spec = {**BF16_FLAGSHIP, "ScenesPerBatch": 2}
    exp = tmp_path / "exp"
    (exp / "ModelParameters").mkdir(parents=True)
    (exp / "specs.json").write_text(json.dumps(spec))
    model = build_model(specs_from_dict(spec), seed=0)
    torch.save({"epoch": 1, "model_state_dict": model.state_dict()},
               exp / "ModelParameters" / "latest.pth")
    sample = torch_parity.make_sample(5, "k0")
    np.savez(tmp_path / "s.npz", **{k: np.asarray(v)[None] for k, v in sample.items()})
    per_image = cli_main(["-e", str(exp), "--samples", str(tmp_path / "s.npz"),
                          "--cube_dim", "16", "--device", "cpu", "--bf16"])
    assert [p["key"] for p in per_image] == ["k0"]
    out = exp / "Eval_obman"
    assert os.path.isfile(out / "hand_pose" / "k0.json") or any(
        "k0" in f for _, _, files in os.walk(out) for f in files)


# bf16 specs whose train decoder is K4 (pixel-aligned) or K5 (a latent input
# at layer 0), at 64 x 64 images and 2 x 128 points so that a CPU step is quick
BF16_K4 = {**torch_parity.PIXEL_NARROW, "ComputeDtype": "bfloat16", "ImageSize": [64, 64],
           "SamplesPerScene": 128}
BF16_K5 = {**BF16_FLAGSHIP, "ImageSize": [64, 64], "SamplesPerScene": 128,
           "NetworkSpecs": {**BF16_FLAGSHIP["NetworkSpecs"], "latent_in": [0, 2]}}


def _step_once(specs, state, step):
    from alignsdf_torch.data.synthetic import synthetic_train_batch
    from alignsdf_torch.training.train_step import batch_to_device

    batch = batch_to_device(synthetic_train_batch(specs, batch_size=2, seed=0), "cpu")
    before = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    losses = step(state, batch, 7)
    assert all(np.isfinite(float(v)) for v in losses.values())
    moved = [k for k, v in state.model.state_dict().items()
             if v.dtype == torch.float32 and not torch.equal(v, before[k])]
    assert any(k.startswith("decoder.") for k in moved)
    return losses


def test_training_takes_bf16_on_k4_and_k5():
    """A bf16 spec whose train decoder is K4 or K5 no longer raises (the
    refusal this test held until their bf16 kernels were ported): from
    make_train_step and make_trainer it builds a step whose decoder is that
    kernel in bf16 (its statics' dtype; no float32 fallback), and one step
    on the CPU (the plain bf16 version) gives finite losses and moves the
    decoder's float32 parameters; the float32 spec's decoder stays float32."""
    from alignsdf_torch.cli.train import make_trainer
    from alignsdf_torch.training.train_step import train_decoder_kind

    for spec, kernel in ((BF16_K4, "K4"), (BF16_K5, "K5")):
        specs = specs_from_dict(spec)
        step = make_train_step(specs)
        assert kernel in train_decoder_kind(step.decode)
        assert step.decode.statics.dtype == torch.bfloat16
        state, step = make_trainer(specs, torch.device("cpu"), init_guard=False)
        assert step.decode.statics.dtype == torch.bfloat16
        _step_once(specs, state, step)
        f32 = make_train_step(specs_from_dict({**spec, "ComputeDtype": "float32"}))
        assert f32.decode.statics.dtype == torch.float32


def test_train_cli_takes_bf16_on_k4_and_k5(tmp_path, capfd):
    """cli.train --bf16 --smoke --device cpu on a K4 and a K5 spec (both
    float32 in their spec file) trains in bf16 through that kernel's plain
    bf16 version, where it raised until their bf16 kernels were ported: the
    log names the compute dtype and the kernel, and the smoke passes."""
    from alignsdf_torch.cli.train import main as train_main

    for spec, kernel in ((BF16_K4, "K4"), (BF16_K5, "K5")):
        path = tmp_path / f"{kernel}.json"
        path.write_text(json.dumps({**spec, "ComputeDtype": "float32"}))
        train_main(["-e", str(path), "--smoke", "--device", "cpu", "--bf16",
                    "--output_root", str(tmp_path)])
        text = capfd.readouterr().err
        assert "compute dtype: bfloat16" in text and f"({kernel})" in text, text[-2000:]
        assert "smoke OK" in text


def test_eval_mode_batchnorm_on_bf16():
    """Eval-mode BatchNorm normalizes a bf16 input with its float32
    statistics in float32 and returns bf16 (train mode's one-pass path:
    tests/test_torch_bf16_train.py)."""
    from alignsdf_torch.models.resnet import BatchNorm2d

    bn = BatchNorm2d(3).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([0.1, -0.2, 0.3]))
        bn.running_var.copy_(torch.tensor([0.5, 1.5, 2.0]))
    x = torch.rand(2, 3, 4, 4).to(BF16)
    out = bn(x)
    assert out.dtype == BF16
    assert torch.equal(out, bn(x.to(torch.float32)).to(BF16))
