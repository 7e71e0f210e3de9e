"""The port's training path against the JAX package on seeded numpy inputs:
losses and masks, the LR schedule, Adam against optax, a 3-step trajectory
of the whole train step (the factored Pallas decoder in interpret mode on
the JAX side, K2's plain version on the port's), K2's plan for a latent
input at the last layer, the checkpoint round trip, the CLI's refusal to
drop to the CPU and its float32 precision."""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from alignsdf_tpu.config import Specs as JaxSpecs
from alignsdf_tpu.ops.decoder_train_kernel import make_fused_train_decoder_factored
from alignsdf_tpu.training import losses as jax_losses
from alignsdf_tpu.training import train_state as jax_train_state
from alignsdf_tpu.training import train_step as jax_train_step
from alignsdf_torch.cli import reconstruct as reconstruct_cli
from alignsdf_torch.cli import train as train_cli
from alignsdf_torch.cli.reconstruct import load_reference_weights
from alignsdf_torch.config import NetworkSpecs, Specs, load_specs, specs_from_dict, specs_to_dict
from alignsdf_torch.convert import from_jax
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.models.alignsdf import build_model
from alignsdf_torch.ops.train_plan import make_train_decoder
from alignsdf_torch.training import checkpoints
from alignsdf_torch.training.losses import compute_losses
from alignsdf_torch.training.train_state import (
    TrainState,
    clip_by_global_norm_,
    learning_rate_for_epoch,
    make_optimizer,
)
from alignsdf_torch.training.train_step import (
    batch_to_device,
    build_batch_masks,
    make_train_step,
)

import torch_parity

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test's own torch work on one thread (torch_parity.torch_threads).
    Function-scoped, so the module-scoped trajectory below runs at the
    default thread count: its per-entry bound on the decoder's updates is
    met at that count's summation order."""
    with torch_parity.torch_threads(1):
        yield


LOSS_SPECS = dict(samples_per_scene=6, mano_branch=True, object_pose_branch=True,
                  classifier_branch=True, penetration_loss=True, contact_loss=True,
                  sdf_scale_factor=7.0, hand_sdf_weight=0.5, joint_weight=0.5)


@pytest.mark.parametrize("active", [0.0, 1.0])
@pytest.mark.parametrize("ignore_other", [False, True])
def test_losses_and_masks_match_jax(active, ignore_other):
    """Every loss term to 1e-6 relative, masks exactly, with the
    AdditionalLossStart gate off and on."""
    kw = dict(LOSS_SPECS, ignore_point_from_other_mesh=ignore_other)
    jspecs, pspecs = JaxSpecs(**kw), Specs(**kw)
    b, m = 2, 12
    rng = np.random.RandomState(3)
    f = lambda *s: (rng.randn(*s) * 0.04).astype(np.float32)  # noqa: E731
    out = {"sdf_hand": f(m), "sdf_obj": f(m), "logits": f(m, 6),
           "joints": f(b, 21, 3), "pose": f(b, 48), "shape": f(b, 10),
           "obj_center": f(b, 3), "obj_corners": f(b, 8, 3)}
    batch = {"sdf_gt_hand": f(m, 1), "sdf_gt_obj": f(m, 1),
             "labels": rng.randint(-1, 6, m).astype(np.int64),
             "hand_joints_3d": f(b, 21, 3), "obj_center": f(b, 3), "obj_corners": f(b, 8, 3)}

    jm = jax_train_step.build_batch_masks(jspecs, b, jnp.float32(active))
    pm = build_batch_masks(pspecs, b, active)
    for j, p in zip(jm, pm):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))

    def outputs(conv):
        mano = {k: conv(out[k]) for k in ("joints", "pose", "shape")}
        obj = {k: conv(out[k]) for k in ("obj_center", "obj_corners")}
        return (conv(out["sdf_hand"]), conv(out["sdf_obj"]), conv(out["logits"]), mano, obj)

    jl = jax_losses.compute_losses(
        jspecs, outputs(jnp.asarray),
        dict({k: jnp.asarray(v) for k, v in batch.items()}, mask_hand=jm[0], mask_obj=jm[1]),
        jnp.float32(active))
    pl = compute_losses(
        pspecs, outputs(torch.from_numpy),
        dict({k: torch.from_numpy(v) for k, v in batch.items()}, mask_hand=pm[0], mask_obj=pm[1]),
        active)
    assert set(jl) == set(pl) and len(pl) == 11
    for k in jl:
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=1e-6, atol=1e-9)


def test_lr_schedule_matches_jax():
    jspecs, pspecs = JaxSpecs(), Specs()
    for epoch in (1, 599, 600, 1199, 1200, 1600):
        np.testing.assert_allclose(
            learning_rate_for_epoch(pspecs, epoch),
            float(jax_train_state.learning_rate_for_epoch(jspecs, jnp.asarray(epoch))),
            rtol=1e-6)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_matches_optax(clip):
    """3 steps on the same gradients, LR crossing a step of the schedule;
    with clip, optax.clip_by_global_norm's min(1, max/||g||) scaling."""
    kw = dict(gradient_clip_norm=clip)
    pspecs = dataclasses.replace(Specs(**kw), lr_schedules=(
        dataclasses.replace(Specs().lr_schedules[0], initial=1e-2, interval=2),))
    jspecs = dataclasses.replace(JaxSpecs(**kw), lr_schedules=(
        dataclasses.replace(JaxSpecs().lr_schedules[0], initial=1e-2, interval=2),))
    rng = np.random.RandomState(5)
    init = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(7).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in init.items()}
             for _ in range(3)]

    opt = jax_train_state.make_optimizer(jspecs)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = opt.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    popt = make_optimizer(pspecs, params.values())
    for epoch, g in enumerate(grads, start=1):
        updates, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        lr = jax_train_state.learning_rate_for_epoch(jspecs, jnp.asarray(epoch))
        jp = optax.apply_updates(jp, jax.tree_util.tree_map(lambda u: u * lr, updates))
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        if clip is not None:
            clip_by_global_norm_(params.values(), clip)
        for group in popt.param_groups:
            group["lr"] = learning_rate_for_epoch(pspecs, epoch)
        popt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
        assert float(np.abs(np.asarray(jp[k]) - init[k]).max()) > 1e-3


# the narrow flagship at 64x64 images, 2 scenes x 128 points; LR interval 2
# and AdditionalLossStart 3 so epochs 1, 2, 3 cross both
TRAJ_SPECS = dict(torch_parity.FLAGSHIP_NARROW, ImageSize=[64, 64], SamplesPerScene=128,
                  ScenesPerBatch=2, AdditionalLossStart=3, PenetrationLoss=True,
                  ContactLoss=True, HandSdfWeight=0.5, ObjSdfWeight=0.5, JointWeight=0.5,
                  LearningRateSchedule=[{"Type": "Step", "Initial": 1e-4, "Interval": 2,
                                         "Factor": 0.5}])


@pytest.fixture(scope="module")
def trajectories():
    """Three steps of each package's train step from the same weights on
    the same batches and dropout seeds."""
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair(TRAJ_SPECS)
    # final biases at 0 put the initial predictions inside the 0.05 clamp
    # band, so the SDF losses carry gradient into the decoder (the init
    # guard's criterion)
    for trunk, name in (("hand", "linh4"), ("obj", "lino4")):
        bias = variables["params"]["decoder"][trunk][name]["bias"]
        variables["params"]["decoder"][trunk][name]["bias"] = np.zeros_like(bias)
        getattr(pmodel.decoder, name).bias.data.zero_()
    opt = jax_train_state.make_optimizer(jspecs)
    override = make_fused_train_decoder_factored(jspecs, interpret=True)
    assert override is not None and override.factored
    jstep = jax.jit(jax_train_step.make_train_step(jmodel, jspecs, opt, override))
    jstate = jax_train_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        consts=variables.get("consts", {}), opt_state=opt.init(variables["params"]),
        epoch=jnp.asarray(1, jnp.int32))
    pstate = TrainState(pmodel, make_optimizer(pspecs, pmodel.parameters()))
    pstep = make_train_step(pspecs)
    j_losses, p_losses = [], []
    for i in range(3):
        batch = synthetic_train_batch(pspecs, batch_size=2, seed=i)
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
    return j_losses, p_losses, ref, pmodel, from_jax(
        variables["params"], variables["batch_stats"], pspecs)


def test_trajectory_losses_match_jax(trajectories):
    """The total to 1e-4 relative at every step; each term to 1e-4 relative
    or 1e-6 absolute (the pose and shape regularizers sit near 1e-3 and
    follow encoder parameters that Adam moves by +-lr on rounding-level
    gradients)."""
    j_losses, p_losses, *_ = trajectories
    for jl, pl in zip(j_losses, p_losses):
        assert set(jl) == set(pl)
        np.testing.assert_allclose(pl["total"], jl["total"], rtol=1e-4)
        for k in jl:
            np.testing.assert_allclose(pl[k], jl[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # the gate opened at epoch 3: contact was 0 before, not after
    assert p_losses[1]["contact"] == 0 and p_losses[2]["contact"] > 0


def test_trajectory_parameters_match_jax(trajectories):
    """Parameters after 3 steps to 1e-3 (JAX's own multi-step tolerance)
    and BatchNorm running statistics to 1e-4 (abs + rel).  The 1e-3 is
    larger than the whole 3-step update (at most 2e-4 an entry at these
    learning rates), so beyond it each tensor's update agrees with JAX's to
    10% in norm, and each decoder tensor's to 1e-5 abs, a twentieth of its
    largest entry: the trunks' gradients came through K2's plain backward."""
    _, _, ref, pmodel, init = trajectories
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
        if k.startswith("decoder."):
            assert float(d_jax.abs().max()) > 1e-4, k
            assert float((d_port - d_jax).abs().max()) <= 1e-5, k


def test_train_decoder_takes_a_last_layer_latent_in():
    """K2 folds the latent into layer 0's and the latent_in layers' scene
    tables, the final layer's too, as JAX's factored kernel re-injects at
    any layer: a spec whose latent_in names the last layer (index
    len(dims)) gets a K2 decoder whose final layer reads a scene table and
    the embedding, and the train step runs it; the layer before still takes
    K2."""
    last = Specs(network_specs=NetworkSpecs(latent_in=(4,)))
    decode = make_train_decoder(last)
    assert decode is not None
    assert decode.statics.scene_bias[-1] and decode.statics.has_x[-1]
    assert make_train_step(last).decode.statics == decode.statics
    assert make_train_decoder(Specs(network_specs=NetworkSpecs(latent_in=(3,)))) is not None


def _tiny_spec_file(tmp_path):
    path = os.path.join(tmp_path, "spec.json")
    with open(path, "w") as f:
        json.dump(dict(TRAJ_SPECS, LatentSize=16,
                       NetworkSpecs=dict(TRAJ_SPECS["NetworkSpecs"], dims=[32] * 4)), f)
    return path


def test_checkpoint_round_trip(tmp_path):
    """Train one step, save; the reconstruction loader takes the model file
    with no missing or unexpected key, and encode_scene agrees; the
    optimizer state restores too."""
    spec = _tiny_spec_file(str(tmp_path))
    out = os.path.join(str(tmp_path), "out")
    train_cli.main(["-e", spec, "--steps", "1", "--device", "cpu", "--no_init_guard",
                    "--output_root", out, "--batch_size", "2"])
    specs = load_specs(spec)
    exp = os.path.join(out, specs.experiment_name())
    path = os.path.join(exp, "ModelParameters", "latest.pth")
    saved = torch.load(path, weights_only=False)
    assert saved["epoch"] == 1
    model = build_model(specs, seed=123)
    load_reference_weights(model, path)
    missing, unexpected = model.load_state_dict(saved["model_state_dict"], strict=False)
    assert not missing and not unexpected
    trained = build_model(specs, seed=7)
    trained.load_state_dict(saved["model_state_dict"])
    s = torch_parity.make_sample(3)
    args = [torch.from_numpy(np.asarray(s[k])[None]) for k in
            ("image", "cam_intr", "mano_root", "rest_obj_corners")]
    assert torch.equal(model.encode_scene(*args)[0], trained.encode_scene(*args)[0])
    state = TrainState(model, make_optimizer(specs, model.parameters()))
    assert checkpoints.restore_checkpoint(exp, state) == 1
    assert len(state.optimizer.state) == len(list(model.parameters()))
    with open(os.path.join(exp, "specs.json")) as f:
        assert json.load(f)["LatentSize"] == 16


def test_cli_needs_cuda_unless_cpu_is_named(tmp_path):
    spec = _tiny_spec_file(str(tmp_path))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["-e", spec, "--smoke"])
    train_cli.main(["-e", spec, "--smoke", "--device", "cpu"])


def test_clis_run_float32_with_tf32_off(tmp_path, monkeypatch):
    """Both CLIs turn TF32 off for matmuls and cuDNN convolutions before they
    build a model (alignsdf_torch.use_float32_precision), whatever the
    process had set: the mode every reported time and parity check uses."""
    spec = _tiny_spec_file(str(tmp_path))
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags]

    class Stop(Exception):
        pass

    def stop(*args, **kwargs):
        assert [f.allow_tf32 for f in flags] == [False, False]
        raise Stop

    try:
        for f in flags:
            f.allow_tf32 = True
        train_cli.main(["-e", spec, "--smoke", "--device", "cpu"])
        assert [f.allow_tf32 for f in flags] == [False, False]
        for f in flags:
            f.allow_tf32 = True
        exp = tmp_path / "exp"
        exp.mkdir()
        with open(exp / "specs.json", "w") as f:
            json.dump(specs_to_dict(load_specs(spec)), f)
        monkeypatch.setattr(reconstruct_cli, "build_model", stop)
        with pytest.raises(Stop):
            reconstruct_cli.main(["-e", str(exp), "--samples", str(tmp_path / "none.npz"),
                                  "--device", "cpu"])
    finally:
        for f, value in zip(flags, before):
            f.allow_tf32 = value


@pytest.mark.parametrize("flag", [["--no_aug"], ["--bg_aug"], ["--epoch", "5"],
                                  ["--lr_interval", "3"], ["--lr_factor", "0.1"]])
def test_cli_refuses_flags_it_does_not_run(tmp_path, flag, capsys):
    """Flags that act only through the dataset reader or later epochs stop
    the CLI before it trains, instead of only renaming the experiment."""
    spec = _tiny_spec_file(str(tmp_path))
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["-e", spec, "--smoke", "--device", "cpu", *flag])
    assert exc.value.code == 2
    assert flag[0] in capsys.readouterr().err


def test_cli_add_epoch_turns_on_the_classifier_loss(tmp_path, capsys):
    """--add_epoch changes what the step computes: with --cls and
    AdditionalLossStart 1 the cross-entropy applies from the first step, and
    the smoke run reports a finite, nonzero cls term."""
    spec = _tiny_spec_file(str(tmp_path))
    train_cli.main(["-e", spec, "--smoke", "--device", "cpu", "--cls", "--add_epoch", "1"])
    log = capsys.readouterr().err  # the CLI logs to stderr
    terms = [dict(kv.split("=") for kv in line.split(": ", 1)[1].split())
             for line in log.splitlines() if "smoke terms" in line]
    assert len(terms) == 2, log
    for t in terms:
        cls = float(t["cls"])
        assert np.isfinite(cls) and cls > 0, t


@pytest.mark.parametrize("freeze", ["none", "bn"])
def test_freeze_bn_keeps_running_statistics(freeze):
    """Freeze "bn" normalizes with batch statistics but leaves the running
    buffers as they were; "none" updates them.  Parameters move either way."""
    specs = specs_from_dict(dict(TRAJ_SPECS, LatentSize=16, Freeze=freeze,
                                 NetworkSpecs=dict(TRAJ_SPECS["NetworkSpecs"], dims=[32] * 4)))
    model = build_model(specs, seed=0)
    state = TrainState(model, make_optimizer(specs, model.parameters()))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    make_train_step(specs)(state, batch_to_device(synthetic_train_batch(specs, 2), "cpu"), 1)
    after = model.state_dict()
    running = [k for k in before if k.endswith(("running_mean", "running_var"))]
    assert running
    changed = [k for k in running if not torch.equal(before[k], after[k])]
    assert (changed == []) == (freeze == "bn")
    assert not torch.equal(before["decoder.linh0.weight_v"], after["decoder.linh0.weight_v"])
