"""The port's pixel-aligned train step (the flagship with --pa_feat at a
narrow decoder width) against the JAX package's, on seeded numpy inputs: a
3-step trajectory (JAX's pixel train kernel in interpret mode, K4's plain
version on the port's side) across an LR boundary and the
AdditionalLossStart gate, and the init guard's probe predictions."""

import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from alignsdf_tpu.ops.decoder_train_pixel import make_fused_train_decoder_pixel
from alignsdf_tpu.training import train_state as jax_train_state
from alignsdf_tpu.training import train_step as jax_train_step
from alignsdf_torch.convert import from_jax
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.ops.geometry import pixel_coords
from alignsdf_torch.training.train_state import TrainState, make_optimizer
from alignsdf_torch.training.train_step import (
    COND_KEYS,
    batch_to_device,
    init_prediction_means,
    make_train_step,
)

import torch_parity

# the pixel flagship at 64x64 images (a 16 x 16 HeadNet map), 2 scenes x 128
# points; LR interval 2 and AdditionalLossStart 3 so epochs 1, 2, 3 cross both
TRAJ_SPECS = dict(torch_parity.PIXEL_NARROW, ImageSize=[64, 64], SamplesPerScene=128,
                  ScenesPerBatch=2, AdditionalLossStart=3, PenetrationLoss=True,
                  ContactLoss=True, HandSdfWeight=0.5, ObjSdfWeight=0.5, JointWeight=0.5,
                  LearningRateSchedule=[{"Type": "Step", "Initial": 1e-4, "Interval": 2,
                                         "Factor": 0.5}])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    with torch_parity.torch_threads(1):
        yield


def _batch(specs, seed):
    """A synthetic batch whose camera (f = 480, c = 128, built for 256-pixel
    images) is scaled to the 64-pixel image, so that part of each scene
    projects into it."""
    batch = synthetic_train_batch(specs, batch_size=2, seed=seed)
    batch["cam_intr"][:, :2, :] *= specs.image_size[0] / 256.0
    return batch


def _in_image_share(model, specs, batch) -> np.ndarray:
    """Each scene's share of points projecting into the image, at the
    predicted root the train step's front half gives."""
    b = batch_to_device(batch, "cpu")
    with torch.no_grad():
        fmap, _, mano, _ = copy.deepcopy(model).decoder_inputs_pixel(
            b["image"], b["xyz"], {k: b[k] for k in COND_KEYS}, train=True)
        _, _, mask = pixel_coords(b["xyz"], b["cam_intr"], mano["joints"][:, 0:1],
                                  specs.image_size[0], specs.sdf_scale_factor, *fmap.shape[2:])
    return mask.mean(dim=1).numpy()


def _keeping_grads(opt: optax.GradientTransformation) -> optax.GradientTransformation:
    """``opt`` that also keeps the last gradients in its state."""

    def init(params):
        return opt.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def trajectories():
    """Three steps of each package's train step from the same weights on
    the same batches and dropout seeds."""
    jmodel, variables, pmodel, jspecs, pspecs = torch_parity.build_pair(TRAJ_SPECS)
    # final biases at 0 put the initial predictions inside the 0.05 clamp
    # band, so the SDF losses carry gradient into the decoder
    for trunk, name in (("hand", "linh4"), ("obj", "lino4")):
        bias = variables["params"]["decoder"][trunk][name]["bias"]
        variables["params"]["decoder"][trunk][name]["bias"] = np.zeros_like(bias)
        getattr(pmodel.decoder, name).bias.data.zero_()
    opt = _keeping_grads(jax_train_state.make_optimizer(jspecs))
    override = make_fused_train_decoder_pixel(jspecs, interpret=True)
    assert override is not None and override.pixel
    jstep = jax.jit(jax_train_step.make_train_step(jmodel, jspecs, opt, override))
    jstate = jax_train_state.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        consts=variables.get("consts", {}), opt_state=opt.init(variables["params"]),
        epoch=jnp.asarray(1, jnp.int32))
    shares = _in_image_share(pmodel, pspecs, _batch(pspecs, 0))
    init_means = (jax_train_step.init_prediction_means(jmodel, jspecs, jstate),
                  init_prediction_means(pmodel, pspecs))
    pstate = TrainState(pmodel, make_optimizer(pspecs, pmodel.parameters()))
    pstep = make_train_step(pspecs)
    j_losses, p_losses, grads = [], [], None
    for i in range(3):
        batch = _batch(pspecs, i)
        key = jax.random.PRNGKey(i)
        seed = int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max))
        jstate = jstate.replace(epoch=jnp.asarray(i + 1, jnp.int32))
        jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        pstate.epoch = i + 1
        pl = pstep(pstate, batch_to_device(batch, "cpu"), seed)
        j_losses.append({k: float(v) for k, v in jl.items()})
        p_losses.append({k: float(v) for k, v in pl.items()})
        if i == 0:
            jg = from_jax(jax.tree_util.tree_map(np.asarray, jstate.opt_state[1]),
                          jax.tree_util.tree_map(np.asarray, jstate.batch_stats), pspecs)
            grads = [(k, p.grad.clone(), jg[k]) for k, p in pmodel.named_parameters()]
    ref = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                   jax.tree_util.tree_map(np.asarray, jstate.batch_stats), pspecs)
    return j_losses, p_losses, ref, pmodel, from_jax(
        variables["params"], variables["batch_stats"], pspecs), shares, grads, init_means


def test_trajectory_batch_projects_partly_into_the_image(trajectories):
    shares = trajectories[5]
    assert bool(((shares > 0) & (shares < 1)).all()), shares


def test_trajectory_losses_match_jax(trajectories):
    """The total to 1e-4 relative at every step; each term to 1e-4 relative
    or 1e-6 absolute, as the flagship's trajectory test holds them."""
    j_losses, p_losses, *_ = trajectories
    for jl, pl in zip(j_losses, p_losses):
        assert set(jl) == set(pl)
        np.testing.assert_allclose(pl["total"], jl["total"], rtol=1e-4)
        for k in jl:
            np.testing.assert_allclose(pl[k], jl[k], rtol=1e-4, atol=1e-6, err_msg=k)
    # the gate opened at epoch 3: contact was 0 before, not after
    assert p_losses[1]["contact"] == 0 and p_losses[2]["contact"] > 0


def test_first_step_gradients_match_jax(trajectories):
    """Every parameter's gradient of the first step to 1e-4 of its largest
    entry (2.4e-5 seen, in the encoder): the decoder's through K4's plain
    backward, the HeadNet's through d(table) and d(mean), the MANO
    branch's through d(xp), d(yp) and the projection."""
    grads = trajectories[6]
    assert len(grads) == len(list(trajectories[3].parameters()))
    for k, g, ref in grads:
        scale = float(ref.abs().max()) + 1e-30
        assert float((g - ref).abs().max()) <= 1e-4 * scale, k
    moved = {k.split(".")[0] for k, g, _ in grads if float(g.abs().max()) > 0}
    assert {"encoder", "mano_decoder", "decoder"} <= moved, moved


def test_trajectory_parameters_match_jax(trajectories):
    """Parameters after 3 steps to 1e-3 and BatchNorm running statistics to
    1e-4 (abs + rel), each tensor's update within 10% of JAX's in norm, and
    every decoder tensor moved.  The flagship's trajectory test also holds
    each decoder tensor's update to 1e-5 abs; here Adam's first update,
    about lr * sign(g), takes either sign where a weight-norm gradient entry
    lies within rounding of zero (3% of linh0.weight_v's entries lie below
    1e-7, its largest at 1.3e-4), and moves single entries by up to 7.5e-5.
    The gradients themselves are held above."""
    _, _, ref, pmodel, init, *_ = trajectories
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


def test_init_prediction_means_match_jax(trajectories):
    """The init guard's probe on a pixel-aligned spec, on the trajectory's
    initial weights: the mean hand and object predictions of the generic
    decoder on decoder_inputs' rows, in eval mode, as the JAX package's full
    model apply gives them."""
    (j_h, j_o), (p_h, p_o) = trajectories[7]
    np.testing.assert_allclose([p_h, p_o], [j_h, j_o], atol=1e-5, rtol=1e-4)
    assert abs(j_h) > 1e-4 and abs(j_o) > 1e-4
