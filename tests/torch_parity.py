"""Shared fixtures of the PyTorch-port parity tests: one narrow flagship
model built in JAX at a seed, its parameters converted into the port, and
seeded numpy samples."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import torch

from alignsdf_tpu.config import specs_from_dict as jax_specs_from_dict
from alignsdf_tpu.models.alignsdf import build_model as jax_build_model
from alignsdf_tpu.models.alignsdf import full_variables
from alignsdf_tpu.models.torch_import import convert_alignsdf
from alignsdf_torch.config import specs_from_dict
from alignsdf_torch.convert import from_jax
from alignsdf_torch.models.alignsdf import build_model

# "Full AlignSDF" (experiments/obman_30k.json + --mano --obj_pose --encode
# both --point_size 9) at a narrow decoder width
FLAGSHIP_NARROW = {
    "ModelType": "1encoder2decoder",
    "Backbone": "resnet18",
    "ImageSize": [256, 256],
    "SdfScaleFactor": 7.018621123357809,
    "LatentSize": 32,
    "PointFeatSize": 9,
    "EncodeStyle": "both",
    "PoseFeatSize": 15,
    "ManoBranch": True,
    "ObjectPoseBranch": True,
    "ObjCornerWeight": 0.2,
    "NetworkSpecs": {"dims": [64, 64, 64, 64], "dropout": [0, 1, 2, 3],
                     "dropout_prob": 0.2, "norm_layers": [0, 1, 2, 3],
                     "latent_in": [2], "weight_norm": True},
}

# the same with --pa_feat: the latent is the HeadNet map's 256 channels,
# sampled per point, so the trunks must be wider than 256 + 6 inputs
PIXEL_NARROW = {
    **FLAGSHIP_NARROW,
    "LatentSize": 256,
    "PixelAlign": True,
    "NetworkSpecs": {**FLAGSHIP_NARROW["NetworkSpecs"], "dims": [320, 320, 320, 320]},
}

CAM = np.array([[480.0, 0, 128, 0], [0, 480.0, 128, 0], [0, 0, 1, 0]], np.float32)


def make_sample(seed: int, key: str = "sample0"):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randint(0, 256, (256, 256, 3)).astype(np.uint8),
        "cam_intr": CAM.copy(),
        "mano_root": (rng.randn(3) * 0.02 + [0, 0, 0.6]).astype(np.float32),
        "rest_obj_corners": (rng.randn(8, 3) * 0.05).astype(np.float32),
        "key": key,
    }


def jax_variables_numpy(variables):
    return {k: jax.tree_util.tree_map(np.asarray, variables[k])
            for k in ("params", "batch_stats")}


def build_pair(specs_dict=FLAGSHIP_NARROW, seed: int = 0):
    """(JAX model, JAX variables, port model, JAX specs, port specs) with
    the same weights.  Batch statistics are randomized so BatchNorm is not
    the identity."""
    jspecs = jax_specs_from_dict(specs_dict)
    jmodel = jax_build_model(jspecs)
    sample = make_sample(seed)
    init = jax.jit(lambda k: jmodel.init(
        k, jnp.asarray(sample["image"][None], jnp.float32), jnp.zeros((4, 3)),
        {"cam_intr": CAM[None], "mano_root": sample["mano_root"][None],
         "rest_obj_corners": sample["rest_obj_corners"][None]}))
    v = jax_variables_numpy(init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 100)

    def perturb(path, a):
        name = path[-1].key
        if name == "mean":
            return (rng.randn(*a.shape) * 0.1).astype(np.float32)
        if name == "var":
            return (rng.rand(*a.shape) + 0.5).astype(np.float32)
        return a

    v["batch_stats"] = jax.tree_util.tree_map_with_path(perturb, v["batch_stats"])
    variables = full_variables(jmodel, v["params"], v["batch_stats"])
    pspecs = specs_from_dict(specs_dict)
    pmodel = build_model(pspecs)
    pmodel.load_state_dict(from_jax(v["params"], v["batch_stats"], pspecs))
    return jmodel, variables, pmodel, jspecs, pspecs


def build_pair_from_port(specs_dict, seed: int = 0):
    """build_pair's (JAX model, JAX variables, port model, JAX specs, port
    specs), the weights drawn by the port's seeded init and imported into
    JAX by the JAX package's reference importer (``convert_alignsdf``, which
    ``tests/test_torch_model.py`` holds to invert ``from_jax`` exactly): no
    compiled JAX init.  Batch statistics are randomized so BatchNorm is not
    the identity."""
    jspecs = jax_specs_from_dict(specs_dict)
    jmodel = jax_build_model(jspecs)
    pspecs = specs_from_dict(specs_dict)
    pmodel = build_model(pspecs, seed=seed)
    rng = np.random.RandomState(seed + 100)
    with torch.no_grad():
        for m in pmodel.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.copy_(torch.from_numpy(
                    (rng.randn(*m.running_mean.shape) * 0.1).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(
                    (rng.rand(*m.running_var.shape) + 0.5).astype(np.float32)))
    params, stats = convert_alignsdf(pmodel.state_dict(), jspecs, (2, 2, 2, 2))
    variables = jax.tree_util.tree_map(np.asarray, full_variables(jmodel, params, stats))
    return jmodel, variables, pmodel, jspecs, pspecs


@contextlib.contextmanager
def torch_threads(count: int):
    """Run torch's CPU ops on ``count`` intra-op threads, then restore the
    count.  The repo's test command runs six pytest workers on one
    machine's cores; each worker's torch would otherwise start a thread per
    core, and the oversubscribed threads spin, slowing small torch work
    many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(count)
    try:
        yield
    finally:
        torch.set_num_threads(before)


ENCODE_KEYS = ("latent", "joints", "verts", "global_trans", "rot_center", "center3d", "obj_rot",
               "obj_trans", "obj_corners")


def encode_outputs(latent, mano, obj) -> dict:
    """encode_scene's (latent, mano dict, object dict), JAX's or the port's,
    as {ENCODE_KEYS name: numpy array}."""
    both = {**mano, **obj, "latent": latent}
    return {k: np.asarray(both[k].detach() if isinstance(both[k], torch.Tensor) else both[k])
            for k in ENCODE_KEYS}


def jax_encode_scene(jmodel, variables, args) -> dict:
    return encode_outputs(*jax.jit(lambda v, *a: jmodel.apply(v, *a, method=jmodel.encode_scene))(
        variables, *map(jnp.asarray, args)))


def jax_encode_scene_rounded(specs_dict, pmodel, args, workdir) -> dict:
    """JAX's encode_scene on the port model's weights (``convert_alignsdf``),
    run in a fresh process whose XLA rounds wherever the code converts
    (``--xla_allow_excess_precision=false``).  By default XLA on the CPU
    drops a convert to bf16 and back, so JAX's bf16 encoder would hand its
    conv outputs on unrounded; the flag must be set before XLA starts."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(pmodel.state_dict(), os.path.join(workdir, "state.pt"))
    np.savez(os.path.join(workdir, "args.npz"), *args)
    with open(os.path.join(workdir, "specs.json"), "w") as f:
        json.dump(specs_dict, f)
    _rounding_subprocess("encode", workdir)
    with np.load(os.path.join(workdir, "out.npz")) as out:
        return dict(out)


def _rounding_subprocess(mode: str, workdir: str) -> None:
    """Run this file's ``mode`` in a fresh process whose XLA rounds wherever
    the code converts (``--xla_allow_excess_precision=false``, set before
    XLA starts), on the files in ``workdir``."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")])),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "") + " --xla_allow_excess_precision=false")
    run = subprocess.run([sys.executable, os.path.abspath(__file__), mode, workdir],
                         env=env, cwd=repo, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]


def jax_train_step_rounded(specs_dict, pmodel, batch, key: int, workdir) -> dict:
    """One step of JAX's train step (its train kernel in interpret mode as
    its decoder: the pixel-aligned, scene-factored or generic one, as its
    CLI routes the spec) from the port model's weights, on ``batch`` with
    ``jax.random.PRNGKey(key)``, under ``specs_dict``'s ComputeDtype and
    under float32, in a process that rounds where the code converts (XLA on
    the CPU otherwise drops a convert to bf16 and back, as in
    ``jax_encode_scene_rounded``).  Returns {"bfloat16" | "float32":
    (losses, the updated state dict in the port's keys as numpy)}."""
    os.makedirs(workdir, exist_ok=True)
    torch.save(pmodel.state_dict(), os.path.join(workdir, "state.pt"))
    np.savez(os.path.join(workdir, "batch.npz"), **batch)
    with open(os.path.join(workdir, "specs.json"), "w") as f:
        json.dump({"specs": specs_dict, "key": key}, f)
    _rounding_subprocess("step", workdir)
    out = {}
    for dtype in ("bfloat16", "float32"):
        with open(os.path.join(workdir, f"{dtype}.json")) as f:
            losses = json.load(f)
        with np.load(os.path.join(workdir, f"{dtype}.npz")) as sd:
            out[dtype] = (losses, dict(sd))
    return out


def _step_main(workdir: str) -> None:
    from alignsdf_tpu.ops.decoder_train_kernel import (
        make_fused_train_decoder,
        make_fused_train_decoder_factored,
    )
    from alignsdf_tpu.ops.decoder_train_pixel import make_fused_train_decoder_pixel
    from alignsdf_tpu.training import train_state as jax_train_state
    from alignsdf_tpu.training import train_step as jax_train_step

    jax.config.update("jax_platforms", "cpu")
    with open(os.path.join(workdir, "specs.json")) as f:
        cfg = json.load(f)
    state = torch.load(os.path.join(workdir, "state.pt"))
    with np.load(os.path.join(workdir, "batch.npz")) as b:
        batch = {k: jnp.asarray(b[k]) for k in b.files}
    for dtype in ("bfloat16", "float32"):
        specs_dict = {**cfg["specs"], "ComputeDtype": dtype}
        jspecs = jax_specs_from_dict(specs_dict)
        jmodel = jax_build_model(jspecs)
        params, stats = convert_alignsdf(state, jspecs, (2, 2, 2, 2))
        variables = full_variables(jmodel, params, stats)
        opt = jax_train_state.make_optimizer(jspecs)
        # routed as the JAX CLI routes it (cli/train.py:225-228)
        override = (make_fused_train_decoder_pixel(jspecs, interpret=True)
                    or make_fused_train_decoder_factored(jspecs, interpret=True)
                    or make_fused_train_decoder(jspecs, block=128, interpret=True))
        step = jax.jit(jax_train_step.make_train_step(jmodel, jspecs, opt, override))
        jstate = jax_train_state.TrainState(
            params=variables["params"], batch_stats=variables["batch_stats"],
            consts=variables.get("consts", {}), opt_state=opt.init(variables["params"]),
            epoch=jnp.asarray(1, jnp.int32))
        jstate, losses = step(jstate, batch, jax.random.PRNGKey(cfg["key"]))
        sd = from_jax(jax.tree_util.tree_map(np.asarray, jstate.params),
                      jax.tree_util.tree_map(np.asarray, jstate.batch_stats),
                      specs_from_dict(specs_dict))
        np.savez(os.path.join(workdir, f"{dtype}.npz"), **{k: v.numpy() for k, v in sd.items()})
        with open(os.path.join(workdir, f"{dtype}.json"), "w") as f:
            json.dump({k: float(v) for k, v in losses.items()}, f)


def _encode_main(workdir: str) -> None:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    with open(os.path.join(workdir, "specs.json")) as f:
        jspecs = jax_specs_from_dict(json.load(f))
    jmodel = jax_build_model(jspecs)
    state = torch.load(os.path.join(workdir, "state.pt"))
    params, stats = convert_alignsdf(state, jspecs, (2, 2, 2, 2))
    variables = jax.tree_util.tree_map(np.asarray, full_variables(jmodel, params, stats))
    with np.load(os.path.join(workdir, "args.npz")) as a:
        args = [a[f"arr_{i}"] for i in range(len(a.files))]
    np.savez(os.path.join(workdir, "out.npz"), **jax_encode_scene(jmodel, variables, args))


if __name__ == "__main__":
    if sys.argv[1:2] == ["encode"]:
        _encode_main(sys.argv[2])
    elif sys.argv[1:2] == ["step"]:
        _step_main(sys.argv[2])
