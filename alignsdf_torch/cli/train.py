"""Training CLI on one GPU (the JAX package's ``cli/train.py``; reference
train.py:201-714).

Usage:
    python -m alignsdf_torch.cli.train -e experiments/obman_30k.json \\
        --mano --obj_pose --encode both --point_size 9 [--pa_feat | --cls] \\
        [--add_epoch E] [--smoke | --steps N] [--device cuda] [--no_init_guard]

The flagship trains its twin trunks through kernel K2; with ``--pa_feat``
(a latent sampled per point from the HeadNet map) through kernel K4; a spec
whose NetworkSpecs put a latent input at layer 0 (``latent_in`` holding 0),
which both decline, through kernel K5 on materialized [latent, embedding]
rows.  The log names the decoder.  With ``--cls`` (the hand-part
classifier, e.g. on experiments/dexycb_140k.json) the kernel also gives the
hand trunk's last hidden activation, whose logits feed the cross-entropy
from AdditionalLossStart (``--add_epoch``) on.

The dataset reader is not ported yet, so training runs on synthetic batches
(``data/synthetic.py``) of ScenesPerBatch scenes: ``--smoke`` takes 2 steps
on one batch of 2 scenes and writes nothing; ``--steps N`` takes N steps on
N seeded batches in epoch 1 and saves ``<output_root>/<experiment>/
ModelParameters/latest.pth``, which ``cli/reconstruct.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Callable, Optional, Tuple

import torch

from alignsdf_torch import config as cfg
from alignsdf_torch import resolve_device, use_float32_precision
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.training import checkpoints as ckpt
from alignsdf_torch.training.train_state import TrainState
from alignsdf_torch.training.train_step import (
    batch_to_device,
    draw_seed,
    healthy_init_train_state,
    init_train_state,
    make_train_step,
    train_decoder_kind,
)

logger = logging.getLogger("alignsdf_torch.train")

# override flags of cfg.add_train_args that act only through the dataset
# reader, the augmentation or later epochs, none of which this CLI runs yet
_NOT_RUN = ("no_aug", "bg_aug", "epoch", "lr_interval", "lr_factor")


def make_trainer(specs: cfg.Specs, device, seed: int = 0,
                 init_guard: bool = True) -> Tuple[TrainState, Callable]:
    """(state, step) for a fresh model on ``device``: the init guard
    re-draws the seeded init until its probe predictions sit inside the
    clamp band (unless ``init_guard`` is False); ``step(state, batch, seed)``
    is the spec's train step: through K4 for a pixel-aligned spec
    (``--pa_feat``), else K2, else K5 (``train_step.make_spec_train_decoder``;
    ``step.decode`` is the decoder)."""
    if init_guard and specs.clamping_distance:
        state, tries = healthy_init_train_state(specs, device, seed)
        if tries > 1:
            logger.warning("init guard: re-drew the init %d time(s); the first draw(s) "
                           "started inside the %.2f clamp's zero-gradient dead zone",
                           tries - 1, specs.clamping_distance)
    else:
        state = init_train_state(specs, device, seed)
    return state, make_train_step(specs)


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="AlignSDF training (PyTorch/CUDA)")
    parser.add_argument("-e", dest="cfg", required=True, help="experiment spec json")
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--smoke", action="store_true",
                        help="2 steps on one synthetic batch of 2 scenes; no checkpoint")
    parser.add_argument("--steps", type=int, default=1,
                        help="steps on synthetic batches (without --smoke)")
    parser.add_argument("--no_init_guard", action="store_true",
                        help="skip the clamp dead-zone check of the fresh init")
    cfg.add_train_args(parser)
    args = parser.parse_args(argv)
    idle = [f"--{flag}" for flag in _NOT_RUN if getattr(args, flag) not in (None, False)]
    if idle:
        parser.error(f"{' '.join(idle)}: the port trains on synthetic batches in epoch 1 "
                     "only (no dataset reader, augmentation or epoch loop yet), so these "
                     "would change nothing but the experiment's name")

    logging.basicConfig(force=True, level=logging.INFO,
                        format="AlignSDF-torch - %(levelname)s - %(message)s")
    device = resolve_device(args.device)
    use_float32_precision()
    specs = cfg.apply_overrides(cfg.load_specs(args.cfg), args)
    seed = specs.random_seed or 0
    state, step = make_trainer(specs, device, seed,
                               init_guard=not (args.smoke or args.no_init_guard))
    logger.info("train decoder: %s", train_decoder_kind(step.decode))
    gen = torch.Generator().manual_seed(seed)

    if args.smoke:
        batch = batch_to_device(synthetic_train_batch(specs, batch_size=2), device)
        for i in range(2):
            losses = step(state, batch, draw_seed(gen))
            logger.info("smoke step %d: loss=%.5f", i, float(losses["total"]))
            logger.info("smoke terms %d: %s", i, " ".join(
                f"{k}={float(v):.6g}" for k, v in sorted(losses.items()) if k != "total"))
        logger.info("smoke OK")
        return

    experiment_dir = os.path.join(args.output_root, specs.experiment_name())
    os.makedirs(experiment_dir, exist_ok=True)
    with open(os.path.join(experiment_dir, "specs.json"), "w") as f:
        json.dump(cfg.specs_to_dict(specs), f, indent=2)
    for i in range(args.steps):
        batch = batch_to_device(
            synthetic_train_batch(specs, batch_size=specs.scenes_per_batch, seed=i), device)
        losses = step(state, batch, draw_seed(gen))
        logger.info("epoch %d step %d: %s", state.epoch, i + 1,
                    " ".join(f"{k}={float(v):.6f}" for k, v in sorted(losses.items())))
    ckpt.save_checkpoint(experiment_dir, state, state.epoch, "latest")
    logger.info("saved %s", os.path.join(experiment_dir, ckpt.MODEL_DIR, "latest.pth"))


if __name__ == "__main__":
    main()
