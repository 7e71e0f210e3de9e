"""Training CLI on one GPU (the JAX package's ``cli/train.py``; reference
train.py:201-714).

Usage:
    python -m alignsdf_torch.cli.train -e experiments/obman_30k.json \\
        --mano --obj_pose --encode both --point_size 9 [--pa_feat | --cls] \\
        [--add_epoch E] (--data_root DIR [--continue NAME] | --smoke | --steps N) \\
        [--device cuda] [--no_init_guard]

The flagship trains its twin trunks through kernel K2; with ``--pa_feat``
(a latent sampled per point from the HeadNet map) through kernel K4; a spec
whose NetworkSpecs put a latent input at layer 0 (``latent_in`` holding 0),
which both decline, through kernel K5 on materialized [latent, embedding]
rows.  The log names the decoder.  With ``--cls`` (the hand-part
classifier, e.g. on experiments/dexycb_140k.json) the kernel also gives the
hand trunk's last hidden activation, whose logits feed the cross-entropy
from AdditionalLossStart (``--add_epoch``) on.

With ``--data_root`` (a dataset in the reference's five-LMDB layout, e.g.
from ``data/synthetic.py:write_synthetic_lmdb``) it runs the epoch loop of
the JAX package's CLI (``cli/train.py:284-390``; reference train.py:446-640):
the TrainSplit's keys, or every key of the LMDB when TrainSplit is empty,
shuffled per epoch by the threaded loader (DataLoaderThreads workers,
ScenesPerBatch scenes, the last partial batch dropped); the step LR of each
epoch; losses every LogFrequencyStep steps and each epoch's LR and time in
``<experiment>/metrics.jsonl``; ``latest`` every LogFrequency epochs and at
the end, numbered snapshots at SnapshotFrequency and AdditionalSnapshots.
``--continue NAME`` (or an existing ``latest``) resumes after the saved
epoch; NAME may also be another experiment's directory, whose ``latest`` is
taken, since ``--epoch`` renames the experiment.  The spec's Resume, where
that file exists, warm-starts the weights.
Not ported: the SLURM requeue handler, ``--multistep``, ``--packed``,
``--loader_mode`` and the post-training test reconstruction.

Without it, training runs on synthetic batches (``data/synthetic.py``) of
ScenesPerBatch scenes: ``--smoke`` takes 2 steps on one batch of 2 scenes and
writes nothing; ``--steps N`` takes N steps on N seeded batches in epoch 1
and saves ``<output_root>/<experiment>/ModelParameters/latest.pth``, which
``cli/reconstruct.py`` reads.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Callable, Optional, Tuple

import torch

from alignsdf_torch import config as cfg
from alignsdf_torch import resolve_device, use_float32_precision
from alignsdf_torch.data import make_train_dataset
from alignsdf_torch.data.dataset import to_train_batch
from alignsdf_torch.data.loader import DataLoader
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.training import checkpoints as ckpt
from alignsdf_torch.training.train_state import TrainState, learning_rate_for_epoch
from alignsdf_torch.training.train_step import (
    batch_to_device,
    draw_seed,
    healthy_init_train_state,
    init_train_state,
    make_train_step,
    train_decoder_kind,
)
from alignsdf_torch.utils.metrics import MetricsLogger

logger = logging.getLogger("alignsdf_torch.train")

# override flags of cfg.add_train_args that act only through the dataset,
# the augmentation or later epochs, which synthetic batches in epoch 1 lack
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


def make_loader(specs: cfg.Specs, data_root: str) -> DataLoader:
    """The epoch loop's loader: the TrainSplit's keys (every key of the
    dataset when TrainSplit is empty) in batches of ScenesPerBatch scenes,
    uint8 images, DataLoaderThreads workers, seeded by RandomSeed."""
    split_keys = None
    if specs.train_split:
        with open(specs.train_split) as f:
            split_keys = json.load(f)["train"]
    dataset = make_train_dataset(specs, data_root, split_keys, raw_image=True)
    logger.info("train dataset: %d scenes via %s", len(dataset), type(dataset.backend).__name__)
    return DataLoader(dataset, batch_size=specs.scenes_per_batch,
                      num_workers=specs.data_loader_threads, seed=specs.random_seed or 0,
                      to_batch=lambda stacked: to_train_batch(specs, stacked))


def main(argv: Optional[list] = None) -> None:
    parser = argparse.ArgumentParser(description="AlignSDF training (PyTorch/CUDA)")
    parser.add_argument("-e", dest="cfg", required=True, help="experiment spec json")
    parser.add_argument("--data_root", default=None,
                        help="dataset directory (five LMDBs); epochs over it")
    parser.add_argument("--continue", dest="continue_from", default=None,
                        help="resume (with --data_root) from this experiment's checkpoint "
                             "of this name, or from the latest of the experiment directory "
                             "given, e.g. a finished run extended with a larger --epoch")
    parser.add_argument("--output_root", default="outputs")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--smoke", action="store_true",
                        help="2 steps on one synthetic batch of 2 scenes; no checkpoint")
    parser.add_argument("--steps", type=int, default=None,
                        help="steps on synthetic batches (default 1, without --data_root)")
    parser.add_argument("--no_init_guard", action="store_true",
                        help="skip the clamp dead-zone check of the fresh init")
    cfg.add_train_args(parser)
    args = parser.parse_args(argv)
    if args.data_root is None:
        idle = [f"--{flag}" for flag in _NOT_RUN if getattr(args, flag) not in (None, False)]
        if idle:
            parser.error(f"{' '.join(idle)}: without --data_root the port trains on synthetic "
                         "batches in epoch 1 only (no augmentation or later epochs), so these "
                         "would change nothing but the experiment's name")
        if args.continue_from:
            parser.error("--continue resumes the epoch loop, which needs --data_root")
    elif args.smoke or args.steps is not None:
        parser.error("--smoke and --steps train on synthetic batches; with --data_root the "
                     "spec's NumEpochs (--epoch) sets the length")

    logging.basicConfig(force=True, level=logging.INFO,
                        format="AlignSDF-torch - %(levelname)s - %(message)s")
    device = resolve_device(args.device)
    use_float32_precision()
    specs = cfg.apply_overrides(cfg.load_specs(args.cfg), args)
    seed = specs.random_seed or 0
    experiment_dir = os.path.join(args.output_root, specs.experiment_name())
    if args.data_root is not None:
        train_epochs(specs, args, device, experiment_dir)
        return

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

    os.makedirs(experiment_dir, exist_ok=True)
    with open(os.path.join(experiment_dir, "specs.json"), "w") as f:
        json.dump(cfg.specs_to_dict(specs), f, indent=2)
    for i in range(1 if args.steps is None else args.steps):
        batch = batch_to_device(
            synthetic_train_batch(specs, batch_size=specs.scenes_per_batch, seed=i), device)
        losses = step(state, batch, draw_seed(gen))
        logger.info("epoch %d step %d: %s", state.epoch, i + 1,
                    " ".join(f"{k}={float(v):.6f}" for k, v in sorted(losses.items())))
    ckpt.save_checkpoint(experiment_dir, state, state.epoch, "latest")
    logger.info("saved %s", os.path.join(experiment_dir, ckpt.MODEL_DIR, "latest.pth"))


def train_epochs(specs: cfg.Specs, args, device, experiment_dir: str) -> None:
    """The epoch loop over ``args.data_root`` (JAX ``cli/train.py:185-197``,
    :284-390)."""
    seed = specs.random_seed or 0
    resume = bool(specs.resume) and os.path.exists(specs.resume)
    fresh = not (resume or args.continue_from or ckpt.checkpoint_exists(experiment_dir))
    state, step = make_trainer(specs, device, seed,
                               init_guard=fresh and not args.no_init_guard)
    logger.info("train decoder: %s", train_decoder_kind(step.decode))
    os.makedirs(experiment_dir, exist_ok=True)
    with open(os.path.join(experiment_dir, "specs.json"), "w") as f:
        json.dump(cfg.specs_to_dict(specs), f, indent=2)
    start_epoch = 1
    if resume:  # the spec's Resume warm start; a later --continue overrides it
        ckpt.warm_start(state, specs.resume)
    source, name = experiment_dir, args.continue_from
    if name and os.path.isdir(name):
        source, name = name, "latest"
    elif not name and ckpt.checkpoint_exists(experiment_dir):
        name = "latest"
    if name:
        saved_epoch = ckpt.restore_checkpoint(source, state, name)
        start_epoch = saved_epoch + 1
        logger.info("resumed from %s of %s at epoch %d", name, source, saved_epoch)

    loader = make_loader(specs, args.data_root)
    metrics = MetricsLogger(experiment_dir)
    gen = torch.Generator().manual_seed(seed)
    log_step = 0
    for epoch in range(start_epoch, specs.num_epochs + 1):
        loader.set_epoch(epoch)
        state.epoch = epoch
        start = time.time()
        for batch in loader:
            losses = step(state, batch_to_device(batch, device), draw_seed(gen))
            log_step += 1
            if log_step % specs.log_frequency_step == 0:
                vals = {k: float(v) for k, v in losses.items()}
                logger.info("epoch %d step %d: " + " ".join(
                    f"{k}={v * 1000:.3f}e-3" for k, v in sorted(vals.items())), epoch, log_step)
                metrics.log_step(epoch, log_step, vals)
        metrics.log_epoch(epoch, learning_rate_for_epoch(specs, epoch), time.time() - start)
        logger.info("epoch %d time: %.1fs", epoch, time.time() - start)
        if epoch % specs.log_frequency == 0:
            ckpt.save_checkpoint(experiment_dir, state, epoch, "latest")
        if epoch in specs.additional_snapshots or (
                specs.snapshot_frequency and epoch % specs.snapshot_frequency == 0):
            ckpt.save_checkpoint(experiment_dir, state, epoch, str(epoch))
    ckpt.save_checkpoint(experiment_dir, state, specs.num_epochs, "latest")
    logger.info("training complete: %s", experiment_dir)


if __name__ == "__main__":
    main()
