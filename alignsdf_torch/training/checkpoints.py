"""Checkpoints in the reference's layout (reference train.py:89-140):

    <experiment_dir>/ModelParameters/<name>.pth      {"epoch", "model_state_dict"}
    <experiment_dir>/OptimizerParameters/<name>.pth  {"epoch", "optimizer_state_dict"}

Each file is written to a temporary name and renamed into place, so a
reader never sees half a checkpoint.  ``cli/reconstruct.py`` loads the model
file as it loads a reference checkpoint.  ``restore_checkpoint`` serves
``--continue`` (model, optimizer and the saved epoch), ``warm_start`` the
spec's ``Resume`` (weights only, non-strict; reference train.py:406-420).
"""

from __future__ import annotations

import logging
import os
import tempfile
from typing import Dict

import torch

from alignsdf_torch.training.train_state import TrainState

logger = logging.getLogger(__name__)

MODEL_DIR = "ModelParameters"
OPTIMIZER_DIR = "OptimizerParameters"


def _atomic_save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(path))
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def save_checkpoint(experiment_dir: str, state: TrainState, epoch: int, name: str) -> None:
    _atomic_save({"epoch": epoch, "model_state_dict": state.model.state_dict()},
                 os.path.join(experiment_dir, MODEL_DIR, f"{name}.pth"))
    _atomic_save({"epoch": epoch, "optimizer_state_dict": state.optimizer.state_dict()},
                 os.path.join(experiment_dir, OPTIMIZER_DIR, f"{name}.pth"))


def restore_checkpoint(experiment_dir: str, state: TrainState, name: str = "latest") -> int:
    """Load model and optimizer state in place; returns the saved epoch."""
    device = next(state.model.parameters()).device
    model = torch.load(os.path.join(experiment_dir, MODEL_DIR, f"{name}.pth"),
                       map_location=device, weights_only=False)
    state.model.load_state_dict(model["model_state_dict"])
    opt = torch.load(os.path.join(experiment_dir, OPTIMIZER_DIR, f"{name}.pth"),
                     map_location=device, weights_only=False)
    state.optimizer.load_state_dict(opt["optimizer_state_dict"])
    return int(model["epoch"])


def checkpoint_exists(experiment_dir: str, name: str = "latest") -> bool:
    return os.path.isfile(os.path.join(experiment_dir, MODEL_DIR, f"{name}.pth"))


def warm_start(state: TrainState, resume_path: str) -> Dict[str, int]:
    """Load a model checkpoint's weights non-strictly (reference
    train.py:406-409, ``strict=False``): every entry whose name and shape
    match is copied, the rest keep their initial values, and the optimizer
    stays fresh.  ``resume_path`` is a ``.pth`` file or an experiment
    directory (its ModelParameters/latest.pth).  Returns the counts."""
    path = resume_path
    if os.path.isdir(path):
        path = os.path.join(path, MODEL_DIR, "latest.pth")
    saved = torch.load(path, map_location="cpu", weights_only=False)
    saved = saved.get("model_state_dict", saved)
    own = state.model.state_dict()
    stats = {"loaded": 0, "missing": 0, "mismatched": 0}
    with torch.no_grad():
        for key, value in own.items():
            if key not in saved:
                stats["missing"] += 1
            elif tuple(saved[key].shape) != tuple(value.shape):
                stats["mismatched"] += 1
            else:
                value.copy_(saved[key])
                stats["loaded"] += 1
    logger.info("warm start from %s: %d entries loaded, %d missing, %d shape-mismatched",
                path, stats["loaded"], stats["missing"], stats["mismatched"])
    return stats
