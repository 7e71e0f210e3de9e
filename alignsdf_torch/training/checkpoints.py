"""Checkpoints in the reference's layout (reference train.py:89-140):

    <experiment_dir>/ModelParameters/<name>.pth      {"epoch", "model_state_dict"}
    <experiment_dir>/OptimizerParameters/<name>.pth  {"epoch", "optimizer_state_dict"}

Each file is written to a temporary name and renamed into place, so a
reader never sees half a checkpoint.  ``cli/reconstruct.py`` loads the model
file as it loads a reference checkpoint.
"""

from __future__ import annotations

import os
import tempfile

import torch

from alignsdf_torch.training.train_state import TrainState

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
