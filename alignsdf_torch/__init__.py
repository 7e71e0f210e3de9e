"""AlignSDF in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

The package mirrors ``alignsdf_tpu``'s layout (``ops/``, ``mano/``,
``models/``, ``inference/``, ``geom/``, ``cli/``) and computes the same
functions; hand-written kernels live in ``kernels/``.  It imports nothing of
the JAX package: what it needs from there is copied.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) but absent, so an
    entry point never drops to the CPU on its own.
    """
    import torch  # here, so that the host-only evaluation imports without torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def use_float32_precision() -> None:
    """Run float32 as float32: TF32 off for matmuls and for cuDNN
    convolutions, the mode the port's parity tests hold its kernels to.  The
    CLIs and ``chip_smoke.py`` call this before they build anything, so
    every time they report is a time of that one mode (PyTorch's default
    would run the encoder's convolutions in TF32)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
