"""Linear layers with the reference's parameter names.

``WeightNormLinear`` keeps torch ``nn.utils.weight_norm``'s state_dict keys
(``weight_v``, ``weight_g``, ``bias``) so a reference checkpoint loads with
``load_state_dict``; the effective weight is g * v / ||v|| with the norm over
the input axis (dim 1 of the (out, in) weight).

Both carry a compute dtype, as the JAX package's ``models/layers.py``
layers do: the parameters stay float32; under bfloat16 the input and the
weight (a weight-norm layer's effective weight, formed in float32) are
cast to bf16, their product is bf16, and the bias, cast to bf16, is added
in bf16 (``x.astype(dtype) @ kernel.astype(dtype) + bias.astype(dtype)``).
Under float32 the casts are no-ops.  ``set_compute_dtype`` sets it on every
layer of a module that has one.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a spec's ``ComputeDtype``."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"ComputeDtype {name!r}: the port computes in {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Set the compute dtype of every submodule of ``module`` that has one."""
    for m in module.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = dtype


def _linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return F.linear(x, weight, bias)
    y = F.linear(x.to(dtype), weight.to(dtype))
    return y if bias is None else y + bias.to(dtype)


class TorchLinear(nn.Linear):
    """``nn.Linear`` (same parameters, init and state_dict) with a compute
    dtype."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.weight, self.bias, self.compute_dtype)


class WeightNormLinear(nn.Module):
    compute_dtype = torch.float32

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features).uniform_(-bound, bound))
        self.weight_g = nn.Parameter(torch.linalg.norm(self.weight_v.detach(), dim=1, keepdim=True))
        self.bias = nn.Parameter(torch.empty(out_features).uniform_(-bound, bound))

    def weight(self) -> torch.Tensor:
        v = self.weight_v
        return v * (self.weight_g.reshape(-1, 1) / torch.linalg.norm(v, dim=1, keepdim=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(x, self.weight(), self.bias, self.compute_dtype)


def materialize_linear(layer: nn.Module):
    """(weight (out, in), bias (out,)) of a TorchLinear or WeightNormLinear."""
    if isinstance(layer, WeightNormLinear):
        return layer.weight(), layer.bias
    return layer.weight, layer.bias
