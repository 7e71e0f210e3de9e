"""DeepSDF-style hand/object SDF decoders in eval mode, the same function as
the JAX package's ``models/decoder.py`` (reference networks/model.py:79-350).

Layer modules are direct children named ``lin{i}`` (combined) or
``linh{i}``/``lino{i}`` (separate), as in the reference state_dict.  This is
the generic decode: it runs on materialized [latent, embedding] rows and
serves on the CPU as a second reference for the fused grid kernel.  With
``use_classifier`` the hand (or combined) trunk also feeds its last layer's
input to ``classifier_head``, a plain Linear to ``num_class`` part logits
(JAX ``models/decoder.py:68-70``), taken before any ``latent_in`` concat.
Both decoders return (sdf_hand, sdf_obj, logits | None), float32.

The compute dtype (``layers.set_compute_dtype``; JAX ``models/decoder.py``
:51-86, :121-203): under bfloat16 a trunk casts its input rows to bf16, its
layers compute in bf16 (``layers.py``), the ReLUs and the final tanh run on
bf16, and the outputs and logits are cast back to float32.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from alignsdf_torch.config import NetworkSpecs
from alignsdf_torch.models.layers import TorchLinear, WeightNormLinear


def trunk_layer_dims(in_dim: int, specs: NetworkSpecs, out_dim: int) -> List[Tuple[int, int]]:
    """(in, out) of each trunk layer.  A layer before a ``latent_in`` layer
    emits ``width - in_dim`` features; the ``latent_in`` layer itself reads
    [x, input]."""
    dims = (in_dim,) + tuple(specs.dims) + (out_dim,)
    shapes = []
    cur = in_dim
    for layer in range(len(dims) - 1):
        out = dims[layer + 1] - dims[0] if layer + 1 in specs.latent_in else dims[layer + 1]
        if out <= 0:
            raise ValueError(f"latent_in layer {layer + 1}: width {dims[layer + 1]} "
                             f"must exceed the input width {dims[0]}")
        layer_in = cur + in_dim if layer in specs.latent_in else cur
        shapes.append((layer_in, out))
        cur = out
    return shapes


def _check_supported(specs: NetworkSpecs) -> None:
    if not specs.weight_norm or specs.use_tanh or specs.xyz_in_all:
        raise NotImplementedError(
            "the port's decoder covers weight-norm trunks without use_tanh "
            "or xyz_in_all")


class _Trunks(nn.Module):
    """Shared forward of the trunks: ReLU hidden layers, latent re-injection
    at ``latent_in``, final tanh; the classifier head, if any, on the input
    of the first trunk's last layer."""

    specs: NetworkSpecs
    classifier_head: Optional[nn.Linear]
    compute_dtype = torch.float32

    def _add_trunk(self, prefix: str, in_dim: int, out_dim: int,
                   use_classifier: bool = False) -> None:
        shapes = trunk_layer_dims(in_dim, self.specs, out_dim)
        for layer, (i, o) in enumerate(shapes):
            linear = WeightNormLinear if layer in self.specs.norm_layers else TorchLinear
            setattr(self, f"{prefix}{layer}", linear(i, o))
        if use_classifier:
            self.classifier_head = TorchLinear(shapes[-2][1], self.specs.num_class)

    def _run_trunk(self, prefix: str, x: torch.Tensor, classify: bool = False):
        """(tanh'd outputs, logits | None) of one trunk, float32."""
        x = x.to(self.compute_dtype)
        inputs = x
        n_layers = len(self.specs.dims) + 1
        logits = None
        for layer in range(n_layers):
            if classify and layer == n_layers - 1:
                logits = self.classifier_head(x)
            if layer in self.specs.latent_in:
                x = torch.cat([x, inputs], dim=1)
            x = getattr(self, f"{prefix}{layer}")(x)
            if layer < n_layers - 1:
                x = torch.relu(x)
        return (torch.tanh(x).to(torch.float32),
                None if logits is None else logits.to(torch.float32))


class CombinedDecoder(_Trunks):
    """One trunk, two SDF outputs (reference networks/model.py:79-188)."""

    def __init__(self, latent_size: int, point_feat_size: int, specs: NetworkSpecs,
                 use_classifier: bool = False):
        super().__init__()
        _check_supported(specs)
        self.specs = specs
        self.classifier_head = None
        self._add_trunk("lin", latent_size + point_feat_size, 2, use_classifier)

    def forward(self, inputs: torch.Tensor):
        x, logits = self._run_trunk("lin", inputs, self.classifier_head is not None)
        return x[:, 0:1], x[:, 1:2], logits


def separate_input_widths(latent_size: int, pfs: int, encode_style: str) -> Tuple[int, int]:
    widths = {"nerf": (pfs, pfs), "hand": (pfs, 3), "obj": (3, pfs), "both": (pfs - 3, 6)}
    if encode_style not in widths:
        raise ValueError(f"unknown encode_style {encode_style!r}")
    h, o = widths[encode_style]
    return latent_size + h, latent_size + o


def separate_decoder_inputs(latent_size: int, encode_style: str, x: torch.Tensor):
    """Per-branch slices of the [latent, embedding] rows
    (reference networks/model.py:285-299)."""
    ls = latent_size
    if encode_style == "nerf":
        return x, x
    if encode_style == "hand":
        return x, x[:, : ls + 3]
    if encode_style == "obj":
        return x[:, : ls + 3], x
    if encode_style == "both":
        return x[:, :-3], torch.cat([x[:, : ls + 3], x[:, -3:]], dim=1)
    raise ValueError(f"unknown encode_style {encode_style!r}")


class SeparateDecoder(_Trunks):
    """Twin hand/object trunks (reference networks/model.py:191-350)."""

    def __init__(self, latent_size: int, point_feat_size: int, encode_style: str,
                 specs: NetworkSpecs, use_classifier: bool = False):
        super().__init__()
        _check_supported(specs)
        self.specs = specs
        self.latent_size = latent_size
        self.encode_style = encode_style
        in_hand, in_obj = separate_input_widths(latent_size, point_feat_size, encode_style)
        self.classifier_head = None
        self._add_trunk("linh", in_hand, 1, use_classifier)
        self._add_trunk("lino", in_obj, 1)

    def forward(self, inputs: torch.Tensor):
        xh, xo = separate_decoder_inputs(self.latent_size, self.encode_style, inputs)
        sdf_hand, logits = self._run_trunk("linh", xh, self.classifier_head is not None)
        return sdf_hand, self._run_trunk("lino", xo)[0], logits


def make_decoder(model_type: str, latent_size: int, point_feat_size: int,
                 encode_style: str, specs: NetworkSpecs, use_classifier: bool = False):
    """Factory matching reference train.py:333-369."""
    if model_type == "1encoder1decoder":
        return CombinedDecoder(latent_size, point_feat_size, specs, use_classifier)
    return SeparateDecoder(latent_size, point_feat_size, encode_style, specs, use_classifier)


def trunk_prefixes(decoder: nn.Module) -> Tuple[str, Optional[str]]:
    """Layer-name prefixes of the decoder's (first, second) trunk."""
    if isinstance(decoder, CombinedDecoder):
        return "lin", None
    return "linh", "lino"
