"""Host-side half of the generic decoder: materialize each trunk's layers
as dense matrices, split every ``latent_in`` layer into its weights on the
previous activation and on the trunk's input row, and hand the packed
trunks to kernel K6.

Counterpart of the JAX package's ``ops/decoder_kernel.py`` generic helpers:
``build_branch_plan`` :59, ``separate_decoder_inputs`` :1409 (the port's
copy is ``models/decoder.py``), ``_classifier_pad`` :1426 (here the class
rows are extra final rows of the first trunk, ``grid_plan.with_classifier``)
and ``make_pallas_decode_fn`` :1438.  ``pad_inputs`` :1385 has no
counterpart: K6 reads the rows at their own width.  The plan pads to what
the CUDA kernel wants (float32: hidden widths to the tensor-core trunk's
128-feature groups, the input row to a multiple of 8; bf16: both to a
multiple of 16), not to the TPU's 128 lanes.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch

from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.kernels.generic_decoder import GenericPlan, generic_decode, pack_generic_plan
from alignsdf_torch.kernels.grid_decoder import FoldedTrunk, HiddenLayer
from alignsdf_torch.models.decoder import (
    separate_decoder_inputs,
    separate_input_widths,
    trunk_layer_dims,
    trunk_prefixes,
)
from alignsdf_torch.models.layers import materialize_linear
from alignsdf_torch.ops.grid_plan import first_layer_weight, with_classifier


def build_branch_plan(layers: List[Tuple[torch.Tensor, torch.Tensor]], in_dim: int,
                      specs: NetworkSpecs, out_dim: int, rows: Sequence[int]) -> FoldedTrunk:
    """One trunk given as materialized (weight (out, in), bias) layers, as
    dense (in, out) matrices: layer 0 on the input row (both halves summed
    when 0 is in ``latent_in``), a latent_in layer split into W_x on the
    previous activation and W_in on the input row, the last layer as the
    final rows ``rows`` (with its W_in as ``fin_x`` where it re-injects)."""
    shapes = trunk_layer_dims(in_dim, specs, out_dim)
    hidden: List[HiddenLayer] = []
    cur = in_dim
    for layer, (weight, b) in enumerate(layers):
        w = weight.to(torch.float32).T
        b = b.to(torch.float32)
        if layer == 0:
            hidden.append(HiddenLayer(None, first_layer_weight(w, in_dim, specs), b))
        elif layer in specs.latent_in:
            # the torch layer's input was [x (cur), input (in_dim)]
            hidden.append(HiddenLayer(w[:cur], w[cur:cur + in_dim], b))
        else:
            hidden.append(HiddenLayer(w, None, b))
        cur = shapes[layer][1]
    last = hidden.pop()
    if last.w is None:
        raise ValueError("the generic decoder needs at least one hidden layer")
    return FoldedTrunk(hidden, last.w, last.x, last.b, rows)


def trunk_input_widths(specs: Specs) -> Tuple[int, ...]:
    """Each trunk's input width: one combined trunk, or the hand and object
    trunks' slices of the [latent, embedding] row."""
    ls, pfs = specs.latent_size, specs.point_feat_size
    if specs.model_type == "1encoder1decoder":
        return (ls + pfs,)
    return separate_input_widths(ls, pfs, specs.encode_style)


def make_generic_plan(decoder: torch.nn.Module, specs: Specs,
                      dtype: torch.dtype = torch.float32) -> GenericPlan:
    """K6's packed plan of the decoder's trunks (weight norm materialized),
    the classifier's rows on the first trunk, on the decoder's device,
    computing in ``dtype`` (JAX's ``build_branch_plan(..., dtype)``: bf16
    weights, float32 biases)."""
    ns = specs.network_specs
    n_layers = len(ns.dims) + 1
    widths = trunk_input_widths(specs)

    def trunk(prefix, in_dim, out_dim, rows):
        layers = [materialize_linear(getattr(decoder, f"{prefix}{i}")) for i in range(n_layers)]
        return build_branch_plan(layers, in_dim, ns, out_dim, rows)

    with torch.no_grad():
        first, second = trunk_prefixes(decoder)
        if second is None:
            trunks = [trunk(first, widths[0], 2, [0, 1])]
        else:
            trunks = [trunk(first, widths[0], 1, [0]), trunk(second, widths[1], 1, [1])]
        if decoder.classifier_head is not None:
            trunks[0] = with_classifier(trunks[0], decoder.classifier_head)
        return pack_generic_plan(trunks, widths, dtype)


def make_generic_decode_fn(specs: Specs, kernel: Callable = generic_decode,
                           dtype: torch.dtype = torch.float32) -> Callable:
    """decode(ctx, rows) -> (sdf_h (M, 1), sdf_o (M, 1), logits (M, C) or
    None) of (M, latent + pfs) rows through K6, for the grid evaluator's
    generic path (JAX's ``make_pallas_decode_fn``).  ``ctx["decoder"]`` is
    the decoder module.  The plan (its weights split and tiled) is built
    once and kept while the decoder and the versions of its parameters stay
    the same, so a grid pass of many runs builds it once, and an in-place
    update of the weights builds it anew.  Twin trunks take their column
    slices of the rows (the four encode styles); a combined trunk reads the
    whole row.  Pixel-aligned rows (the map sampled per point) decode the
    same way.  ``kernel`` may name K6's plain version, to compare the two on
    the card.  ``dtype`` is K6's compute dtype (JAX's ``make_pallas_decode_fn
    (specs, dtype)``): with bfloat16 the rows enter as bf16, as JAX's
    ``run`` casts them (:196-199)."""
    combined = specs.model_type == "1encoder1decoder"
    cache: Dict[str, object] = {}

    def plan_of(decoder: torch.nn.Module) -> GenericPlan:
        key = (decoder, tuple((p.data_ptr(), p._version) for p in decoder.parameters()))
        if cache.get("key") != key:
            cache["key"], cache["plan"] = key, make_generic_plan(decoder, specs, dtype)
        return cache["plan"]

    def decode(ctx: Dict, rows: torch.Tensor):
        plan = plan_of(ctx["decoder"])
        rows = rows.to(dtype)
        if combined:
            return kernel(plan, rows)
        return kernel(plan, *separate_decoder_inputs(specs.latent_size, specs.encode_style, rows))

    return decode
