"""Host-side half of the generic train decoder: materialize the weight-norm
layers and split each trunk's weights into the operands of kernel K5, which
runs on materialized [latent, embedding] rows.

Counterpart of ``make_fused_train_decoder`` (``ops/decoder_train_kernel.py
:891``).  Everything here is plain PyTorch outside K5's autograd Function, so
autograd carries the gradients of ``weight_v``, ``weight_g`` and the biases;
the rows' gradient reaches the latent (or, for pixel-aligned rows, the map
through ``pixel_alignment``) and the embedding.  With 0 in ``latent_in``,
layer 0 reads [row, row]: in float32 its two halves are summed here (exact
algebra), so K5 runs one product there; in bf16 they stay apart, stacked
(2 in_dim, out), since JAX rounds each to bf16 before its own product
(``decoder_train_kernel.py:117-121``).  The statics carry the spec's compute
dtype, so that a bf16 spec runs K5's bf16 contract (JAX's ``cdtype`` :914).
The classifier's logits are ``train_plan.classify`` on ``x_last``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from alignsdf_torch.config import Specs
from alignsdf_torch.kernels.generic_train_decoder import generic_train_decode
from alignsdf_torch.kernels.train_decoder import TrainStatics
from alignsdf_torch.models.decoder import separate_decoder_inputs, trunk_layer_dims, trunk_prefixes
from alignsdf_torch.models.layers import compute_dtype_of, materialize_linear
from alignsdf_torch.ops.decoder_plan import trunk_input_widths
from alignsdf_torch.ops.train_plan import classify


def generic_trunk_operands(decoder: torch.nn.Module, prefix: str, in_dim: int, specs: Specs,
                           out_dim: int):
    """(ws, xs, bs) of one trunk for K5: ws[l] (in, out) on the previous
    activation or None (layer 0), xs[l] (in_dim, out) on the input row at
    layer 0 and the latent_in layers, else None, bs[l] (out,).  With 0 in
    ``latent_in``, xs[0] is its two halves' sum in float32 and the halves
    stacked (2 in_dim, out) in bf16."""
    ns = specs.network_specs
    stacked = compute_dtype_of(specs.compute_dtype) == torch.bfloat16
    shapes = trunk_layer_dims(in_dim, ns, out_dim)
    ws: List[Optional[torch.Tensor]] = []
    xs: List[Optional[torch.Tensor]] = []
    bs: List[torch.Tensor] = []
    cur = in_dim
    for layer in range(len(shapes)):
        weight, bias = materialize_linear(getattr(decoder, f"{prefix}{layer}"))
        w = weight.T  # (in, out)
        if layer == 0:
            ws.append(None)
            if 0 not in ns.latent_in:
                xs.append(w)
            else:
                xs.append(w[:2 * in_dim] if stacked else w[:in_dim] + w[in_dim:2 * in_dim])
        elif layer in ns.latent_in:
            # the torch layer's input was [x (cur), input (in_dim)]
            ws.append(w[:cur])
            xs.append(w[cur:cur + in_dim])
        else:
            ws.append(w)
            xs.append(None)
        bs.append(bias)
        cur = shapes[layer][1]
    return ws, xs, bs


def make_generic_train_decoder(specs: Specs, kernel: Callable = generic_train_decode
                               ) -> Optional[Callable]:
    """decode(decoder, rows (M, latent + pfs), seed, train) -> (sdf_h (M,),
    sdf_o (M,), logits (M, C) or None) through K5, or None for a structure
    K5 does not take: the JAX factory's refusals (LayerNorm trunks,
    ``use_tanh``, ``latent_dropout``, ``xyz_in_all``).  A latent input at the
    final layer is taken, as JAX's ``_fwd_kernel`` takes it (:117-121).  The
    hand (or combined) trunk draws its dropout from ``seed``, the object
    trunk from ``seed + 1``.  ``kernel`` may name K5's plain version
    instead, to compare the two on the card.  ``decode.materialized`` is
    True: the train step feeds it ``decoder_inputs``."""
    ns = specs.network_specs
    n_layers = len(ns.dims) + 1
    if not ns.weight_norm or ns.use_tanh or ns.latent_dropout or ns.xyz_in_all:
        return None
    statics = TrainStatics(
        n_per_scene=1,
        has_w=tuple(layer > 0 for layer in range(n_layers)),
        has_x=tuple(layer == 0 or layer in ns.latent_in for layer in range(n_layers)),
        scene_bias=(False,) * n_layers,
        dropout=tuple(bool(ns.dropout) and layer in ns.dropout for layer in range(n_layers - 1)),
        keep=1.0 - ns.dropout_prob,
        train=True,
        dtype=compute_dtype_of(specs.compute_dtype))
    widths = trunk_input_widths(specs)

    def run(decoder, prefix, in_dim, out_dim, x0, seed, train):
        ws, xs, bs = generic_trunk_operands(decoder, prefix, in_dim, specs, out_dim)
        return kernel(x0.to(torch.float32), ws, xs, bs, seed,
                      statics._replace(train=bool(train)))

    def decode(decoder, rows: torch.Tensor, seed: int, train: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        first, second = trunk_prefixes(decoder)
        if second is None:
            y, x_last = run(decoder, first, widths[0], 2, rows, seed, train)
            return y[0], y[1], classify(decoder, x_last)
        xh, xo = separate_decoder_inputs(specs.latent_size, specs.encode_style, rows)
        y_h, x_last = run(decoder, first, widths[0], 1, xh, seed, train)
        y_o, _ = run(decoder, second, widths[1], 1, xo, seed + 1, train)
        return y_h[0], y_o[0], classify(decoder, x_last)

    decode.materialized = True
    decode.statics = statics
    return decode
