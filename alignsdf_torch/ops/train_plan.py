"""Host-side half of the scene-factored train decoder: materialize the
weight-norm layers, fold the per-scene latent into bias tables and split
each trunk's weights into the operands of kernel K2.

Counterpart of the JAX package's ``ops/decoder_kernel.py:build_branch_plan``
(:59) and of ``run_branch`` in ``make_fused_train_decoder_factored``
(``ops/decoder_train_kernel.py:762-852``).  Everything here is plain
PyTorch outside K2's autograd Function, so autograd carries the gradients of
``weight_v``, ``weight_g``, the biases and the latent:

    b0[s] = b_0 + latent[s] @ W_0[:ls]            (B, h) scene table
    b2[s] = b_2 + latent[s] @ W_2[cur:cur+ls]     for a latent_in layer

The final layer folds the same way where ``latent_in`` names it (index
``len(dims)``, as JAX's factored kernel re-injects at any layer,
``decoder_train_kernel.py:443-451``): its scene table and embedding
weights go to K2's final rows.

With a classifier, K2 also gives the hand (or combined) trunk's x_last, and
the logits x_last @ cw^T + cb are one torch.matmul outside the kernel, as
the JAX package's ``classifier_apply`` (:854-859) is XLA outside its kernel.

The port keeps per-scene tables as (B, h); the TPU's (B*8, h) row-0-of-8
layout answered Mosaic's tiling.

Under ComputeDtype bfloat16 the fold is JAX's (``run_branch`` :826-839):
the latent and W's latent rows rounded to bf16, their product summed in
float32 and not rounded, the tables float32; autograd through the casts
rounds the latent's and W's cotangents to bf16 where JAX's does
(``tests/test_torch_bf16_train.py`` pins both).  K2 then runs the trunk in
bf16 (``TrainStatics.dtype``), and the logits stay a float32 product.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from alignsdf_torch.config import Specs
from alignsdf_torch.kernels.train_decoder import TrainStatics, train_decode
from alignsdf_torch.models.decoder import trunk_layer_dims, trunk_prefixes
from alignsdf_torch.models.layers import compute_dtype_of, materialize_linear
from alignsdf_torch.ops.grid_plan import branch_columns


def fold_latent(latent: torch.Tensor, w_lat: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """latent (B, ls) @ w_lat (ls, h), float32: in bf16 of both operands
    rounded to bf16 (exact products, float32 sums), as JAX's ``jnp.dot(lat_c,
    w.astype(bf16), preferred_element_type=float32)``."""
    if dtype == torch.float32:
        return latent @ w_lat
    return latent.to(dtype).to(torch.float32) @ w_lat.to(dtype).to(torch.float32)


def trunk_operands(decoder: torch.nn.Module, prefix: str, n_cols: int, latent: torch.Tensor,
                   specs: Specs, out_dim: int):
    """(ws, xs, bs) of one trunk for K2: ws[l] (in, out) on the previous
    activation or None, xs[l] (n_cols, out) on the embedding or None, bs[l]
    a (B, out) scene table where the latent folds in (``fold_latent`` in
    the spec's compute dtype), else (out,)."""
    ns = specs.network_specs
    dtype = compute_dtype_of(specs.compute_dtype)
    ls = latent.shape[1]
    in_dim = ls + n_cols
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
            xs.append(w[ls:in_dim])
            bs.append(bias + fold_latent(latent, w[:ls], dtype))
        elif layer in ns.latent_in:
            # the torch layer's input was [x (cur), latent (ls), emb (n_cols)]
            ws.append(w[:cur])
            xs.append(w[cur + ls:cur + in_dim])
            bs.append(bias + fold_latent(latent, w[cur:cur + ls], dtype))
        else:
            ws.append(w)
            xs.append(None)
            bs.append(bias)
        cur = shapes[layer][1]
    return ws, xs, bs


def classify(decoder: torch.nn.Module, x_last: torch.Tensor) -> Optional[torch.Tensor]:
    """The classifier's logits x_last @ cw^T + cb (M, C), one torch.matmul
    outside the kernel that gave x_last, or None without a classifier."""
    if decoder.classifier_head is None:
        return None
    cw, cb = materialize_linear(decoder.classifier_head)
    return torch.matmul(x_last, cw.T) + cb


def make_train_decoder(specs: Specs, kernel: Callable = train_decode) -> Optional[Callable]:
    """decode(decoder, latent (B, ls), emb (M, pfs), seed, train) -> (sdf_h
    (M,), sdf_o (M,), logits (M, C) or None) through K2, or None for a
    structure K2 does not take (the same refusals as
    ``make_fused_train_decoder_factored``, less the TPU's block-size rule; a
    latent input at the final layer is taken, as JAX's).  The
    hand trunk draws its dropout from ``seed``, the object trunk from ``seed
    + 1``.  ``kernel`` may name K2's plain
    version instead, to compare the two on the card.  The statics carry the
    spec's compute dtype, so that a bf16 spec runs K2's bf16 contract."""
    ns = specs.network_specs
    if (not ns.weight_norm or ns.use_tanh or ns.latent_dropout or ns.xyz_in_all
            or specs.pixel_align or 0 in ns.latent_in):
        return None
    n_layers = len(ns.dims) + 1
    latent_in = tuple(layer in ns.latent_in for layer in range(n_layers))
    statics = TrainStatics(
        n_per_scene=specs.samples_per_scene,
        has_w=tuple(layer > 0 for layer in range(n_layers)),
        has_x=tuple(layer == 0 or latent_in[layer] for layer in range(n_layers)),
        scene_bias=tuple(layer == 0 or latent_in[layer] for layer in range(n_layers)),
        dropout=tuple(bool(ns.dropout) and layer in ns.dropout for layer in range(n_layers - 1)),
        keep=1.0 - ns.dropout_prob,
        train=True,
        dtype=compute_dtype_of(specs.compute_dtype))
    cols_h, cols_o = branch_columns(specs)
    combined = specs.model_type == "1encoder1decoder"

    def run(decoder, prefix, cols, out_dim, latent, emb, seed, train):
        ws, xs, bs = trunk_operands(decoder, prefix, len(cols), latent, specs, out_dim)
        idx = torch.as_tensor(cols, dtype=torch.long, device=emb.device)
        return kernel(emb.index_select(1, idx), ws, xs, bs, seed,
                      statics._replace(train=bool(train)))

    def decode(decoder, latent: torch.Tensor, emb: torch.Tensor, seed: int,
               train: bool = True) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        first, second = trunk_prefixes(decoder)
        if combined:
            y, x_last = run(decoder, first, cols_h, 2, latent, emb, seed, train)
            return y[0], y[1], classify(decoder, x_last)
        y_h, x_last = run(decoder, first, cols_h, 1, latent, emb, seed, train)
        y_o, _ = run(decoder, second, cols_o, 1, latent, emb, seed + 1, train)
        return y_h[0], y_o[0], classify(decoder, x_last)

    decode.statics = statics
    return decode
