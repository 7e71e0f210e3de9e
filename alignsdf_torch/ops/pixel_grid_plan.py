"""Host-side half of the fused pixel grid decoder: fold the scene's
(affine-in-xyz) point embedding into per-layer biases plus 3-row xyz
weights, keep the latent as explicit weights of layer 0 and of the
latent_in layers, lay the feature map out as a channel-contiguous table and
build the projection scalars, then hand all of it to kernel K3.

Counterpart of the JAX package's ``ops/decoder_kernel.py``:
``build_pixel_grid_branch_plan`` :805 and ``make_fused_pixel_grid_decode_fn``
:1275, with the classifier packed as extra final rows of the first trunk
(:1355-1375, ``grid_plan.with_classifier``).  The sampling is not banded (no
``_band_plan``): K3 gathers each point's taps directly.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.kernels.pixel_grid_decoder import (
    PixelHiddenLayer,
    PixelTrunk,
    make_feature_table,
    make_pixel_projection,
    pack_pixel_grid_plan,
    pixel_grid_decode,
)
from alignsdf_torch.models.decoder import trunk_layer_dims, trunk_prefixes
from alignsdf_torch.models.layers import materialize_linear
from alignsdf_torch.ops.grid_plan import (
    branch_columns,
    embedding_affine,
    first_layer_weight,
    fused_embedding,
    with_classifier,
)


def build_pixel_grid_branch_plan(
    layers: List[Tuple[torch.Tensor, torch.Tensor]],
    latent_width: int,
    emb_a: torch.Tensor,
    emb_b: torch.Tensor,
    specs: NetworkSpecs,
    out_dim: int,
    rows: List[int],
) -> PixelTrunk:
    """Fold an affine embedding emb = xyz @ A + b into one trunk given as
    materialized (weight (out, in), bias) layers; the per-point latent's
    weights stay explicit."""
    in_dim = latent_width + emb_a.shape[1]
    shapes = trunk_layer_dims(in_dim, specs, out_dim)

    def fold(w_full, b):
        """[latent, emb(xyz)] @ w_full -> (latent weights, xyz weights, bias)."""
        w_lat, w_emb = w_full[:latent_width], w_full[latent_width:in_dim]
        return w_lat, emb_a @ w_emb, b + emb_b @ w_emb

    hidden: List[PixelHiddenLayer] = []
    cur_dim = in_dim
    for layer, (weight, b) in enumerate(layers):
        w = weight.to(torch.float32).T  # (in, out)
        b = b.to(torch.float32)
        if layer == 0:
            lat, x, b = fold(first_layer_weight(w, in_dim, specs), b)
            mm = None
        elif layer in specs.latent_in:
            # the torch layer's input was [x (cur_dim), input (in_dim)]
            lat, x, b = fold(w[cur_dim:cur_dim + in_dim], b)
            mm = w[:cur_dim]
        else:
            lat, x, mm = None, None, w
        hidden.append(PixelHiddenLayer(mm, lat, x, b))
        cur_dim = shapes[layer][1]
    last = hidden.pop()
    if last.w is None:
        raise ValueError("the fused pixel grid path needs a hidden layer")
    return PixelTrunk(hidden, last.w, last.x, last.b, rows, last.lat)


def make_pixel_grid_decode_fn(specs: Specs, n: int, ref_projection: bool = False,
                              dtype: torch.dtype = torch.float32) -> Optional[Callable]:
    """prepare(ctx) -> decode(base, m, origin, voxel) -> (2 + C, m) fields
    and logits (C = 0 without a classifier) for a pixel-aligned config, or
    None when it cannot use the fused path (not pixel-aligned, an embedding
    not affine in xyz).  A latent input at the final layer keeps its latent
    weights as the trunk's ``fin_lat``, which K3's final rows read, as JAX's
    plan carries them (``final_ops``' ``flat``, :961-966).

    ``ctx`` holds the decoder module, the (1, C, Hf, Wf) feature map as
    ``latent``, ``cam_intr`` (1, 3, 3+), ``pred_root`` (1, 1, 3) and, for
    kinematic styles, rot_center / global_trans / obj_trans.  ``prepare``
    builds the plan once per scene, on the map's device; ``decode`` runs K3
    over a run of linear indices.

    ``ref_projection`` projects the embedding's first three columns, as the
    reference's mesh path does; the default projects the raw grid
    coordinates, as its train path does (inference/grid.py).  ``dtype`` is
    K3's compute dtype (JAX's ``dtype``, :1275-1380): bfloat16 packs bf16
    tiles and rounds the feature table with its mean row (:997-998) and the
    final and class weights; the biases and xyz weights stay float32.
    """
    ns = specs.network_specs
    n_layers = len(ns.dims) + 1
    if not specs.pixel_align or not fused_embedding(specs):
        return None
    combined = specs.model_type == "1encoder1decoder"
    cols_h, cols_o = branch_columns(specs)
    image_size = specs.image_size[0]

    def prepare(ctx: Dict[str, Any]):
        decoder = ctx["decoder"]
        fmap = ctx["latent"]
        device = fmap.device
        _, c, hf, wf = fmap.shape
        with torch.no_grad():
            a_full, b_full = embedding_affine(specs, ctx, device)
            if ref_projection:
                a_proj, b_proj = a_full[:, :3], b_full[:3]
            else:
                a_proj, b_proj = torch.eye(3, device=device), torch.zeros(3, device=device)
            proj = make_pixel_projection(a_proj, b_proj, ctx["cam_intr"][0, :3, :3],
                                         ctx["pred_root"], specs.sdf_scale_factor, (hf, wf),
                                         image_size)

            def trunk(prefix, cols, out_dim, rows):
                layers = [materialize_linear(getattr(decoder, f"{prefix}{i}"))
                          for i in range(n_layers)]
                return build_pixel_grid_branch_plan(layers, c, a_full[:, cols], b_full[cols],
                                                    ns, out_dim, rows)

            first, second = trunk_prefixes(decoder)
            if combined:
                trunks = [trunk(first, cols_h, 2, [0, 1])]
            else:
                trunks = [trunk(first, cols_h, 1, [0]), trunk(second, cols_o, 1, [1])]
            if decoder.classifier_head is not None:
                trunks[0] = with_classifier(trunks[0], decoder.classifier_head)
            plan = pack_pixel_grid_plan(trunks, make_feature_table(fmap), proj, (hf, wf), n,
                                        dtype)

        def decode(base: int, m: int, origin: torch.Tensor, voxel: torch.Tensor):
            return pixel_grid_decode(plan, base, m, origin, voxel)

        decode.plan = plan
        return decode

    return prepare
