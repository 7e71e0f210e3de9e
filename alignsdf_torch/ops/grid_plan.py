"""Host-side half of the fused grid decoder: fold the scene's broadcast latent
and its (affine-in-xyz) point embedding into per-layer biases plus 3-row xyz
weights, then hand the folded trunks to kernel K1.

Counterpart of the JAX package's ``ops/decoder_kernel.py``:
``_materialize_linear`` :50, ``build_grid_branch_plan`` :291,
``branch_columns`` :1391, the 4-point affine probe :727-738,
``make_fused_grid_decode_fn`` :693 and, for the classifier, ``_classifier_pad``
:1426 with :749-765.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from alignsdf_torch.config import NetworkSpecs, Specs
from alignsdf_torch.kernels.grid_decoder import (
    FoldedTrunk,
    HiddenLayer,
    grid_decode,
    pack_grid_plan,
)
from alignsdf_torch.models.decoder import trunk_layer_dims, trunk_prefixes
from alignsdf_torch.models.layers import materialize_linear
from alignsdf_torch.ops.embeddings import kinematic_embedding


def branch_columns(specs: Specs) -> Tuple[np.ndarray, np.ndarray]:
    """Which columns of the full embedding each trunk consumes: the
    column-index form of separate_decoder_inputs."""
    pfs, style = specs.point_feat_size, specs.encode_style
    if specs.model_type == "1encoder1decoder" or style == "nerf":
        cols = np.arange(pfs)
        return cols, cols
    if style == "hand":
        return np.arange(pfs), np.arange(3)
    if style == "obj":
        return np.arange(3), np.arange(pfs)
    if style == "both":
        return np.arange(pfs - 3), np.array([0, 1, 2, pfs - 3, pfs - 2, pfs - 1])
    raise ValueError(style)


def fused_embedding(specs: Specs) -> bool:
    """Whether the point embedding is affine in xyz (kinematic styles, or
    raw xyz); NeRF positional encoding is not."""
    return specs.encode_style in ("hand", "obj", "both") or specs.point_feat_size == 3


def embedding_affine(specs: Specs, ctx: Dict[str, Any],
                     device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scene's embedding as emb(xyz) = xyz @ A + b, by probing it at
    {0, e_x, e_y, e_z}; ``ctx`` holds rot_center / global_trans / obj_trans
    for the kinematic styles."""
    style, pfs = specs.encode_style, specs.point_feat_size
    if style not in ("hand", "obj", "both"):
        return torch.eye(3, device=device), torch.zeros(3, device=device)
    probes = torch.cat([torch.zeros(1, 3), torch.eye(3)], dim=0).to(device)
    emb = kinematic_embedding(
        probes, 4, pfs, specs.sdf_scale_factor, style,
        rot_center=ctx.get("rot_center"), global_trans=ctx.get("global_trans"),
        obj_trans=ctx.get("obj_trans"))
    return emb[1:4] - emb[0][None], emb[0]


def first_layer_weight(w: torch.Tensor, in_dim: int, specs: NetworkSpecs) -> torch.Tensor:
    """Layer 0's (in_dim, out) weight on the trunk's input.  With 0 in
    ``latent_in`` the layer reads [input, input], so both halves multiply
    the same rows and are summed.  The JAX package's fused grid kernel keeps
    only the first half (``decoder_kernel.py:334-335``), which changes the
    field; its generic decoder sums both."""
    if 0 in specs.latent_in:
        return w[:in_dim] + w[in_dim:2 * in_dim]
    return w


def build_grid_branch_plan(
    layers: List[Tuple[torch.Tensor, torch.Tensor]],
    latent: torch.Tensor,
    emb_a: torch.Tensor,
    emb_b: torch.Tensor,
    specs: NetworkSpecs,
    out_dim: int,
    rows: List[int],
) -> FoldedTrunk:
    """Fold a (1, L) latent and an affine embedding emb = xyz @ A + b into
    one trunk given as materialized (weight (out, in), bias) layers."""
    latent_width = latent.shape[-1]
    lat = latent.to(torch.float32).reshape(1, latent_width)
    in_dim = latent_width + emb_a.shape[1]
    shapes = trunk_layer_dims(in_dim, specs, out_dim)

    def fold(w_full, b):
        """[latent, emb(xyz)] @ w_full -> (xyz weights (3, out), bias)."""
        w_lat, w_emb = w_full[:latent_width], w_full[latent_width:in_dim]
        return emb_a @ w_emb, b + (lat @ w_lat + emb_b[None] @ w_emb)[0]

    hidden: List[HiddenLayer] = []
    cur_dim = in_dim
    for layer, (weight, b) in enumerate(layers):
        w = weight.to(torch.float32).T  # (in, out)
        b = b.to(torch.float32)
        if layer == 0:
            x, b = fold(first_layer_weight(w, in_dim, specs), b)
            mm = None
        elif layer in specs.latent_in:
            # the torch layer's input was [x (cur_dim), input (in_dim)]
            x, b = fold(w[cur_dim:cur_dim + in_dim], b)
            mm = w[:cur_dim]
        else:
            x, mm = None, w
        hidden.append(HiddenLayer(mm, x, b))
        cur_dim = shapes[layer][1]
    last = hidden.pop()
    if last.w is None:
        raise ValueError("the fused grid path needs at least one hidden layer")
    return FoldedTrunk(hidden, last.w, last.x, last.b, rows)


def with_classifier(trunk, head: torch.nn.Module):
    """The trunk (a FoldedTrunk, or K3's PixelTrunk) with the classifier's
    logits cw a + cb appended as final rows 2.. on the same input a (the
    last hidden activation), their bias in ``fin_b``; they read no xyz or
    input term (zero columns of ``fin_x``) and no latent (zero columns of
    K3's ``fin_lat``, where the final layer takes one)."""
    cw, cb = (t.to(torch.float32) for t in materialize_linear(head))
    c = cw.shape[0]

    def widen(w):
        return None if w is None else torch.cat([w, w.new_zeros(w.shape[0], c)], dim=1)

    extra = {"fin_lat": widen(trunk.fin_lat)} if hasattr(trunk, "fin_lat") else {}
    return trunk._replace(fin=torch.cat([trunk.fin, cw.T], dim=1), fin_x=widen(trunk.fin_x),
                          fin_b=torch.cat([trunk.fin_b, cb]),
                          rows=[*trunk.rows, *range(2, 2 + c)], **extra)


def make_grid_decode_fn(specs: Specs, n: int,
                        dtype: torch.dtype = torch.float32) -> Optional[Callable]:
    """prepare(ctx) -> decode(base, m, origin, voxel) -> (2 + C, m) fields
    and logits (C = 0 without a classifier), or None when the config cannot
    use the fused path (NeRF positional encoding is not affine in xyz).
    ``dtype`` is K1's compute dtype (JAX's ``dtype``: bfloat16 packs bf16
    tiles; the fold runs in float32 and its xyz weights are rounded to bf16,
    ``(emb_a @ w_emb).astype(dtype)``, :331, as are the final and class
    rows; the biases stay float32).

    ``ctx`` holds the decoder module, the (1, L) latent and, for kinematic
    styles, rot_center / global_trans / obj_trans.  ``prepare`` folds and
    packs the plan once per scene, on the latent's device; ``decode`` runs
    K1 over a run of linear indices.
    """
    if not fused_embedding(specs):
        return None
    ns = specs.network_specs
    combined = specs.model_type == "1encoder1decoder"
    cols_h, cols_o = branch_columns(specs)

    def prepare(ctx: Dict[str, Any]):
        decoder = ctx["decoder"]
        latent = ctx["latent"]
        a_full, b_full = embedding_affine(specs, ctx, latent.device)
        n_layers = len(ns.dims) + 1

        def trunk(prefix, cols, out_dim, rows):
            layers = [materialize_linear(getattr(decoder, f"{prefix}{i}"))
                      for i in range(n_layers)]
            return build_grid_branch_plan(layers, latent, a_full[:, cols], b_full[cols],
                                          ns, out_dim, rows)

        with torch.no_grad():
            first, second = trunk_prefixes(decoder)
            if combined:
                trunks = [trunk(first, cols_h, 2, [0, 1])]
            else:
                trunks = [trunk(first, cols_h, 1, [0]), trunk(second, cols_o, 1, [1])]
            if decoder.classifier_head is not None:
                trunks[0] = with_classifier(trunks[0], decoder.classifier_head)
            plan = pack_grid_plan(trunks, n, dtype)

        def decode(base: int, m: int, origin: torch.Tensor, voxel: torch.Tensor):
            return grid_decode(plan, base, m, origin, voxel)

        decode.plan = plan
        return decode

    return prepare
