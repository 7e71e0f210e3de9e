"""Two-pass dense SDF grid evaluation on one device (the JAX package's
``inference/grid.py``; reference utils/mesh.py:17-123, 198-256).

The first pass covers the [-1, 1]^3 cube; the bounding box of its negative
region plus a 2-voxel buffer becomes the second pass's cube.  Both passes and
the refinement stay on the device: origin and voxel are device tensors, so
no host round trip separates the passes.  Points are visited in contiguous
runs of linear indices (z fastest, x slowest).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from alignsdf_torch.config import Specs
from alignsdf_torch.ops.embeddings import kinematic_embedding, nerf_embed_for_point_feat
from alignsdf_torch.ops.geometry import pixel_alignment


class GridResult(NamedTuple):
    sdf_hand: torch.Tensor    # (N, N, N)
    sdf_obj: torch.Tensor     # (N, N, N)
    cls: torch.Tensor         # (N, N, N) int32 argmax of the logits (0 without a classifier)
    voxel_size: torch.Tensor  # () refined pass voxel size
    origin: torch.Tensor      # (3,) refined pass origin


def _coords_from_linear(idx: torch.Tensor, n: int, origin: torch.Tensor,
                        voxel: torch.Tensor) -> torch.Tensor:
    """Linear index -> (x, y, z) (reference utils/mesh.py:27-40)."""
    ijk = torch.stack([idx // (n * n) % n, idx // n % n, idx % n], dim=-1)
    return ijk.to(torch.float32) * voxel + origin[None, :]


def embed_points(specs: Specs, ctx: Dict[str, Any], pts: torch.Tensor) -> torch.Tensor:
    """The point embedding of (M, 3) points for the scene in ``ctx``:
    kinematic where its transforms are there, NeRF PE otherwise, raw xyz at
    point_feat_size 3."""
    if specs.point_feat_size > 3:
        if specs.encode_style != "nerf" and "global_trans" in ctx:
            return kinematic_embedding(
                pts, pts.shape[0], specs.point_feat_size, specs.sdf_scale_factor,
                specs.encode_style, rot_center=ctx.get("rot_center"),
                global_trans=ctx.get("global_trans"), obj_trans=ctx.get("obj_trans"))
        return nerf_embed_for_point_feat(pts, specs.point_feat_size)
    return pts


def _refine_cube(specs: Specs, sdf_hand: torch.Tensor, sdf_obj: torch.Tensor,
                 n: int, voxel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounding box of the negative region + 2-voxel buffer -> (new voxel,
    new origin).  With no negative voxel the box collapses to index 0."""
    axes = torch.meshgrid(*(torch.arange(n, device=sdf_hand.device, dtype=torch.float32),) * 3,
                          indexing="ij")

    def bbox(sdf):
        neg = sdf < 0
        any_neg = neg.any()
        mins = torch.stack([torch.where(neg, ax, float(n)).amin() for ax in axes])
        maxs = torch.stack([torch.where(neg, ax, -1.0).amax() for ax in axes])
        zero = torch.zeros(3, device=sdf.device)
        return torch.where(any_neg, mins, zero), torch.where(any_neg, maxs, zero)

    if specs.hand_branch and specs.obj_branch:
        min_h, max_h = bbox(sdf_hand)
        min_o, max_o = bbox(sdf_obj)
        min_index, max_index = torch.minimum(min_h, min_o), torch.maximum(max_h, max_o)
    elif specs.hand_branch:
        min_index, max_index = bbox(sdf_hand)
    else:
        min_index, max_index = bbox(sdf_obj)

    new_cube_size = ((max_index - min_index).amax() + 4) * voxel
    return new_cube_size / (n - 1), (min_index - 2) * voxel - 1.0


def make_grid_evaluator(
    decode_fn: Optional[Callable[[Dict[str, Any], torch.Tensor], Tuple[torch.Tensor, ...]]],
    specs: Specs,
    n: int,
    chunk: int = 1 << 18,
    two_pass: bool = True,
    grid_decode_fn: Optional[Callable] = None,
    pixel_ref_projection: bool = False,
):
    """evaluate(ctx) -> GridResult on the latent's device.

    ``decode_fn(ctx, rows)`` is the generic path: it decodes materialized
    [latent, embedding] rows into (sdf_hand (M, 1), sdf_obj (M, 1), logits
    (M, C) or None).  A (1, L) latent is broadcast to every point; a (1, C,
    Hf, Wf) feature map (pixel-aligned configs, with ``cam_intr`` and
    ``pred_root`` in ctx) is sampled at each point's projection.  ``grid_decode_fn``
    (ops.grid_plan.make_grid_decode_fn or
    ops.pixel_grid_plan.make_pixel_grid_decode_fn) is the fused path:
    ``grid_decode_fn(ctx)`` prepares a decode(base, m, origin, voxel) that
    derives the coordinates itself, and returns the fields and any logits
    as rows (2 + C, m); it is used instead when given.

    ``pixel_ref_projection`` projects the embedding's first three columns,
    as the reference's mesh path does (reference utils/mesh.py:47-55).  For
    kinematic embeddings those are xyz + rot_center * sf / 2, a shift its
    train path (utils/utils.py:536-549, raw xyz) does not apply: a
    train/inference inconsistency of the reference.  The default projects
    the raw grid coordinates, as training does.
    """
    total = n ** 3
    if grid_decode_fn is not None:
        # the fused path streams no per-point inputs; larger runs only cut
        # the launch count
        chunk = min(max(chunk, 1 << 20), total)

    def eval_points(ctx, fused, origin, voxel):
        device = ctx["latent"].device
        h = torch.empty(total, dtype=torch.float32, device=device)
        o = torch.empty(total, dtype=torch.float32, device=device)
        cls = torch.zeros(total, dtype=torch.int32, device=device)
        for start in range(0, total, chunk):
            m = min(chunk, total - start)
            if fused is not None:
                out = fused(start, m, origin, voxel)
                h[start:start + m], o[start:start + m] = out[0], out[1]
                if out.shape[0] > 2:
                    cls[start:start + m] = out[2:].argmax(dim=0)
                continue
            idx = torch.arange(start, start + m, device=device)
            pts = _coords_from_linear(idx, n, origin, voxel)
            emb = embed_points(specs, ctx, pts)
            latent = ctx["latent"]
            if latent.ndim == 4:
                latent = pixel_alignment(latent, emb[:, :3] if pixel_ref_projection else pts,
                                         ctx["cam_intr"], ctx["pred_root"],
                                         specs.image_size[0], specs.sdf_scale_factor)
            else:
                latent = latent.expand(m, latent.shape[1])
            sdf_h, sdf_o, logits = decode_fn(ctx, torch.cat([latent, emb], dim=1))
            h[start:start + m], o[start:start + m] = sdf_h[:, 0], sdf_o[:, 0]
            if logits is not None:
                cls[start:start + m] = logits.argmax(dim=1)
        return h.reshape(n, n, n), o.reshape(n, n, n), cls.reshape(n, n, n)

    @torch.no_grad()
    def evaluate(ctx: Dict[str, Any]) -> GridResult:
        device = ctx["latent"].device
        fused = grid_decode_fn(ctx) if grid_decode_fn is not None else None
        origin = torch.full((3,), -1.0, dtype=torch.float32, device=device)
        voxel = torch.tensor(2.0 / (n - 1), dtype=torch.float32, device=device)
        h, o, cls = eval_points(ctx, fused, origin, voxel)
        if not two_pass:
            return GridResult(h, o, cls, voxel, origin)
        voxel, origin = _refine_cube(specs, h, o, n, voxel)
        return GridResult(*eval_points(ctx, fused, origin, voxel), voxel, origin)

    return evaluate
