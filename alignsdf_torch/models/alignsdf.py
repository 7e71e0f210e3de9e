"""Top-level AlignSDF model: encoder + MANO branch + object pose + SDF
decoder (reference networks/model.py:353-414; the JAX package's
``models/alignsdf.py``).  Submodule names follow the reference state_dict, so
a reference ``latest.pth`` loads with ``load_state_dict``."""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from alignsdf_torch.config import Specs
from alignsdf_torch.mano.layer import load_mano_model
from alignsdf_torch.models.decoder import make_decoder
from alignsdf_torch.models.layers import compute_dtype_of, set_compute_dtype
from alignsdf_torch.models.manobranch import ManoBranch
from alignsdf_torch.models.resnet import Conv2d, ResNetEncoder
from alignsdf_torch.ops.embeddings import kinematic_embedding, nerf_embed_for_point_feat
from alignsdf_torch.ops.geometry import get_obj_trans, pixel_alignment, soft_argmax

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image_on_device(image: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> ImageNet-normalized float32 NHWC (reference
    utils/data.py:67-71); float inputs pass through as already normalized."""
    if image.dtype != torch.uint8:
        return image
    mean = torch.tensor(_IMAGENET_MEAN, dtype=torch.float32, device=image.device)
    std = torch.tensor(_IMAGENET_STD, dtype=torch.float32, device=image.device)
    return (image.to(torch.float32) / 255.0 - mean) / std


def check_supported(specs: Specs) -> None:
    """Raise for a pixel-aligned spec without the MANO branch, whose
    predicted root the projection is centred on, and for a ComputeDtype
    other than float32 or bfloat16 (both train and serve, through every
    train decoder)."""
    if specs.pixel_align and not specs.mano_branch:
        raise ValueError("PixelAlign needs ManoBranch: points are projected about the "
                         "predicted hand root")
    compute_dtype_of(specs.compute_dtype)


class AlignSDF(nn.Module):
    """Encoder, MANO branch, object pose and SDF decoder.  ``encode_scene``
    always runs in eval mode; the training front half runs in the mode its
    ``train`` argument names.  ``specs.compute_dtype`` sets the encoder's,
    the decoder's and the volume layer's compute dtype, as the JAX model
    builds them; the MANO branch, the object pose and the outputs stay
    float32."""

    def __init__(self, specs: Specs):
        super().__init__()
        check_supported(specs)
        self.specs = specs
        self.encoder = ResNetEncoder(specs.backbone, specs.latent_size,
                                     mano_features=specs.mano_branch,
                                     use_headnet=specs.use_headnet,
                                     use_pixel_align=specs.pixel_align)
        self.mano_decoder = (
            ManoBranch(load_mano_model(ncomps=specs.pose_feat_size),
                       ncomps=specs.pose_feat_size, absolute_depth=specs.use_depth,
                       use_obj_rot=specs.use_obj_rot)
            if specs.mano_branch else None)
        self.decoder = make_decoder(specs.model_type, specs.latent_size,
                                    specs.point_feat_size, specs.encode_style,
                                    specs.network_specs, specs.classifier_branch)
        # 1x1 conv: 256 channels -> 64 depth-bin heatmap (reference model.py:376-377)
        self.volume_layer = Conv2d(256, 64, 1) if specs.use_obj_pose else None
        dtype = compute_dtype_of(specs.compute_dtype)
        for part in (self.encoder, self.decoder, self.volume_layer):
            if part is not None:
                set_compute_dtype(part, dtype)

    @contextmanager
    def _mode(self, train: bool):
        """Run the body with BatchNorm in batch-statistic (train) or
        running-statistic (eval) mode, then restore the module's mode."""
        was = self.training
        self.train(train)
        try:
            yield
        finally:
            self.train(was)

    def _encode(self, image: torch.Tensor, cond_input: Dict[str, torch.Tensor], train: bool):
        """Encoder, MANO branch and object pose: (sdf_feat, aux_feat,
        mano_results, obj_results).  Only in eval mode do the object corners
        add the hand's center3d, as in the JAX package (``_scene_parts`` vs
        ``encode_scene``)."""
        specs = self.specs
        x = normalize_image_on_device(image).permute(0, 3, 1, 2)
        sdf_feat, mano_feat, aux_feat = self.encoder(x)
        mano_results = self.mano_decoder(mano_feat, cond_input) if specs.mano_branch else None

        obj_results = None
        if specs.use_obj_pose:
            heatmaps = self.volume_layer(aux_feat)  # (B, 64 depth bins, 64, 64)
            obj_trans, obj_center = get_obj_trans(
                soft_argmax(heatmaps.to(torch.float32)), mano_results["center3d"],
                cond_input["cam_intr"],
                mano_results["obj_rot"] if specs.use_obj_rot else None)
            obj_corners = (torch.einsum("bij,bnj->bni", obj_trans[:, :3, :3],
                                        cond_input["rest_obj_corners"])
                           + obj_trans[:, None, :3, 3])
            if not train:
                obj_corners = obj_corners + mano_results["center3d"]
            obj_results = {"obj_center": obj_center, "obj_corners": obj_corners,
                           "obj_trans": obj_trans}
        return sdf_feat, aux_feat, mano_results, obj_results

    @torch.no_grad()
    def encode_scene(self, image: torch.Tensor, cam_intr: torch.Tensor,
                     mano_root: torch.Tensor, rest_obj_corners: torch.Tensor
                     ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]], Optional[Dict[str, Any]]]:
        """(B, H, W, 3) image -> (latent, mano_results, obj_results) for grid
        reconstruction (reference utils/utils.py:575-625 minus IO).  The
        latent is (B, L), or for pixel-aligned specs the (B, 256, 64, 64)
        float32 HeadNet map (NCHW)."""
        cond_input = {"cam_intr": cam_intr, "mano_root": mano_root,
                      "rest_obj_corners": rest_obj_corners}
        with self._mode(False):
            sdf_feat, aux_feat, mano_results, obj_results = self._encode(image, cond_input, False)
        latent = aux_feat if self.specs.pixel_align else sdf_feat
        return latent.to(torch.float32), mano_results, obj_results

    def _scene_parts(self, image: torch.Tensor, xyz: torch.Tensor,
                     cond_input: Dict[str, torch.Tensor], train: bool):
        """The training front half (the JAX package's ``_scene_parts``):
        encoder, MANO branch, object pose and point embedding, with autograd
        on.  Returns (sdf_feat, aux_feat, xyz_embed, mano_results,
        obj_results)."""
        specs = self.specs
        with self._mode(train):
            sdf_feat, aux_feat, mano_results, obj_results = self._encode(image, cond_input, train)
        if specs.point_feat_size > 3:
            if mano_results is not None and specs.encode_style != "nerf":
                xyz_embed = kinematic_embedding(
                    xyz, xyz.shape[0] // image.shape[0], specs.point_feat_size,
                    specs.sdf_scale_factor, specs.encode_style,
                    rot_center=mano_results["rot_center"],
                    global_trans=mano_results["global_trans"],
                    obj_trans=obj_results["obj_trans"] if obj_results else None)
            else:
                xyz_embed = nerf_embed_for_point_feat(xyz, specs.point_feat_size)
        else:
            xyz_embed = xyz
        return sdf_feat, aux_feat, xyz_embed, mano_results, obj_results

    def decoder_inputs(self, image: torch.Tensor, xyz: torch.Tensor,
                       cond_input: Dict[str, torch.Tensor], train: bool = False):
        """Everything before the SDF decoder, as materialized per-point
        [latent, embedding] rows: (rows (M, L + pfs), mano_results,
        obj_results).  Pixel-aligned specs sample the HeadNet map at each
        point's projection; the others repeat the scene's latent."""
        sdf_feat, aux_feat, xyz_embed, mano_results, obj_results = self._scene_parts(
            image, xyz, cond_input, train)
        if self.specs.pixel_align:
            latent = pixel_alignment(aux_feat.to(torch.float32), xyz, cond_input["cam_intr"],
                                     mano_results["joints"][:, 0:1], self.specs.image_size[0],
                                     self.specs.sdf_scale_factor)
        else:
            latent = sdf_feat.repeat_interleave(xyz.shape[0] // sdf_feat.shape[0], dim=0)
        return torch.cat([latent, xyz_embed], dim=1), mano_results, obj_results

    def decoder_inputs_factored(self, image: torch.Tensor, xyz: torch.Tensor,
                                cond_input: Dict[str, torch.Tensor], train: bool = False):
        """Everything before the SDF decoder, without materializing per-point
        [latent, embedding] rows: (latent (B, ls), xyz_embed (M, pfs),
        mano_results, obj_results).  The scene-factored train decoder folds
        the latent into per-scene biases instead (ops/train_plan.py).
        Broadcast-latent specs only: a pixel-aligned latent is per point
        (``decoder_inputs_pixel``)."""
        if self.specs.pixel_align:
            raise ValueError("pixel-aligned latents are per point; use decoder_inputs")
        sdf_feat, _, xyz_embed, mano_results, obj_results = self._scene_parts(
            image, xyz, cond_input, train)
        return sdf_feat, xyz_embed, mano_results, obj_results

    def decoder_inputs_pixel(self, image: torch.Tensor, xyz: torch.Tensor,
                             cond_input: Dict[str, torch.Tensor], train: bool = False):
        """Everything before the SDF decoder of a pixel-aligned spec, without
        sampling the map: (aux_feat (B, C, Hf, Wf) float32 NCHW, xyz_embed (M,
        pfs), mano_results, obj_results).  The pixel train decoder samples
        the map at each point's projection itself (ops/pixel_train_plan.py).
        The JAX package returns the map NHWC; the port keeps its encoder's
        NCHW."""
        if not self.specs.pixel_align:
            raise ValueError("decoder_inputs_pixel is for pixel-aligned specs")
        _, aux_feat, xyz_embed, mano_results, obj_results = self._scene_parts(
            image, xyz, cond_input, train)
        return aux_feat.to(torch.float32), xyz_embed, mano_results, obj_results

    def decode_points(self, decoder_inputs: torch.Tensor):
        """Only the SDF decoder, in eval mode, on assembled [latent,
        embedding] rows: (sdf_hand (M, 1), sdf_obj (M, 1), logits (M, C) or
        None)."""
        return self.decoder(decoder_inputs)


def build_model(specs: Specs, device: Union[str, torch.device] = "cpu",
                seed: Optional[int] = None) -> AlignSDF:
    """The model on ``device``; with ``seed``, its random initial weights come
    from that seed without touching the global generator."""
    if seed is None:
        return AlignSDF(specs).to(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return AlignSDF(specs).to(device)
