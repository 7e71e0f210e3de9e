"""Training losses, formula for formula the JAX package's
``training/losses.py`` (reference train.py:511-581).  The epoch-dependent
masking arrives as per-point mask tensors built by the caller
(``train_step.build_batch_masks``)."""

from __future__ import annotations

from typing import Dict

import torch


def clamped_l1_sdf(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                   clamp: float, weight: float) -> torch.Tensor:
    """weight * L1_sum(clamp(pred)*mask, clamp(target)*mask) / mask.sum()
    (reference train.py:513-534; both sides clamped to +/-clamp)."""
    pred = torch.clamp(pred, -clamp, clamp)
    target = torch.clamp(target, -clamp, clamp)
    return weight * torch.sum(torch.abs(pred * mask - target * mask)) / torch.sum(mask)


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """torch CrossEntropyLoss(ignore_index=-1) semantics, but 0 (not NaN)
    when every row is ignored, as in the JAX package (reference
    train.py:395,554-558)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(1, safe[:, None])[:, 0]
    denom = torch.clamp(valid.sum(), min=1)
    return torch.sum(torch.where(valid, nll, torch.zeros_like(nll))) / denom


def penetration_loss(scaled_hand: torch.Tensor, scaled_obj: torch.Tensor,
                     weight: float) -> torch.Tensor:
    """max(-(h+o), 0).mean() * w on metre-scale SDFs (reference train.py:570-571)."""
    return torch.mean(torch.clamp(-(scaled_hand + scaled_obj), min=0.0)) * weight


def contact_loss(scaled_hand: torch.Tensor, scaled_obj: torch.Tensor,
                 sigma: float, weight: float) -> torch.Tensor:
    """min(alpha*(h^2+o^2), 1).mean() * w, alpha = 1/sigma^2
    (reference train.py:575-577)."""
    alpha = 1.0 / sigma ** 2
    return torch.mean(torch.clamp(alpha * (scaled_hand ** 2 + scaled_obj ** 2), max=1.0)) * weight


def compute_losses(specs, outputs, batch: Dict[str, torch.Tensor],
                   additional_active: float) -> Dict[str, torch.Tensor]:
    """The total training loss and its terms.

    ``outputs`` is (sdf_hand, sdf_obj, pred_class, mano_results,
    obj_results); ``batch`` holds sdf_gt_hand / sdf_gt_obj, labels,
    mask_hand / mask_obj, hand_joints_3d, obj_center and obj_corners;
    ``additional_active`` is 1.0 from AdditionalLossStart on, else 0.0 (it
    gates the classifier, penetration and contact terms; the SDF masks carry
    their own gating)."""
    sdf_hand, sdf_obj, pred_class, mano_results, obj_results = outputs
    clamp = specs.clamping_distance
    losses: Dict[str, torch.Tensor] = {}
    total = 0.0

    sdf_hand = sdf_hand.reshape(-1)
    sdf_obj = sdf_obj.reshape(-1)
    mask_hand = batch["mask_hand"].reshape(-1)
    mask_obj = batch["mask_obj"].reshape(-1)

    if specs.hand_branch:
        losses["hand_sdf"] = clamped_l1_sdf(sdf_hand, batch["sdf_gt_hand"].reshape(-1),
                                            mask_hand, clamp, specs.hand_sdf_weight)
        total = total + losses["hand_sdf"]
    if specs.obj_branch:
        losses["obj_sdf"] = clamped_l1_sdf(sdf_obj, batch["sdf_gt_obj"].reshape(-1),
                                           mask_obj, clamp, specs.obj_sdf_weight)
        total = total + losses["obj_sdf"]

    if specs.mano_branch:
        losses["joint"] = specs.joint_weight * mse(mano_results["joints"], batch["hand_joints_3d"])
        losses["pose"] = specs.pose_reg_weight * mse(mano_results["pose"],
                                                     torch.zeros_like(mano_results["pose"]))
        losses["shape"] = specs.shape_reg_weight * mse(mano_results["shape"],
                                                       torch.zeros_like(mano_results["shape"]))
        total = total + losses["joint"] + losses["pose"] + losses["shape"]

    if specs.use_obj_pose:
        losses["obj_center"] = specs.obj_center_weight * mse(obj_results["obj_center"],
                                                             batch["obj_center"])
        losses["obj_corner"] = specs.obj_corner_weight * mse(obj_results["obj_corners"],
                                                             batch["obj_corners"])
        total = total + losses["obj_center"] + losses["obj_corner"]

    if specs.classifier_branch:
        ce = cross_entropy_ignore(pred_class, batch["labels"])
        losses["cls"] = ce * specs.classifier_weight * additional_active
        total = total + losses["cls"]

    if specs.penetration_loss or specs.contact_loss:
        # back to metre scale (reference train.py:562-568; pairs with the /2
        # in the data pipeline, reference utils/data.py:198-199)
        scaled_hand = sdf_hand * 2.0 / specs.sdf_scale_factor
        scaled_obj = sdf_obj * 2.0 / specs.sdf_scale_factor
        if specs.penetration_loss:
            losses["penetration"] = penetration_loss(
                scaled_hand, scaled_obj, specs.penetration_loss_weight) * additional_active
            total = total + losses["penetration"]
        if specs.contact_loss:
            losses["contact"] = contact_loss(
                scaled_hand, scaled_obj, specs.contact_loss_sigma,
                specs.contact_loss_weight) * additional_active
            total = total + losses["contact"]

    losses["total"] = total
    return losses
