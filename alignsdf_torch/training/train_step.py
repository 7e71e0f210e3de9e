"""The training step on one device (the JAX package's
``training/train_step.py``, its scene-factored, pixel and materialized-input
branches): the model's front half with BatchNorm in batch-statistic mode,
the trunks through K4 for a pixel-aligned spec (``ops/pixel_train_plan.py``),
else K2 (``ops/train_plan.py``), else, for the specs both decline (``0 in
latent_in``), K5 on materialized rows (``ops/generic_train_plan.py``), the
reference's losses and masks, Adam with the step LR.  Also the per-point
loss masks and the clamp dead-zone init guard.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from alignsdf_torch.config import Specs
from alignsdf_torch.data.synthetic import synthetic_train_batch
from alignsdf_torch.models.alignsdf import build_model
from alignsdf_torch.ops.generic_train_plan import make_generic_train_decoder
from alignsdf_torch.ops.pixel_train_plan import make_pixel_train_decoder
from alignsdf_torch.ops.train_plan import make_train_decoder
from alignsdf_torch.training.losses import compute_losses
from alignsdf_torch.training.train_state import (
    TrainState,
    clip_by_global_norm_,
    learning_rate_for_epoch,
    make_optimizer,
)

COND_KEYS = ("cam_intr", "mano_root", "rest_obj_corners")


def build_batch_masks(specs: Specs, batch_size: int, additional_active: float,
                      is_hand: Optional[torch.Tensor] = None,
                      device: Optional[torch.device] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point (B*N, 1) hand/obj loss masks (reference train.py:467-487).
    The point layout is [hand half | obj half] per scene, or ``is_hand``
    (B*N,) where the loader reordered the points.  Before
    AdditionalLossStart (or with IgnorePointFromOtherMesh) each branch sees
    only its own points; from then on both see all of them."""
    n = specs.samples_per_scene
    half = n // 2
    total = batch_size * n
    ones = torch.ones((total, 1), device=device)
    if not (specs.hand_branch and specs.obj_branch):
        return ones, ones
    if is_hand is not None:
        early_hand = is_hand.reshape(total, 1).to(torch.float32)
        early_obj = 1.0 - early_hand
    else:
        per_hand = torch.cat([torch.ones(half), torch.zeros(n - half)]).to(device)
        per_obj = torch.cat([torch.zeros(half), torch.ones(n - half)]).to(device)
        early_hand = per_hand.repeat(batch_size).reshape(total, 1)
        early_obj = per_obj.repeat(batch_size).reshape(total, 1)
    if specs.ignore_point_from_other_mesh:
        return early_hand, early_obj
    active = float(additional_active)
    return (early_hand * (1 - active) + ones * active,
            early_obj * (1 - active) + ones * active)


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def draw_seed(gen: torch.Generator) -> int:
    """A step's dropout seed in [0, 2^31 - 1), as the JAX step draws it."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))


def _bn_buffers(model: torch.nn.Module):
    return [b for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
            for b in (m.running_mean, m.running_var, m.num_batches_tracked) if b is not None]


def make_spec_train_decoder(specs: Specs) -> Optional[Callable]:
    """The spec's train decoder, routed as the JAX CLI routes it
    (``cli/train.py:225-228``): K4 for a pixel-aligned spec, else the
    scene-factored K2, else K5 on materialized rows; None where all three
    decline.  For the port, K5 takes exactly the specs with 0 in
    ``latent_in``, flat or pixel-aligned."""
    return (make_pixel_train_decoder(specs) or make_train_decoder(specs)
            or make_generic_train_decoder(specs))


def train_decoder_kind(decode: Callable) -> str:
    """How a train decoder reads its inputs, and its kernel, for the logs."""
    if getattr(decode, "pixel", False):
        band = getattr(decode, "band", None)
        if band is None:
            return "pixel-aligned (K4)"
        return (f"pixel-aligned (K4) with a band of {band} rows"
                + (" on host-sorted points" if decode.presorted else ", sorted on the device"))
    if getattr(decode, "materialized", False):
        return "materialized inputs (K5)"
    return "scene-factored (K2)"


def make_train_step(specs: Specs, decode: Optional[Callable] = None) -> Callable:
    """step(state, batch, seed, mark=None) -> losses (detached tensors).

    ``decode`` defaults to ``make_spec_train_decoder(specs)``: K4, where both
    trunks draw their dropout from ``seed``; K2 or K5, where the hand trunk
    draws from ``seed`` and the object trunk from ``seed + 1``.  ``mark``, if
    given, is called with "inputs", "decoder", "loss", "backward" and
    "optimizer" as each phase has been enqueued (for timing).  ``step.decode``
    is the decoder it runs.  A bf16 spec (ComputeDtype bfloat16) runs the
    front half on bf16 operands and its train decoder (K2, K4 or K5) in
    bf16; the losses, the parameters and Adam stay float32."""
    if decode is None:
        decode = make_spec_train_decoder(specs)
    if decode is None:
        raise NotImplementedError("this decoder structure has no fused train kernel")
    pixel = getattr(decode, "pixel", False)
    materialized = getattr(decode, "materialized", False)

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int,
             mark: Optional[Callable[[str], None]] = None) -> Dict[str, torch.Tensor]:
        mark = mark or (lambda name: None)
        model, optimizer = state.model, state.optimizer
        active = 1.0 if state.epoch >= specs.additional_loss_start else 0.0
        batch_size = batch["image"].shape[0]
        mask_hand, mask_obj = build_batch_masks(specs, batch_size, active,
                                                batch.get("point_is_hand"),
                                                device=batch["xyz"].device)
        loss_batch = dict(batch, mask_hand=mask_hand, mask_obj=mask_obj)
        frozen = ([b.clone() for b in _bn_buffers(model)] if specs.freeze == "bn" else None)

        cond = {k: batch[k] for k in COND_KEYS}
        if pixel:
            fmap, emb, mano_results, obj_results = model.decoder_inputs_pixel(
                batch["image"], batch["xyz"], cond, train=True)
            mark("inputs")
            sdf_hand, sdf_obj, logits = decode(model.decoder, fmap, emb, batch["xyz"],
                                               batch["cam_intr"], mano_results["joints"][:, 0:1],
                                               seed, train=True)
        elif materialized:
            rows, mano_results, obj_results = model.decoder_inputs(
                batch["image"], batch["xyz"], cond, train=True)
            mark("inputs")
            sdf_hand, sdf_obj, logits = decode(model.decoder, rows, seed, train=True)
        else:
            latent, emb, mano_results, obj_results = model.decoder_inputs_factored(
                batch["image"], batch["xyz"], cond, train=True)
            mark("inputs")
            sdf_hand, sdf_obj, logits = decode(model.decoder, latent, emb, seed, train=True)
        mark("decoder")
        losses = compute_losses(specs, (sdf_hand, sdf_obj, logits, mano_results, obj_results),
                                loss_batch, active)
        mark("loss")
        optimizer.zero_grad(set_to_none=True)
        losses["total"].backward()
        mark("backward")
        params = [p for group in optimizer.param_groups for p in group["params"]]
        for p in params:  # optax sees a zero gradient where autograd gives none
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if specs.gradient_clip_norm is not None:
            clip_by_global_norm_(params, specs.gradient_clip_norm)
        lr = learning_rate_for_epoch(specs, state.epoch)
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        if frozen is not None:
            # momentum-0 freeze (reference networks/model.py:24-30): the step
            # normalized with batch statistics; the running buffers stay
            with torch.no_grad():
                for b, saved in zip(_bn_buffers(model), frozen):
                    b.copy_(saved)
        mark("optimizer")
        return {k: v.detach() for k, v in losses.items()}

    step.decode = decode
    return step


def init_prediction_means(model, specs: Specs, batch_size: int = 2,
                          seed: int = 17) -> Tuple[float, float]:
    """Mean hand/obj SDF predictions at init on a synthetic probe batch, in
    eval mode through the generic decoder (for a pixel-aligned spec on the
    rows of ``decoder_inputs``, as the JAX package's full model apply).
    Detects the clamp dead zone: an init whose predictions all start at or
    past the ClampingDistance band has a zero-gradient SDF loss."""
    device = next(model.parameters()).device
    batch = batch_to_device(synthetic_train_batch(specs, batch_size, seed), device)
    cond = {k: batch[k] for k in COND_KEYS}
    with torch.no_grad():
        if specs.pixel_align:
            rows, _, _ = model.decoder_inputs(batch["image"], batch["xyz"], cond, train=False)
        else:
            latent, emb, _, _ = model.decoder_inputs_factored(batch["image"], batch["xyz"],
                                                              cond, train=False)
            n = emb.shape[0] // latent.shape[0]
            rows = torch.cat([latent.repeat_interleave(n, dim=0), emb], dim=1)
        h, o, _ = model.decoder(rows)
    return float(h.mean()), float(o.mean())


def healthy_init_train_state(specs: Specs, device, seed: int = 0,
                             max_tries: int = 25) -> Tuple[TrainState, int]:
    """A fresh TrainState whose probe predictions sit inside the clamp band
    (|mean| < 0.6 * ClampingDistance for both branches), re-drawing the init
    from seed, seed + 1, ... until one does.  Returns (state, tries); raises
    when no draw in ``max_tries`` is healthy."""
    clamp = specs.clamping_distance
    threshold = 0.6 * clamp if clamp else None
    last = None
    for t in range(max_tries):
        model = build_model(specs, device=device, seed=seed + t)
        if threshold is not None:
            last = init_prediction_means(model, specs)
            if not (abs(last[0]) < threshold and abs(last[1]) < threshold):
                continue
        return TrainState(model, make_optimizer(specs, model.parameters())), t + 1
    raise RuntimeError(
        f"no healthy init in {max_tries} draws (last probe means {last}, threshold "
        f"{threshold}): every draw starts the decoder in the {clamp} clamp's "
        "zero-gradient dead zone. Warm-start from a checkpoint or pass --no_init_guard.")


def init_train_state(specs: Specs, device, seed: int = 0) -> TrainState:
    model = build_model(specs, device=device, seed=seed)
    return TrainState(model, make_optimizer(specs, model.parameters()))
