"""Experiment configuration: the subset of the spec schema the port reads.

Same JSON keys, defaults and derived gates as the JAX package's config
(reference train.py:239-330); keys the port does not read are ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class NetworkSpecs:
    """SDF decoder MLP hyperparameters (reference networks/model.py:79-350)."""

    dims: Tuple[int, ...] = (512, 512, 512, 512)
    dropout: Tuple[int, ...] = (0, 1, 2, 3)
    dropout_prob: float = 0.2
    norm_layers: Tuple[int, ...] = (0, 1, 2, 3)
    latent_in: Tuple[int, ...] = (2,)
    num_class: int = 6
    xyz_in_all: bool = False
    use_tanh: bool = False
    latent_dropout: bool = False
    weight_norm: bool = True


@dataclass(frozen=True)
class LearningRateSchedule:
    """Step LR schedule (reference train.py:55-62)."""

    type: str = "Step"
    initial: float = 1e-4
    interval: int = 600
    factor: float = 0.5

    def learning_rate(self, epoch: int) -> float:
        return self.initial * (self.factor ** (epoch // self.interval))


@dataclass(frozen=True)
class Specs:
    """The spec fields that shape the reconstruction and training paths."""

    data_source: str = "data"
    image_source: str = "rgb"         # the per-file layout's image directory
    train_split: str = ""
    dataset: str = "obman"
    model_type: str = "1encoder2decoder"
    backbone: str = "resnet18"
    image_size: Tuple[int, int] = (256, 256)
    sdf_scale_factor: float = 1.0
    latent_size: int = 256
    point_feat_size: int = 3
    encode_style: str = "nerf"
    pose_feat_size: int = 15
    pixel_align: bool = False
    hand_branch: bool = True
    obj_branch: bool = True
    object_pose_branch: bool = False
    mano_branch: bool = False
    depth_branch: bool = False
    render: bool = False
    classifier_branch: bool = False
    obj_corner_weight: float = 0.2
    compute_dtype: str = "float32"
    network_specs: NetworkSpecs = field(default_factory=NetworkSpecs)

    # training (reference train.py:239-330, the JAX package's defaults)
    lmdb: bool = True                 # the dataset is the five-LMDB format
    snapshot_frequency: int = 500
    log_frequency: int = 5            # epochs between "latest" checkpoints
    log_frequency_step: int = 10      # steps between logged losses
    additional_snapshots: Tuple[int, ...] = (100, 500)
    data_loader_threads: int = 5
    resume: str = "latest.pth"        # a warm-start checkpoint, if it exists
    num_epochs: int = 1600
    # "bn": normalize with batch statistics but never update the running
    # buffers (reference networks/model.py:24-30); "none": normal training
    freeze: str = "none"
    additional_loss_start: int = 1201
    samples_per_scene: int = 2000
    scenes_per_batch: int = 64
    clamping_distance: float = 0.05
    classifier_weight: float = 0.005
    penetration_loss: bool = False
    contact_loss: bool = False
    contact_loss_sigma: float = 0.005
    ignore_point_from_other_mesh: bool = False
    hand_sdf_weight: float = 1.0
    obj_sdf_weight: float = 1.0
    joint_weight: float = 1.0
    vert_weight: float = 0.0
    shape_reg_weight: float = 1.0
    pose_reg_weight: float = 1.0
    obj_center_weight: float = 1.0
    penetration_loss_weight: float = 15.0
    contact_loss_weight: float = 0.005
    disable_aug: bool = False
    background_aug: bool = False
    # the JAX package's opt-in synthetic occlusion: the reference draws
    # do_occlusion but its train dataset never applies it (utils/data.py:
    # 132,142), so off keeps the reference's behaviour
    occlusion_aug: bool = False
    random_seed: Optional[int] = None
    gradient_clip_norm: Optional[float] = None
    lr_schedules: Tuple[LearningRateSchedule, ...] = (LearningRateSchedule(),)

    # derived gates (reference train.py:249-278)
    @property
    def use_obj_pose(self) -> bool:
        return self.object_pose_branch and self.mano_branch

    @property
    def use_obj_rot(self) -> bool:
        return self.use_obj_pose and self.obj_corner_weight > 0

    @property
    def use_depth(self) -> bool:
        return self.depth_branch and self.mano_branch

    @property
    def use_headnet(self) -> bool:
        return self.object_pose_branch or self.render or self.pixel_align

    def experiment_name(self) -> str:
        """Config-encoding experiment directory name (reference train.py:291-296)."""
        data_info = (self.train_split.split("/")[-1].rsplit(".", 1)[0]
                     if self.train_split else self.dataset)
        model_abbr = "".join(re.findall(r"\d+", self.model_type))
        j_w = self.joint_weight if self.mano_branch else 0
        v_w = self.vert_weight if self.mano_branch else 0
        s_w = self.shape_reg_weight if self.mano_branch else 0
        p_w = self.pose_reg_weight if self.mano_branch else 0
        oc_w = self.obj_center_weight if self.use_obj_pose else 0
        ocr_w = self.obj_corner_weight if self.use_obj_pose else 0
        cls_w = self.classifier_weight if self.classifier_branch else 0
        pen_w = self.penetration_loss_weight if self.penetration_loss else 0
        con_w = self.contact_loss_weight if self.contact_loss else 0
        model_info = (
            f"m{model_abbr}_{self.backbone}_mlp{len(self.network_specs.dims) + 1}"
            f"_pa{int(self.pixel_align)}_h{int(self.hand_branch)}_o{int(self.obj_branch)}"
            f"_d{int(self.use_depth)}_cls{int(self.classifier_branch)}"
            f"_mano{int(self.mano_branch)}_obj{int(self.use_obj_pose)}"
            f"_pose{self.pose_feat_size}_point{self.point_feat_size}_{self.encode_style}"
        )
        train_info = (
            f"e{self.num_epochs}_ae{self.additional_loss_start}"
            f"_b{self.scenes_per_batch}_np{self.samples_per_scene}"
            f"_ims{self.image_size[0]}_lr{self.lr_schedules[0].initial}"
            f"_aug{int(not self.disable_aug)}_bg{int(self.background_aug)}"
            f"_hsw{self.hand_sdf_weight}_osw{self.obj_sdf_weight}"
            f"_jw{j_w}_vw{v_w}_prw{p_w}_srw{s_w}_ocw{oc_w}_ocrw{ocr_w}"
            f"_clsw{cls_w}_penw{pen_w}_conw{con_w}"
        )
        return "_".join([data_info, model_info, train_info])


_KEY_MAP = {
    "DataSource": "data_source",
    "ImageSource": "image_source",
    "TrainSplit": "train_split",
    "Dataset": "dataset",
    "ModelType": "model_type",
    "Backbone": "backbone",
    "ImageSize": "image_size",
    "SdfScaleFactor": "sdf_scale_factor",
    "LatentSize": "latent_size",
    "PointFeatSize": "point_feat_size",
    "EncodeStyle": "encode_style",
    "PoseFeatSize": "pose_feat_size",
    "PixelAlign": "pixel_align",
    "HandBranch": "hand_branch",
    "ObjectBranch": "obj_branch",
    "ObjectPoseBranch": "object_pose_branch",
    "ManoBranch": "mano_branch",
    "DepthBranch": "depth_branch",
    "Render": "render",
    "ClassifierBranch": "classifier_branch",
    "ObjCornerWeight": "obj_corner_weight",
    "ComputeDtype": "compute_dtype",
    "LMDB": "lmdb",
    "SnapshotFrequency": "snapshot_frequency",
    "LogFrequency": "log_frequency",
    "LogFrequencyStep": "log_frequency_step",
    "AdditionalSnapshots": "additional_snapshots",
    "DataLoaderThreads": "data_loader_threads",
    "Resume": "resume",
    "NumEpochs": "num_epochs",
    "Freeze": "freeze",
    "AdditionalLossStart": "additional_loss_start",
    "SamplesPerScene": "samples_per_scene",
    "ScenesPerBatch": "scenes_per_batch",
    "ClampingDistance": "clamping_distance",
    "ClassifierWeight": "classifier_weight",
    "PenetrationLoss": "penetration_loss",
    "ContactLoss": "contact_loss",
    "ContactLossSigma": "contact_loss_sigma",
    "IgnorePointFromOtherMesh": "ignore_point_from_other_mesh",
    "HandSdfWeight": "hand_sdf_weight",
    "ObjSdfWeight": "obj_sdf_weight",
    "JointWeight": "joint_weight",
    "VertWeight": "vert_weight",
    "ShapeRegWeight": "shape_reg_weight",
    "PoseRegWeight": "pose_reg_weight",
    "ObjCenterWeight": "obj_center_weight",
    "PenetrationLossWeight": "penetration_loss_weight",
    "ContactLossWeight": "contact_loss_weight",
    "DisableAug": "disable_aug",
    "OcclusionAug": "occlusion_aug",
    "BackgroundAug": "background_aug",
    "RandomSeed": "random_seed",
    "GradientClipNorm": "gradient_clip_norm",
}

_NS_FIELDS = {f.name for f in dataclasses.fields(NetworkSpecs)}

_TUPLE_FIELDS = {"image_size", "additional_snapshots", "dims", "dropout", "norm_layers",
                 "latent_in"}


def specs_from_dict(raw: Dict[str, Any]) -> Specs:
    """Build a Specs from a reference-format JSON dict; unknown keys ignored."""
    kwargs: Dict[str, Any] = {}
    for json_key, value in raw.items():
        if json_key == "NetworkSpecs":
            ns_kwargs = {}
            for k, v in value.items():
                if k not in _NS_FIELDS:
                    continue
                if k in _TUPLE_FIELDS and isinstance(v, list):
                    v = tuple(v)
                ns_kwargs[k] = v
            kwargs["network_specs"] = NetworkSpecs(**ns_kwargs)
            continue
        if json_key == "LearningRateSchedule":
            kwargs["lr_schedules"] = tuple(
                LearningRateSchedule(type=s.get("Type", "Step"), initial=s.get("Initial", 1e-4),
                                     interval=s.get("Interval", 600), factor=s.get("Factor", 0.5))
                for s in value)
            continue
        fname = _KEY_MAP.get(json_key)
        if fname is None:
            continue
        if fname in _TUPLE_FIELDS and isinstance(value, list):
            value = tuple(value)
        kwargs[fname] = value
    return Specs(**kwargs)


def load_specs(path: str) -> Specs:
    with open(path, "r") as f:
        return specs_from_dict(json.load(f))


def specs_to_dict(specs: Specs) -> Dict[str, Any]:
    """Inverse of specs_from_dict for the fields the port holds: a
    reference-format (CamelCase) spec dict, e.g. an experiment's specs.json."""
    out: Dict[str, Any] = {}
    for json_key, fname in _KEY_MAP.items():
        value = getattr(specs, fname)
        if value is not None:
            out[json_key] = list(value) if isinstance(value, tuple) else value
    ns = specs.network_specs
    out["NetworkSpecs"] = {f.name: (list(v) if isinstance(v, tuple) else v)
                           for f in dataclasses.fields(NetworkSpecs)
                           for v in [getattr(ns, f.name)]}
    out["LearningRateSchedule"] = [
        {"Type": s.type, "Initial": s.initial, "Interval": s.interval, "Factor": s.factor}
        for s in specs.lr_schedules]
    return out


# CLI flag -> (field, kind): the reference's override flags (reference
# utils/utils.py:36-354) for the fields the port holds.
_CLI_OVERRIDES = {
    "epoch": ("num_epochs", int),
    "add_epoch": ("additional_loss_start", int),
    "batch_size": ("scenes_per_batch", int),
    "num_points": ("samples_per_scene", int),
    "random_seed": ("random_seed", int),
    "hsw": ("hand_sdf_weight", float),
    "osw": ("obj_sdf_weight", float),
    "jw": ("joint_weight", float),
    "vw": ("vert_weight", float),
    "srw": ("shape_reg_weight", float),
    "prw": ("pose_reg_weight", float),
    "ocw": ("obj_center_weight", float),
    "penw": ("penetration_loss_weight", float),
    "conw": ("contact_loss_weight", float),
    "no_aug": ("disable_aug", "flag"),
    "lmdb": ("lmdb", "flag"),
    "freeze": ("freeze", str),
    "penetration": ("penetration_loss", "flag"),
    "contact": ("contact_loss", "flag"),
    "bg_aug": ("background_aug", "flag"),
    "image_size": ("image_size", "size2"),
    "latent_size": ("latent_size", int),
    "pose_size": ("pose_feat_size", int),
    "point_size": ("point_feat_size", int),
    "mano": ("mano_branch", "flag"),
    "cls": ("classifier_branch", "flag"),
    "depth": ("depth_branch", "flag"),
    "obj_pose": ("object_pose_branch", "flag"),
    "ocrw": ("obj_corner_weight", float),
    "render": ("render", "flag"),
    "encode": ("encode_style", str),
    "pa_feat": ("pixel_align", "flag"),
    "backbone": ("backbone", str),
}


def add_train_args(parser: argparse.ArgumentParser) -> None:
    """Register the override flags (reference utils/utils.py:36-231)."""
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--lr_interval", type=int, default=None)
    parser.add_argument("--lr_factor", type=float, default=None)
    parser.add_argument("--bf16", action="store_true", default=False,
                        help="bfloat16 compute dtype (params/stats/losses f32)")
    for flag, (_, kind) in _CLI_OVERRIDES.items():
        if kind == "flag":
            parser.add_argument(f"--{flag}", action="store_true", default=False)
        else:
            parser.add_argument(f"--{flag}", type=int if kind == "size2" else kind,
                                default=None)


def apply_overrides(specs: Specs, args: Any) -> Specs:
    """Apply parsed CLI flags (any object with the flags as attributes) over
    the spec (reference utils/utils.py:234-354)."""
    updates: Dict[str, Any] = {}
    for flag, (fname, kind) in _CLI_OVERRIDES.items():
        value = getattr(args, flag, None)
        if kind == "flag":
            if value:
                updates[fname] = True
        elif value is not None:
            updates[fname] = (value, value) if kind == "size2" else value
    if getattr(args, "bf16", False):
        updates["compute_dtype"] = "bfloat16"
    lr = {k: getattr(args, f"lr{s}", None) for k, s in
          (("initial", ""), ("interval", "_interval"), ("factor", "_factor"))}
    lr = {k: v for k, v in lr.items() if v is not None}
    if lr:
        updates["lr_schedules"] = tuple(dataclasses.replace(s, **lr)
                                        for s in specs.lr_schedules)
    return dataclasses.replace(specs, **updates) if updates else specs
