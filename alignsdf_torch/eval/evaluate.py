"""Evaluation over a reconstruction workspace, the JAX package's ``eval/evaluate.py``: chamfer, MANO
joint/vert errors and object pose errors in numpy/scipy on the host
(reference evaluate.py:19-326; its multiprocessing Queue replaced by a pool
of spawned processes).

Modes (reference evaluate.py:30-60 mesh selection):
  * default ("hand"): chamfer on the reconstructed SDF hand mesh
    (``meshes/<key>_hand.ply``) vs GT ``mesh_hand/<key>.obj``
  * ``mano``:  chamfer on the predicted MANO mesh (``pred_mano/<key>.ply``,
    or ``optim_mano/`` with ``optim_mano=True``) vs GT hand mesh, plus
    root-relative joint/vert errors in mm (reference evaluate.py:67-89)
  * ``obj``:   chamfer on ``meshes/<key>_obj.ply`` vs GT ``mesh_obj``, plus
    object center/corner errors in mm (reference evaluate.py:91-105)
  * ``fit``:   chamfer between the SDF hand mesh and the MANO hand mesh
    (hand-SDF/MANO consistency, reference evaluate.py:48-50)

Metric protocols (BASELINE.md): symmetric mean-squared-NN chamfer over 30k
surface samples in cm^2 (mean + median); mm errors scaled at reporting.
Best/worst-20 artifact copies mirror reference evaluate.py:230-301.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import pickle
import shutil
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from alignsdf_torch.eval.chamfer import compute_chamfer


def _mano_errors(pred_mano_json: str, gt_meta_pkl: str, cam_extr: np.ndarray):
    """Root-relative joint/vert L2 in mm (reference evaluate.py:67-89)."""
    with open(pred_mano_json) as f:
        pred = json.load(f)
    with open(gt_meta_pkl, "rb") as f:
        gt = pickle.load(f)

    pred_joints = np.asarray(pred["joints"], np.float64)
    gt_joints = (cam_extr @ np.asarray(gt["coords_3d"], np.float64)[:, :3].T).T

    pred_joints = pred_joints - pred_joints[0:1]
    gt_joints = gt_joints - gt_joints[0:1]
    joint_err = float(np.linalg.norm(pred_joints - gt_joints, axis=1).mean() * 1000.0)

    vert_err = None
    if "verts_3d" in gt and "vertices" in pred:
        pred_verts = np.asarray(pred["vertices"], np.float64)
        gt_verts = (cam_extr @ np.asarray(gt["verts_3d"], np.float64)[:, :3].T).T
        pred_verts = pred_verts - np.asarray(pred["joints"], np.float64)[0:1]
        gt_verts = gt_verts - (cam_extr @ np.asarray(gt["coords_3d"], np.float64)[0:1, :3].T).T
        vert_err = float(np.linalg.norm(pred_verts - gt_verts, axis=1).mean() * 1000.0)
    return joint_err, vert_err


def _obj_errors(pred_obj_json: str, gt_meta_pkl: str, cam_extr: np.ndarray):
    """Object center/corner L2 in mm (reference evaluate.py:91-105):
    center = predicted obj_trans translation vs the GT affine translation
    relative to the hand root; corners = predicted corners vs GT rows 1:."""
    with open(pred_obj_json) as f:
        pred = json.load(f)
    with open(gt_meta_pkl, "rb") as f:
        gt = pickle.load(f)
    pred_center = np.asarray(pred["obj_trans"], np.float64)[:3, 3]
    gt_center = cam_extr @ (
        np.asarray(gt["affine_transform"], np.float64)[:3, 3]
        - np.asarray(gt["coords_3d"], np.float64)[0, :3]
    )
    center_err = float(np.linalg.norm(gt_center - pred_center) * 1000.0)
    pred_corners = np.asarray(pred["obj_corners"], np.float64)
    gt_corners = (
        cam_extr @ np.asarray(gt["obj_corners_3d"], np.float64)[1:, :3].T
    ).T
    corner_err = float(
        np.linalg.norm(gt_corners - pred_corners, axis=1).mean() * 1000.0
    )
    return center_err, corner_err


def _mesh_pair(key: str, cfg: Dict[str, Any]):
    """Reconstructed/GT mesh paths per mode (reference evaluate.py:48-60)."""
    mode = cfg["mode"]
    mesh_dir, mano_dir, gt_root = cfg["mesh_dir"], cfg["mano_dir"], cfg["gt_root"]
    if mode == "fit":
        return (os.path.join(mesh_dir, key + "_hand.ply"),
                os.path.join(mano_dir, key + "_hand.ply"))
    if mode == "mano":
        return (os.path.join(mano_dir, key + ".ply"),
                os.path.join(gt_root, "mesh_hand", key + ".obj"))
    if mode == "obj":
        return (os.path.join(mesh_dir, key + "_obj.ply"),
                os.path.join(gt_root, "mesh_obj", key + ".obj"))
    return (os.path.join(mesh_dir, key + "_hand.ply"),
            os.path.join(gt_root, "mesh_hand", key + ".obj"))


def _eval_one(args):
    key, cfg = args
    mode = cfg["mode"]
    out: Dict[str, Optional[float]] = {"key": key}
    cam_extr = (
        np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
        if ("obman" in cfg["task"] or "ho3d" in cfg["task"]) else np.eye(3)
    )

    pred_path, gt_path = _mesh_pair(key, cfg)
    if not (os.path.isfile(pred_path) and os.path.isfile(gt_path)):
        out["chamfer"] = None
        return out
    try:
        out["chamfer"] = compute_chamfer(
            gt_path, pred_path, optim=cfg["optim"], rot=cfg["rot"]
        )
    except Exception:
        out["chamfer"] = None
        return out

    meta = os.path.join(cfg["gt_root"], "meta", key + ".pkl")
    if mode == "mano" and os.path.isfile(meta):
        mano_json = os.path.join(cfg["mano_dir"], key + ".json")
        if os.path.isfile(mano_json):
            try:
                out["joint_err"], out["vert_err"] = _mano_errors(
                    mano_json, meta, cam_extr)
            except Exception:
                pass
    elif mode == "obj" and os.path.isfile(meta):
        obj_json = os.path.join(cfg["output_dir"], "object", key + ".json")
        if os.path.isfile(obj_json):
            try:
                out["obj_center_err"], out["obj_corner_err"] = _obj_errors(
                    obj_json, meta, cam_extr)
            except Exception:
                pass
    return out


def _discover_keys(cfg: Dict[str, Any]) -> List[str]:
    """List evaluable keys from the Eval workspace (reference
    evaluate.py:30-45)."""
    mode = cfg["mode"]
    if mode == "mano":
        files = [f for f in os.listdir(cfg["mano_dir"]) if f.endswith(".ply")
                 and not f.endswith("_hand.ply")]
        return sorted(f.split(".")[0] for f in files)
    suffix = "_obj.ply" if mode == "obj" else "_hand.ply"
    files = [f for f in os.listdir(cfg["mesh_dir"]) if f.endswith(suffix)]
    return sorted(f.split("_")[0] for f in files)


def _copy_extremes(results: List[Dict[str, Any]], cfg: Dict[str, Any]) -> None:
    """Copy the GT/pred/input artifacts of the 20 worst and 20 best samples
    by chamfer (reference evaluate.py:230-301; summary sorted descending, so
    the head is the worst)."""
    mode = cfg["mode"]
    sub = {"mano": ("best_mano", "worst_mano"), "obj": ("best_obj", "worst_obj")}
    best_name, worst_name = sub.get(mode, ("best_hand", "worst_hand"))
    best_dir = os.path.join(cfg["output_dir"], best_name)
    worst_dir = os.path.join(cfg["output_dir"], worst_name)
    os.makedirs(best_dir, exist_ok=True)
    os.makedirs(worst_dir, exist_ok=True)

    ranked = sorted((r for r in results if r.get("chamfer") is not None),
                    key=lambda r: r["chamfer"], reverse=True)
    for idx, r in enumerate(ranked):
        if not (idx < 20 or idx > len(ranked) - 21):
            continue
        key = r["key"]
        dst = worst_dir if idx < 20 else best_dir
        gt_sub = "mesh_obj" if mode == "obj" else "mesh_hand"
        candidates = [
            os.path.join(cfg["gt_root"], gt_sub, key + ".obj"),
            os.path.join(cfg["gt_root"], "rgb", key + ".jpg"),
            os.path.join(cfg["mesh_dir"], key + "_hand.ply"),
            os.path.join(cfg["mesh_dir"], key + "_obj.ply"),
        ]
        if mode == "mano":
            candidates.append(os.path.join(cfg["mano_dir"], key + ".ply"))
        for path in candidates:
            if os.path.isfile(path):
                shutil.copy2(path, dst)


def evaluate(
    output_dir: str,
    task: str,
    keys: Optional[List[str]] = None,
    data_root: Optional[str] = None,
    mano: bool = False,
    obj: bool = False,
    optim: bool = False,
    optim_mano: bool = False,
    fit: bool = False,
    rot: bool = False,
    workers: int = 10,
) -> Dict[str, float]:
    """Evaluate reconstructed meshes; writes the summary txt, a JSON report,
    and best/worst-20 artifact copies.  Returns the aggregate dict
    (reference evaluate.py:230-326).  ``keys=None`` discovers evaluable
    samples from the workspace like the reference."""
    mode = "fit" if fit else "mano" if mano else "obj" if obj else "hand"
    mano_dir = os.path.join(output_dir, "optim_mano" if optim_mano else "pred_mano")
    cfg = {
        "task": task,
        "mode": mode,
        "mesh_dir": os.path.join(output_dir, "meshes"),
        "mano_dir": mano_dir,
        "gt_root": data_root or os.path.join("data", task, "test"),
        "output_dir": output_dir,
        "optim": optim,
        "rot": rot,
    }
    if keys is None:
        keys = _discover_keys(cfg)
    jobs = [(k, cfg) for k in keys]
    if workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
            results = list(pool.map(_eval_one, jobs))
    else:
        results = [_eval_one(j) for j in jobs]

    summary: Dict[str, float] = {}

    def agg(field: str):
        vals = [r[field] for r in results if r.get(field) is not None]
        if vals:
            summary[f"{field}_mean"] = float(np.mean(vals))
            summary[f"{field}_median"] = float(np.median(vals))
            summary[f"{field}_count"] = len(vals)

    for field in ("chamfer", "joint_err", "vert_err",
                  "obj_center_err", "obj_corner_err"):
        agg(field)
    evaluated = [r for r in results if r.get("chamfer") is not None]
    summary["failure_count"] = len(results) - len(evaluated)

    if not fit:
        _copy_extremes(results, cfg)

    summary_filename = (
        "fit.txt" if fit else
        "chamfer_mano.txt" if mano else
        "chamfer_obj.txt" if obj else "chamfer_hand.txt"
    )
    with open(os.path.join(output_dir, summary_filename), "w") as f:
        f.write("summary of chamfer_dist\n")
        for r in sorted(evaluated, key=lambda r: r["chamfer"], reverse=True):
            f.write("{}, {}, {}, {}\n".format(
                r["key"], r["chamfer"],
                (r.get("joint_err") or r.get("obj_center_err") or 0.0),
                (r.get("vert_err") or r.get("obj_corner_err") or 0.0)))
        for k, v in sorted(summary.items()):
            f.write(f"{k}: {v}\n")
    with open(os.path.join(output_dir, f"eval_{task}_{mode}.json"), "w") as f:
        json.dump({"summary": summary, "per_sample": results}, f, indent=1)
    return summary
