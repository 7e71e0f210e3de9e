"""Per-image reconstruction (the JAX package's
``inference/reconstruct.py``; reference reconstruct.py:33-95 and the host
side of utils/mesh.py).

Per image: encode -> MANO and object pose -> two-pass grid (kernel K1, or
K3 for pixel-aligned configs, when the config allows the fused path; else
the generic path's ``decode_fn`` on materialized rows: the plain decoder, or
kernel K6 with ``ops/decoder_plan.make_generic_decode_fn``) ->
marching cubes -> largest component -> PLY/JSON exports; with
``eval_mode``, each mesh is first aligned to its GT mesh by trans+scale ICP
(reference utils/mesh.py:383-398); with ``label_out``, the hand-part labels
at the hand mesh's vertices (reference utils/mesh.py:137-184).
``submit`` enqueues the device work on the reconstructor's CUDA stream and
starts copies of the results into pinned host memory; ``finalize`` waits for
them and does the host work.  ``run_pipelined`` keeps ``lookahead`` images
of device work in flight, so image i's grid overlaps image i-1's marching
cubes.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from alignsdf_torch import resolve_device
from alignsdf_torch.config import Specs
from alignsdf_torch.eval.icp import ICPTransScale
from alignsdf_torch.geom.marching_cubes import marching_cubes
from alignsdf_torch.geom.meshlib import (TriMesh, largest_component, load_mesh, read_obj,
                                         write_ply)
from alignsdf_torch.inference.grid import embed_points, make_grid_evaluator
from alignsdf_torch.ops.geometry import pixel_alignment
from alignsdf_torch.ops.grid_plan import make_grid_decode_fn
from alignsdf_torch.ops.pixel_grid_plan import make_pixel_grid_decode_fn

logger = logging.getLogger(__name__)

PART_COLORS = np.array(
    [[13, 212, 128], [250, 70, 42], [131, 66, 37],
     [78, 137, 54], [187, 246, 163], [67, 220, 74]], np.uint8
)  # reference utils/mesh.py:316-323


def surface_mesh(sdf_field: np.ndarray, origin: np.ndarray,
                 voxel_size: float) -> Optional[TriMesh]:
    """Marching cubes of the zero level set, placed at ``origin``
    (reference utils/mesh.py:331-369); None when the field has no surface."""
    try:
        verts, faces = marching_cubes(sdf_field, 0.0, spacing=(voxel_size,) * 3)
    except ValueError as e:
        logger.warning("Cannot reconstruct mesh: %s", e)
        return None
    return TriMesh(verts + np.asarray(origin, np.float32)[None], faces)


def export_with_optional_icp(mesh: TriMesh, out_path: str, gt_mesh_path: Optional[str] = None,
                             timings: Optional[Dict[str, float]] = None):
    """PLY export; in eval mode (a GT mesh path that exists) the mesh is
    first aligned to the GT mesh by trans+scale ICP over 30k surface samples,
    at most 100 iterations (the JAX package's; reference
    utils/mesh.py:383-398).  Returns (trans, scale); adds the ICP's and the
    write's ms to ``timings["icp_ms"]`` and ``timings["export_ms"]``."""
    t0 = time.perf_counter()
    if gt_mesh_path is not None and os.path.isfile(gt_mesh_path):
        solver = ICPTransScale(mesh, load_mesh(gt_mesh_path))
        solver.sample_mesh(30000, "both")
        solver.run_icp_f(max_iter=100)
        t1 = time.perf_counter()
        solver.export_source_mesh(out_path)
        result = solver.get_trans_scale()
    else:
        t1 = t0
        mesh.export(out_path)
        result = np.zeros((1, 3)), np.array([1.0])
    if timings is not None:
        timings["icp_ms"] += (t1 - t0) * 1e3
        timings["export_ms"] += (time.perf_counter() - t1) * 1e3
    return result


def fused_grid_allowed(specs: Specs) -> bool:
    """Whether the embedding is affine in xyz with every transform the
    4-point probe needs present (the JAX Reconstructor's gate)."""
    style = specs.encode_style
    return ((style == "nerf" and specs.point_feat_size == 3)
            or (style == "hand" and specs.mano_branch)
            or (style in ("obj", "both") and specs.mano_branch and specs.object_pose_branch))


class Reconstructor:
    """Encoder and grid evaluator of one model, on one device.

    ``decode_fn(ctx, rows)`` decodes the generic path's materialized rows
    (default: the plain decoder; JAX's ``--pallas`` passes K6); the fused
    path (K1 or K3) still wins where the config allows it, and ``fused``
    says whether it does.  ``pixel_ref_projection``: for pixel-aligned
    configs, project the embedding's first three columns as the reference's
    mesh path does, instead of the raw grid coordinates (inference/grid.py).
    ``grid_dtype``: the fused kernels' compute dtype (JAX's ``grid_dtype``,
    ``--bf16``: torch.bfloat16; default float32), apart from the model's own
    (``ComputeDtype``), which the encoder, the plain decoder and the label
    re-query follow; a K6 ``decode_fn`` carries its own."""

    def __init__(self, model, specs: Specs, cube_dim: int = 128,
                 device: Optional[Union[str, torch.device]] = None,
                 mano_faces: Optional[np.ndarray] = None,
                 pixel_ref_projection: bool = False,
                 decode_fn: Optional[Callable] = None,
                 grid_dtype: Optional[torch.dtype] = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.specs = specs
        self.cube_dim = cube_dim
        self.mano_faces = mano_faces
        self.pixel_ref_projection = pixel_ref_projection
        self.grid_dtype = grid_dtype or torch.float32
        grid_decode_fn = None
        if fused_grid_allowed(specs):
            grid_decode_fn = (make_pixel_grid_decode_fn(specs, cube_dim, pixel_ref_projection,
                                                        self.grid_dtype)
                              if specs.pixel_align
                              else make_grid_decode_fn(specs, cube_dim, self.grid_dtype))
        if decode_fn is None:
            def decode_fn(ctx, rows):
                return ctx["decoder"](rows)
        self.fused = grid_decode_fn is not None
        self.evaluate_grid = make_grid_evaluator(decode_fn, specs, cube_dim,
                                                 grid_decode_fn=grid_decode_fn,
                                                 pixel_ref_projection=pixel_ref_projection)
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda" else None)

    def _on_stream(self):
        return torch.cuda.stream(self.stream) if self.stream is not None else contextlib.nullcontext()

    def _event(self):
        if self.stream is None:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.stream)
        return ev

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if self.stream is None:
            return t.detach().clone()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        return host

    @torch.no_grad()
    def submit(self, sample: Dict[str, Any]) -> Dict[str, Any]:
        """Enqueue one image's device work (encode + grid) and the copies of
        its results to the host; returns a pending record for finalize()."""
        if self.stream is not None:
            # weights and inputs prepared on the caller's stream come first
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._on_stream():
            def dev(key, shape):
                t = torch.as_tensor(np.asarray(sample[key]))
                if self.stream is not None:
                    t = t.pin_memory()
                return t.reshape(shape).to(self.device, non_blocking=True)

            ev0 = self._event()
            cam_intr = dev("cam_intr", (1,) + np.shape(sample["cam_intr"])).float()
            latent, mano_results, obj_results = self.model.encode_scene(
                dev("image", (1,) + np.shape(sample["image"])), cam_intr,
                dev("mano_root", (1, -1)).float(),
                dev("rest_obj_corners", (1,) + np.shape(sample["rest_obj_corners"])).float())
            ev1 = self._event()
            ctx: Dict[str, Any] = {"decoder": self.model.decoder, "latent": latent}
            if self.specs.pixel_align:
                ctx["cam_intr"] = cam_intr
                ctx["pred_root"] = mano_results["joints"][:, 0:1]
            if mano_results is not None and self.specs.encode_style != "nerf":
                ctx["rot_center"] = mano_results["rot_center"]
                ctx["global_trans"] = mano_results["global_trans"]
            if obj_results is not None:
                ctx["obj_trans"] = obj_results["obj_trans"]
            grid = self.evaluate_grid(ctx)
            ev2 = self._event()

            out = {"sdf_hand": grid.sdf_hand, "sdf_obj": grid.sdf_obj,
                   "origin": grid.origin, "voxel": grid.voxel_size}
            if mano_results is not None:
                out.update({f"mano_{k}": mano_results[k]
                            for k in ("verts", "joints", "shape", "pcas", "center3d")})
            if obj_results is not None:
                out.update({f"obj_{k}": obj_results[f"obj_{k}"] for k in ("trans", "corners")})
            host = {k: self._to_host(v) for k, v in out.items()}
            done = self._event()
        return {"sample": sample, "host": host, "events": (ev0, ev1, ev2, done), "ctx": ctx}

    def finalize(self, pending: Dict[str, Any], out_dirs: Dict[str, str],
                 task: str = "obman", label_out: bool = False,
                 viz: bool = False, eval_mode: bool = False) -> Dict[str, float]:
        """Host side of one image: wait for its results, export the MANO and
        object parameters, mesh both fields; with ``eval_mode``, align each
        mesh to its GT mesh (``<DataSource>/<task>/test/mesh_hand`` or
        ``mesh_obj/<key>.obj``) before the export; with ``label_out`` (and a
        classifier), write the hand mesh's per-vertex part labels as
        ``<key>_hand_label.npz`` and, with ``viz``, the mesh colored by part
        as ``<key>_hand_color.ply``.  Returns its timings in ms: encode and
        grid (CUDA events), marching cubes (``marching_ms``), largest
        component, ICP, export (the parameter files and the meshes), with
        labels the labels' query and files, and ``host_ms``, all this host
        work together (the span that earlier records call ``mc_ms``)."""
        ev0, ev1, ev2, done = pending["events"]
        if done is not None:
            done.synchronize()
        host = {k: v.numpy() for k, v in pending["host"].items()}
        specs = self.specs
        prefix = pending["sample"]["key"]
        timings = dict.fromkeys(("marching_ms", "lcc_ms", "icp_ms", "export_ms"), 0.0)
        t_host = t0 = time.perf_counter()

        if "mano_verts" in host:
            verts = host["mano_verts"][0]
            mano_para = {"joints": host["mano_joints"][0].tolist(), "vertices": verts.tolist(),
                         "shape": host["mano_shape"][0].tolist(),
                         "pose": host["mano_pcas"][0].tolist()}
            with open(os.path.join(out_dirs["pred_mano"], prefix + ".json"), "w") as f:
                json.dump(mano_para, f)
            if self.mano_faces is not None:
                TriMesh(verts, self.mano_faces).export(
                    os.path.join(out_dirs["pred_mano"], prefix + ".ply"))

        if "obj_trans" in host and "obj_dir" in out_dirs:
            obj_trans = host["obj_trans"][0]
            rest_path = os.path.join(specs.data_source, task, "test",
                                     "mesh_obj_rest", prefix + ".obj")
            if os.path.isfile(rest_path):
                rest = read_obj(rest_path)
                v = (obj_trans[:3, :3] @ rest.vertices.T).T + obj_trans[:3, 3]
                TriMesh(v + host["mano_center3d"][0], rest.faces).export(
                    os.path.join(out_dirs["obj_dir"], prefix + ".obj"))
            with open(os.path.join(out_dirs["obj_dir"], prefix + ".json"), "w") as f:
                json.dump({"obj_corners": host["obj_corners"][0].tolist(),
                           "obj_trans": obj_trans.tolist()}, f)
        timings["export_ms"] += (time.perf_counter() - t0) * 1e3

        origin, voxel = host["origin"], float(host["voxel"])
        mesh_base = os.path.join(out_dirs["meshes"], prefix)
        meshes = {}
        for name, on in (("hand", specs.hand_branch), ("obj", specs.obj_branch)):
            meshes[name] = None
            if not on:
                continue
            t0 = time.perf_counter()
            mesh = surface_mesh(host[f"sdf_{name}"], origin, voxel)
            t1 = time.perf_counter()
            timings["marching_ms"] += (t1 - t0) * 1e3
            if mesh is None:
                continue
            mesh = largest_component(mesh)
            timings["lcc_ms"] += (time.perf_counter() - t1) * 1e3
            gt = (os.path.join(specs.data_source, task, "test", f"mesh_{name}", prefix + ".obj")
                  if eval_mode else None)
            export_with_optional_icp(mesh, f"{mesh_base}_{name}.ply", gt, timings)
            meshes[name] = mesh
        pending["meshes"] = meshes

        hand = meshes.get("hand")
        if label_out and hand is not None and specs.classifier_branch:
            t0 = time.perf_counter()
            labels = self._query_labels(pending["ctx"], hand.vertices)
            np.savez(f"{mesh_base}_hand_label.npz", points=hand.vertices.astype(np.float32),
                     labels=labels.astype(np.float32))
            if viz:
                write_ply(f"{mesh_base}_hand_color.ply", hand.vertices, hand.faces,
                          vertex_colors=PART_COLORS[labels % len(PART_COLORS)])
            timings["labels_ms"] = (time.perf_counter() - t0) * 1e3
        timings["host_ms"] = (time.perf_counter() - t_host) * 1e3

        if done is not None:
            timings["encode_ms"] = ev0.elapsed_time(ev1)
            timings["grid_ms"] = ev1.elapsed_time(ev2)
        return timings

    @torch.no_grad()
    def _query_labels(self, ctx: Dict[str, Any], verts: np.ndarray) -> np.ndarray:
        """The argmax of the classifier's logits at (V, 3) mesh vertices: the
        vertices embedded as the grid embeds its points, the scene's latent
        broadcast or, for a pixel-aligned config, the feature map sampled at
        each vertex's projection (the raw vertex, or the embedding's first
        three columns under ``pixel_ref_projection``), then the plain decoder
        (``decode_points``) in the model's compute dtype, as the JAX
        package's ``_query_labels`` decodes in XLA."""
        specs = self.specs
        pts = torch.as_tensor(np.asarray(verts, np.float32), device=ctx["latent"].device)
        emb = embed_points(specs, ctx, pts)
        if ctx["latent"].ndim == 4:
            proj = emb[:, :3] if self.pixel_ref_projection else pts
            latent = pixel_alignment(ctx["latent"], proj, ctx["cam_intr"], ctx["pred_root"],
                                     specs.image_size[0], specs.sdf_scale_factor)
        else:
            latent = ctx["latent"].expand(pts.shape[0], ctx["latent"].shape[1])
        _, _, logits = self.model.decode_points(torch.cat([latent, emb], dim=1))
        return logits.argmax(dim=1).cpu().numpy()


def run_pipelined(recon: Reconstructor, samples, out_dirs: Dict[str, str],
                  task: str = "obman",
                  on_done: Optional[Callable[[int, Dict[str, Any]], None]] = None,
                  lookahead: int = 2, label_out: bool = False, viz: bool = False,
                  eval_mode: bool = False) -> int:
    """Reconstruct a sequence with ``lookahead`` images of device work in
    flight ahead of the host work.  Each pending image holds two N^3 float32
    fields (16 MB at 128^3).  ``on_done(i, pending)`` sees the image's
    ``timings`` and ``meshes`` (the meshes before any ICP alignment).
    ``label_out``, ``viz`` and ``eval_mode`` go to ``finalize``.  Returns
    the number of images processed."""
    window: deque = deque()
    count = 0

    def finish():
        nonlocal count
        idx, pending = window.popleft()
        pending["timings"] = recon.finalize(pending, out_dirs, task=task, label_out=label_out,
                                            viz=viz, eval_mode=eval_mode)
        count += 1
        if on_done is not None:
            on_done(idx, pending)

    for i in range(len(samples)):
        window.append((i, recon.submit(samples[i])))
        if len(window) > max(1, lookahead):
            finish()
    while window:
        finish()
    return count


def make_output_dirs(output_dir: str) -> Dict[str, str]:
    """Workspace layout (reference reconstruct.py:34-48)."""
    dirs = {
        "meshes": os.path.join(output_dir, "meshes"),
        "pred_mano": os.path.join(output_dir, "pred_mano"),
        "obj_dir": os.path.join(output_dir, "object"),
    }
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    return dirs


def load_mano_faces() -> np.ndarray:
    """The closed MANO mesh's faces, for the predicted hands' PLY files."""
    return np.load(os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                                "closed_fmano.npy"))
