"""Reconstruction CLI on one GPU (the JAX package's ``cli/reconstruct.py``;
reference reconstruct.py:107-178).

Usage:
    python -m alignsdf_torch.cli.reconstruct -e <experiment_dir> -t obman \\
        [-s split.json [--data_root DIR] | --samples samples.npz] \\
        [--checkpoint latest | --weights model.pth] \\
        [--start_point A --end_point B] [--cube_dim 128] [--device cuda] \\
        [--ref_pixel_projection] [--label [--viz]] [--pallas] [--eval_mode] [--bf16]

Weights are a reference-schema torch checkpoint,
``<experiment_dir>/ModelParameters/<checkpoint>.pth`` ({"epoch",
"model_state_dict"} or a bare state_dict), or ``--weights``.  The images
are a test split (reference reconstruct.py:126-140): ``-s`` names a json
``{"filenames": [...]}`` (default ``input/<task>.json``) whose keys are read
from ``<data_root>/rgb/<key>.jpg`` and ``<data_root>/meta/<key>.pkl``
(``data/dataset.py:ImagesDataset``; ``--data_root`` defaults to
``<DataSource>/<task>/test``).  Or they come from an npz (``--samples``)
holding ``image`` (S, H, W, 3) uint8, ``cam_intr`` (S, 3, 4), ``mano_root``
(S, 3), ``rest_obj_corners`` (S, 8, 3) and ``key`` (S,).
``--start_point`` / ``--end_point`` slice either list; one process takes
the whole slice.  Outputs go to ``<experiment_dir>/Eval_<task>/``.  A pixel-aligned
experiment (``PixelAlign``) reconstructs through kernel K3, the others
through K1, where the embedding is affine in xyz.  Otherwise (e.g. NeRF PE
with point_size > 3) the grid decodes materialized [latent, embedding] rows:
through kernel K6 with ``--pallas``, as the JAX CLI's ``--pallas`` runs its
generic Pallas decoder, else through the plain decoder.  With a
classifier (``ClassifierBranch``), ``--label`` writes the hand mesh's
per-vertex part labels (``meshes/<key>_hand_label.npz``) and ``--viz`` the
mesh colored by part (``meshes/<key>_hand_color.ply``).  With
``--eval_mode`` each mesh is aligned to its GT mesh
(``<DataSource>/<task>/test/mesh_hand`` or ``mesh_obj/<key>.obj``, where it
exists) by trans+scale ICP on the host before its PLY is written.  Each
``--bf16`` runs the grid's kernels (K1, K3, or K6 with ``--pallas``) in
bf16, as the JAX CLI's ``--bf16`` does; the encoder and the plain decoder
follow the experiment's ``ComputeDtype`` instead, float32 or bfloat16.  Each
image's log line gives its timings in ms: encode and grid (device), marching
cubes, largest component, ICP, export and all the host work together (host).  ``cli/evaluate.py`` scores
the workspace.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

from alignsdf_torch import resolve_device, use_float32_precision
from alignsdf_torch.config import specs_from_dict
from alignsdf_torch.data.dataset import ImagesDataset
from alignsdf_torch.inference.reconstruct import (Reconstructor, load_mano_faces,
                                                   make_output_dirs, run_pipelined)
from alignsdf_torch.models.alignsdf import build_model
from alignsdf_torch.ops.decoder_plan import make_generic_decode_fn

logger = logging.getLogger("alignsdf_torch.reconstruct")

SAMPLE_KEYS = ("image", "cam_intr", "mano_root", "rest_obj_corners", "key")


def load_reference_weights(model: torch.nn.Module, path: str) -> None:
    """Load a reference checkpoint (DDP 'module.' prefixes stripped).  Keys
    the port does not hold (e.g. the MANO layer's buffers) are ignored; a
    parameter the checkpoint lacks is an error."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data["model_state_dict"] if "model_state_dict" in data else data
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"checkpoint {path} lacks {missing}")
    if unexpected:
        logger.info("ignored %d checkpoint entries the port does not hold", len(unexpected))


def load_samples(path: str, start=None, end=None):
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in SAMPLE_KEYS}
    count = len(arrays["key"])
    sl = slice(start or 0, end if end is not None else count)
    return [{k: (str(arrays[k][i]) if k == "key" else arrays[k][i]) for k in SAMPLE_KEYS}
            for i in range(count)[sl]]


def main(argv=None):
    """Parse ``argv`` and reconstruct; returns each image's key and timings (ms)."""
    parser = argparse.ArgumentParser(description="AlignSDF reconstruction (PyTorch/CUDA)")
    parser.add_argument("-e", dest="experiment_dir", required=True)
    parser.add_argument("-t", dest="task", default="obman", choices=["obman", "dexycb", "ho3d"])
    parser.add_argument("--checkpoint", default="latest")
    parser.add_argument("--start_point", type=int, default=None)
    parser.add_argument("--end_point", type=int, default=None)
    parser.add_argument("--cube_dim", type=int, default=128)
    parser.add_argument("--lookahead", type=int, default=2,
                        help="images of device work kept in flight ahead of the "
                             "host-side meshing/export work")
    source = parser.add_mutually_exclusive_group()
    source.add_argument("-s", dest="split_filename", default=None,
                        help="test split json {\"filenames\": [...]} (default "
                             "input/<task>.json)")
    source.add_argument("--samples", default=None, help="npz of input samples")
    parser.add_argument("--data_root", default=None,
                        help="the test split's directory (rgb/, meta/; default "
                             "<DataSource>/<task>/test)")
    parser.add_argument("--weights", default=None,
                        help="torch checkpoint to load instead of ModelParameters/")
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("--ref_pixel_projection", action="store_true",
                        help="pixel-align configs: project the embedding's first three "
                             "columns as the reference's mesh path does, instead of the "
                             "raw grid coordinates as its train path does "
                             "(see inference/grid.py)")
    parser.add_argument("--label", action="store_true",
                        help="classifier configs: write the hand mesh's per-vertex part labels")
    parser.add_argument("--viz", action="store_true",
                        help="with --label: also write the hand mesh colored by part")
    parser.add_argument("--pallas", action="store_true",
                        help="decode the generic grid path (configs the fused K1/K3 path "
                             "does not take) through kernel K6 instead of the plain decoder")
    parser.add_argument("--eval_mode", action="store_true",
                        help="align each mesh to its GT mesh by trans+scale ICP before "
                             "the export (reference utils/mesh.py:383-398)")
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 grid fast path (the grid kernels in bf16; "
                             "field deviation vs f32 documented in PERF.md)")
    args = parser.parse_args(argv)
    if args.samples is not None and args.data_root is not None:
        parser.error("--data_root: the images come from --samples")

    logging.basicConfig(force=True, level=logging.INFO,
                        format="AlignSDF-torch - %(levelname)s - %(message)s")
    device = resolve_device(args.device)
    use_float32_precision()
    with open(os.path.join(args.experiment_dir, "specs.json")) as f:
        specs = specs_from_dict(json.load(f))

    model = build_model(specs)
    weights = args.weights or os.path.join(args.experiment_dir, "ModelParameters",
                                           f"{args.checkpoint}.pth")
    load_reference_weights(model, weights)
    logger.info("loaded %s", weights)

    if args.samples is not None:
        samples = load_samples(args.samples, args.start_point, args.end_point)
    else:
        samples = ImagesDataset.from_split(args.split_filename or f"input/{args.task}.json",
                                           specs, args.task, args.data_root,
                                           args.start_point, args.end_point)
    out_dirs = make_output_dirs(os.path.join(args.experiment_dir, f"Eval_{args.task}"))
    grid_dtype = torch.bfloat16 if args.bf16 else torch.float32
    recon = Reconstructor(model, specs, cube_dim=args.cube_dim, device=device,
                          mano_faces=load_mano_faces(),
                          pixel_ref_projection=args.ref_pixel_projection,
                          decode_fn=(make_generic_decode_fn(specs, dtype=grid_dtype)
                                     if args.pallas else None),
                          grid_dtype=grid_dtype)
    if recon.fused:
        logger.info("grid: the fused path (kernel %s)", "K3" if specs.pixel_align else "K1")
    else:
        logger.info("grid: the generic path on materialized rows, through %s",
                    "kernel K6 (--pallas)" if args.pallas else "the plain decoder")
    logger.info("compute dtypes: the grid's kernels %s, the model %s",
                "bf16" if args.bf16 else "float32", specs.compute_dtype)

    t0 = time.time()
    per_image = []

    def log_done(idx, pending):
        nonlocal t0
        per_image.append({"key": pending["sample"]["key"], **pending["timings"]})
        logger.info("[%d/%d] %s: %.2fs, ms: %s", idx + 1, len(samples), pending["sample"]["key"],
                    time.time() - t0, " ".join(f"{k[:-3]} {v:.1f}"
                                               for k, v in pending["timings"].items()))
        t0 = time.time()

    run_pipelined(recon, samples, out_dirs, task=args.task, on_done=log_done,
                  lookahead=args.lookahead, label_out=args.label, viz=args.viz,
                  eval_mode=args.eval_mode)
    return per_image


if __name__ == "__main__":
    main()
