"""Evaluation CLI, the JAX package's ``cli/evaluate.py`` (reference
evaluate.py:115-178 argument surface).  It runs on the host: numpy and
scipy, no device.

    python -m alignsdf_torch.cli.evaluate -e <experiment_dir> -t obman \
        [--mano] [--obj] [--optim] [--rot] [--workers 10] [--data_root ...]

It scores ``<experiment_dir>/Eval_<task>/`` (``cli/reconstruct.py``'s
output) against the GT meshes and meta under ``--data_root`` (default
``data/<task>/test``) and writes the summary ``.txt``, ``eval_<task>_<mode>.json``
and the best/worst-20 copies there.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from alignsdf_torch.eval.evaluate import evaluate


def main(argv=None):
    """Parse ``argv``, evaluate, log and return the summary dict."""
    parser = argparse.ArgumentParser(description="AlignSDF evaluation (host)")
    parser.add_argument("-e", dest="experiment_dir", required=True)
    parser.add_argument("-t", dest="task", default="obman",
                        choices=["obman", "dexycb", "ho3d"])
    parser.add_argument("-s", dest="split_filename", default=None,
                        help="optional key list; default: discover from the "
                             "Eval workspace like the reference")
    parser.add_argument("--mano", action="store_true",
                        help="evaluate the predicted MANO mesh + joint/vert errors")
    parser.add_argument("--obj", action="store_true",
                        help="evaluate the object mesh + center/corner errors")
    parser.add_argument("--optim", action="store_true",
                        help="trans+scale ICP before chamfer")
    parser.add_argument("--optim_mano", action="store_true",
                        help="use optim_mano/ instead of pred_mano/")
    parser.add_argument("--fit", action="store_true",
                        help="hand-SDF vs MANO mesh consistency chamfer")
    parser.add_argument("--rot", action="store_true",
                        help="full-rotation ICP before chamfer")
    parser.add_argument("--workers", type=int, default=10)
    parser.add_argument("--data_root", default=None)
    args = parser.parse_args(argv)

    logging.basicConfig(force=True, level=logging.INFO,
                        format="AlignSDF-torch - %(levelname)s - %(message)s")

    keys = None
    if args.split_filename:
        with open(args.split_filename) as f:
            filenames = json.load(f)["filenames"]
        keys = [f.split("/")[-1].split(".")[0] for f in filenames]

    output_dir = os.path.join(args.experiment_dir, f"Eval_{args.task}")
    summary = evaluate(
        output_dir, args.task, keys, data_root=args.data_root,
        mano=args.mano, obj=args.obj, optim=args.optim,
        optim_mano=args.optim_mano, fit=args.fit, rot=args.rot,
        workers=args.workers,
    )
    for key, value in sorted(summary.items()):
        logging.info("%s: %s", key, value)
    return summary


if __name__ == "__main__":
    main()
